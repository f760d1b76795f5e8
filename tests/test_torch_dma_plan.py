"""PyTorch port: the launch plan of the TMA-fed tensor-core kernel that K3a,
K3b, K4b and K7a run on (``ops/nhwc_conv.py:dma_plan``,
``csrc/int8_tma_conv.cuh``), held on the CPU.

The CUDA kernel cannot run here, so what it is given is checked instead: the
plan takes TMA exactly where a tensor map is legal, the image stride in its
strides; its shared memory and grid fit the H100 at every w16 and w64 shape
of each kernel's contract, at b128 and b1; a ring slot's address function
(the TMA box's layout) walks every (pixel, granule) once; an int64 product
walked as the consumers walk it (the input read from its flat buffer through
the tensor map's address function, image stride included; each wgmma's A and
B bytes gathered through the descriptors' address functions, the weights
packed by the wrapper's own ``pack_dma_weights``, the n index mapped back
through ``dma_channel_order``) equals the plain version exactly, with garbage
in the padding channels, zero-filled out-of-bounds halo rows and edges, live
H-pad rows for K3a and random pad rows that K3b must not read; the kernel's
requant by a rounding add equals ``requant``; and one case each, through that
epilogue, equals JAX's Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from twinvoice_tpu.ops import nhwc_conv as JN
from twinvoice_tpu.ops import qconv_pallas as QP
from twinvoice_tpu_torch.ops import nhwc_conv as nhwc
from twinvoice_tpu_torch.ops import qconv

CS = (1, 3, 16, 17, 32, 33, 64, 128, 129)
INT_MAX = 2**31 - 1
F32 = np.float32


def _s8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _k3a_plan(n, h, w, c, co, **kw):
    return nhwc.dma_plan(n, h + 2, w + 2, c, h, w, co, 3, **kw)


def _k7a_plan(n, h, p, cpk, co2, in_phase, **kw):
    p_out = p - 1 if in_phase == "A" else p + 1
    return nhwc.dma_plan(n, h, p, cpk, h, p_out, co2, 2, **kw)


def _k3b_plan(n, h, w, c, co, **kw):
    """K3b sees rows 1..h of its (n, h+2, w+2, c) input, h + 2 rows apart."""
    return nhwc.dma_plan(n, h, w + 2, c, h, w, co, 3, himg=h + 2, **kw)


def _k4b_plan(n, h, w, c, co, **kw):
    return nhwc.dma_plan(n, h, w, c, h, w, co, 3, **kw)


# the box's start against its tile, (row_off, col_off), as each C entry sets it
# (csrc/qconv3x3_nhwc_dma.cu, qconv3x3_nhwc_requant.cu, qconv3x3_requant_dma.cu,
# qconv3x3_pair_dma.cu)
BOX_OFFSETS = {nhwc.K3A: (0, 0), nhwc.K3B: (-1, 0), qconv.K4B: (-1, -1),
               (nhwc.K7A, "A"): (-1, 0), (nhwc.K7A, "B"): (-1, -1)}


# -- the kernel's address functions, mirrored from csrc/int8_tma_conv.cuh -----------


def slab_offset(plan, granule, row, col):
    """Byte offset in a ring slot of 16-byte granule ``granule`` of slab pixel
    (``row``, ``col``): the TMA box's layout [granule][row][column][16]
    (``fill_slab``, the 5-D box)."""
    pw = 64 + plan.kw - 1
    return ((granule * (plan.th + 2) + row) * pw + col) * 16


def k_steps(plan):
    """32-byte k steps of one tap and chunk (``consumer``'s ``ksteps``)."""
    return max(1, plan.chunk // 32)


def a_operand_offset(plan, out_row, tap, k, m, kbyte):
    """Byte of the slot that ``consumer``'s wgmma reads as A's element (pixel
    ``m`` of tile row ``out_row``, k byte ``kbyte`` of 32) at ``tap`` and k
    step ``k``: the descriptor's start is the slab's row out_row + dy from
    column dx at granule 2k; core matrices of 8 pixels 128 bytes apart (SBO),
    the second k half one granule plane on (LBO; 0 for a 16-channel chunk,
    which re-reads its granule against zero weights)."""
    dy, dx = divmod(tap, plan.kw)
    lbo = plan.slab_bytes // (plan.chunk // 16) if plan.chunk >= 32 else 0
    start = slab_offset(plan, 2 * k, out_row + dy, dx)
    return start + (m // 8) * 128 + (m % 8) * 16 + (kbyte // 16) * lbo + kbyte % 16


def b_operand_offset(plan, tap, k, o, kbyte):
    """Byte of one chunk's packed weights that the wgmma reads as B's element
    (n index ``o``, k byte ``kbyte``) at ``tap`` and k step ``k``: core
    matrices of 8 n indices 128 bytes apart (SBO), cot·16 along k (LBO)."""
    start = (tap * (plan.kb // 16) + 2 * k) * plan.cot * 16
    return start + (o // 8) * 128 + (o % 8) * 16 + (kbyte // 16) * plan.cot * 16 + kbyte % 16


# -- tensor maps ------------------------------------------------------------------


def test_tensor_map_legality():
    """The rules cuTensorMapEncodeTiled holds a map to: 16-byte strides and base, box
    dimensions 1–256, the inner box a multiple of 16 bytes and within the
    swizzle span."""
    dims, strides, box = (16, 66, 10, 4, 2), (64, 64 * 66, 16, 64 * 66 * 10), (16, 66, 10, 4, 1)
    legal = nhwc.tensor_map_legal
    assert legal(dims, strides, box, base_aligned=True)
    assert not legal(dims, strides, box, base_aligned=False)
    assert not legal(dims, (72, 72 * 66, 16, 72 * 66 * 10), box, base_aligned=True)
    assert not legal(dims, strides, (16, 257, 10, 4, 1), base_aligned=True)
    assert not legal(dims, strides, (8, 66, 10, 4, 1), base_aligned=True)
    assert not legal(dims, strides, (16, 66, 0, 4, 1), base_aligned=True)
    assert legal((128, 64), (128,), (128, 64), base_aligned=True, swizzle=128)
    assert not legal((128, 64), (128,), (128, 64), base_aligned=True, swizzle=64)
    assert not legal((16,) * 6, (16,) * 5, (16,) * 6, base_aligned=True)


@pytest.mark.parametrize("c", CS + (48, 1024))
@pytest.mark.parametrize("aligned", (True, False))
def test_plan_takes_tma_exactly_where_a_map_is_legal(c, aligned):
    for kw, plan in ((3, _k3a_plan(2, 9, 37, c, 24, x_aligned=aligned, out_aligned=aligned)),
                     (2, _k7a_plan(2, 9, 37, c, 24, "A", x_aligned=aligned,
                                   out_aligned=aligned))):
        hin, win = (11, 39) if kw == 3 else (9, 37)
        dims, strides, box = nhwc.in_map_geometry(2, hin, win, c, kw, plan.cot, plan.chunk)
        assert plan.tma_in == nhwc.tensor_map_legal(dims, strides, box, base_aligned=aligned)
        assert plan.tma_in == (c % 16 == 0 and aligned)
        assert box == (16, 64 + kw - 1, plan.th + 2, plan.chunk // 16, 1)
        assert strides[2] == 16 and dims[3] == c // 16
    for co in (2, 16, 24, 32, 40, 64, 72, 128, 256):
        for aligned in (True, False):
            plan = _k3a_plan(2, 9, 37, 64, co, out_aligned=aligned)
            dims, strides, box = nhwc.out_map_geometry(2, 9, 37, co, plan.cot)
            assert box == (plan.cot, 64, plan.th // 2, 1)
            assert plan.tma_out == (plan.cot <= co and nhwc.tensor_map_legal(
                dims, strides, box, base_aligned=aligned))
            assert plan.tma_out == (co % 16 == 0 and plan.cot <= co and aligned)


@pytest.mark.parametrize("c", CS + (48,))
@pytest.mark.parametrize("aligned", (True, False))
def test_k3b_k4b_plans_take_tma_exactly_where_a_map_is_legal(c, aligned):
    """K3b's map sees rows 1..H of its padded input (H rows, starting a
    padded row in), its images (H+2)·(W+2)·C bytes apart; K4b's the unpadded
    input, H·W·C apart. TMA exactly where the map is legal: C % 16 == 0 and
    the first visible row aligned (for K3b, (W+2)·C % 16 == 0 then too)."""
    n, h, w = 2, 9, 37
    assert nhwc.dma_input(nhwc.K3B, (n, h + 2, w + 2, c)) == (3, h, h + 2, 1)
    assert nhwc.dma_input(qconv.K4B, (n, h, w, c)) == (3, h, h, 0)
    cases = [(_k3b_plan(n, h, w, c, 24, x_aligned=aligned, out_aligned=aligned),
              h, w + 2, h + 2)]
    if c <= qconv.K4B_MAX_CIN:
        cases.append((_k4b_plan(n, h, w, c, 24, x_aligned=aligned, out_aligned=aligned),
                      h, w, h))
    for plan, hin, win, himg in cases:
        dims, strides, box = nhwc.in_map_geometry(n, hin, win, c, 3, plan.cot, plan.chunk,
                                                  himg)
        assert dims == (16, win, hin, c // 16, n)
        assert strides == (c, win * c, 16, himg * win * c)
        assert plan.tma_in == nhwc.tensor_map_legal(dims, strides, box, base_aligned=aligned)
        assert plan.tma_in == (c % 16 == 0 and aligned)
        assert box == (16, 66, plan.th + 2, plan.chunk // 16, 1)
        assert plan.tma_out == (plan.cot <= 24)  # Co 24 has a 32-channel block


# -- shared memory and grid -----------------------------------------------------------


def _plan_cases():
    cases = []
    for base in (16, 64):
        for hw, cin, co in chip_smoke.trunk_shapes(base=base)[qconv.K4A]:
            for n in (128, 1):
                cases.append(pytest.param("K3a", n, hw, hw, cin, co, None,
                                          id=f"K3a-w{base}-b{n}-{hw}-{cin}-{co}"))
        for label, (_, h, p, cpk, co2), in_phase in chip_smoke.k7b_serving_calls(base=base):
            for n in (128, 1):
                cases.append(pytest.param("K7a", n, h, p, cpk, co2, in_phase,
                                          id=f"K7a-w{base}-b{n}-{label.split()[1]}-{in_phase}"))
        for hw, cin, co in chip_smoke.trunk_shapes(base=base)[qconv.K4A]:
            kinds = ("K3b", "K4b") if cin <= qconv.K4B_MAX_CIN else ("K3b",)
            for kind in kinds:
                for n in (128, 1):
                    cases.append(pytest.param(kind, n, hw, hw, cin, co, None,
                                              id=f"{kind}-w{base}-b{n}-{hw}-{cin}-{co}"))
    cases += [pytest.param("K3b", 1, 1, 1, 1, 1, None, id="K3b-one-pixel"),
              pytest.param("K4b", 1, 1, 1, 1, 1, None, id="K4b-one-pixel"),
              pytest.param("K3b", 2, 9, 14, 1024, 256, None, id="K3b-wide"),
              pytest.param("K4b", 2, 9, 14, 128, 256, None, id="K4b-widest")]
    cases += [pytest.param("K3a", 1, 1, 1, 1, 1, None, id="K3a-one-pixel"),
              pytest.param("K7a", 1, 1, 3, 1, 2, "A", id="K7a-narrowest-A"),
              pytest.param("K7a", 1, 1, 2, 1, 2, "B", id="K7a-narrowest-B"),
              pytest.param("K3a", 2, 9, 14, 1024, 256, None, id="K3a-wide")]
    return cases


@pytest.mark.parametrize("kind,n,h,w,c,co,in_phase", _plan_cases())
def test_plan_fits_the_card(kind, n, h, w, c, co, in_phase):
    if kind in ("K3a", "K3b", "K4b"):
        plan_of = {"K3a": _k3a_plan, "K3b": _k3b_plan, "K4b": _k4b_plan}[kind]
        plan, w_out = plan_of(n, h, w, c, co), w
    else:
        plan, w_out = _k7a_plan(n, h, w, c, co, in_phase), w - 1 if in_phase == "A" else w + 1
    kw = plan.kw
    assert plan.cot == (32 if co <= 32 else 64 if co <= 64 else 128)
    assert plan.th == 2 * (256 // plan.cot)
    assert plan.chunk in (16, 32, 64, 128) and plan.chunk <= -(-c // 16) * 16
    assert plan.n_chunks == -(-c // plan.chunk) and plan.kb == max(32, plan.chunk)
    assert 2 <= plan.stages <= 4
    # the parts of the shared memory, as the kernel carves it
    pw = 64 + kw - 1
    assert plan.slab_bytes == plan.chunk // 16 * (plan.th + 2) * pw * 16
    assert plan.wchunk_bytes == 3 * kw * plan.kb * plan.cot
    slot = -(-(plan.slab_bytes + (0 if plan.resident else plan.wchunk_bytes)) // 128) * 128
    wres = -(-plan.n_chunks * plan.wchunk_bytes // 128) * 128 if plan.resident else 0
    staging = plan.th * 64 * plan.cot
    barriers = 8 * (2 * plan.stages + 3)
    assert plan.smem == 128 + plan.stages * slot + wres + staging + 8 * plan.cot + barriers
    assert plan.smem <= qconv.SMEM_LIMIT == 232_448
    assert plan.smem + 1024 <= qconv.SM_SMEM  # one block an SM
    assert plan.resident == (nhwc._dma_smem(kw, plan.cot, plan.chunk, plan.n_chunks,
                                            plan.stages, True) == plan.smem)
    blocks, n_co = plan.grid
    assert n_co == -(-co // plan.cot) <= 65535
    assert plan.tiles == n * -(-h // plan.th) * -(-w_out // 64)
    assert plan.tiles <= INT_MAX // 2
    assert 1 <= blocks <= plan.tiles and blocks * n_co <= qconv.H100_SMS + n_co
    box = nhwc.in_map_geometry(n, h, w, c, kw, plan.cot, plan.chunk)[2]
    assert all(1 <= d <= 256 for d in box)
    # a resident block's weights are one bulk copy's worth of 16-byte pieces
    assert plan.wchunk_bytes % 16 == 0 and plan.slab_bytes % 16 == 0


def test_w64_flagship_plans():
    """The shapes the timings are taken at: K3a resident with a 3-slot ring
    of 64-channel slabs, K7a resident with 2 slots of 128 channels, K7a's B->A
    dec0 conv1 (Cpk 256) streaming its weights through the ring."""
    k3a = _k3a_plan(128, 512, 512, 64, 64)
    assert (k3a.cot, k3a.chunk, k3a.stages, k3a.resident) == (64, 64, 3, True)
    assert k3a.tma_in and k3a.tma_out and k3a.grid == (132, 1)
    k7a = _k7a_plan(128, 512, 257, 128, 128, "A")
    assert (k7a.cot, k7a.chunk, k7a.stages, k7a.resident) == (128, 128, 2, True)
    dec = _k7a_plan(128, 512, 256, 256, 128, "B")
    assert not dec.resident and dec.n_chunks * dec.chunk == 256


# -- the slot's layout and the consumers' walk -------------------------------------------


@pytest.mark.parametrize("kw", (3, 2))
@pytest.mark.parametrize("c", (16, 48, 128))
def test_slot_address_walks_every_pixel_and_granule_once(kw, c):
    """The box's layout [granule][row][column][16 bytes] covers the slab's
    bytes exactly once; 8 neighbouring pixels of a granule are one 128-byte
    core matrix, and a tap's shift moves the A operand by whole pixels."""
    plan = nhwc.dma_plan(1, 9, 70, c, 7, 68 - kw + 1, 64, kw)
    pw = 64 + kw - 1
    g, r, col = np.meshgrid(np.arange(plan.chunk // 16), np.arange(plan.th + 2),
                            np.arange(pw), indexing="ij")
    offs = slab_offset(plan, g, r, col)[..., None] + np.arange(16)
    assert sorted(offs.ravel().tolist()) == list(range(plan.slab_bytes))
    m = np.arange(64)
    for tap in range(3 * kw):
        dy, dx = divmod(tap, kw)
        for k in range(k_steps(plan)):
            for kbyte in (0, 15, 16, 31):
                a = a_operand_offset(plan, 1, tap, k, m, kbyte)
                gran = 2 * k + kbyte // 16 if plan.chunk >= 32 else 0
                want = slab_offset(plan, gran, 1 + dy, dx + m) + kbyte % 16
                np.testing.assert_array_equal(a, want)
                assert (np.diff(a.reshape(8, 8), axis=1) == 16).all()


def input_offset(strides, img, row, col, chan):
    """Byte offset from the kernel's input pointer of channel ``chan`` of
    pixel (``row``, ``col``) of image ``img``: the 5-D tensor map's address
    function, (16-byte granule, column, row, granule index, image) at byte
    strides (1, C, Win·C, 16, Himg·Win·C), which ``fill_slab`` also follows."""
    return (chan % 16 + col * strides[0] + row * strides[1] + chan // 16 * strides[2]
            + img * strides[3])


def _walk(kind, x, wts, plan, h_out, w_out, rng, in_phase=None):
    """int64 sums walked as the kernel's consumers walk them, on the input as
    kernel ``kind`` sees it (``nhwc.dma_input``: its window, visible rows,
    image stride and first row): for each block of output channels, tile and
    chunk, the slot filled as TMA fills it, each byte read from the flat
    buffer of ``x`` through the tensor map's address function from the first
    visible row, with the box started at the tile's origin plus the entry's
    ``BOX_OFFSETS`` (zeros outside the visible rows and columns, garbage in
    the channels past C, which meet zero weights); then for each tap and k
    step each output row's 64 x 32 A bytes and the cot x 32 B bytes gathered
    through the operand address functions, the n index mapped back to its
    channel. → (n, h_out, w_out, co) int64."""
    n, _, win, c = x.shape
    kw, hin, himg, row0 = nhwc.dma_input(kind, x.shape)
    assert kw == plan.kw
    row_off, col_off = BOX_OFFSETS[kind if in_phase is None else (kind, in_phase)]
    strides = nhwc.in_map_geometry(n, hin, win, c, kw, plan.cot, plan.chunk, himg)[1]
    flat = np.ascontiguousarray(x).ravel().astype(np.int64)
    base = row0 * strides[1]
    co = wts.shape[0]
    th, chunk = plan.th, plan.chunk
    pw = 64 + kw - 1
    granules = chunk // 16
    packed = nhwc.pack_dma_weights(torch.from_numpy(wts), plan).numpy().astype(np.int64)
    packed = packed.reshape(plan.grid[1], plan.n_chunks, -1)
    order = nhwc.dma_channel_order(plan.cot).numpy()
    out = np.zeros((n, h_out, w_out, co), np.int64)
    m, kb = np.arange(64)[:, None], np.arange(32)[None, :]
    o = np.arange(plan.cot)[:, None]
    n_th, n_tw = -(-h_out // th), -(-w_out // 64)
    gi, ri, ci, bi = np.ix_(np.arange(granules), np.arange(th + 2), np.arange(pw),
                            np.arange(16))
    for blk in range(plan.grid[1]):
        for t in range(plan.tiles):
            img, rr = divmod(t, n_th * n_tw)
            h0, w0 = rr // n_tw * th, rr % n_tw * 64
            acc = np.zeros((th, 64, plan.cot), np.int64)
            for ch in range(plan.n_chunks):
                row, col = h0 + row_off + ri, w0 + col_off + ci
                chan = ch * chunk + 16 * gi + bi
                seen = (row >= 0) & (row < hin) & (col >= 0) & (col < win)
                live = seen & (chan < c)
                addr = base + input_offset(strides, img, row, col, chan)
                slot = np.where(live, flat[np.where(live, addr, 0)], 0)
                garbage = rng.integers(-127, 128, slot.shape)
                slot = np.where(seen & (chan >= c), garbage, slot)
                slot = slot.ravel()
                wflat = packed[blk, ch]
                for tap in range(3 * kw):
                    for k in range(k_steps(plan)):
                        b = wflat[b_operand_offset(plan, tap, k, o, kb)]  # (cot, 32)
                        for r in range(th):
                            a = slot[a_operand_offset(plan, r, tap, k, m, kb)]
                            acc[r] += a @ b.T
            for nn in range(plan.cot):
                ch_out = blk * plan.cot + order[nn]
                if ch_out < co:
                    hs, ws = min(th, h_out - h0), min(64, w_out - w0)
                    out[img, h0:h0 + hs, w0:w0 + ws, ch_out] = acc[:hs, :ws, nn]
    return out


@pytest.mark.parametrize("c", CS)
def test_k3a_walk_equals_nhwc_conv_i8(c):
    """Every row of the padded input read, its H-pad rows live; W 70 puts the
    last tile past the edge; Co 40 leaves n indices past Co in the block."""
    rng = np.random.default_rng(500 + c)
    n, h, w, co = 1, 5, 70, 40
    x_pad = _s8(rng, (n, h + 2, w + 2, c))  # pad rows and columns not zero
    k = _s8(rng, (co, 3, 3, c))
    plan = _k3a_plan(n, h, w, c, co)
    assert nhwc.dma_input(nhwc.K3A, x_pad.shape) == (3, h + 2, h + 2, 0)  # stride = Hin
    got = _walk(nhwc.K3A, x_pad, k, plan, h, w, rng)
    want = nhwc.nhwc_conv_i8(torch.from_numpy(x_pad), torch.from_numpy(k), drop_h_pad=False)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("in_phase", ["A", "B"])
@pytest.mark.parametrize("cpk", CS)
def test_k7a_walk_equals_pair_conv_i8(cpk, in_phase):
    """The box starts a row above the tile (the zero H halo from TMA) and,
    for a B input, a pair left of it (the zero slab edges)."""
    rng = np.random.default_rng(600 + cpk)
    n, h, co2 = 1, 3, 34
    p = 67 if in_phase == "A" else 66
    x = _s8(rng, (n, h, p, cpk))
    wp = _s8(rng, (co2, 3, 2, cpk))
    plan = _k7a_plan(n, h, p, cpk, co2, in_phase)
    p_out = p - 1 if in_phase == "A" else p + 1
    assert nhwc.dma_input(nhwc.K7A, x.shape) == (2, h, h, 0)  # stride = Hin
    got = _walk(nhwc.K7A, x, wp, plan, h, p_out, rng, in_phase)
    want = nhwc.pair_conv_i8(torch.from_numpy(x), torch.from_numpy(wp), in_phase)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("c", CS)
def test_k3b_walk_equals_nhwc_conv_i8_dropping_the_h_pad(c):
    """Two images whose pad rows and columns hold random bytes: the walk
    reads rows 1..H of each through the image stride (H+2)·(W+2)·C from the
    flat padded buffer, the box a row above the tile (TMA's zero rows in
    place of the pad rows), the W-pad columns as they lie; W 70 puts the last
    tile past the edge; Co 40 leaves n indices past Co in the block."""
    rng = np.random.default_rng(700 + c)
    n, h, w, co = 2, 5, 70, 40
    x_pad = _s8(rng, (n, h + 2, w + 2, c))
    k = _s8(rng, (co, 3, 3, c))
    plan = _k3b_plan(n, h, w, c, co)
    got = _walk(nhwc.K3B, x_pad, k, plan, h, w, rng)
    want = nhwc.nhwc_conv_i8(torch.from_numpy(x_pad), torch.from_numpy(k), drop_h_pad=True)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    live = nhwc.nhwc_conv_i8(torch.from_numpy(x_pad), torch.from_numpy(k), drop_h_pad=False)
    assert (live.numpy()[:, [0, -1]] != got[:, [0, -1]]).any()


@pytest.mark.parametrize("c", [c for c in CS if c <= qconv.K4B_MAX_CIN])
def test_k4b_walk_equals_conv3x3_i8(c):
    """The unpadded input, the box a row above and a column left of the
    tile: TMA's zero fill is the whole SAME halo; W 70 puts the last tile
    past the edge, H 9 the last rows past the image."""
    rng = np.random.default_rng(800 + c)
    n, h, w, co = 2, 9, 70, 40
    x = _s8(rng, (n, h, w, c))
    k = _s8(rng, (co, 3, 3, c))
    plan = _k4b_plan(n, h, w, c, co)
    got = _walk(qconv.K4B, x, k, plan, h, w, rng)
    want = qconv.conv3x3_i8(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


def test_k3b_k4b_flagship_plans():
    """At the flagship shape K3b and K4b get K3a's plan: a 3-slot ring of
    64-channel slabs, resident weights, TMA in and out, a persistent grid; at
    the w64 stem (Cin 3) the producer copies."""
    for plan in (_k3b_plan(128, 512, 512, 64, 64), _k4b_plan(128, 512, 512, 64, 64)):
        assert (plan.cot, plan.chunk, plan.stages, plan.resident) == (64, 64, 3, True)
        assert plan.tma_in and plan.tma_out and plan.grid == (132, 1)
        assert plan == _k3a_plan(128, 512, 512, 64, 64)
    assert not _k4b_plan(128, 512, 512, 3, 64).tma_in


def test_channel_order_is_a_permutation_of_whole_words():
    """Each quad thread's n indices of one pixel are cot/4 neighbouring
    channels, so its stores are whole words; and the epilogue
    (``int8_tma_conv.cuh:epilogue_row``) reads the factors of channel
    q·cot/4 + 4·w4 + e for sum i0 + {0, 1, 4, 5}[e], i0 = 8·w4 + 2·hf, which
    is n index 8j + 2q + e' with j = 2·w4 + e // 2, e' = e % 2."""
    for cot in (32, 64, 128):
        order = nhwc.dma_channel_order(cot).numpy()
        assert sorted(order.tolist()) == list(range(cot))
        nidx = np.arange(cot)
        for q in range(4):
            mine = np.sort(order[(nidx % 8) // 2 == q])
            np.testing.assert_array_equal(mine, q * cot // 4 + np.arange(cot // 4))
            for w4 in range(cot // 16):
                for e in range(4):
                    j = 2 * w4 + e // 2
                    assert order[8 * j + 2 * q + e % 2] == q * cot // 4 + 4 * w4 + e


# -- the epilogue ------------------------------------------------------------------------


def _requant_bits(acc, a, b, inv, relu):
    """The kernel's requant (``int8_tma_conv.cuh:requant_bits``) in numpy
    float32: y = fma(acc, a, b), v = clip(y·inv, lo, 127), the int8 result the
    low byte of v + 1.5·2^23 (a round half to even)."""
    y = qconv.fma32(torch.from_numpy(acc.astype(F32)), torch.from_numpy(a),
                    torch.from_numpy(b)).numpy()
    v = np.minimum(np.maximum((y * F32(inv)).astype(F32), F32(0 if relu else -127)), F32(127))
    bits = (v + F32(12582912.0)).astype(F32).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("relu", (True, False))
def test_rounding_add_requant_equals_requant(relu):
    """The rounding add equals ``requant`` (ReLU, round half to even, the clip)
    on random sums and on exact ties of y·inv at every half from -130 to 130."""
    rng = np.random.default_rng(7)
    acc = rng.integers(-2**24, 2**24, 4096).astype(np.int64)
    a = rng.uniform(1e-6, 1e-4, 4096).astype(F32)
    b = rng.normal(0, 30, 4096).astype(F32)
    os_ = F32(40.0)
    inv = qconv.out_inv(os_)
    y = qconv.fma32(torch.from_numpy(acc.astype(F32)), torch.from_numpy(a),
                    torch.from_numpy(b))
    np.testing.assert_array_equal(_requant_bits(acc, a, b, inv, relu),
                                  qconv.requant(y, os_, relu).numpy())
    # ties: acc = 0, y = b exactly, y·inv = k + 1/2 exactly with inv = 1
    halves = np.arange(-260, 261).astype(F32) / F32(2)
    zero = np.zeros(halves.size, np.int64)
    got = _requant_bits(zero, np.ones(halves.size, F32), halves, F32(1), relu)
    want = qconv.requant(torch.from_numpy(halves), 127.0, relu).numpy()
    np.testing.assert_array_equal(got, want)


def test_k3a_walk_with_the_epilogue_equals_pallas_k3a():
    """Cin 24 (a 32-channel chunk, 8 padding channels), Co 24 (a 32-channel
    block), live H-pad rows: the walk's sums through the kernel's requant
    equal JAX's Pallas K3a in interpret mode."""
    rng = np.random.default_rng(9)
    n, h, w, c, co = 2, 16, 12, 24, 24
    x_pad = _s8(rng, (n, h + 2, w + 2, c), -40, 41)
    k_hwio = _s8(rng, (3, 3, c, co), -20, 21)
    kern = np.ascontiguousarray(np.transpose(k_hwio, (3, 0, 1, 2)))
    a = rng.uniform(1e-3, 2e-3, co).astype(F32)
    bias = rng.normal(0, 0.3, co).astype(F32)
    os_ = F32(1.5)
    plan = _k3a_plan(n, h, w, c, co)
    assert plan.chunk == 32 and plan.cot == 32
    acc = _walk(nhwc.K3A, x_pad, kern, plan, h, w, rng)
    got = _requant_bits(acc, a, bias, qconv.out_inv(os_), False)
    ref = JN.qconv3x3_nhwc_dma(jnp.asarray(x_pad), jnp.asarray(k_hwio), jnp.asarray(a),
                               jnp.asarray(bias), os_, relu=False, th=8, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.max() == 127 and got.min() == -127


def test_k3b_walk_with_the_epilogue_equals_pallas_k3b():
    """Cin 24 (a 32-channel chunk, 8 padding channels), Co 24, H 16 (two of
    JAX's 8-row blocks), pad rows and columns not zero: the walk's sums
    through the kernel's requant equal JAX's rolling-carry K3b in interpret
    mode, which drops the H-pad rows."""
    rng = np.random.default_rng(10)
    n, h, w, c, co = 2, 16, 12, 24, 24
    x_pad = _s8(rng, (n, h + 2, w + 2, c), -40, 41)
    k_hwio = _s8(rng, (3, 3, c, co), -20, 21)
    kern = np.ascontiguousarray(np.transpose(k_hwio, (3, 0, 1, 2)))
    a = rng.uniform(1e-3, 2e-3, co).astype(F32)
    bias = rng.normal(0, 0.3, co).astype(F32)
    os_ = F32(1.5)
    plan = _k3b_plan(n, h, w, c, co)
    assert plan.chunk == 32 and plan.cot == 32
    acc = _walk(nhwc.K3B, x_pad, kern, plan, h, w, rng)
    got = _requant_bits(acc, a, bias, qconv.out_inv(os_), False)
    ref = JN.qconv3x3_nhwc_requant(jnp.asarray(x_pad), jnp.asarray(k_hwio), jnp.asarray(a),
                                   jnp.asarray(bias), os_, relu=False, th=8, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.max() == 127 and got.min() == -127


def test_k4b_walk_with_the_epilogue_equals_pallas_k4b():
    """Cin 20 (a 32-channel chunk, 12 padding channels), Co 40 (a 64-channel
    block), odd H != W: the walk's sums through the kernel's requant with a
    ReLU equal JAX's manual-DMA K4b in interpret mode, on frames."""
    rng = np.random.default_rng(12)
    n, h, w, c, co = 2, 7, 11, 20, 40
    x = _s8(rng, (n, h, w, c), 0, 41)
    k_hwio = _s8(rng, (3, 3, c, co), -20, 21)
    kern = np.ascontiguousarray(np.transpose(k_hwio, (3, 0, 1, 2)))
    a = rng.uniform(1e-3, 2e-3, co).astype(F32)
    bias = rng.normal(0, 0.3, co).astype(F32)
    os_ = F32(0.7)
    plan = _k4b_plan(n, h, w, c, co)
    assert plan.chunk == 32 and plan.cot == 64
    acc = _walk(qconv.K4B, x, kern, plan, h, w, rng)
    got = _requant_bits(acc, a, bias, qconv.out_inv(os_), True)
    frame = QP.to_frame(jnp.asarray(np.transpose(x, (1, 3, 2, 0))))
    ref = QP.qconv3x3_requant_dma(frame, QP.pack_w3x3(k_hwio), jnp.asarray(a),
                                  jnp.asarray(bias), os_, relu=True, interpret=True)
    ref = np.transpose(np.asarray(QP.from_frame(ref)), (3, 0, 2, 1))
    np.testing.assert_array_equal(got, ref)
    assert got.max() == 127 and got.min() == 0


@pytest.mark.parametrize("in_phase", ["A", "B"])
def test_k7a_walk_with_the_epilogue_equals_pallas_k7a(in_phase):
    """Cpk 12 (one 16-channel chunk: half a k step), 8 output channels: the
    walk's sums through the kernel's requant and K7a's pad zeroing equal
    JAX's Pallas K7a in interpret mode (H 16, its least in interpret mode)."""
    h, cpk, co2 = 16, 12, 8
    p = 7 if in_phase == "A" else 6
    rng = np.random.default_rng(11)
    x = _s8(rng, (2, h, p, cpk), -40, 41)
    wp_j = _s8(rng, (3, 2, cpk, co2), -20, 21)  # JAX's (3,2,Cpk,Co2)
    wp = np.ascontiguousarray(np.transpose(wp_j, (3, 0, 1, 2)))
    a2 = rng.uniform(1e-3, 2e-3, co2).astype(F32)
    b2 = rng.normal(0, 0.1, co2).astype(F32)
    os_ = F32(2.5)
    plan = _k7a_plan(2, h, p, cpk, co2, in_phase)
    assert plan.chunk == 16 and plan.cot == 32
    acc = _walk(nhwc.K7A, x, wp, plan, h, p - 1 if in_phase == "A" else p + 1, rng,
                in_phase)
    got = torch.from_numpy(_requant_bits(acc, a2, b2, qconv.out_inv(os_), True).copy())
    got = nhwc._zero_pad_pairs(got, in_phase).numpy()
    ref = JN.qconv3x3_pair_dma(jnp.asarray(x), jnp.asarray(wp_j), jnp.asarray(a2),
                               jnp.asarray(b2), os_, in_phase=in_phase, relu=True, th=8,
                               interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.max() == 127 and (got == 0).any()
