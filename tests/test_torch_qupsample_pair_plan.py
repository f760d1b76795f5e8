"""PyTorch port: the launch plans of K6's and K7b's tensor-core kernels
(``ops/qupsample.py:qupsample_plan``, ``ops/nhwc_conv.py:pair_plan``), held on
the CPU.

The CUDA kernels (``csrc/qupsample2x2.cu``, ``csrc/qconv3x3_pair.cu``) cannot
run here, so what they are given is checked instead, for each kernel: the k
order walks every (tap, channel) once and stages zero weights in every
padding slot; an int64 product walked in the plan's k order, with the weights
staged byte by byte as the CUDA source lays them out and garbage in the
padding slots' activations, equals the plain version exactly; the shared
memory and the grid fit the H100 at every w16 and w64 serving shape; and one
case, through the port's epilogue, equals JAX's Pallas kernel in interpret
mode."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from twinvoice_tpu.ops import nhwc_conv as NC
from twinvoice_tpu.ops import qconv_pallas as QP
from twinvoice_tpu_torch.ops import nhwc_conv as nhwc
from twinvoice_tpu_torch.ops import qconv, qupsample

CINS = (1, 3, 16, 17, 31, 32, 33, 64, 129, 1024)
INT_MAX = 2**31 - 1


def _s8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


# -- K6 -------------------------------------------------------------------------


def _k6_staged(kern, plan, block, chunk):
    """One block's weights of one chunk as the kernel stages them
    (``csrc/qupsample2x2.cu:stage_weights``): column n holds tap n // CoT of
    channel co0 + n % CoT, Cin channels c0.. at bytes 0.., zero past Cin and
    past Co. ``kern``: (Co,2,2,Cin). → (4·CoT, kc) int64."""
    co, cin = kern.shape[0], kern.shape[3]
    cot, kc = plan.co_tile, plan.kc
    out = np.zeros((4 * cot, kc), np.int64)
    c0 = chunk * kc
    part = kern.reshape(co, 4, cin)[:, :, c0: min(cin, c0 + kc)].astype(np.int64)
    for n in range(4 * cot):
        ch = block * cot + n % cot
        if ch < co:
            out[n, : part.shape[2]] = part[ch, n // cot]
    return out


@pytest.mark.parametrize("co", (1, 16, 40))
@pytest.mark.parametrize("cin", CINS)
def test_k6_slots_walk_each_tap_channel_and_column_once(cin, co):
    plan = qupsample.qupsample_plan(2, 3, 5, cin, co)
    slots = qupsample.qupsample_k_slots(plan, cin)
    assert slots.shape == (plan.k_chunks, plan.k_steps, 32)
    valid = slots >= 0
    assert sorted(slots[valid].tolist()) == list(range(cin))
    cols = qupsample.qupsample_columns(plan, co)
    assert cols.shape == (plan.grid[1], 4 * plan.co_tile, 2)
    pairs = cols[cols[..., 0] >= 0]
    assert sorted(map(tuple, pairs.tolist())) == [(t, o) for t in range(4)
                                                  for o in range(co)]
    rng = np.random.default_rng(cin + co)
    kern = rng.integers(1, 128, (co, 2, 2, cin)).astype(np.int8)  # no zero weight
    for b in range(plan.grid[1]):
        for chunk in range(plan.k_chunks):
            st = _k6_staged(kern, plan, b, chunk).reshape(4 * plan.co_tile, plan.k_steps, 32)
            for n, (tap, o) in enumerate(cols[b]):
                row = st[n]
                if tap < 0:
                    assert (row == 0).all()
                    continue
                ok = valid[chunk]
                np.testing.assert_array_equal(
                    row[ok], kern[o].reshape(4, cin)[tap, slots[chunk][ok]])
                assert (row[~ok] == 0).all()


def _k6_walk(x, kern, plan, rng):
    """int64 product walked in ``plan``'s order: per block and chunk, each k
    step's 32 activations of every pixel (garbage where the slot is padding)
    times the staged weights, the columns then scattered to (2h+dy, 2w+dx, co)
    as the kernel's stores place them. → (n,2h,2w,co) int64."""
    n, h, w, cin = x.shape
    co = kern.shape[0]
    slots = qupsample.qupsample_k_slots(plan, cin)
    cols = qupsample.qupsample_columns(plan, co)
    px = x.reshape(-1, cin).astype(np.int64)
    out = np.zeros((n, h, 2, w, 2, co), np.int64)
    for b in range(plan.grid[1]):
        acc = np.zeros((px.shape[0], 4 * plan.co_tile), np.int64)
        for chunk in range(plan.k_chunks):
            st = _k6_staged(kern, plan, b, chunk).reshape(-1, plan.k_steps, 32)
            for s in range(plan.k_steps):
                a = rng.integers(-127, 128, (px.shape[0], 32)).astype(np.int64)
                ok = slots[chunk, s] >= 0
                a[:, ok] = px[:, slots[chunk, s][ok]]
                acc += a @ st[:, s].T
        acc = acc.reshape(n, h, w, -1)
        for col, (tap, o) in enumerate(cols[b]):
            if tap >= 0:
                out[:, :, tap // 2, :, tap % 2, o] = acc[..., col]
    return out.reshape(n, 2 * h, 2 * w, co)


@pytest.mark.parametrize("cin,co", [(1, 8), (3, 16), (17, 5), (32, 16), (33, 40),
                                    (64, 32), (129, 72), (1024, 24)])
def test_k6_walk_in_plan_order_equals_conv_transpose2x2_i8(cin, co):
    rng = np.random.default_rng(300 + cin + co)
    x = _s8(rng, (2, 3, 5, cin))
    kern = _s8(rng, (co, 2, 2, cin))
    plan = qupsample.qupsample_plan(2, 3, 5, cin, co)
    got = _k6_walk(x, kern, plan, rng)
    want = qconv.conv_transpose2x2_i8(torch.from_numpy(x), torch.from_numpy(kern))
    assert want.dtype == torch.float64
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


def _k6_plan_cases():
    cases = []
    for base in (16, 64):
        for hw, cin, co in chip_smoke.trunk_shapes(base=base)[qupsample.K6]:
            for n in (128, 1):
                cases.append(pytest.param(n, hw, cin, co, id=f"w{base}-b{n}-{hw}-{cin}-{co}"))
    cases += [pytest.param(1, 1, 1, 1, id="one-pixel"),
              pytest.param(2, 9, 129, 256, id="co-past-one-block")]
    return cases


@pytest.mark.parametrize("n,hw,cin,co", _k6_plan_cases())
def test_k6_plan_fits_the_card(n, hw, cin, co):
    plan = qupsample.qupsample_plan(n, hw, hw, cin, co)
    assert plan.smem <= qconv.SMEM_LIMIT and plan.smem % 16 == 0
    assert qupsample.BLOCKS_PER_SM * (plan.smem + 1024) <= qconv.SM_SMEM
    blocks, n_co = plan.grid
    assert n_co <= 65535
    assert plan.co_tile * n_co >= co > plan.co_tile * (n_co - 1)
    assert plan.co_tile == (8 if co <= 8 else 16 if co <= 16 else 32)
    assert plan.tile_m == (128 if plan.co_tile == 32 else 256)
    pixels = n * hw * hw
    assert pixels <= INT_MAX // 2  # the kernel's 32-bit pixel index
    assert plan.tiles * plan.tile_m >= pixels > (plan.tiles - 1) * plan.tile_m
    assert 1 <= blocks <= plan.tiles
    assert blocks * n_co <= qconv.H100_SMS * qupsample.BLOCKS_PER_SM + n_co
    assert plan.kc in (32, 64, 128) and plan.kc <= -(-cin // 32) * 32
    assert plan.k_chunks == -(-cin // plan.kc)
    assert 2 <= plan.stages <= 4 and plan.resident == (plan.k_chunks <= plan.stages)


def test_k6_walk_with_the_epilogue_equals_pallas_k6():
    """Cin 40 (one 64-channel chunk, 24 padding slots), Co 24 (a 32-channel
    block, 8 columns of each tap past Co): the walk's sums through the
    port's epilogue equal JAX's Pallas K6 in interpret mode."""
    n, h, w, cin, co = 2, 4, 6, 40, 24
    rng = np.random.default_rng(9)
    x = _s8(rng, (n, h, w, cin), -40, 41)
    k_hwio = _s8(rng, (2, 2, cin, co), -20, 21)
    kern = np.ascontiguousarray(np.transpose(k_hwio, (3, 0, 1, 2)))
    w_scale = rng.uniform(1e-3, 2e-3, co).astype(np.float32)
    bias = rng.normal(0, 0.3, co).astype(np.float32)
    s, s_out = np.float32(0.021), np.float32(0.5)  # clips at both ends
    plan = qupsample.qupsample_plan(n, h, w, cin, co)
    assert plan.kc == 64 and plan.co_tile == 32
    acc = _k6_walk(x, kern, plan, rng)
    y = qconv.dequant(torch.from_numpy(acc.astype(np.float64)), torch.from_numpy(w_scale),
                      torch.from_numpy(bias), s)
    got = qconv.requant(y, s_out, relu=False).numpy()
    ref = QP.qupsample2x2_requant(
        QP.to_frame(jnp.asarray(np.transpose(x, (1, 3, 2, 0)))), QP.pack_wup(k_hwio),
        jnp.asarray(s * w_scale), jnp.asarray(bias), s_out, interpret=True)
    np.testing.assert_array_equal(got, np.transpose(np.asarray(QP.from_frame(ref)),
                                                    (3, 0, 2, 1)))
    assert got.max() == 127 and got.min() == -127


# -- K7b ------------------------------------------------------------------------


def _pair_staged_row(wp_co, plan, chunk, cpk):
    """One output channel's weights of one chunk as the kernel stages them
    (``csrc/int8_window_conv.cuh:stage_weights``, KW = 2): kStem tap t at byte
    4t, kPair at 16t, kWide chunk channel c of tap t at byte t·cc + c; zero
    elsewhere. ``wp_co``: (3,2,Cpk). → (k_steps·32,) int64."""
    row = np.zeros(plan.k_steps * 32, np.int64)
    k = wp_co.reshape(6, cpk).astype(np.int64)
    for t in range(6):
        if plan.layout == qconv.STEM:
            row[4 * t: 4 * t + cpk] = k[t]
        elif plan.layout == qconv.PAIR:
            row[16 * t: 16 * t + cpk] = k[t]
        else:
            c0 = chunk * plan.cc
            part = k[t, c0: min(cpk, c0 + plan.cc)]
            row[t * plan.cc: t * plan.cc + len(part)] = part
    return row


@pytest.mark.parametrize("cpk", CINS)
def test_pair_slots_walk_each_tap_and_channel_once(cpk):
    plan = nhwc.pair_plan(2, 5, 7, cpk, 24, "A")
    slots = qconv.k_slots(plan, cpk, kw=2)
    assert slots.shape == (plan.n_chunks, plan.k_steps, 32, 2)
    valid = slots[..., 0] >= 0
    pairs = slots[valid]
    assert len(pairs) == 6 * cpk
    assert len({(int(t), int(c)) for t, c in pairs}) == 6 * cpk
    assert pairs[:, 0].max() == 5 and pairs[:, 1].max() == cpk - 1
    assert (slots[~valid] == -1).all()
    rng = np.random.default_rng(cpk)
    wp = rng.integers(1, 128, (3, 3, 2, cpk)).astype(np.int8)  # no zero weight
    for co in range(3):
        for chunk in range(plan.n_chunks):
            row = _pair_staged_row(wp[co], plan, chunk, cpk).reshape(plan.k_steps, 32)
            ok = valid[chunk]
            tap, ch = slots[chunk][..., 0], slots[chunk][..., 1]
            np.testing.assert_array_equal(row[ok], wp[co].reshape(6, cpk)[tap[ok], ch[ok]])
            assert (row[~ok] == 0).all()


def test_pair_narrow_inputs_pack_taps():
    """Six taps of Cpk ≤ 4 in one 32-byte k step, of Cpk ≤ 16 two a step;
    a 3×3 conv's plan is unchanged by the window's generalisation."""
    assert nhwc.pair_plan(1, 8, 9, 3, 16).k_steps == 1
    assert nhwc.pair_plan(1, 8, 8, 16, 16, "B").k_steps == 3
    plan = nhwc.pair_plan(1, 8, 9, 32, 16)
    assert plan.layout == qconv.WIDE and plan.k_steps == 6 and plan.cc == 32
    assert qconv.conv_plan(1, 8, 8, 3, 16).k_steps == 2
    assert qconv.conv_plan(1, 8, 8, 16, 16).k_steps == 5


def _pair_walk(x, wp, plan, in_phase, rng):
    """int64 im2col product of the pair conv walked in ``plan``'s k order
    (garbage in the padding slots' activations). → (n,h,p_out,co2) int64."""
    n, h, p_in, cpk = x.shape
    co2 = wp.shape[0]
    delta = 0 if in_phase == "A" else -1
    p_out = p_in - 1 if in_phase == "A" else p_in + 1
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    slots = qconv.k_slots(plan, cpk, kw=2)
    acc = np.zeros((n, h, p_out, co2), np.int64)
    for chunk in range(plan.n_chunks):
        wst = np.stack([_pair_staged_row(wp[o], plan, chunk, cpk) for o in range(co2)])
        wst = wst.reshape(co2, plan.k_steps, 32)
        for s in range(plan.k_steps):
            a = rng.integers(-127, 128, (n, h, p_out, 32)).astype(np.int64)
            for j in range(32):
                tap, ch = slots[chunk, s, j]
                if tap >= 0:
                    dy, v = tap // 2, tap % 2
                    c0 = v + delta + 1
                    a[..., j] = xp[:, dy: dy + h, c0: c0 + p_out, ch]
            acc += np.einsum("nhpj,oj->nhpo", a, wst[:, s])
    return acc


@pytest.mark.parametrize("in_phase", ["A", "B"])
@pytest.mark.parametrize("cpk", (1, 3, 4, 5, 16, 17, 32, 33, 129))
def test_pair_walk_in_plan_order_equals_pair_conv_i8(cpk, in_phase):
    rng = np.random.default_rng(400 + cpk)
    p_in = 5 if in_phase == "A" else 4
    x = _s8(rng, (2, 4, p_in, cpk))
    wp = _s8(rng, (6, 3, 2, cpk))
    plan = nhwc.pair_plan(2, 4, p_in, cpk, 6, in_phase)
    got = _pair_walk(x, wp, plan, in_phase, rng)
    want = nhwc.pair_conv_i8(torch.from_numpy(x), torch.from_numpy(wp), in_phase)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


def _pair_plan_cases():
    cases = []
    for base in (16, 64):
        for label, (n, h, p, cpk, co2), in_phase in chip_smoke.k7b_serving_calls(base=base):
            for b in (128, 1):
                cases.append(pytest.param(b, h, p, cpk, co2, in_phase,
                                          id=f"w{base}-b{b}-{label.split()[1]}-{in_phase}"))
    cases += [pytest.param(1, 1, 3, 1, 2, "A", id="narrowest-A"),
              pytest.param(1, 1, 2, 1, 2, "B", id="narrowest-B"),
              pytest.param(2, 9, 14, 1024, 256, "B", id="wide")]
    return cases


@pytest.mark.parametrize("n,h,p,cpk,co2,in_phase", _pair_plan_cases())
def test_pair_plan_fits_the_card(n, h, p, cpk, co2, in_phase):
    plan = nhwc.pair_plan(n, h, p, cpk, co2, in_phase)
    p_out = p - 1 if in_phase == "A" else p + 1
    assert plan == qconv.conv_plan(n, h, p_out, cpk, co2, kw=2)
    assert plan.smem <= qconv.SMEM_LIMIT == 232_448 and plan.smem % 16 == 0
    blocks, n_co = plan.grid
    assert n_co <= 65535
    assert plan.co_tile * n_co >= co2 > plan.co_tile * (n_co - 1)
    rows = qconv.tile_rows(plan.nt)
    assert plan.tiles == n * -(-h // rows) * -(-p_out // qconv.TILE_W)
    assert 1 <= blocks <= min(plan.tiles, INT_MAX)
    per_sm = qconv.blocks_per_sm(plan.nt)
    assert per_sm * (plan.smem + 1024) <= qconv.SM_SMEM
    assert blocks * n_co <= qconv.H100_SMS * per_sm + n_co
    assert plan.n_chunks == -(-cpk // plan.cc) and plan.items == plan.n_chunks
    assert 2 <= plan.stages <= 4 and plan.resident == (plan.items <= plan.stages)
    assert plan.layout == (qconv.STEM if cpk <= 4 else qconv.PAIR if cpk <= 16
                           else qconv.WIDE)


@pytest.mark.parametrize("in_phase", ["A", "B"])
def test_pair_walk_with_the_epilogue_equals_pallas_k7b(in_phase):
    """Cpk 12 (two taps a k step, 4 padding slots a tap), 8 output channels:
    the walk's sums through K7b's epilogue and pad zeroing equal JAX's Pallas
    K7b in interpret mode (``th=8``)."""
    h, cpk, co2 = 8, 12, 8
    p_in = 7 if in_phase == "A" else 6
    rng = np.random.default_rng(11)
    x = _s8(rng, (2, h, p_in, cpk), -40, 41)
    wp_j = _s8(rng, (3, 2, cpk, co2), -20, 21)  # JAX's (3,2,Cpk,Co2)
    wp = np.ascontiguousarray(np.transpose(wp_j, (3, 0, 1, 2)))
    a2 = rng.uniform(1e-3, 2e-3, co2).astype(np.float32)
    b2 = rng.normal(0, 0.1, co2).astype(np.float32)
    out_scale = np.float32(2.5)
    plan = nhwc.pair_plan(2, h, p_in, cpk, co2, in_phase)
    assert plan.layout == qconv.PAIR and plan.k_steps == 3
    acc = _pair_walk(x, wp, plan, in_phase, rng)
    y = qconv.fma32(torch.from_numpy(acc.astype(np.float32)), torch.from_numpy(a2),
                    torch.from_numpy(b2))
    got = nhwc._zero_pad_pairs(qconv.requant(y, out_scale, True).contiguous(), in_phase)
    ref = NC.qconv3x3_pair_requant(jnp.asarray(x), jnp.asarray(wp_j), jnp.asarray(a2),
                                   jnp.asarray(b2), jnp.float32(out_scale),
                                   in_phase=in_phase, relu=True, th=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.max() == 127 and (got == 0).any()
