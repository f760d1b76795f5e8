"""PyTorch port: the launch plan of K4a/K5's tensor-core kernel
(``ops/qconv.py:conv_plan``, ``k_slots``), held on the CPU.

The CUDA kernel (``csrc/qconv3x3.cu``) cannot run here, so what it is given
is checked instead: the k order walks every (tap, channel) of the 3×3 window
once and stages zero weights in every padding slot; the shared memory and
the grid fit the H100 at every K4a and K5 shape of the w16 and w64 trunks; and
an int64 im2col product walked in the plan's k order, with the weights staged
byte by byte as the kernel's source lays them out and garbage in the padding
slots' activations, equals the plain conv exactly (and, in one case, JAX's
Pallas K4a in interpret mode)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from twinvoice_tpu.ops import qconv_pallas as QP
from twinvoice_tpu_torch.ops import qconv

CINS = (1, 2, 3, 4, 5, 8, 16, 17, 31, 32, 33, 48, 64, 129, 256, 1024)


def _staged_row(kernel_co, plan, chunk, cin):
    """One output channel's weights of one chunk as the kernel stages them
    (``csrc/qconv3x3.cu:stage_weights``): kStem tap t channel c at byte
    4t + c, kPair at 16t + c, kWide chunk channel c at byte t·cc + c; zero
    elsewhere. → (k_steps·32,) int64."""
    row = np.zeros(plan.k_steps * 32, np.int64)
    k = kernel_co.reshape(9, cin).astype(np.int64)
    for t in range(9):
        if plan.layout == qconv.STEM:
            row[4 * t: 4 * t + cin] = k[t]
        elif plan.layout == qconv.PAIR:
            row[16 * t: 16 * t + cin] = k[t]
        else:
            c0 = chunk * plan.cc
            part = k[t, c0: min(cin, c0 + plan.cc)]
            row[t * plan.cc: t * plan.cc + len(part)] = part
    return row


@pytest.mark.parametrize("halves", [1, 2])
@pytest.mark.parametrize("cin", CINS)
def test_k_slots_walk_each_tap_and_channel_once(cin, halves):
    plan = qconv.conv_plan(2, 16, 40, cin, 24, halves=halves)
    slots = qconv.k_slots(plan, cin)
    assert plan.items == halves * plan.n_chunks
    assert slots.shape == (plan.n_chunks, plan.k_steps, 32, 2)
    valid = slots[..., 0] >= 0
    pairs = slots[valid]
    assert len(pairs) == 9 * cin
    assert len({(int(t), int(c)) for t, c in pairs}) == 9 * cin
    assert pairs[:, 0].max() == 8 and pairs[:, 1].max() == cin - 1
    assert (slots[~valid] == -1).all()
    # the staged weights hold kernel[co, tap, ch] where a slot is valid, zero
    # in every padding slot
    rng = np.random.default_rng(cin)
    kern = rng.integers(1, 128, (3, 3, 3, cin)).astype(np.int8)  # no zero weight
    for co in range(3):
        for chunk in range(plan.n_chunks):
            row = _staged_row(kern[co], plan, chunk, cin).reshape(plan.k_steps, 32)
            ok = valid[chunk]
            tap, ch = slots[chunk][..., 0], slots[chunk][..., 1]
            want = kern[co].reshape(9, cin)[tap[ok], ch[ok]]
            np.testing.assert_array_equal(row[ok], want)
            assert (row[~ok] == 0).all()


def test_narrow_inputs_pack_taps():
    assert qconv.conv_plan(1, 8, 8, 3, 16).k_steps == 2     # 8 taps a step
    assert qconv.conv_plan(1, 8, 8, 16, 16).k_steps == 5    # 2 taps a step
    plan = qconv.conv_plan(1, 8, 8, 32, 16)
    assert plan.layout == qconv.WIDE and plan.k_steps == 9 and plan.cc == 32


def _plan_cases():
    cases = []
    for base in (16, 64):
        for kind, shapes in chip_smoke.trunk_shapes(base=base).items():
            if kind not in (qconv.K4A, qconv.K5):
                continue
            for hw, cin, co in shapes:
                for sep in ((False, True) if kind == qconv.K5 else (False,)):
                    for n in (128, 1):
                        cases.append(pytest.param(
                            kind, n, hw, cin, co, sep,
                            id=f"w{base}-{kind}-b{n}-{hw}-{cin}-{co}-{'sep' if sep else 'one'}"))
    return cases


@pytest.mark.parametrize("kind,n,hw,cin,co,sep", _plan_cases())
def test_plan_fits_the_card(kind, n, hw, cin, co, sep):
    halves = 2 if kind == qconv.K5 else 1
    plan = qconv.conv_plan(n, hw, hw, cin, co, halves=halves, separate=sep)
    assert plan.smem <= qconv.SMEM_LIMIT == 232_448
    assert plan.smem % 16 == 0
    blocks, n_co = plan.grid
    assert n_co <= 65535
    assert plan.co_tile * n_co >= co > plan.co_tile * (n_co - 1)
    assert plan.co_tile <= (16 if sep else 64)
    rows = qconv.tile_rows(plan.nt)
    assert plan.tiles == n * -(-hw // rows) * -(-hw // qconv.TILE_W)
    assert 1 <= blocks <= min(plan.tiles, 2**31 - 1)
    per_sm = qconv.blocks_per_sm(plan.nt, sep)
    assert blocks * n_co <= qconv.H100_SMS * per_sm + n_co
    assert plan.n_chunks == -(-cin // plan.cc) and plan.items == halves * plan.n_chunks
    assert 2 <= plan.stages <= 4 and plan.resident == (plan.items <= plan.stages)
    # as many blocks share an SM as the registers allow
    assert per_sm * (plan.smem + 1024) <= qconv.SM_SMEM
    if plan.layout == qconv.WIDE:
        assert plan.cc in (32, 64, 128) and plan.cc <= -(-cin // 32) * 32


def _walk(x, kernel, plan, rng):
    """int64 im2col product of one input walked in ``plan``'s k order: each k
    step's 32 activations (garbage where the slot is padding) times the
    weights staged for it. → (n,h,w,co) int64."""
    n, h, w, cin = x.shape
    co = kernel.shape[0]
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    slots = qconv.k_slots(plan, cin)
    acc = np.zeros((n, h, w, co), np.int64)
    for chunk in range(plan.n_chunks):
        wst = np.stack([_staged_row(kernel[o], plan, chunk, cin) for o in range(co)])
        wst = wst.reshape(co, plan.k_steps, 32)
        for s in range(plan.k_steps):
            a = rng.integers(-127, 128, (n, h, w, 32)).astype(np.int64)
            for j in range(32):
                tap, ch = slots[chunk, s, j]
                if tap >= 0:
                    a[..., j] = xp[:, tap // 3: tap // 3 + h, tap % 3: tap % 3 + w, ch]
            acc += np.einsum("nhwj,oj->nhwo", a, wst[:, s])
    return acc


@pytest.mark.parametrize("cin", (1, 3, 4, 5, 16, 17, 32, 33, 129))
def test_im2col_in_plan_order_equals_conv3x3_i8(cin):
    rng = np.random.default_rng(100 + cin)
    x = rng.integers(-127, 128, (2, 5, 7, cin)).astype(np.int8)
    kern = rng.integers(-127, 128, (6, 3, 3, cin)).astype(np.int8)
    plan = qconv.conv_plan(2, 5, 7, cin, 6)
    got = _walk(x, kern, plan, rng)
    want = qconv.conv3x3_i8(torch.from_numpy(x), torch.from_numpy(kern))
    assert want.dtype == torch.float64
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("cin,sep", [(3, False), (16, True), (33, False), (129, True)])
def test_im2col_of_both_halves_equals_k5_sums(cin, sep):
    rng = np.random.default_rng(200 + cin)
    xs = [rng.integers(-127, 128, (1, 6, 5, cin)).astype(np.int8) for _ in range(2)]
    ks = [rng.integers(-127, 128, (4, 3, 3, cin)).astype(np.int8) for _ in range(2)]
    plan = qconv.conv_plan(1, 6, 5, cin, 4, halves=2, separate=sep)
    assert plan.items == 2 * plan.n_chunks
    for x, k in zip(xs, ks):
        want = qconv.conv3x3_i8(torch.from_numpy(x), torch.from_numpy(k))
        np.testing.assert_array_equal(_walk(x, k, plan, rng),
                                      want.numpy().astype(np.int64))


def test_im2col_walk_with_the_epilogue_equals_pallas_k4a():
    """cin 17 (too wide for tap pairs: a k step holds one tap's 17 channels
    and 15 padding slots): the walk's sums through the port's epilogue equal
    JAX's Pallas K4a in interpret mode."""
    n, h, w, cin, co, out_scale = 2, 8, 8, 17, 8, 3.0
    rng = np.random.default_rng(7)
    x = rng.integers(-40, 41, (n, h, w, cin)).astype(np.int8)
    k_hwio = rng.integers(-20, 21, (3, 3, cin, co)).astype(np.int8)
    kern = np.ascontiguousarray(np.transpose(k_hwio, (3, 0, 1, 2)))
    w_scale = rng.uniform(1e-3, 2e-3, co).astype(np.float32)
    bias = rng.normal(0, 0.5, co).astype(np.float32)
    s_in = np.float32(0.83)
    acc = _walk(x, kern, qconv.conv_plan(n, h, w, cin, co), rng)
    y = qconv.dequant(torch.from_numpy(acc.astype(np.float64)), torch.from_numpy(w_scale),
                      torch.from_numpy(bias), s_in)
    got = qconv.requant(y, out_scale, True).numpy()
    cc = QP._plan_tiles(h, cin, w, n, co)[2]
    frame = QP.to_frame(jnp.asarray(np.transpose(x, (1, 3, 2, 0))))
    ref = QP.qconv3x3_requant(frame, QP.pack_w3x3(k_hwio, cc), jnp.asarray(s_in * w_scale),
                              jnp.asarray(bias), np.float32(out_scale), relu=True,
                              interpret=True)
    np.testing.assert_array_equal(got, np.transpose(np.asarray(QP.from_frame(ref)),
                                                    (3, 0, 2, 1)))
    assert got.max() == 127 and got.min() == 0
