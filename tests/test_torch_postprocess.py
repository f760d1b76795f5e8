"""PyTorch port: box post-processing and K1's plain version against the JAX
package (``bbox_postprocess_pallas`` in interpret mode, as the JAX package's
own tests run it on the CPU). Box functions are exact: every case must be
bit-equal, including the sentinel box of an empty class."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from twinvoice_tpu.infer import postprocess as jpost
from twinvoice_tpu.ops.pallas.postprocess import bbox_postprocess_pallas
from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.infer import postprocess as tpost
from twinvoice_tpu_torch.ops.bbox_postprocess import (
    NAME,
    bbox_postprocess,
    bbox_postprocess_reference,
)

THR = (0.25, 0.40, 0.30)


def test_logit_thresholds_bit_equal():
    for thr in (THR, (0.5, 0.01, 0.99), (0.123, 0.777, 0.3333)):
        want = np.asarray(jpost.probability_to_logit_thresholds(thr))
        got = tpost.probability_to_logit_thresholds(thr)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def planted(rng, b, h, w, c=3):
    """Logits well below every threshold with a planted rectangle per (b, c),
    one class left empty, and one lone pixel: every box edge is exercised."""
    x = rng.normal(-6.0, 1.0, (b, h, w, c)).astype(np.float32)
    for bi in range(b):
        for ci in range(c):
            if (bi + ci) % 4 == 3:
                continue  # empty class: sentinel box
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            y1, x1 = rng.integers(y0, h) + 1, rng.integers(x0, w) + 1
            x[bi, y0:y1, x0:x1, ci] += 8.0
            if ci == 1:
                x[bi, rng.integers(0, h), rng.integers(0, w), ci] = 3.0
    return x


CASES = {
    "random-noise": lambda rng: (rng.standard_normal((2, 32, 64, 3)) * 2).astype(np.float32),
    "planted": lambda rng: planted(rng, 4, 48, 48),
    "H!=W": lambda rng: planted(rng, 3, 40, 72),
    "odd": lambda rng: planted(rng, 2, 33, 37),
    "all-below": lambda rng: np.full((2, 16, 24, 3), -10.0, np.float32),
    "all-above": lambda rng: np.full((2, 16, 24, 3), 10.0, np.float32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_matches_pallas_k1(rng, case, dtype):
    x = CASES[case](rng)
    jx = jnp.asarray(x, dtype)
    want_b, want_v = bbox_postprocess_pallas(jx, THR, interpret=True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    logit_thr = tpost.probability_to_logit_thresholds(THR)
    got_b, got_v = bbox_postprocess(tx, logit_thr)
    assert got_b.dtype == torch.int32 and got_v.dtype == torch.bool
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    # and the JAX serving graph's box function, vmapped
    fast_b, fast_v = jax.vmap(jpost.bbox_from_logits_fast, (0, None))(
        jx, jpost.probability_to_logit_thresholds(THR))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(fast_b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(fast_v))


def test_plain_k1_reads_strided_nchw_view(rng):
    x = planted(rng, 3, 40, 56)
    nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    view = nchw.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    want_b, want_v = bbox_postprocess_pallas(jnp.asarray(x), THR, interpret=True)
    logit_thr = tpost.probability_to_logit_thresholds(THR)
    for t in (view, view[:, ::2, 3:]):
        got_b, got_v = bbox_postprocess(t, logit_thr)
        ref_b, ref_v = bbox_postprocess_pallas(jnp.asarray(t.numpy()), THR,
                                               interpret=True)
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(bbox_postprocess(view, logit_thr)[0].numpy(),
                                  np.asarray(want_b))


def test_sentinel_box_is_w_h_minus_one():
    x = torch.full((1, 10, 14, 3), -10.0)
    boxes, valid = bbox_postprocess(x, tpost.probability_to_logit_thresholds(THR))
    assert not valid.any()
    assert boxes[0].tolist() == [[14, 10, -1, -1]] * 3


def test_wrapper_counts_only_kernel_launches_and_rejects_other_devices():
    x = torch.zeros((1, 8, 8, 3))
    thr = tpost.probability_to_logit_thresholds(THR)
    before = _build.launches[NAME]
    bbox_postprocess(x, thr)  # CPU: the plain version, no launch
    assert _build.launches[NAME] == before
    with pytest.raises(ValueError, match="no kernel"):
        bbox_postprocess(x.to("meta"), thr)
    assert bbox_postprocess_reference is not bbox_postprocess


def test_bbox_from_probs_matches_jax(rng):
    prob = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32) ** 6
    want_b, want_v = jax.vmap(jpost.bbox_from_probs, (0, None))(
        jnp.asarray(prob), jnp.asarray(THR))
    got_b, got_v = tpost.bbox_from_probs(torch.from_numpy(prob), THR)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_scale_and_pad_boxes_matches_jax(rng):
    b, grid = 64, 512
    x1 = rng.integers(-1, grid + 1, (b, 3))
    y1 = rng.integers(-1, grid + 1, (b, 3))
    boxes = np.stack([x1, y1, x1 + rng.integers(-2, 200, (b, 3)),
                      y1 + rng.integers(-2, 200, (b, 3))], -1).astype(np.int32)
    valid = rng.uniform(size=(b, 3)) < 0.8
    sizes = np.stack([rng.integers(1, 4000, b), rng.integers(1, 4000, b)],
                     -1).astype(np.int32)
    want_b, want_ok = jax.vmap(
        lambda gb, v, osz: jpost.scale_and_pad_boxes(gb, v, osz, grid, 0.15))(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(sizes))
    got_b, got_ok = tpost.scale_and_pad_boxes(
        torch.from_numpy(boxes), torch.from_numpy(valid), torch.from_numpy(sizes),
        grid, 0.15)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
