"""PyTorch port: K2's plain version (the fused int8 head) against the JAX
Pallas kernel in interpret mode, and the box read from row/col maxima against
``pallas_head.bbox_from_rowcol_max``.

K2 multiplies int8 activations by ``bf16(w·act_scale)`` and sums in float32:
the products are exact, only the order of the sum differs, so the tolerance
is JAX's own (``tests/unit/test_pallas_head.py``: rtol 2e-2). The box rule
is exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from twinvoice_tpu.ops.pallas_head import bbox_from_rowcol_max as jax_bbox
from twinvoice_tpu.ops.pallas_head import head_rowcol_max as jax_head
from twinvoice_tpu_torch.ops import head


@pytest.mark.parametrize("b,h,w,c", [
    (2, 16, 24, 8),     # tests/unit/test_pallas_head.py's case
    (8, 16, 256, 32),   # W = 256: four 64-column tiles in the Pallas grid
    (3, 9, 13, 16),     # odd H != W at the w16 model's width
])
def test_k2_plain_equals_pallas_head(b, h, w, c):
    rng = np.random.default_rng(b * w + c)
    x = rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)
    wt = rng.normal(0, 0.2, (c, 3)).astype(np.float32)
    scale = np.float32(0.037)
    jrow, jcol = jax_head(jnp.asarray(x), jnp.asarray(wt), scale, interpret=True)
    row, col = head.head_rowcol_max(torch.from_numpy(x), torch.from_numpy(wt), scale)
    assert row.shape == (b, h, 3) and col.shape == (b, w, 3)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(col.numpy(), np.asarray(jcol), rtol=2e-2, atol=2e-2)


def test_head_weight_rounds_like_jax():
    """``bf16(f32(w)·f32(act_scale))``, pallas_head.py:101."""
    rng = np.random.default_rng(4)
    wt = rng.normal(0, 0.3, (16, 3)).astype(np.float32)
    scale = 0.0213  # a host float, rounded to float32 first as under jit
    ref = (jnp.asarray(wt) * jnp.float32(scale)).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(head.head_weight(torch.from_numpy(wt), scale).numpy(),
                                  np.asarray(ref))


def test_bbox_from_rowcol_max_equals_jax():
    rng = np.random.default_rng(6)
    b, h, w = 5, 20, 28
    row = rng.normal(-2.0, 1.5, (b, h, 3)).astype(np.float32)
    col = rng.normal(-2.0, 1.5, (b, w, 3)).astype(np.float32)
    row[0, :, 1] = -9.0  # an empty class: the sentinel box
    col[0, :, 1] = -9.0
    thr = np.asarray([-0.5, 0.0, 0.7], np.float32)
    jb, jv = jax_bbox(jnp.asarray(row), jnp.asarray(col), jnp.asarray(thr))
    tb, tv = head.bbox_from_rowcol_max(torch.from_numpy(row), torch.from_numpy(col),
                                       torch.from_numpy(thr))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tb.dtype == torch.int32 and not tv[0, 1] and tv.sum() > 1


def test_k2_wrapper_launches_or_raises_off_the_cpu():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        head.head_rowcol_max(x, torch.zeros((16, 3), device="meta"), 1.0)
