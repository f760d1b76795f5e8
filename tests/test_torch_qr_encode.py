"""PyTorch port: the QR encoder (``twinvoice_tpu_torch/qr/encode.py``) against
the JAX package's.

Tolerance: none. ``encode_qr_matrix`` and ``render_qr`` return JAX's arrays
for any payload (text or bytes), error-correction level, mask and version
that holds it, under a hypothesis sweep; the Reed–Solomon helpers and the
version choice are equal on every size; each rendered code reads back
through the port's native decoder.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from twinvoice_tpu.qr import encode as jenc
from twinvoice_tpu_torch.qr import encode as tenc
from twinvoice_tpu_torch.qr import native

LEVELS = "LMQH"


@st.composite
def qr_cases(draw):
    """(payload, level, mask, version or None): a version that holds the
    payload, or the encoder's own choice."""
    payload = draw(st.one_of(st.text(max_size=60), st.binary(max_size=60)))
    level = draw(st.sampled_from(LEVELS))
    mask = draw(st.integers(0, 7))
    n = len(payload.encode("utf-8") if isinstance(payload, str) else payload)
    least = jenc.pick_version(n, level)
    version = draw(st.one_of(st.none(), st.integers(least, min(least + 8, 40))))
    return payload, level, mask, version


@settings(max_examples=120, deadline=None, database=None)
@given(qr_cases())
def test_matrix_equals_jax(case):
    payload, level, mask, version = case
    got = tenc.encode_qr_matrix(payload, level=level, mask=mask, version=version)
    want = jenc.encode_qr_matrix(payload, level=level, mask=mask, version=version)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


@settings(max_examples=40, deadline=None, database=None)
@given(qr_cases(), st.integers(1, 5), st.integers(0, 6))
def test_render_equals_jax(case, module_px, border):
    payload, level, mask, _ = case
    got = tenc.render_qr(payload, module_px=module_px, border_modules=border, level=level,
                         mask=mask)
    want = jenc.render_qr(payload, module_px=module_px, border_modules=border, level=level,
                          mask=mask)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", LEVELS)
def test_version_choice_and_reed_solomon_equal_jax(level):
    for n in range(0, 400, 7):
        try:
            want = jenc.pick_version(n, level)
        except ValueError:
            with pytest.raises(ValueError):
                tenc.pick_version(n, level)
            continue
        assert tenc.pick_version(n, level) == want
    rng = np.random.default_rng(LEVELS.index(level))
    for n_ec in (7, 10, 13, 18, 22, 26, 30):
        data = rng.integers(0, 256, int(rng.integers(1, 60))).tolist()
        assert tenc.rs_generator(n_ec) == jenc.rs_generator(n_ec)
        assert tenc.rs_encode(data, n_ec) == jenc.rs_encode(data, n_ec)


@pytest.mark.parametrize("payload,level,mask", [
    ("AB123456781140909" + "1234:00000078:0:0:0:AAAA/BBBBCCCC==", "M", 0),
    ("**синt:1:120", "M", 0),
    ("**紅茶拿鐵:2:60:火腿吐司:1:45", "Q", 5),
    ("TW-" + "0123456789" * 12, "L", 3),  # version 7 or more: version info
])
def test_rendered_code_reads_back(payload, level, mask):
    img = tenc.render_qr(payload, level=level, mask=mask)
    assert native.decode(img) == [payload]
