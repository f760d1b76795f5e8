"""PyTorch port: the QR payload parsers, the native decoder's binding and the
``QrPipeline`` scan (``twinvoice_tpu_torch/qr/``) against the JAX package's.

Tolerance: none. The parsers return equal values on the fuzz inputs of
``tests/unit/test_fuzz_parsers.py`` and on a hypothesis sweep; the binding
returns JAX's payloads on rendered invoices, gray and RGB; the scan returns
JAX's payloads, in order, with OpenCV present and with it blocked: the region
pass runs on the port's locator and the ``opencv_decode`` backend on the
port's decoder (cv2's both, rebuilt), so nothing is skipped.
"""

import os
import sys
import warnings

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.unit.test_fuzz_parsers import _garbage_strings
from twinvoice_tpu.data.synthetic import render_invoice
from twinvoice_tpu.qr import detect as jdetect
from twinvoice_tpu.qr import native as jnative
from twinvoice_tpu.qr import parse as jparse
from twinvoice_tpu.qr.encode import render_qr
from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.qr import detect as tdetect
from twinvoice_tpu_torch.qr import locate
from twinvoice_tpu_torch.qr import native as tnative
from twinvoice_tpu_torch.qr import parse as tparse

PARSERS = ("parse_header_qr", "parse_items_qr")


def _same_parse(payloads):
    for name in PARSERS:
        assert getattr(tparse, name)(payloads) == getattr(jparse, name)(payloads), (name, payloads)
    for s in payloads:
        text = tparse.coerce_text(s)
        assert text == jparse.coerce_text(s)
        assert tparse.is_text_qr_payload(s) == jparse.is_text_qr_payload(s)
        assert tparse.roc_date_to_iso(text[:7]) == jparse.roc_date_to_iso(text[:7])
        assert tparse.is_valid_invoice_no(text) == jparse.is_valid_invoice_no(text)


def test_parsers_on_the_fuzz_inputs():
    rng = np.random.default_rng(0)
    garbage = _garbage_strings(rng)
    for s in garbage:
        _same_parse([s])
    _same_parse(garbage)
    _same_parse(["AB123456781140909xx", "**紅茶:1:22:鬆餅:1:22", "**總計:1:5",
                 "AB12345678", "**茶:2:30", "**********:1:2", "台:1:2:" * 5])


_PAYLOAD_PARTS = st.sampled_from([
    "AB12345678", "1140909", "1131231", "0000000", "2011301", "**", "*", ":", "1", "22",
    "紅茶", "總計", "隨機", "金額", "синt", "**********", " ", "x", "ZZ99999999"])


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.lists(_PAYLOAD_PARTS, max_size=12).map("".join), max_size=4))
def test_parsers_on_a_sweep(payloads):
    _same_parse(payloads)


@pytest.fixture(scope="module")
def invoices():
    """Rendered invoices in RGB: the four fixture-page contents, and one with
    two items (a TEXT QR of several names)."""
    from scripts.make_torch_smoke_pages import PAGES

    pages = [np.asarray(render_invoice(**kw)[0].convert("RGB")) for kw in PAGES]
    pages.append(np.asarray(render_invoice(
        "CD11223344", "2025-01-02", 165, seed=5,
        items=[{"name": "紅茶拿鐵", "qty": 2, "price": 60},
               {"name": "火腿吐司", "qty": 1, "price": 45}])[0]))
    return pages


def test_native_builds_from_source_into_the_build_directory(monkeypatch, tmp_path):
    """The decoder is built from ``native/qrdecode.cpp`` into the build
    directory under a hash of the source and flags, once; the committed
    ``native/libqrdecode.so`` is never the one loaded."""
    monkeypatch.setenv("TWINVOICE_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    path = tnative.build()
    assert path.parent == tmp_path and path.name.startswith("libqrdecode-")
    assert path == tnative.library_path()
    mtime = path.stat().st_mtime_ns
    assert tnative.build() == path and path.stat().st_mtime_ns == mtime
    assert tnative.SOURCE.name == "qrdecode.cpp"
    assert os.path.samefile(tnative.SOURCE.parent, os.path.join(
        os.path.dirname(jnative._LIB_PATH)))
    assert tnative.load()._name == str(path)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No compiler, or one that fails: ``QrPipeline()`` raises, where the
    JAX binding would read nothing."""
    monkeypatch.setenv("TWINVOICE_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="QR decoder build failed"):
        tdetect.QrPipeline()
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(FileNotFoundError, match="no C\\+\\+ compiler"):
        tnative.build()


def test_native_decode_equals_jax(invoices):
    """Gray and RGB inputs (the RGB's float luma truncated, as JAX's), the
    non-ASCII TEXT payload byte for byte, a single QR, a blank page."""
    for page in invoices:
        for arr in (page, page[..., 1], page[::2, ::2]):
            got = tnative.decode(arr)
            assert got == jnative.decode(arr)
        assert len(tnative.decode(page)) == 2
    assert any("синt" in p for p in tnative.decode(invoices[0]))
    qr = render_qr("AB123456781140909XXYYZZ11223344556677889900", module_px=4)
    assert tnative.decode(qr) == jnative.decode(qr) == [
        "AB123456781140909XXYYZZ11223344556677889900"]
    assert tnative.decode(np.full((50, 60, 3), 255, np.uint8)) == []


def test_scan_equals_jax_with_cv2(invoices):
    tdetect.passes.clear()
    jq, tq = jdetect.QrPipeline(), tdetect.QrPipeline()
    assert tq.decoders == [tdetect.native_decode, tdetect.opencv_decode]
    for page in invoices:
        assert tq.scan(page) == jq.scan(page)
    assert dict(tdetect.passes) == {"gray_0.75": len(invoices)}  # one pass a page
    # a page with no QR runs the whole cascade, the region pass included
    blank = np.full((440, 300, 3), 250, np.uint8)
    tdetect.passes.clear()
    assert tq.scan(blank) == jq.scan(blank) == []
    assert dict(tdetect.passes) == {"gray_0.75": 1, "regions": 1, "full_frame": 1,
                                    "half_tile": 2, "upscale_2x": 1}


def test_scan_without_cv2(invoices, monkeypatch):
    """cv2 blocked: JAX's default payloads, in order, with no warning, on
    the invoices (the first pass suffices), on a page under 420 px (the
    region pass on cv2's one box, the full frame reads the other code) and
    on a blank page, where every pass runs and nothing is skipped. The
    locator's generators are seeded alike before each scan."""
    jq = jdetect.QrPipeline()
    want = [jq.scan(p) for p in invoices]
    small = invoices[4][::2, ::2].copy()  # 320×220: no 0.75× pass
    blank = np.full((440, 300, 3), 250, np.uint8)
    cv2.setRNGSeed(0)
    want_small = jq.scan(small)
    cv2.setRNGSeed(0)
    want_blank = jq.scan(blank)
    monkeypatch.setitem(sys.modules, "cv2", None)
    tq = tdetect.QrPipeline()
    assert tq.decoders == [tdetect.native_decode, tdetect.opencv_decode]
    tdetect.passes.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert [tq.scan(p) for p in invoices] == want
        assert dict(tdetect.passes) == {"gray_0.75": len(invoices)}
        tdetect.passes.clear()
        locate.set_rng_seed(0)
        got = tq.scan(small)
        assert got == want_small and len(got) == 2
        assert dict(tdetect.passes) == {"regions": 1, "region_crop": 1, "full_frame": 1}
        tdetect.passes.clear()
        locate.set_rng_seed(0)
        assert tq.scan(blank) == want_blank == []
    assert dict(tdetect.passes) == {"gray_0.75": 1, "regions": 1, "full_frame": 1,
                                    "half_tile": 2, "upscale_2x": 1}
