"""PyTorch port: the image file codec (``ops/host_jpeg.py``'s decoder and
encoder, ``ops/host_png.py``, ``ops/host_imageio.py``, the host C++ library
``csrc/host_codec.cpp``) against OpenCV, and ``data.dataset.load_invoice_dataset``
against the JAX package's.

Tolerance: none. Decoding is byte for byte ``cv2.imdecode``'s / ``cv2.imread``'s
RGB: JPEG at 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and gray, qualities 1-100,
sizes 1×1 to 160×224, restart intervals of 1, 3 and 17 MCUs, EXIF
orientations 1-8 in both byte orders; progressive files by cv2 and by
Pillow (per-scan Huffman tables), whole, cut after each scan (block
smoothing) and with scans out of order; CMYK, YCCK and RGB-coded files; PNG of every colour type and depth,
each row filter, Adam7 and ``eXIf`` (PNGs written here with ``zlib``, since
cv2's writer picks its own filters). Encoding is byte for byte
``cv2.imencode(".jpg", ...)``'s at every quality 1-100, and decoding its
bytes gives ``jpeg_roundtrip_u8``. Unsupported or corrupt files raise; a
file that is neither JPEG nor PNG reads as ``None``, as cv2's does.
"""

import ctypes
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from scripts import make_torch_smoke_jpegforms as jpegforms
from scripts.make_torch_smoke_codec import (CHANNELS, exif_tiff, png_bytes, png_chunk,
                                            sample_frame, with_app1)
from twinvoice_tpu.data import dataset as jdataset
from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.data import dataset as tdataset
from twinvoice_tpu_torch.ops import host_imageio, host_jpeg
from twinvoice_tpu_torch.ops.host_imageio import imread_rgb, imwrite_jpeg
from twinvoice_tpu_torch.ops.host_jpeg import decode_jpeg, encode_jpeg, jpeg_roundtrip_u8
from twinvoice_tpu_torch.ops.host_png import decode_png

from tests.test_torch_imports import BLOCKED, ROOT

SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "gray": None}
QUALITIES = (1, 2, 5, 10, 25, 50, 75, 90, 95, 100)
EDGE_SIZES = ((1, 1), (1, 9), (9, 1), (2, 3), (8, 8), (15, 17), (16, 16), (33, 7))


def cv_jpeg(img, q=95, sampling="420", rst=0, **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    for k, v in extra.items():
        params += [getattr(cv2, k), v]
    if sampling == "gray":
        src = img[..., 0]
    else:
        src = img[..., ::-1]
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def cv_rgb(data):
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if got is None else got[..., ::-1]


def assert_same(got, want, what):
    assert want is not None, what
    assert got.dtype == np.uint8 and got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), (what, int((got != want).sum()))


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_jpeg_decoder_equals_cv2(sampling):
    """Each quality at its own size (1×1 to 160×224, noisy and smooth),
    then the edge sizes at q 75."""
    rng = np.random.default_rng(sorted(SAMPLINGS).index(sampling))
    for i, q in enumerate(QUALITIES):
        h, w = int(rng.integers(1, 161)), int(rng.integers(1, 225))
        data = cv_jpeg(sample_frame(rng, h, w, noisy=i % 3 == 0), q, sampling)
        assert_same(decode_jpeg(data), cv_rgb(data), (sampling, q, h, w))
    for h, w in EDGE_SIZES + ((160, 224),):
        data = cv_jpeg(sample_frame(rng, h, w), 75, sampling)
        assert_same(decode_jpeg(data), cv_rgb(data), (sampling, h, w))


def with_fill_bytes(data: bytes, n: int) -> bytes:
    """``data`` with ``n`` fill bytes (0xFF) before each RSTn marker of its
    scan, which a decoder must skip."""
    sos = data.index(b"\xff\xda")
    scan = data[sos:]
    for k in range(8):
        scan = scan.replace(bytes([0xFF, 0xD0 + k]), b"\xff" * (n + 1) + bytes([0xD0 + k]))
    return data[:sos] + scan


@pytest.mark.parametrize("rst", [1, 3, 17])
def test_jpeg_restart_intervals(rst):
    """RSTn markers every ``rst`` MCUs (the DC predictors reset) at each
    sampling, on sizes whose MCU count is not a multiple of ``rst``; then
    with one and with three fill bytes before each RSTn."""
    rng = np.random.default_rng(rst)
    for sampling in SAMPLINGS:
        h, w = int(rng.integers(50, 100)), int(rng.integers(90, 160))  # > 17 MCUs
        data = cv_jpeg(sample_frame(rng, h, w), 90, sampling, rst)
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
        assert_same(decode_jpeg(data), cv_rgb(data), (sampling, rst, h, w))
        for n in (1, 3):
            filled = with_fill_bytes(data, n)
            assert b"\xff" * (n + 1) + b"\xd0" in filled
            assert_same(decode_jpeg(filled), cv_rgb(filled), (sampling, rst, h, w, n))


def multi_scan_jpeg(rgb, q, groups):
    """``encode_jpeg``'s file with its one scan split into several
    sequential scans, one for each group of component indices (a single
    component non-interleaved over its own blocks), coded by the port's
    scan encoder. cv2 writes no such file; libjpeg reads them."""
    qy, qc, coefs = host_jpeg._forward(rgb, q)
    base = encode_jpeg(rgb, q)
    tables = [bytes(host_jpeg._TABLE_BYTES)] * 8
    for (kind, slot), t in host_jpeg._STD_HUFFMAN.items():
        tables[4 * kind + slot] = host_jpeg._table_bytes(t)
    slots = ((0, 4), (1, 5), (1, 5))
    hv = ((2, 2), (1, 1), (1, 1))
    scans = b""
    for group in groups:
        if len(group) == 1:  # the component's own blocks, one an MCU
            c = group[0]
            params = [1, coefs[c].shape[1], coefs[c].shape[0], 0, 1, 1, coefs[c].shape[1],
                      *slots[c]]
        else:  # chroma only here: one block of each an MCU
            params = [len(group), coefs[1].shape[1], coefs[1].shape[0], 0]
            for c in group:
                params += [*hv[c], coefs[c].shape[1], *slots[c]]
        params = np.array(params, np.int32)
        ptrs = (ctypes.c_void_p * len(group))(*(coefs[c].ctypes.data for c in group))
        out = np.empty(1024 + 420 * sum(coefs[c][..., 0].size for c in group), np.uint8)
        n = host_imageio.codec().jpeg_encode_scan(params.ctypes.data, b"".join(tables), ptrs,
                                                  out.ctypes.data, out.size)
        assert n > 0
        sos = bytes([len(group)]) + b"".join(
            bytes([c + 1, 16 * slots[c][0] + slots[c][1] - 4]) for c in group) + bytes([0, 63, 0])
        scans += host_jpeg._segment(0xDA, sos) + out[:n].tobytes()
    return base[:base.index(b"\xff\xda")] + scans + b"\xff\xd9"


@pytest.mark.parametrize("groups", [((0,), (1,), (2,)), ((0,), (1, 2)), ((2,), (0,), (1,))],
                         ids=["three", "luma+chroma", "out of order"])
def test_jpeg_several_sequential_scans(groups):
    """A baseline file of several scans, non-interleaved or interleaved,
    read as cv2 reads it (and as the one-scan file it was split from)."""
    rng = np.random.default_rng(11)
    for h, w in ((1, 1), (17, 33), (61, 77), (96, 128)):
        img = sample_frame(rng, h, w)
        data = multi_scan_jpeg(img, 85, groups)
        assert data.count(b"\xff\xda") == len(groups)
        assert_same(decode_jpeg(data), cv_rgb(data), (groups, h, w))
        assert_same(decode_jpeg(data), decode_jpeg(encode_jpeg(img, 85)), (groups, h, w))


def test_dct_passes_in_chunks(monkeypatch):
    """The DCTs run over bounded chunks of block rows (a phone photo's
    190k luma blocks); chunks of a few blocks give the same bytes."""
    rng = np.random.default_rng(12)
    img = sample_frame(rng, 61, 77)
    want = {s: cv_jpeg(img, 90, s) for s in ("420", "444", "gray")}
    monkeypatch.setattr(host_jpeg, "_CHUNK_BLOCKS", 5)
    assert encode_jpeg(img, 90) == want["420"]
    for s, data in want.items():
        assert_same(decode_jpeg(data), cv_rgb(data), s)
    assert_same(jpeg_roundtrip_u8(img, 90), cv_rgb(want["420"]), "round trip")


@pytest.mark.parametrize("order", ["II", "MM"])
def test_exif_orientation(order, tmp_path):
    """EXIF orientations 1-8 in a JPEG's APP1 and a PNG's ``eXIf`` chunk,
    read through files by ``imread_rgb`` against ``cv2.imread``: 5-8 swap the
    sides, and each is the stored pixels (the file without its EXIF, as cv2
    reads it) turned by ``apply_orientation``."""
    rng = np.random.default_rng(8)
    img = sample_frame(rng, 5, 7)
    base = cv_jpeg(img, 95, "444")
    stored = {".jpg": decode_jpeg(base), ".png": decode_png(png_bytes(img, 2, 8))}
    assert_same(stored[".jpg"], cv_rgb(base), "stored .jpg")
    assert_same(stored[".png"], img, "stored .png")
    for o in range(1, 9):
        tiff = exif_tiff(o, order)
        for ext, data in ((".jpg", with_app1(base, tiff)),
                          (".png", png_bytes(img, 2, 8, before=[(b"eXIf", tiff)]))):
            path = tmp_path / f"o{o}{ext}"
            path.write_bytes(data)
            got = imread_rgb(str(path))
            assert_same(got, cv2.imread(str(path))[..., ::-1], (o, order, ext))
            assert got.shape[:2] == ((7, 5) if o >= 5 else (5, 7))
            assert_same(got, host_imageio.apply_orientation(stored[ext], o), (o, ext))


@pytest.mark.parametrize("block", range(4))
def test_encoder_equals_cv2_at_every_quality(block):
    """q 1-100 in four blocks of 25, on three sizes each; the decoder on its
    bytes gives ``jpeg_roundtrip_u8``."""
    rng = np.random.default_rng(100 + block)
    frames = [sample_frame(rng, 1, 1), sample_frame(rng, 37, 53, noisy=True),
              sample_frame(rng, 120, 161)]
    for q in range(1 + 25 * block, 26 + 25 * block):
        for img in frames:
            data = encode_jpeg(img, q)
            assert data == cv_jpeg(img, q), (q, img.shape)
            assert_same(decode_jpeg(data), jpeg_roundtrip_u8(img, q), (q, img.shape))


PNG_FORMATS = [(c, d) for c, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                    (4, (8, 16)), (6, (8, 16))) for d in ds]


@pytest.mark.parametrize("ctype,depth", PNG_FORMATS)
def test_png_equals_cv2(ctype, depth):
    """Each row filter alone and all five in turn, plain and Adam7, at sizes
    from 1×1 up, the data over two IDATs; palettes one entry short (an index
    past them reads black) and ancillary chunks cv2 ignores."""
    rng = np.random.default_rng(10 * ctype + depth)
    pal = rng.integers(0, 256, ((1 << depth) - 1, 3)) if ctype == 3 else None
    trns = (b"tRNS", bytes(2 if ctype == 0 else 6)) if ctype in (0, 2) else (b"sRGB", b"\0")
    ancillary = [(b"gAMA", bytes(4)), (b"tEXt", b"k\0v"), trns]
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        for interlace in (False, True):
            for h, w in ((1, 1), (3, 5), (11, 17), (16, 9)):
                s = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype])).astype(np.uint16)
                data = png_bytes(s, ctype, depth, filters=filters, interlace=interlace,
                                 palette=pal, before=ancillary, split=2)
                assert_same(decode_png(data), cv_rgb(data), (filters, interlace, h, w))


def test_png_written_by_cv2(tmp_path):
    """cv2's own PNGs (its filters, gray, RGB, RGBA, 16-bit) through
    ``imread_rgb``."""
    rng = np.random.default_rng(3)
    for i, arr in enumerate((rng.integers(0, 256, (21, 34), dtype=np.uint8),
                             rng.integers(0, 256, (21, 34, 3), dtype=np.uint8),
                             rng.integers(0, 256, (21, 34, 4), dtype=np.uint8),
                             rng.integers(0, 65536, (21, 34, 3), dtype=np.uint16))):
        path = str(tmp_path / f"c{i}.png")
        assert cv2.imwrite(path, arr)
        assert_same(imread_rgb(path), cv2.imread(path)[..., ::-1], i)


def _corrupt(data: bytes, at: int, byte: int) -> bytes:
    return data[:at] + bytes([byte]) + data[at + 1:]


def test_refusals(tmp_path):
    """What the codec does not handle raises with the reason; a file that is
    neither JPEG nor PNG, or none at all, reads as ``None`` as in cv2."""
    rng = np.random.default_rng(4)
    img = sample_frame(rng, 40, 56)
    base = cv_jpeg(img)
    sof = base.index(b"\xff\xc0")
    prog = cv_jpeg(img, IMWRITE_JPEG_PROGRESSIVE=1)
    sof2 = prog.index(b"\xff\xc2")
    cases = {
        "truncated mid-scan": (base[:len(base) * 2 // 3], "truncated"),
        "no EOI": (base[:-2], "no EOI"),
        "arithmetic": (_corrupt(base, sof + 1, 0xC9), "arithmetic"),
        "progressive arithmetic": (_corrupt(prog, sof2 + 1, 0xCA), "arithmetic"),
        "lossless": (_corrupt(base, sof + 1, 0xC3), "lossless"),
        "hierarchical": (_corrupt(base, sof + 1, 0xC5), "hierarchical"),
        "12-bit": (_corrupt(base, sof + 4, 12), "12-bit"),
        "progressive 12-bit": (_corrupt(prog, sof2 + 4, 12), "12-bit"),
        "two components": (_corrupt(_corrupt(base, sof + 9, 2), sof + 3, 14), "2 components"),
        "3×2 luma sampling": (_corrupt(base, sof + 11, 0x32), "sampling"),
        "65535×65535": (base[:sof + 5] + b"\xff\xff\xff\xff" + base[sof + 9:], "more than"),
    }
    for name, (data, reason) in cases.items():
        with pytest.raises(ValueError, match=reason):
            decode_jpeg(data)
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=reason):
            imread_rgb(str(path))
    png = png_bytes(img.astype(np.uint16), 2, 8)
    bad_crc = _corrupt(png, 40, png[40] ^ 1)
    with pytest.raises(ValueError, match="bad CRC"):
        decode_png(bad_crc)
    idat = png.index(b"IDAT") - 4
    short = png[:idat] + png_chunk(b"IDAT", png[idat + 8:idat + 40]) + png_chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="corrupt image data|too little"):
        decode_png(short)
    (tmp_path / "note.jpg").write_text("not an image at all\n")
    assert imread_rgb(str(tmp_path / "note.jpg")) is None
    assert cv2.imread(str(tmp_path / "note.jpg")) is None
    assert imread_rgb(str(tmp_path / "missing.png")) is None


def _png_header_only(width: int, height: int, raw: bytes) -> bytes:
    """An RGB PNG that declares ``width`` × ``height`` and holds ``raw`` as its
    inflated image data, however little that is."""
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (host_imageio.PNG_SIGNATURE + png_chunk(b"IHDR", header)
            + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b""))


def test_png_declared_size_checked_before_the_image_is_made(tracemalloc_peak):
    """A small file that declares a huge image raises ``ValueError`` (cv2
    reads nothing) before any buffer of that size is made; one past
    OpenCV's pixel limit raises as cv2 does; inflating stops at what the
    image needs, so data past it (cv2 reads the image and warns) is neither
    kept nor an error."""
    with tracemalloc_peak() as peak:
        with pytest.raises(ValueError, match="too little image data"):
            decode_png(_png_header_only(30000, 30000, bytes(100)))
    assert peak() < 1 << 24  # the image would be 2.7 GB
    assert cv_rgb(_png_header_only(30000, 30000, bytes(100))) is None
    with pytest.raises(ValueError, match="more than"):
        decode_png(_png_header_only(1 << 16, 1 << 15, bytes(100)))
    with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE_PIXELS"):
        cv_rgb(_png_header_only(1 << 16, 1 << 15, bytes(100)))
    extra = _png_header_only(5, 5, bytes(5 * 16) + bytes(1 << 24))  # 16 MB past 5 rows
    with tracemalloc_peak() as peak:
        got = decode_png(extra)
    assert peak() < 1 << 22
    assert_same(got, cv_rgb(extra), "data past the image")


@pytest.fixture
def tracemalloc_peak():
    """A context manager that traces Python's allocations (numpy's too) and
    gives a function returning their peak in bytes."""
    import contextlib
    import tracemalloc

    @contextlib.contextmanager
    def traced():
        peak = []
        tracemalloc.start()
        try:
            yield lambda: peak[0]
        finally:
            peak.append(tracemalloc.get_traced_memory()[1])
            tracemalloc.stop()

    return traced


def test_corrupt_jpegs_raise_or_decode_whole():
    """Random byte flips and cuts of a restart-coded JPEG: each either
    decodes to a whole image or raises ``ValueError``; the C++ scan decoder
    never reads out of bounds or crashes the process."""
    rng = np.random.default_rng(5)
    base = cv_jpeg(sample_frame(rng, 45, 61), 90, "420", 2)
    for t in range(400):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(2, len(data)))] = int(rng.integers(0, 256))
        if t % 3 == 0:
            data = data[:int(rng.integers(2, len(data)))]
        try:
            got = decode_jpeg(bytes(data))
        except ValueError:
            continue
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3


def test_codec_builds_from_source_into_the_build_directory(monkeypatch, tmp_path):
    """The library is built from ``csrc/host_codec.cpp`` by the host C++
    compiler into the build directory, once, under a hash of the source and
    flags; a compiler that fails raises, and nothing falls back."""
    monkeypatch.setenv("TWINVOICE_TORCH_BUILD_DIR", str(tmp_path))
    path = host_imageio.build_codec()
    assert path.parent == tmp_path and path.name.startswith("libhostcodec-")
    assert path == _build.host_library_path(host_imageio.CODEC_SOURCE, "hostcodec")
    mtime = path.stat().st_mtime_ns
    assert host_imageio.build_codec() == path and path.stat().st_mtime_ns == mtime
    assert host_imageio.CODEC_SOURCE.suffix == ".cpp"
    assert "host_codec" not in _build.sources()  # not a CUDA kernel
    monkeypatch.setenv("TWINVOICE_TORCH_BUILD_DIR", str(tmp_path / "other"))
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(host_imageio, "_codec", None)
    with pytest.raises(RuntimeError, match="image codec build failed"):
        decode_jpeg(cv_jpeg(np.zeros((8, 8, 3), np.uint8)))


@pytest.fixture
def image_dir(tmp_path):
    """``fixed_images`` with ``.jpg``, ``.png`` and ``.jpeg`` files written by
    cv2 (gray and 4:4:4 JPEGs among them) and ``fixed_masks`` with one mask
    missing."""
    rng = np.random.default_rng(6)
    img_dir, mask_dir = tmp_path / "fixed_images", tmp_path / "fixed_masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    for i, ext in enumerate((".jpg", ".png", ".jpeg", ".jpg", ".png")):
        img = sample_frame(rng, 40, 40, noisy=i == 1)
        if i == 3:
            (img_dir / f"s{i}{ext}").write_bytes(cv_jpeg(img, 80, "gray"))
        elif ext == ".jpeg":
            (img_dir / f"s{i}{ext}").write_bytes(cv_jpeg(img, 70, "444"))
        else:
            assert cv2.imwrite(str(img_dir / f"s{i}{ext}"), img[..., ::-1])
        if i != 2:
            np.save(mask_dir / f"s{i}.npy",
                    rng.integers(0, 2, (40, 40, 3)).astype(np.uint8) * 255)
    return img_dir, mask_dir


def test_load_invoice_dataset_equals_jax(image_dir):
    img_dir, mask_dir = (str(p) for p in image_dir)
    got = tdataset.load_invoice_dataset(img_dir, mask_dir)
    want = jdataset.load_invoice_dataset(img_dir, mask_dir)
    assert got.names == want.names == ("s0", "s1", "s3", "s4")
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.masks, want.masks)
    empty = tdataset.load_invoice_dataset(img_dir + "_none", mask_dir)
    assert len(empty) == 0 and empty.images.shape == (0, 512, 512, 3)


def test_imwrite_jpeg_writes_cv2s_file(tmp_path):
    img = sample_frame(np.random.default_rng(7), 33, 47)
    imwrite_jpeg(str(tmp_path / "a.jpg"), img, 85)
    assert cv2.imwrite(str(tmp_path / "b.jpg"), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 85])
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


_DATA_WITHOUT_CV2 = f"""
import json, os, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
from twinvoice_tpu_torch.data.dataset import load_invoice_dataset
from twinvoice_tpu_torch.data.labelme import build_dataset_from_labelme
root = sys.argv[1]
done, missing = build_dataset_from_labelme(
    json_dir=os.path.join(root, "json"), images_dir=os.path.join(root, "images"),
    out_img_dir=os.path.join(root, "fixed_images"),
    out_mask_dir=os.path.join(root, "fixed_masks"), train_size=(64, 48), log=lambda m: None)
assert done == ["a", "b"] and missing == [], (done, missing)
ds = load_invoice_dataset(os.path.join(root, "fixed_images"), os.path.join(root, "fixed_masks"))
assert ds.names == ("a", "b") and ds.images.shape == (2, 48, 64, 3), ds.images.shape
np.save(os.path.join(root, "images.npy"), ds.images)
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("built")
"""


def test_build_and_load_run_without_cv2_or_pil(tmp_path):
    """``build_dataset_from_labelme`` (a JPEG photo and a PNG one) and
    ``load_invoice_dataset`` with JAX, the JAX package, OpenCV and Pillow
    blocked, as on the card's machine; the images it loads are the JPEG
    round trips of the resized photos, as JAX's pipeline writes them."""
    from twinvoice_tpu.data import labelme as jlabelme

    rng = np.random.default_rng(9)
    (tmp_path / "json").mkdir()
    (tmp_path / "images").mkdir()
    for name, ext in (("a", ".jpg"), ("b", ".png")):
        assert cv2.imwrite(str(tmp_path / "images" / f"{name}{ext}"),
                           sample_frame(rng, 70, 90)[..., ::-1])
        (tmp_path / "json" / f"{name}.json").write_text(
            '{"imageWidth": 90, "imageHeight": 70, "shapes": [{"label": "date", '
            '"points": [[3, 4], [60, 4], [60, 30]]}]}')
    out = subprocess.run([sys.executable, "-c", _DATA_WITHOUT_CV2, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "built"
    jout = tmp_path / "jax"
    jlabelme.build_dataset_from_labelme(
        json_dir=str(tmp_path / "json"), images_dir=str(tmp_path / "images"),
        out_img_dir=str(jout / "i"), out_mask_dir=str(jout / "m"), train_size=(64, 48),
        log=lambda m: None)
    want = np.stack([cv2.imread(str(jout / "i" / f"{n}.jpg"))[..., ::-1] for n in "ab"])
    np.testing.assert_array_equal(np.load(tmp_path / "images.npy"), want)
    assert sorted(os.listdir(tmp_path / "fixed_images")) == sorted(os.listdir(jout / "i"))


# -- the forms beyond baseline: progressive, CMYK/YCCK, RGB-coded ---------------

PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2, "gray": None}


def writer_jpeg(writer, img, q, sampling, rst=0):
    """A progressive JPEG of ``img`` by cv2 (``rst``: its restart interval) or
    by Pillow with ``optimize=True`` (Huffman tables for each scan)."""
    if writer == "cv2":
        return cv_jpeg(img, q, sampling, rst, IMWRITE_JPEG_PROGRESSIVE=1)
    if sampling == "gray":
        return jpegforms.pil_jpeg(img, "L", quality=q, progressive=True, optimize=True)
    return jpegforms.pil_jpeg(img, quality=q, progressive=True, optimize=True,
                              subsampling=PIL_SUBSAMPLING[sampling])


@pytest.mark.parametrize("writer", ["cv2", "pil"])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
def test_progressive_equals_cv2(writer, sampling):
    """Progressive files at each quality, with and without a restart
    interval (cv2's; Pillow writes none), on sizes from 1×1 up: cv2's RGB
    byte for byte, and, where the coefficients are the same, the baseline
    file's pixels (a whole progressive file is not smoothed)."""
    rng = np.random.default_rng(200 + 10 * ["444", "422", "420", "gray"].index(sampling)
                                + (writer == "pil"))
    for i, q in enumerate((5, 50, 95)):
        for rst in ((0, 2) if writer == "cv2" else (0,)):
            for h, w in ((1, 1), (int(rng.integers(2, 40)), int(rng.integers(2, 60))),
                         (int(rng.integers(40, 90)), int(rng.integers(60, 130)))):
                img = sample_frame(rng, h, w, noisy=i == 1)
                data = writer_jpeg(writer, img, q, sampling, rst)
                assert data[:4] != b"\xff\xd8\xff\xc0" and b"\xff\xc2" in data
                assert (b"\xff\xdd" in data) == (rst > 0)
                assert_same(decode_jpeg(data), cv_rgb(data), (writer, sampling, q, rst, h, w))
                if writer == "cv2" and not rst:
                    assert_same(decode_jpeg(data), decode_jpeg(cv_jpeg(img, q, sampling)),
                                "the baseline file of the same coefficients")


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_progressive_cut_scans_are_smoothed(sampling):
    """A progressive file without its last 1..n−1 scans (EOI appended),
    which cv2 reads through libjpeg-turbo 3.1's block smoothing: byte-equal
    to cv2's on sizes whose block rows and columns hit the 5×5 window's
    edges (one block, two, odd counts of iMCU rows), and differing from the
    same coefficients unsmoothed."""
    rng = np.random.default_rng(300 + sorted(SAMPLINGS).index(sampling))
    smoothed = 0
    for h, w in ((8, 8), (9, 17), (20, 12), (33, 41), (47, 70), (96, 80)):
        data = cv_jpeg(sample_frame(rng, h, w), 90, sampling, IMWRITE_JPEG_PROGRESSIVE=1)
        n = len(jpegforms.scan_units(data)[1])
        assert n == (6 if sampling == "gray" else 10)
        for k in range(1, n):
            cut = jpegforms.cut_scans(data, k)
            got = decode_jpeg(cut)
            assert_same(got, cv_rgb(cut), (sampling, h, w, k))
            smoothed += not np.array_equal(got, _unsmoothed(cut))
    assert smoothed > 20


def _unsmoothed(data):
    frame_cls = host_jpeg._Frame
    saved = frame_cls.smoothing
    frame_cls.smoothing = lambda self: False
    try:
        return decode_jpeg(data)
    finally:
        frame_cls.smoothing = saved


BAD_PROGRESSIONS = {  # (scan, field edits): jdphuff.c's JERR_BAD_PROGRESSION
    "DC scan with Se 1": (0, {"se": 1}),
    "AC scan with Ss > Se": (1, {"ss": 6, "se": 5}),
    "AC scan with Se 64": (3, {"se": 64}),
    "AC scan of three components": (0, {"ss": 1, "se": 5}),
    "Al 14": (1, {"ahal": 0x0E}),
    "Ah 2 with Al 0": (4, {"ahal": 0x20}),
}


@pytest.mark.parametrize("case", list(BAD_PROGRESSIONS))
def test_bad_progressions_raise(case):
    """Scan parameters libjpeg refuses: cv2 reads no image, and the port
    raises ``ValueError`` that says so."""
    rng = np.random.default_rng(13)
    data = cv_jpeg(sample_frame(rng, 67, 93), 90, "420", IMWRITE_JPEG_PROGRESSIVE=1)
    scan, edits = BAD_PROGRESSIONS[case]
    bad = jpegforms.with_scan_fields(data, scan, **edits)
    assert cv_rgb(bad) is None
    with pytest.raises(ValueError, match="bad progression"):
        decode_jpeg(bad)


@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_bogus_progressions_decode_as_cv2(writer):
    """Scans out of order, which libjpeg only warns about: each scan
    repeated (with the tables before it), a DC refinement dropped, a first
    scan dropped where its band holds only zeros (its refinement then
    refines coefficients never started). cv2 reads each, and so does the
    port, byte for byte. A progressive file that leans on the Annex K
    tables (jdphuff.c, unlike jdhuff.c, has no defaults) is refused as cv2
    refuses it."""
    rng = np.random.default_rng(14)
    img = sample_frame(rng, 51, 66)
    data = (cv_jpeg(img, 90, "420", IMWRITE_JPEG_PROGRESSIVE=1) if writer == "cv2"
            else jpegforms.pil_jpeg(img, progressive=True, quality=85))
    n = len(jpegforms.scan_units(data)[1])
    for i in range(n):
        if i < 5 or i == 6:  # a first scan (refinements repeated desynchronise the data)
            rep = jpegforms.repeat_scan(data, i)
            assert_same(decode_jpeg(rep), cv_rgb(rep), ("repeat", i))
    dropped = jpegforms.drop_scan(data, 6)  # the DC refinement
    assert_same(decode_jpeg(dropped), cv_rgb(dropped), "DC refinement dropped")
    gray = np.repeat(img[..., :1], 3, -1)  # no chroma AC: the chroma first scans code zeros
    flat = cv_jpeg(gray, 90, "420", IMWRITE_JPEG_PROGRESSIVE=1)
    for i in (2, 3):
        unstarted = jpegforms.drop_scan(flat, i)
        assert_same(decode_jpeg(unstarted), cv_rgb(unstarted), ("unstarted", i))
        assert_same(decode_jpeg(unstarted), decode_jpeg(flat), ("unstarted", i))
    head, units, tail = jpegforms.scan_units(data)
    first_ac = units[1]
    assert first_ac[:2] == b"\xff\xc4"
    no_table = head + units[0] + first_ac[2 + struct.unpack(">H", first_ac[2:4])[0]:] + b"".join(
        units[2:]) + tail
    assert cv_rgb(no_table) is None
    with pytest.raises(ValueError, match="no Huffman table"):
        decode_jpeg(no_table)


@pytest.mark.parametrize("quality", [10, 50, 95])
def test_cmyk_and_ycck_equal_cv2(quality):
    """Pillow's CMYK files (Adobe's inverted ink, transform 0), the same
    with the transform set to 2 (YCCK: ``ycck_cmyk_convert``) or to 1
    (libjpeg warns and reads YCCK), the same without an Adobe APP14 (CMYK),
    and Pillow's progressive CMYK, through OpenCV's own CMYK → BGR step:
    cv2's RGB byte for byte."""
    rng = np.random.default_rng(15 + quality)
    for h, w in ((1, 1), (13, 29), (45, 59)):
        img = sample_frame(rng, h, w, noisy=quality == 50)
        cmyk = jpegforms.pil_jpeg(img, "CMYK", quality=quality)
        at = cmyk.index(b"Adobe") - 4  # the APP14 marker
        no_adobe = cmyk[:at] + cmyk[at + 2 + struct.unpack_from(">H", cmyk, at + 2)[0]:]
        files = {"CMYK": cmyk, "YCCK": jpegforms.with_adobe_transform(cmyk, 2),
                 "transform 1": jpegforms.with_adobe_transform(cmyk, 1),
                 "no APP14": no_adobe,
                 "progressive": jpegforms.pil_jpeg(img, "CMYK", quality=quality,
                                                   progressive=True)}
        for name, data in files.items():
            assert_same(decode_jpeg(data), cv_rgb(data), (name, quality, h, w))
    ink, k = np.meshgrid(np.arange(0, 256, 15), np.arange(0, 256, 15))
    got = host_jpeg._cmyk_to_rgb(ink, ink, ink, k)  # OpenCV's step: k − (255 − x)·k >> 8
    assert got.dtype == np.uint8 and np.array_equal(got[..., 1], k - ((255 - ink) * k >> 8))


def test_rgb_coded_equals_cv2():
    """RGB-coded colour, as libjpeg-turbo's ``default_decompress_parms``
    guesses it: Pillow's ``keep_rgb`` (an Adobe APP14 of transform 0, plain
    and progressive), a YCbCr file whose JFIF APP0 is replaced by such an
    APP14 (read as R, G, B), the component IDs R, G, B without JFIF; a JFIF
    APP0 beside an APP14 of transform 0, and unknown IDs, stay YCbCr."""
    rng = np.random.default_rng(16)
    for h, w in ((1, 1), (17, 23), (64, 90)):
        img = sample_frame(rng, h, w)
        base = cv_jpeg(img, 85, "444")
        sof = base.index(b"\xff\xc0")
        ids = bytearray(base)
        ids[sof + 10], ids[sof + 13], ids[sof + 16] = b"RGB"
        sos = ids.index(b"\xff\xda")
        ids[sos + 5], ids[sos + 7], ids[sos + 9] = b"RGB"
        no_jfif = bytes(ids[:2] + ids[4 + struct.unpack_from(">H", ids, 4)[0]:])
        odd = bytearray(no_jfif)
        o = odd.index(b"\xff\xc0")
        odd[o + 10] = 7
        s2 = odd.index(b"\xff\xda")
        odd[s2 + 5] = 7
        files = {"keep_rgb": jpegforms.pil_jpeg(img, keep_rgb=True, quality=90),
                 "keep_rgb progressive": jpegforms.pil_jpeg(img, keep_rgb=True, quality=90,
                                                            progressive=True),
                 "Adobe transform 0": jpegforms.adobe_rgb_header(base),
                 "JFIF and Adobe 0": base[:20] + jpegforms.ADOBE_RGB + base[20:],
                 "IDs RGB": no_jfif, "IDs RGB with JFIF": bytes(ids),
                 "unknown IDs": bytes(odd)}
        for name, data in files.items():
            assert_same(decode_jpeg(data), cv_rgb(data), (name, h, w))
        assert not np.array_equal(decode_jpeg(files["Adobe transform 0"]), decode_jpeg(base))


def test_corrupt_progressive_jpegs_raise_or_decode_whole():
    """Random byte flips and cuts of a restart-coded progressive JPEG: each
    either decodes to a whole image or raises ``ValueError``; the C++ scan
    decoder never reads or writes out of bounds."""
    rng = np.random.default_rng(17)
    base = cv_jpeg(sample_frame(rng, 45, 61), 90, "420", 2, IMWRITE_JPEG_PROGRESSIVE=1)
    for t in range(400):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(2, len(data)))] = int(rng.integers(0, 256))
        if t % 3 == 0:
            data = data[:int(rng.integers(2, len(data)))] + b"\xff\xd9"
        try:
            got = decode_jpeg(bytes(data))
        except ValueError:
            continue
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3


def test_build_and_load_mixed_photos_equal_jax(tmp_path):
    """A labelme folder of a baseline, a progressive and a CMYK photo:
    ``build_dataset_from_labelme`` writes the JAX package's ``.jpg`` bytes
    and masks, and ``load_invoice_dataset`` on the output and on the photos
    themselves returns the JAX package's arrays."""
    from twinvoice_tpu.data import labelme as jlabelme
    from twinvoice_tpu_torch.data import labelme as tlabelme

    rng = np.random.default_rng(18)
    for d in ("json", "images", "masks"):
        (tmp_path / d).mkdir()
    for name in ("base", "prog", "cmyk"):
        img = sample_frame(rng, 70, 90)
        data = {"base": cv_jpeg(img, 90),
                "prog": cv_jpeg(img, 90, IMWRITE_JPEG_PROGRESSIVE=1),
                "cmyk": jpegforms.pil_jpeg(img, "CMYK", quality=90)}[name]
        (tmp_path / "images" / f"{name}.jpg").write_bytes(data)
        np.save(tmp_path / "masks" / f"{name}.npy", rng.integers(0, 2, (70, 90, 3), np.uint8))
        (tmp_path / "json" / f"{name}.json").write_text(
            '{"imageWidth": 180, "imageHeight": 140, "shapes": [{"label": "date", '
            '"points": [[6, 8], [120, 8], [120, 60]]}]}')
    out = {}
    for who, mod in (("port", tlabelme), ("jax", jlabelme)):
        done, missing = mod.build_dataset_from_labelme(
            json_dir=str(tmp_path / "json"), images_dir=str(tmp_path / "images"),
            out_img_dir=str(tmp_path / who / "i"), out_mask_dir=str(tmp_path / who / "m"),
            train_size=(64, 48), log=lambda m: None)
        assert sorted(done) == ["base", "cmyk", "prog"] and missing == []
        out[who] = tmp_path / who
    for name in ("base", "prog", "cmyk"):
        assert ((out["port"] / "i" / f"{name}.jpg").read_bytes()
                == (out["jax"] / "i" / f"{name}.jpg").read_bytes()), name
        np.testing.assert_array_equal(np.load(out["port"] / "m" / f"{name}.npy"),
                                      np.load(out["jax"] / "m" / f"{name}.npy"))
    for img_dir, mask_dir in ((out["jax"] / "i", out["jax"] / "m"),
                              (tmp_path / "images", tmp_path / "masks")):
        got = tdataset.load_invoice_dataset(str(img_dir), str(mask_dir))
        want = jdataset.load_invoice_dataset(str(img_dir), str(mask_dir))
        assert got.names == want.names == ("base", "cmyk", "prog")
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.masks, want.masks)
