"""Make ``tests/data/torch_smoke_jpegforms.npz``: the fixture that holds the
PyTorch port's reading of the JPEG forms beyond baseline (progressive with
libjpeg-turbo's block smoothing, CMYK and YCCK, RGB-coded colour) against
OpenCV and the JAX package on the card (``chip_smoke.py`` phase 34), where
neither is installed.

It writes, with this machine's ``cv2`` and Pillow:

(a) about 40 small files and ``cv2.imdecode(..., IMREAD_COLOR)``'s RGB of
    each: cv2 progressive at q 5, 50 and 95 at 4:4:4, 4:2:2, 4:2:0 and gray,
    at 4:4:0 and 4:1:1, one with a restart interval and one with an EXIF
    orientation; Pillow progressive with ``optimize=True`` (Huffman tables
    for each scan); one cv2 progressive file with its last 1-9 scans cut
    (EOI appended: block smoothing); a bad progression (a DC scan with Se 1,
    which cv2 reads as ``None``: stored with its reason) and bogus ones
    (a scan repeated; a refinement of coefficients whose first scan is
    gone), made by editing bytes; Pillow CMYK at q 50 and 95, and each with
    its Adobe transform set to 2 (YCCK); Pillow progressive CMYK; Pillow
    ``keep_rgb`` (plain and progressive) and a cv2 YCbCr file with its JFIF
    APP0 replaced by an Adobe APP14 of transform 0 (read as RGB);
(b) a progressive phone photo: the training fixture's first page resized
    by ``cv2.resize`` (INTER_LINEAR, as phase 30 (b) resizes it) to
    4032×3024 if cv2's progressive q95 file of it is at most 4 MB, else
    2016×1512, and the SHA-256 of cv2's RGB of it (not the array);
(c) a labelme case whose two photos are a cv2 progressive file and a
    Pillow CMYK file (640×480, the training fixture's pages 1 and 2), their
    JSONs, the JAX package's ``build_one`` output for each at 512² (the
    ``.jpg`` bytes and the ``.npy`` mask), and the SHA-256 of the JAX
    package's ``load_invoice_dataset`` arrays on the build's output and on
    the two photos themselves (zero masks of their size);
(d) the JAX package's boxes and ok flags from the bundled w16 ``Segmenter``
    at fp32 on ``cv2.imread``'s pixels of (c)'s progressive photo, through
    the raw path (``segment_batch(pre_resized=False)``).

Stored: ``file_<i>`` (uint8 bytes), ``want_<i>`` (the RGB; (0, 0, 3) where
cv2 reads nothing), ``names``, ``reasons`` (what the port's error must say,
"" where it decodes); ``photo``, ``photo_sha``, ``photo_size``; ``lm_names``,
``lm_photo_<n>``, ``lm_json_<n>``, ``lm_jpg_<n>``, ``lm_mask_<n>``,
``load_built_sha``, ``load_photos_sha``; ``serve_boxes``, ``serve_ok``.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_jpegforms.py    # ~30 s

The byte editors here are also the tests' (``tests/test_torch_imageio.py``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts.make_torch_smoke_codec import exif_tiff, sample_frame, with_app1  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_jpegforms.npz")
PHOTO_SIZES = ((4032, 3024), (2016, 1512))  # (b): width, height; the second past 4 MB
PHOTO_MAX_BYTES = 4 << 20
PHOTO_QUALITY = 95
LM_SIZE = (640, 480)  # (c)'s photos, width and height
LM_NAMES = ("prog", "cmyk")
ADOBE_RGB = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"  # APP14, transform 0


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def cv_progressive(cv2, rgb, q=75, sampling=None, rst=0) -> bytes:
    """cv2's progressive JPEG of ``rgb`` (``sampling``: an
    ``IMWRITE_JPEG_SAMPLING_FACTOR_*`` value, ``"gray"`` for the first
    channel alone, None for cv2's 4:2:0)."""
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, q,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling == "gray":
        src = rgb[..., 0]
    else:
        src = rgb[..., ::-1]
        if sampling is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def pil_jpeg(rgb, mode="RGB", **kw) -> bytes:
    """Pillow's JPEG of ``rgb`` converted to ``mode`` (``"CMYK"``: Adobe's
    inverted ink, transform 0)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def scan_units(data: bytes):
    """A JPEG file split at its scans: (the head up to and with the SOF
    segment, [each scan with the table segments before it], the tail from
    the marker after the last scan's data)."""
    pos, segs = 2, []
    while data[pos + 1] != 0xD9:
        m = data[pos + 1]
        start, pos = pos, pos + 2 + struct.unpack_from(">H", data, pos + 2)[0]
        if m == 0xDA:  # the entropy-coded data run to the next marker other than RSTn
            while not (data[pos] == 0xFF and data[pos + 1] not in (0, *range(0xD0, 0xD8))):
                pos += 1
        segs.append((m, start, pos))
    sof = next(i for i, (m, _, _) in enumerate(segs) if m in (0xC0, 0xC1, 0xC2))
    cur, units = segs[sof][2], []
    for m, _, end in segs[sof + 1:]:
        if m == 0xDA:
            units.append(data[cur:end])
            cur = end
    return data[:segs[sof][2]], units, data[cur:]


def cut_scans(data: bytes, k: int) -> bytes:
    """``data`` without its last ``k`` scans, EOI appended."""
    head, units, _ = scan_units(data)
    return head + b"".join(units[:len(units) - k]) + b"\xff\xd9"


def sos_fields(data: bytes, scan: int):
    """The offset of scan ``scan``'s Ss byte (Se and Ah/Al follow)."""
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    n = data[sos[scan] + 4]
    return sos[scan] + 5 + 2 * n


def with_scan_fields(data: bytes, scan: int, ss=None, se=None, ahal=None) -> bytes:
    """``data`` with scan ``scan``'s Ss, Se or Ah/Al byte replaced."""
    at, out = sos_fields(data, scan), bytearray(data)
    for off, v in ((0, ss), (1, se), (2, ahal)):
        if v is not None:
            out[at + off] = v
    return bytes(out)


def repeat_scan(data: bytes, scan: int) -> bytes:
    """``data`` with scan ``scan`` (and the tables before it) twice."""
    head, units, tail = scan_units(data)
    return head + b"".join(units[:scan + 1] + units[scan:]) + tail


def drop_scan(data: bytes, scan: int) -> bytes:
    """``data`` without scan ``scan`` (and the tables before it)."""
    head, units, tail = scan_units(data)
    return head + b"".join(units[:scan] + units[scan + 1:]) + tail


def with_adobe_transform(data: bytes, transform: int) -> bytes:
    """``data`` with its Adobe APP14's transform byte set to ``transform``."""
    at = data.index(b"Adobe") + 11  # the segment's 12th byte
    assert data[at - 15:at - 13] == b"\xff\xee"
    return data[:at] + bytes([transform]) + data[at + 1:]


def adobe_rgb_header(data: bytes) -> bytes:
    """A JFIF file from cv2 with its APP0 replaced by an Adobe APP14 of
    transform 0: libjpeg reads its YCbCr samples as R, G, B."""
    assert data[2:4] == b"\xff\xe0"
    return data[:2] + ADOBE_RGB + data[4 + struct.unpack_from(">H", data, 4)[0]:]


def form_cases(cv2, rng):
    """(name, bytes) of (a)'s files."""
    sf = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
          "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
          "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "gray": "gray"}
    out = []
    for i, (name, s) in enumerate(sf.items()):
        for j, q in enumerate((5, 50, 95)):
            img = sample_frame(rng, 19 + 7 * i + 3 * j, 27 + 5 * i - 2 * j, noisy=j == 1)
            out.append((f"prog_cv2_{name}_q{q}", cv_progressive(cv2, img, q, s)))
    for name in ("440", "411"):
        img = sample_frame(rng, 33, 45)
        s = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}")
        out.append((f"prog_cv2_{name}_q75", cv_progressive(cv2, img, 75, s)))
    img = sample_frame(rng, 61, 77)
    out.append(("prog_cv2_rst2", cv_progressive(cv2, img, 90, rst=2)))
    out.append(("prog_cv2_exif6", with_app1(cv_progressive(cv2, sample_frame(rng, 13, 21)),
                                            exif_tiff(6, "MM"))))
    img = sample_frame(rng, 57, 83)
    out.append(("prog_pil_optimize", pil_jpeg(img, progressive=True, optimize=True)))
    out.append(("prog_pil_optimize_444_q90", pil_jpeg(img, progressive=True, optimize=True,
                                                      quality=90, subsampling=0)))
    whole = cv_progressive(cv2, sample_frame(rng, 67, 93), 90)
    assert len(scan_units(whole)[1]) == 10
    for k in range(1, 10):
        out.append((f"prog_cut{k}", cut_scans(whole, k)))
    out.append(("bad_dc_se1", with_scan_fields(whole, 0, se=1)))
    out.append(("bogus_repeat_ac", repeat_scan(whole, 1)))
    flat = np.repeat(sample_frame(rng, 40, 56)[..., :1], 3, -1)  # gray in RGB: no chroma AC
    out.append(("bogus_refine_unstarted", drop_scan(cv_progressive(cv2, flat, 90), 3)))
    img = sample_frame(rng, 45, 59)
    for q in (50, 95):
        cmyk = pil_jpeg(img, "CMYK", quality=q)
        out.append((f"cmyk_q{q}", cmyk))
        out.append((f"ycck_q{q}", with_adobe_transform(cmyk, 2)))
    out.append(("cmyk_prog", pil_jpeg(img, "CMYK", quality=80, progressive=True)))
    img = sample_frame(rng, 37, 51)
    out.append(("rgb_keep", pil_jpeg(img, keep_rgb=True, quality=90)))
    out.append(("rgb_keep_prog", pil_jpeg(img, keep_rgb=True, quality=90, progressive=True)))
    base = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes()
    out.append(("rgb_adobe0", adobe_rgb_header(base)))
    return out


REASONS = {"bad_dc_se1": "bad progression"}


def decode_cv2(cv2, data):
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if got is None else got[..., ::-1]


def phone_photo(cv2, page):
    """(b): (the file's bytes, (width, height))."""
    for size in PHOTO_SIZES:
        data = cv_progressive(cv2, cv2.resize(page, size, interpolation=cv2.INTER_LINEAR),
                              PHOTO_QUALITY)
        if len(data) <= PHOTO_MAX_BYTES:
            return data, size
    raise AssertionError("no photo size gives a file of at most 4 MB")


def field_boxes(mask, sx, sy):
    """The bounding box of each channel of a training mask, scaled."""
    from twinvoice_tpu.data.labelme import DEFAULT_LABELS

    boxes = {}
    for label, ch in DEFAULT_LABELS.items():
        ys, xs = np.nonzero(mask[..., ch] > 127)
        if ys.size:
            boxes[label] = (round(xs.min() * sx), round(ys.min() * sy),
                            round((xs.max() + 1) * sx), round((ys.max() + 1) * sy))
    return boxes


def labelme_case(cv2, train, tmp):
    """(c) and (d): the photos, their JSONs, JAX's ``build_one`` outputs, the
    load digests and JAX's served boxes."""
    import jax.numpy as jnp

    from twinvoice_tpu.data import dataset as jdataset
    from twinvoice_tpu.data import labelme as jlabelme
    from twinvoice_tpu.data import synthetic as jsynthetic
    from twinvoice_tpu.models.pretrained import load_pretrained_segmenter

    dirs = {k: os.path.join(tmp, k) for k in ("json", "images", "fixed_images", "fixed_masks",
                                              "zero_masks")}
    for d in dirs.values():
        os.makedirs(d)
    w, h = LM_SIZE
    out = {"lm_names": np.array(LM_NAMES)}
    for i, name in enumerate(LM_NAMES):
        page = cv2.resize(train["pages"][1 + i], LM_SIZE, interpolation=cv2.INTER_LINEAR)
        data = (cv_progressive(cv2, page, 90) if name == "prog"
                else pil_jpeg(page, "CMYK", quality=90))
        path = os.path.join(dirs["images"], f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        shapes = jsynthetic.labelme_shapes(field_boxes(train["masks"][1 + i], w / 512, h / 512))
        meta = {"imageWidth": w, "imageHeight": h, "shapes": shapes}
        json_path = os.path.join(dirs["json"], f"{name}.json")
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        jlabelme.build_one(json_path, path, dirs["fixed_images"], dirs["fixed_masks"],
                           (512, 512))
        with open(os.path.join(dirs["fixed_images"], f"{name}.jpg"), "rb") as f:
            jpg = f.read()
        np.save(os.path.join(dirs["zero_masks"], f"{name}.npy"), np.zeros((h, w, 3), np.uint8))
        out.update({f"lm_photo_{name}": np.frombuffer(data, np.uint8),
                    f"lm_json_{name}": np.array(json.dumps(meta)),
                    f"lm_jpg_{name}": np.frombuffer(jpg, np.uint8),
                    f"lm_mask_{name}": np.load(os.path.join(dirs["fixed_masks"],
                                                            f"{name}.npy"))})
    for key, (img_dir, mask_dir) in (("load_built_sha", ("fixed_images", "fixed_masks")),
                                     ("load_photos_sha", ("images", "zero_masks"))):
        ds = jdataset.load_invoice_dataset(dirs[img_dir], dirs[mask_dir])
        assert ds.names == tuple(sorted(LM_NAMES)), ds.names
        out[key] = np.array([digest(ds.images), digest(ds.masks)])
    rgb = cv2.imread(os.path.join(dirs["images"], "prog.jpg"))[..., ::-1]
    seg = load_pretrained_segmenter(jnp.float32, variant="w16")
    _, boxes, ok = seg.segment_batch(np.ascontiguousarray(rgb)[None], pre_resized=False)
    out["serve_boxes"], out["serve_ok"] = np.asarray(boxes)[0], np.asarray(ok)[0]
    return out


def main():
    import cv2

    rng = np.random.default_rng(34)
    files = form_cases(cv2, rng)
    arrays = {"names": np.array([n for n, _ in files]),
              "reasons": np.array([REASONS.get(n, "") for n, _ in files])}
    for i, (name, data) in enumerate(files):
        want = decode_cv2(cv2, data)
        assert (want is None) == (name in REASONS), name
        arrays[f"file_{i}"] = np.frombuffer(data, np.uint8)
        arrays[f"want_{i}"] = np.zeros((0, 0, 3), np.uint8) if want is None else want
    with np.load(os.path.join(ROOT, "tests", "data", "torch_smoke_train.npz")) as z:
        train = {k: z[k] for k in ("pages", "masks")}
    photo, size = phone_photo(cv2, train["pages"][0])
    print(f"(b) the photo at {size[0]}×{size[1]}: {len(photo)} bytes")
    arrays.update(photo=np.frombuffer(photo, np.uint8), photo_size=np.array(size),
                  photo_sha=np.array(digest(decode_cv2(cv2, photo))))
    with tempfile.TemporaryDirectory() as tmp:
        arrays.update(labelme_case(cv2, train, tmp))
    print(f"(d) JAX's w16 fp32 raw path on the progressive photo: ok "
          f"{arrays['serve_ok'].tolist()}, boxes {arrays['serve_boxes'].tolist()}")
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(files)} files, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
