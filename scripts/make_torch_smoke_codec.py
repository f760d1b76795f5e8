"""Make ``tests/data/torch_smoke_codec.npz``: the fixture that holds the
PyTorch port's image file codec (``ops/host_jpeg.py``, ``host_png.py``,
``host_imageio.py``) against OpenCV and the JAX package on the card
(``chip_smoke.py`` phase 30), where neither is installed.

It writes, with this machine's ``cv2``:

- about 30 small files and ``cv2.imdecode(..., IMREAD_COLOR)``'s RGB of each:
  JPEGs at q 5, 50, 75 and 95 at 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and gray
  on frames of odd sizes, one with a restart interval, EXIF orientations
  1-8 in both byte orders (an APP1 put into a cv2 JPEG), PNGs of every colour
  type and depth with every row filter (written here with ``zlib``, since
  cv2's writer picks its own filters), one Adam7 PNG and one with ``eXIf``;
- ``cv2.imencode(".jpg", ...)``'s bytes for two frames, at q 95 and 50;
- one labelme case: a 640×440 photo written by ``cv2.imwrite``, its JSON,
  and the JAX package's ``build_one`` output at 512² (the ``.jpg`` bytes and
  the ``.npy`` mask).

Stored: ``file_<i>`` (uint8 bytes), ``want_<i>`` (the RGB), ``names``;
``enc_frame_<i>``, ``enc_quality``, ``enc_bytes_<i>``; ``lm_photo``,
``lm_json``, ``lm_jpg``, ``lm_mask``.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_codec.py

The PNG and EXIF writers here are also the tests' (``tests/test_torch_imageio.py``).
"""

from __future__ import annotations

import json
import os
import struct
import sys
import tempfile
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from twinvoice_tpu_torch.ops.host_png import ADAM7, CHANNELS  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_codec.npz")
LM_SIZE = (640, 440)  # the labelme photo's width and height
ENC_QUALITIES = (95, 50)


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples at ``depth`` bits → (h, rowbytes) uint8 raw rows."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
    return np.packbits(bits.reshape(h, -1), axis=1)


def filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Raw rows → PNG's filtered stream, row i with filter type
    ``filters[i % len(filters)]``."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int32)
    for i, row in enumerate(rows.astype(np.int32)):
        kind = filters[i % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out += bytes([kind]) + ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, *, filters=(0,), interlace=False,
              palette=None, before=(), after=(), split=1) -> bytes:
    """A PNG of ``samples`` ((h, w, ch) at ``depth`` bits; palette indices for
    colour type 3), its rows filtered by ``filters`` in turn, Adam7 if
    ``interlace``; ``before``/``after``: (type, body) chunks put before the
    first IDAT and after the last; the data split over ``split`` IDATs."""
    h, w = samples.shape[:2]
    bpp = max(1, depth * CHANNELS[ctype] // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += filter_rows(pack_rows(sub, depth), bpp, filters)
    z = zlib.compress(raw, 9)
    cut = [len(z) * i // split for i in range(split + 1)]
    chunks = [png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                              int(interlace)))]
    chunks += [png_chunk(k, v) for k, v in before]
    if palette is not None:
        chunks.append(png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    chunks += [png_chunk(b"IDAT", z[cut[i]:cut[i + 1]]) for i in range(split)]
    chunks += [png_chunk(k, v) for k, v in after]
    return b"\x89PNG\r\n\x1a\n" + b"".join(chunks) + png_chunk(b"IEND", b"")


def exif_tiff(orientation: int, order: str = "II") -> bytes:
    """A TIFF-structured EXIF block whose IFD0 holds Orientation (and a
    tag before it, so the entry is not the first)."""
    e = "<" if order == "II" else ">"
    head = order.encode() + struct.pack(e + "HI", 42, 8)
    entries = [struct.pack(e + "HHI4s", 0x010F, 2, 4, b"cam\0"),
               struct.pack(e + "HHIH2x", 0x0112, 3, 1, orientation)]
    return head + struct.pack(e + "H", len(entries)) + b"".join(entries) + b"\0\0\0\0"


def with_app1(jpeg: bytes, tiff: bytes) -> bytes:
    """``jpeg`` with an EXIF APP1 (``Exif\\0\\0`` + ``tiff``) after its APP0."""
    body = b"Exif\0\0" + tiff
    at = 2 + 2 + struct.unpack(">H", jpeg[4:6])[0] if jpeg[2:4] == b"\xff\xe0" else 2
    return jpeg[:at] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[at:]


def sample_frame(rng, h, w, noisy=False) -> np.ndarray:
    """A smooth RGB frame with noise, or a noisy one."""
    if noisy:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def png_cases(rng):
    """(name, bytes) of PNGs: every colour type and depth, the filter types
    in turn, Adam7, and ``eXIf``."""
    out = []
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                          (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            h, w = 7 + depth, 13 + ctype
            s = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype])).astype(np.uint16)
            pal = rng.integers(0, 256, ((1 << depth) - 1, 3)) if ctype == 3 else None
            out.append((f"png_c{ctype}_d{depth}",
                        png_bytes(s, ctype, depth, filters=(0, 1, 2, 3, 4), palette=pal)))
    s = rng.integers(0, 256, (19, 21, 3)).astype(np.uint16)
    out.append(("png_adam7", png_bytes(s, 2, 8, filters=(4, 1, 3), interlace=True)))
    out.append(("png_exif6", png_bytes(s[:5, :7], 2, 8, before=[(b"eXIf", exif_tiff(6, "MM"))])))
    return out


def jpeg_cases(cv2, rng):
    """(name, bytes) of JPEGs: four qualities at each sampling and gray, a
    restart interval, EXIF orientations 1-8 in both byte orders."""
    samplings = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                 "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                 "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                 "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                 "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "gray": None}
    out = []
    for i, (name, sf) in enumerate(samplings.items()):
        q = (5, 50, 75, 95)[i % 4]
        img = sample_frame(rng, 17 + 6 * i, 29 + 4 * i)
        params = [cv2.IMWRITE_JPEG_QUALITY, q]
        src = img[..., 0] if sf is None else img[..., ::-1]
        if sf is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf]
        out.append((f"jpeg_{name}_q{q}", cv2.imencode(".jpg", src, params)[1].tobytes()))
    for q in (5, 50, 75, 95):
        img = sample_frame(rng, 23, 41, noisy=q == 50)
        out.append((f"jpeg_420_q{q}_b",
                    cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])[1]
                    .tobytes()))
    img = sample_frame(rng, 37, 45)
    out.append(("jpeg_rst3", cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_RST_INTERVAL, 3])[1].tobytes()))
    base = cv2.imencode(".jpg", sample_frame(rng, 11, 19)[..., ::-1])[1].tobytes()
    for order in ("II", "MM"):
        for o in range(1, 9):
            out.append((f"jpeg_exif{o}_{order}", with_app1(base, exif_tiff(o, order))))
    return out


def labelme_case(cv2, rng, tmp):
    """The 640×440 photo, its JSON and the JAX package's ``build_one`` output."""
    from twinvoice_tpu.data import labelme as jlabelme
    from twinvoice_tpu.data import synthetic as jsynthetic

    w, h = LM_SIZE
    photo = sample_frame(rng, h, w)
    photo[60:140, 80:400] = (245, 240, 230)
    photo[300:360, 350:600] = (30, 35, 40)
    img_path = os.path.join(tmp, "images", "photo0.jpg")
    os.makedirs(os.path.dirname(img_path))
    assert cv2.imwrite(img_path, photo[..., ::-1])
    nominal = (1280, 880)  # the JSON's size: twice the photo's
    shapes = jsynthetic.labelme_shapes({"invoice_no": (160, 120, 800, 280),
                                        "date": (700, 600, 1200, 720)})
    shapes.append({"label": "total_amount", "points": [[100, 700], [500, 650], [520, 820],
                                                       [90, 860]]})
    meta = {"imageWidth": nominal[0], "imageHeight": nominal[1], "shapes": shapes}
    json_path = os.path.join(tmp, "json", "photo0.json")
    os.makedirs(os.path.dirname(json_path))
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    out_img, out_mask = os.path.join(tmp, "fixed_images"), os.path.join(tmp, "fixed_masks")
    base = jlabelme.build_one(json_path, img_path, out_img, out_mask, (512, 512))
    with open(img_path, "rb") as f:
        photo_bytes = f.read()
    with open(os.path.join(out_img, base + ".jpg"), "rb") as f:
        jpg = f.read()
    return photo_bytes, json.dumps(meta), jpg, np.load(os.path.join(out_mask, base + ".npy"))


def main():
    import cv2

    rng = np.random.default_rng(30)
    files = jpeg_cases(cv2, rng) + png_cases(rng)
    arrays = {"names": np.array([n for n, _ in files])}
    for i, (name, data) in enumerate(files):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert want is not None, name
        arrays[f"file_{i}"] = np.frombuffer(data, np.uint8)
        arrays[f"want_{i}"] = want[..., ::-1]
    arrays["enc_quality"] = np.array(ENC_QUALITIES)
    for i, q in enumerate(ENC_QUALITIES):
        frame = sample_frame(rng, 45 + 20 * i, 71 - 10 * i, noisy=i == 1)
        arrays[f"enc_frame_{i}"] = frame
        arrays[f"enc_bytes_{i}"] = cv2.imencode(".jpg", frame[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, q])[1]
    with tempfile.TemporaryDirectory() as tmp:
        photo, meta, jpg, mask = labelme_case(cv2, rng, tmp)
    arrays.update(lm_photo=np.frombuffer(photo, np.uint8), lm_json=np.array(meta),
                  lm_jpg=np.frombuffer(jpg, np.uint8), lm_mask=mask)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(files)} files, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
