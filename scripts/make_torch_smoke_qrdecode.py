"""Make ``tests/data/torch_smoke_qrdecode.npz``: the fixture that holds the
PyTorch port's rebuild of ``cv2.QRCodeDetector``'s decoder (``qr.cvdecode``,
``csrc/host_qrdecode.cpp``) and the default ``QrPipeline`` against OpenCV and
the JAX package (``chip_smoke.py`` phase 35,
``tests/test_torch_fixture_qrdecode.py``).

Stored (JSON strings hold the lists):

- ``names`` and ``img_<i>``: about 60 small gray images (uint8): codes of
  the JAX package's encoder and of ``cv2.QRCodeEncoder`` (numeric,
  alphanumeric, byte, kanji, ECI, auto) at versions 1-40 sampled, every
  level and mask; a mirrored and a transposed code; codes with codewords
  flipped up to the correction limit and one past it (version 21 too,
  whose alignment table OpenCV misprints); Big5, Latin-1, C1, NUL and
  overlong-UTF-8 byte payloads; crafted segment streams (an ECI with a
  three-byte designator, an ECI after a byte segment, mode 5); a
  structured-append set; two codes side by side, a perspective warp, a
  softened, turned and low-contrast code (the QR fixture's page kinds);
  a blank image and one of 20 pixels a side;
- ``cv2``: for each image cv2's ``detectAndDecodeMulti`` and
  ``detectAndDecode``, each after ``cv2.setRNGSeed(0)``: ``["ok", found,
  [strings]]`` / ``["ok", string]``, ``["err"]`` where cv2 raises
  ``cv2.error``, ``["uni"]`` where its binding raises
  ``UnicodeDecodeError``;
- ``sweep_default``: the JAX package's default ``QrPipeline().scan`` on the
  QR fixture's 82 sweep pages (``tests/data/torch_smoke_qr.npz``: the
  INTER_AREA downscales of ``portrait_0`` and ``portrait_5`` at
  0.40-0.80, rebuilt from the portraits where they are checked), each after
  ``cv2.setRNGSeed(0)``, keyed ``"<seed>_<scale>"`` as ``sweep_native``;
- ``extract_pages`` (``"qr:<name>"`` a page of the QR fixture, ``"sweep:
  <seed>_<scale>"`` a sweep page), ``jax_extract`` (``chip_smoke.
  fusion_record`` of JAX's ``InvoiceExtractor.extract``: the bundled w16 at
  fp32, ``QrPipeline()``, ``JaxOcrEngine()``, the default ``FusionConfig``),
  ``extract_boxes`` / ``extract_ok`` (JAX's ``segment_pil`` boxes on each
  page), on ``s0_x0.55`` and the 0.49× sweep page of seed 5, the pages
  where cv2's decoder decides the payloads.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_qrdecode.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_qrdecode.npz")
QR_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_qr.npz")
SWEEP_SCALES = tuple(round(0.40 + 0.01 * i, 2) for i in range(41))
EXTRACT_PAGES = ("qr:s0_x0.55", "sweep:5_0.49")


# ------------------------------------------------------------ code images


def bits_of(value: int, n: int):
    return [(value >> i) & 1 for i in range(n - 1, -1, -1)]


def byte_segment(payload: bytes, version: int):
    return bits_of(4, 4) + bits_of(len(payload), 8 if version <= 9 else 16) + [
        b for x in payload for b in bits_of(x, 8)]


def eci_segment(value: int):
    if value < 128:
        return bits_of(7, 4) + bits_of(value, 8)
    if value < 16384:
        return bits_of(7, 4) + bits_of(0x8000 | value, 16)
    return bits_of(7, 4) + bits_of(0xC00000 | value, 24)


def blocks_of(bits, version: int, level: str):
    """A segment bit stream → the data and ECC codewords of each block (the
    JAX encoder's tables and Reed-Solomon), terminator and padding added."""
    from twinvoice_tpu.qr import encode as E

    cap = E._data_capacity_bytes(version, level)
    bits = list(bits) + [0] * min(4, max(0, cap * 8 - len(bits)))
    while len(bits) % 8:
        bits.append(0)
    data = [int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8)]
    pads = (0xEC, 0x11)
    while len(data) < cap:
        data.append(pads[(len(data) - len(bits) // 8) % 2])
    ec, g1b, g1dc, g2b, g2dc = E._EC_TABLE[version][level]
    blocks, pos = [], 0
    for n, size in ((g1b, g1dc), (g2b, g2dc)):
        for _ in range(n):
            blocks.append(data[pos:pos + size])
            pos += size
    return blocks, [E.rs_encode(b, ec) for b in blocks]


def matrix_of(blocks, ecb, version: int, level: str, mask: int):
    """Interleaved codewords placed as the JAX encoder places them → bool
    matrix (True dark)."""
    from twinvoice_tpu.qr import encode as E

    cw = [b[i] for i in range(max(len(b) for b in blocks)) for b in blocks if i < len(b)]
    cw += [e[i] for i in range(len(ecb[0])) for e in ecb]
    n = 17 + 4 * version
    template = E._place_function_patterns(version)
    m = template.copy()
    it = iter((byte >> (7 - k)) & 1 for byte in cw for k in range(8))
    col, up = n - 1, True
    while col > 0:
        if col == 6:
            col -= 1
        for r in (range(n - 1, -1, -1) if up else range(n)):
            for c in (col, col - 1):
                if template[r, c] == -1:
                    bit = next(it, 0)
                    m[r, c] = bit ^ int(E._MASKS[mask](r, c))
        up, col = not up, col - 2
    f = E._format_bits(level, mask)
    fb = [(f >> i) & 1 for i in range(15)]
    coords_a = [(0, 8), (1, 8), (2, 8), (3, 8), (4, 8), (5, 8), (7, 8), (8, 8), (8, 7), (8, 5),
                (8, 4), (8, 3), (8, 2), (8, 1), (8, 0)]
    coords_b = [(8, n - 1 - i) for i in range(8)] + [(n - 7 + i, 8) for i in range(7)]
    for (r, c), bit in zip(coords_a + coords_b, fb + fb):
        m[r, c] = bit
    if version >= 7:
        v = E._version_bits(version)
        for i in range(18):
            m[i // 3, n - 11 + i % 3] = m[n - 11 + i % 3, i // 3] = (v >> i) & 1
    return m.astype(bool)


def render(m, px: int, border: int = 4):
    """bool matrix (True dark) → uint8 gray, ``border`` light modules around."""
    img = np.pad(np.where(m, 0, 255).astype(np.uint8), border, constant_values=255)
    return np.kron(img, np.ones((px, px), np.uint8))


def damaged(version, level, block, k, rng, mask=2, payload=b"DAMAGED 0123456789"):
    """A code whose ``block``-th block carries ``k`` wrong codewords."""
    blocks, ecb = blocks_of(byte_segment(payload, version), version, level)
    full = list(blocks[block]) + list(ecb[block])
    for p in rng.choice(len(full), size=k, replace=False):
        full[p] ^= int(rng.integers(1, 256))
    nd = len(blocks[block])
    blocks[block], ecb[block] = full[:nd], full[nd:]
    return matrix_of(blocks, ecb, version, level, mask)


def warped(img, kind, rng):
    """The QR fixture's page kinds on a code image (cv2, as that script)."""
    import cv2

    img = np.pad(img, 30, constant_values=255)
    h, w = img.shape
    if kind == "persp":
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = np.float32([[12, 8], [w - 4, 0], [w - 16, h - 4], [0, h]])
        return cv2.warpPerspective(img, cv2.getPerspectiveTransform(src, dst), (w, h),
                                   borderValue=255)
    if kind == "soft":
        small = cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    if kind == "r7":
        M = cv2.getRotationMatrix2D((w / 2, h / 2), 7, 1.0)
        return cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR, borderValue=255)
    if kind == "lowc":
        return (img.astype(np.float32) * 0.3 + 150).astype(np.uint8)
    if kind == "blur":
        return cv2.GaussianBlur(img, (5, 5), 1.2)
    raise ValueError(kind)


def code_images():
    """→ [(name, uint8 gray)] (module doc)."""
    import cv2

    from twinvoice_tpu.qr.encode import encode_qr_matrix

    rng = np.random.default_rng(2026)
    out = []
    levels = "LMQH"
    for i, v in enumerate((1, 2, 3, 4, 5, 6, 7, 9, 10, 13, 14, 17, 21, 24, 27, 33, 40)):
        lv, mask = levels[i % 4], i % 8
        payload = bytes(rng.integers(33, 127, int(rng.integers(4, 24))).astype(np.uint8))
        m = encode_qr_matrix(payload, level=lv, mask=mask, version=v)
        out.append((f"jax_v{v}{lv}m{mask}", render(m, 3 if v < 14 else 2)))
    params = cv2.QRCodeEncoder_Params()
    for mode, text in ((cv2.QRCODE_ENCODER_MODE_NUMERIC, "31415926535897932384"),
                       (cv2.QRCODE_ENCODER_MODE_ALPHANUMERIC, "INVOICE AB-1234/5:$%*"),
                       (cv2.QRCODE_ENCODER_MODE_BYTE, "**珍珠奶茶:1:60"),
                       (cv2.QRCODE_ENCODER_MODE_KANJI, "\u6f22\u5b57"),
                       (cv2.QRCODE_ENCODER_MODE_ECI, "**雞排:2:80"),
                       (cv2.QRCODE_ENCODER_MODE_AUTO, "AUTO 12345 mixed")):
        for level in (0, 3):
            params.mode, params.correction_level = mode, level
            m = cv2.QRCodeEncoder_create(params).encode(text) < 128
            out.append((f"cv2enc_mode{mode}_l{level}", render(m, 3, border=2)))
    m = encode_qr_matrix("MIRRORED CODE 20251019", level="Q", mask=5, version=3)
    out.append(("mirrored", render(m[:, ::-1], 3)))
    out.append(("transposed", render(m.T, 3)))
    for name, (v, lv, block, k) in {"dmg_v2L_at_limit": (2, "L", 0, 5),
                                    "dmg_v2L_past_limit": (2, "L", 0, 6),
                                    "dmg_v7M_at_limit": (7, "M", 3, 9),
                                    "dmg_v7M_past_limit": (7, "M", 3, 10),
                                    "dmg_v8L_block1_t": (8, "L", 1, 12),
                                    "dmg_v10H_past_limit": (10, "H", 2, 15),
                                    "dmg_v21Q_below_limit": (21, "Q", 0, 13)}.items():
        out.append((name, render(damaged(v, lv, block, k, rng), 3 if v < 14 else 2)))
    for name, payload in (("big5", "**珍珠奶茶:1:60".encode("big5")),
                          ("latin1", "café crème brûlée".encode("latin-1")),
                          ("c1", bytes([0x80, 0x85, 0x9F, 0x41, 0x90, 0x42])),
                          ("nul", b"AB\x00CD"),
                          ("overlong", b"AB\xc0\x80CD")):
        out.append((f"bytes_{name}", render(encode_qr_matrix(payload, level="M", mask=3), 3)))
    for name, bits in (("eci_3byte", eci_segment(100000) + byte_segment(b"abc", 5)),
                       ("byte_then_eci", byte_segment(b"ab", 5) + eci_segment(26)
                        + byte_segment("é".encode(), 5)),
                       ("mode5", bits_of(5, 4) + bits_of(0, 20))):
        out.append((f"seg_{name}", render(matrix_of(*blocks_of(bits, 5, "L"), 5, "L", 3), 3)))
    params = cv2.QRCodeEncoder_Params()
    params.structure_number = 3
    parts = cv2.QRCodeEncoder_create(params).encodeStructuredAppend(
        "STRUCTURED APPEND PARTS 0123456789 " * 2)
    out.append(("structured_append", np.hstack(
        [np.pad(np.kron(p, np.ones((3, 3), np.uint8)), 12, constant_values=255) for p in parts])))
    header = encode_qr_matrix("AB12345678114090912345678:00000120:0:0:0:AAAA", level="M", mask=1)
    items = encode_qr_matrix("**珍珠奶茶:1:60:雞排:2:80", level="L", mask=6)
    a, b = render(header, 3), render(items, 3)
    hh = max(a.shape[0], b.shape[0])
    pair = np.hstack([np.pad(a, ((0, hh - a.shape[0]), (0, 24)), constant_values=255),
                      np.pad(b, ((0, hh - b.shape[0]), (0, 0)), constant_values=255)])
    out.append(("two_side_by_side", pair))
    for kind in ("persp", "soft", "r7", "lowc", "blur"):
        out.append((f"kind_{kind}", warped(render(header, 4), kind, rng)))
    out.append(("blank", np.full((240, 320), 246, np.uint8)))
    out.append(("tiny_20px", render(encode_qr_matrix("T", level="L", mask=0), 1, border=0)[:20, :20]))
    return out


def cv2_results(gray):
    """cv2's two calls on ``gray``, each after ``cv2.setRNGSeed(0)`` (module doc)."""
    import cv2

    det = cv2.QRCodeDetector()
    res = []
    for call in ("multi", "single"):
        cv2.setRNGSeed(0)
        try:
            if call == "multi":
                ok, texts, _, _ = det.detectAndDecodeMulti(gray)
                res.append(["ok", bool(ok), list(texts) if ok else []])
            else:
                text, _, _ = det.detectAndDecode(gray)
                res.append(["ok", text])
        except cv2.error:
            res.append(["err"])
        except UnicodeDecodeError:
            res.append(["uni"])
    return {"multi": res[0], "single": res[1]}


# ------------------------------------------------------------ scans, extract


def sweep_pages():
    """The QR fixture's sweep pages → {"<seed>_<scale>": uint8 RGB}."""
    import cv2

    from twinvoice_tpu_torch.ops.host_image import resize_area_u8

    with np.load(QR_FIXTURE) as z:
        portraits = {s: z[f"portrait_{s}"] for s in (0, 5)}
    out = {}
    for seed, p in portraits.items():
        for sc in SWEEP_SCALES:
            page = cv2.resize(p, None, fx=sc, fy=sc, interpolation=cv2.INTER_AREA)
            assert np.array_equal(page, resize_area_u8(p, fx=sc, fy=sc)), (seed, sc)
            out[f"{seed}_{sc}"] = page
    return out


def sweep_default(pages):
    import cv2

    import twinvoice_tpu.qr.detect as jdetect

    default = jdetect.QrPipeline()
    out = {}
    for key, page in pages.items():
        cv2.setRNGSeed(0)
        out[key] = default.scan(page)
    return out


def extract_page(key, sweep):
    kind, name = key.split(":")
    if kind == "sweep":
        return sweep[name]
    import chip_smoke

    fix = chip_smoke.qr_fixture()
    return fix["pages"][fix["names"].index(name)]


def main():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import make_torch_smoke_qr as mq

    images = code_images()
    results = [cv2_results(g) for _, g in images]
    decoded = sum(r["multi"][0] == "ok" and any(r["multi"][2]) or
                  (r["single"][0] == "ok" and r["single"][1] != "") for r in results)
    print(f"{len(images)} images, {decoded} with a payload from cv2, "
          f"{sum('err' in (r['multi'][0], r['single'][0]) for r in results)} where cv2 raises")
    sweep = sweep_pages()
    scans = sweep_default(sweep)
    print(f"sweep: {sum(len(v) == 2 for v in scans.values())} of {len(scans)} pages with both codes")
    pages = [(k, extract_page(k, sweep), None) for k in EXTRACT_PAGES]
    records, boxes, ok = mq.extract_runs(pages, range(len(pages)), [0] * len(pages))
    for k, r in zip(EXTRACT_PAGES, records):
        print(k, r["qr_raw"], r["items"])
    arrays = {f"img_{i}": g for i, (_, g) in enumerate(images)}
    np.savez_compressed(
        OUT, names=json.dumps([n for n, _ in images]), cv2=json.dumps(results, ensure_ascii=False),
        sweep_default=json.dumps(scans, ensure_ascii=False),
        extract_pages=json.dumps(list(EXTRACT_PAGES)),
        jax_extract=json.dumps(records, ensure_ascii=False), extract_boxes=boxes,
        extract_ok=ok, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
