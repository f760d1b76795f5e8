"""PNG files without OpenCV: ``decode_png``, the port's ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)[..., ::-1]`` for a PNG (libpng as OpenCV drives it).

- Every chunk's CRC is checked; IHDR first, PLTE where the colour type needs
  it, the IDAT chunks concatenated through ``zlib``, IEND last. Unknown
  critical chunks raise; ancillary ones (gAMA, sRGB, iCCP, tRNS, text, ...)
  are skipped, as cv2's reading ignores them.
- Gray at 1, 2, 4, 8 and 16 bits, RGB at 8 and 16, palette at 1-8 bits, gray
  with alpha and RGBA at 8 and 16, Adam7 interlacing.
- What comes back is 8-bit RGB: alpha dropped (``png_set_strip_alpha``),
  16-bit samples as their high byte (``png_set_strip_16``: ``v >> 8``), gray
  of 1, 2 and 4 bits scaled to 8 (× 255, 85 and 17) and replicated, palette
  indices expanded (an index past the palette reads black, as libpng's
  zero-filled palette gives), and the ``eXIf`` chunk's orientation applied.
- Row filters 0-4 are undone by the host C++ library (``png_unfilter`` in
  ``csrc/host_codec.cpp``).

Anything else (a bad CRC, a missing chunk, too little image data, a filter
type above 4, more than ``MAX_PIXELS``) raises ``ValueError`` with the
reason, too little data before the image is allocated.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from twinvoice_tpu_torch.ops.host_imageio import (MAX_PIXELS, PNG_SIGNATURE, apply_orientation,
                                                  codec, exif_orientation)

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples a pixel
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunks(data: bytes):
    """(type, body) of each chunk up to IEND, every CRC checked."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG: truncated before IEND")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"PNG: a truncated {kind!r} chunk")
        body = data[pos + 8:end - 4]
        if zlib.crc32(kind + body) != struct.unpack_from(">I", data, end - 4)[0]:
            raise ValueError(f"PNG: a bad CRC in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _unfilter(raw: memoryview, rows: int, rowbytes: int, bpp: int) -> np.ndarray:
    """``rows`` filtered rows (a filter byte and ``rowbytes`` bytes each) →
    (rows, rowbytes) uint8."""
    out = np.empty((rows, rowbytes), np.uint8)
    src = np.frombuffer(raw, np.uint8)
    rc = codec().png_unfilter(src.ctypes.data, rows, rowbytes, bpp, out.ctypes.data)
    if rc:
        raise ValueError("PNG: a row filter type above 4")
    return out


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows → (rows, width, channels) uint8: sub-byte samples
    unpacked (not yet scaled), 16-bit ones as their high byte."""
    n = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(n, width, channels)
    if depth == 16:
        return rows[:, :2 * width * channels].reshape(n, width, channels, 2)[..., 0]
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(n, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes → the RGB uint8 (H, W, 3) array ``cv2.imdecode(buf,
    cv2.IMREAD_COLOR)[..., ::-1]`` returns, the ``eXIf`` orientation
    applied."""
    data = bytes(data)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file: no signature")
    header, palette, idat, exif = None, None, [], None
    for kind, body in _chunks(data):
        if header is None and kind != b"IHDR":
            raise ValueError(f"PNG: {kind!r} before IHDR")
        if kind == b"IHDR":
            if header is not None or len(body) != 13:
                raise ValueError("PNG: a corrupt or second IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError(f"PNG: a PLTE of {len(body)} bytes")
            palette = np.zeros((256, 3), np.uint8)  # past its entries: black
            palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            if exif is None:  # before or after the image data: cv2 reads either
                exif = body
        elif kind != b"IEND" and not kind[0] & 0x20:
            raise ValueError(f"PNG: an unknown critical chunk {kind!r}")
    width, height, depth, ctype, method, filt, interlace = header
    if ctype not in CHANNELS or depth not in DEPTHS[ctype]:
        raise ValueError(f"PNG: colour type {ctype} at {depth} bits is not a PNG format")
    if not width or not height or method or filt or interlace > 1:
        raise ValueError(f"PNG: a {width}×{height} image with compression {method}, "
                         f"filter {filt}, interlace {interlace}")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG: a {width}×{height} image is more than {MAX_PIXELS} pixels")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: a palette image without PLTE")
    if not idat:
        raise ValueError("PNG: no IDAT chunk")
    ch = CHANNELS[ctype]
    bits = depth * ch
    bpp = max(1, bits // 8)
    passes = []  # (x0, y0, dx, dy, pass width, rows, bytes a row) of each non-empty pass
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            passes.append((x0, y0, dx, dy, pw, ph, -(-pw * bits // 8)))
    need = sum(ph * (rowbytes + 1) for *_, ph, rowbytes in passes)
    try:  # inflated no further than the passes need (data past them is ignored, as libpng does)
        raw = memoryview(zlib.decompressobj().decompress(b"".join(idat), need))
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    if len(raw) < need:  # checked before the image is allocated
        raise ValueError(f"PNG: too little image data ({len(raw)} of {need} bytes)")
    img = np.empty((height, width, ch), np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, rowbytes in passes:
        size = ph * (rowbytes + 1)
        rows = _unfilter(raw[pos:pos + size], ph, rowbytes, bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        pos += size
    if ctype == 3:
        rgb = palette[img[..., 0]]
    elif ch <= 2:  # gray, gray + alpha
        gray = img[..., 0] * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else img[..., 0]
        rgb = np.repeat(gray[..., None], 3, -1)
    else:
        rgb = np.ascontiguousarray(img[..., :3])
    return apply_orientation(rgb, exif_orientation(exif)) if exif else rgb
