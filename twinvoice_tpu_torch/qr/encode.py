"""QR code *encoder* (ISO/IEC 18004), versions 1-40, byte mode: the port's
copy of ``twinvoice_tpu.qr.encode`` (pure Python and numpy).

It makes the QR codes of test invoices and is the round-trip oracle of the
native decoder (``qr.native``) and the locator (``qr.locate``).
``encode_qr_matrix`` and ``render_qr`` return what the JAX package's return.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# GF(256) arithmetic (poly 0x11D) + Reed-Solomon encoding
# ---------------------------------------------------------------------------

_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def rs_generator(n_ec: int) -> List[int]:
    """Π (x − α^i) for i<n_ec, coefficients in DESCENDING power order
    (g[0] is the leading 1) as the long-division in rs_encode consumes them."""
    g = [1]
    for i in range(n_ec):
        g2 = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            g2[j] ^= _gf_mul(c, _EXP[i])
            g2[j + 1] ^= c
        g = g2
    return g[::-1]


def rs_encode(data: List[int], n_ec: int) -> List[int]:
    gen = rs_generator(n_ec)
    rem = [0] * (len(gen) - 1)
    for byte in data:
        factor = byte ^ rem[0]
        rem = rem[1:] + [0]
        for i, g in enumerate(gen[1:]):
            rem[i] ^= _gf_mul(factor, g)
    return rem


# ---------------------------------------------------------------------------
# Version tables (spec data, versions 1-10)
# (total data codewords, EC codewords per block, #blocks-group1,
#  data-codewords-per-block-group1, #blocks-group2, dc-per-block-group2)
# ---------------------------------------------------------------------------

_EC_TABLE = {
    # version: {level: (ec_per_block, g1_blocks, g1_dc, g2_blocks, g2_dc)}
    1: {"L": (7, 1, 19, 0, 0), "M": (10, 1, 16, 0, 0), "Q": (13, 1, 13, 0, 0), "H": (17, 1, 9, 0, 0)},
    2: {"L": (10, 1, 34, 0, 0), "M": (16, 1, 28, 0, 0), "Q": (22, 1, 22, 0, 0), "H": (28, 1, 16, 0, 0)},
    3: {"L": (15, 1, 55, 0, 0), "M": (26, 1, 44, 0, 0), "Q": (18, 2, 17, 0, 0), "H": (22, 2, 13, 0, 0)},
    4: {"L": (20, 1, 80, 0, 0), "M": (18, 2, 32, 0, 0), "Q": (26, 2, 24, 0, 0), "H": (16, 4, 9, 0, 0)},
    5: {"L": (26, 1, 108, 0, 0), "M": (24, 2, 43, 0, 0), "Q": (18, 2, 15, 2, 16), "H": (22, 2, 11, 2, 12)},
    6: {"L": (18, 2, 68, 0, 0), "M": (16, 4, 27, 0, 0), "Q": (24, 4, 19, 0, 0), "H": (28, 4, 15, 0, 0)},
    7: {"L": (20, 2, 78, 0, 0), "M": (18, 4, 31, 0, 0), "Q": (18, 2, 14, 4, 15), "H": (26, 4, 13, 1, 14)},
    8: {"L": (24, 2, 97, 0, 0), "M": (22, 2, 38, 2, 39), "Q": (22, 4, 18, 2, 19), "H": (26, 4, 14, 2, 15)},
    9: {"L": (30, 2, 116, 0, 0), "M": (22, 3, 36, 2, 37), "Q": (20, 4, 16, 4, 17), "H": (24, 4, 12, 4, 13)},
    10: {"L": (18, 2, 68, 2, 69), "M": (26, 4, 43, 1, 44), "Q": (24, 6, 19, 2, 20), "H": (28, 6, 15, 2, 16)},
    11: {"L": (20, 4, 81, 0, 0), "M": (30, 1, 50, 4, 51), "Q": (28, 4, 22, 4, 23), "H": (24, 3, 12, 8, 13)},
    12: {"L": (24, 2, 92, 2, 93), "M": (22, 6, 36, 2, 37), "Q": (26, 4, 20, 6, 21), "H": (28, 7, 14, 4, 15)},
    13: {"L": (26, 4, 107, 0, 0), "M": (22, 8, 37, 1, 38), "Q": (24, 8, 20, 4, 21), "H": (22, 12, 11, 4, 12)},
    14: {"L": (30, 3, 115, 1, 116), "M": (24, 4, 40, 5, 41), "Q": (20, 11, 16, 5, 17), "H": (24, 11, 12, 5, 13)},
    15: {"L": (22, 5, 87, 1, 88), "M": (24, 5, 41, 5, 42), "Q": (30, 5, 24, 7, 25), "H": (24, 11, 12, 7, 13)},
    16: {"L": (24, 5, 98, 1, 99), "M": (28, 7, 45, 3, 46), "Q": (24, 15, 19, 2, 20), "H": (30, 3, 15, 13, 16)},
    17: {"L": (28, 1, 107, 5, 108), "M": (28, 10, 46, 1, 47), "Q": (28, 1, 22, 15, 23), "H": (28, 2, 14, 17, 15)},
    18: {"L": (30, 5, 120, 1, 121), "M": (26, 9, 43, 4, 44), "Q": (28, 17, 22, 1, 23), "H": (28, 2, 14, 19, 15)},
    19: {"L": (28, 3, 113, 4, 114), "M": (26, 3, 44, 11, 45), "Q": (26, 17, 21, 4, 22), "H": (26, 9, 13, 16, 14)},
    20: {"L": (28, 3, 107, 5, 108), "M": (26, 3, 41, 13, 42), "Q": (30, 15, 24, 5, 25), "H": (28, 15, 15, 10, 16)},
    21: {"L": (28, 4, 116, 4, 117), "M": (26, 17, 42, 0, 0), "Q": (28, 17, 22, 6, 23), "H": (30, 19, 16, 6, 17)},
    22: {"L": (28, 2, 111, 7, 112), "M": (28, 17, 46, 0, 0), "Q": (30, 7, 24, 16, 25), "H": (24, 34, 13, 0, 0)},
    23: {"L": (30, 4, 121, 5, 122), "M": (28, 4, 47, 14, 48), "Q": (30, 11, 24, 14, 25), "H": (30, 16, 15, 14, 16)},
    24: {"L": (30, 6, 117, 4, 118), "M": (28, 6, 45, 14, 46), "Q": (30, 11, 24, 16, 25), "H": (30, 30, 16, 2, 17)},
    25: {"L": (26, 8, 106, 4, 107), "M": (28, 8, 47, 13, 48), "Q": (30, 7, 24, 22, 25), "H": (30, 22, 15, 13, 16)},
    26: {"L": (28, 10, 114, 2, 115), "M": (28, 19, 46, 4, 47), "Q": (28, 28, 22, 6, 23), "H": (30, 33, 16, 4, 17)},
    27: {"L": (30, 8, 122, 4, 123), "M": (28, 22, 45, 3, 46), "Q": (30, 8, 23, 26, 24), "H": (30, 12, 15, 28, 16)},
    28: {"L": (30, 3, 117, 10, 118), "M": (28, 3, 45, 23, 46), "Q": (30, 4, 24, 31, 25), "H": (30, 11, 15, 31, 16)},
    29: {"L": (30, 7, 116, 7, 117), "M": (28, 21, 45, 7, 46), "Q": (30, 1, 23, 37, 24), "H": (30, 19, 15, 26, 16)},
    30: {"L": (30, 5, 115, 10, 116), "M": (28, 19, 47, 10, 48), "Q": (30, 15, 24, 25, 25), "H": (30, 23, 15, 25, 16)},
    31: {"L": (30, 13, 115, 3, 116), "M": (28, 2, 46, 29, 47), "Q": (30, 42, 24, 1, 25), "H": (30, 23, 15, 28, 16)},
    32: {"L": (30, 17, 115, 0, 0), "M": (28, 10, 46, 23, 47), "Q": (30, 10, 24, 35, 25), "H": (30, 19, 15, 35, 16)},
    33: {"L": (30, 17, 115, 1, 116), "M": (28, 14, 46, 21, 47), "Q": (30, 29, 24, 19, 25), "H": (30, 11, 15, 46, 16)},
    34: {"L": (30, 13, 115, 6, 116), "M": (28, 14, 46, 23, 47), "Q": (30, 44, 24, 7, 25), "H": (30, 59, 16, 1, 17)},
    35: {"L": (30, 12, 121, 7, 122), "M": (28, 12, 47, 26, 48), "Q": (30, 39, 24, 14, 25), "H": (30, 22, 15, 41, 16)},
    36: {"L": (30, 6, 121, 14, 122), "M": (28, 6, 47, 34, 48), "Q": (30, 46, 24, 10, 25), "H": (30, 2, 15, 64, 16)},
    37: {"L": (30, 17, 122, 4, 123), "M": (28, 29, 46, 14, 47), "Q": (30, 49, 24, 10, 25), "H": (30, 24, 15, 46, 16)},
    38: {"L": (30, 4, 122, 18, 123), "M": (28, 13, 46, 32, 47), "Q": (30, 48, 24, 14, 25), "H": (30, 42, 15, 32, 16)},
    39: {"L": (30, 20, 117, 4, 118), "M": (28, 40, 47, 7, 48), "Q": (30, 43, 24, 22, 25), "H": (30, 10, 15, 67, 16)},
    40: {"L": (30, 19, 118, 6, 119), "M": (28, 18, 47, 31, 48), "Q": (30, 34, 24, 34, 25), "H": (30, 20, 15, 61, 16)},
}

_ALIGN_POS = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30],
    6: [6, 34], 7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46], 10: [6, 28, 50],
    11: [6, 30, 54], 12: [6, 32, 58], 13: [6, 34, 62],
    14: [6, 26, 46, 66], 15: [6, 26, 48, 70], 16: [6, 26, 50, 74],
    17: [6, 30, 54, 78], 18: [6, 30, 56, 82], 19: [6, 30, 58, 86],
    20: [6, 34, 62, 90],
    21: [6, 28, 50, 72, 94], 22: [6, 26, 50, 74, 98], 23: [6, 30, 54, 78, 102],
    24: [6, 28, 54, 80, 106], 25: [6, 32, 58, 84, 110],
    26: [6, 30, 58, 86, 114], 27: [6, 34, 62, 90, 118],
    28: [6, 26, 50, 74, 98, 122], 29: [6, 30, 54, 78, 102, 126],
    30: [6, 26, 52, 78, 104, 130], 31: [6, 30, 56, 82, 108, 134],
    32: [6, 34, 60, 86, 112, 138], 33: [6, 30, 58, 86, 114, 142],
    34: [6, 34, 62, 90, 118, 146],
    35: [6, 30, 54, 78, 102, 126, 150], 36: [6, 24, 50, 76, 102, 128, 154],
    37: [6, 28, 54, 80, 106, 132, 158], 38: [6, 32, 58, 84, 110, 136, 162],
    39: [6, 26, 54, 82, 110, 138, 166], 40: [6, 30, 58, 86, 114, 142, 170],
}

_LEVEL_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}


def _data_capacity_bytes(version: int, level: str) -> int:
    ec, g1b, g1dc, g2b, g2dc = _EC_TABLE[version][level]
    return g1b * g1dc + g2b * g2dc


def pick_version(payload_len: int, level: str = "M") -> int:
    for v in range(1, 41):
        # byte mode: 4 mode bits + 8 count bits (v1-9) / 16 (v10+)
        count_bits = 8 if v <= 9 else 16
        if _data_capacity_bytes(v, level) * 8 >= 4 + count_bits + 8 * payload_len:
            return v
    raise ValueError(f"payload too long for v<=40: {payload_len} bytes")


# ---------------------------------------------------------------------------
# Bit assembly
# ---------------------------------------------------------------------------


class _Bits:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def to_bytes(self) -> List[int]:
        out = []
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i : i + 8]:
                b = (b << 1) | bit
            b <<= 8 - min(8, len(self.bits) - i)
            out.append(b)
        return out


def _make_codewords(payload: bytes, version: int, level: str) -> List[int]:
    cap = _data_capacity_bytes(version, level)
    bits = _Bits()
    bits.put(0b0100, 4)  # byte mode
    bits.put(len(payload), 8 if version <= 9 else 16)
    for b in payload:
        bits.put(b, 8)
    # terminator (up to 4 zero bits), byte-align, pad with 0xEC/0x11
    bits.put(0, min(4, cap * 8 - len(bits.bits)))
    while len(bits.bits) % 8:
        bits.bits.append(0)
    data = bits.to_bytes()
    pads = [0xEC, 0x11]
    i = 0
    while len(data) < cap:
        data.append(pads[i % 2])
        i += 1

    # split into RS blocks, interleave data then EC
    ec, g1b, g1dc, g2b, g2dc = _EC_TABLE[version][level]
    blocks, pos = [], 0
    for _ in range(g1b):
        blocks.append(data[pos : pos + g1dc]); pos += g1dc
    for _ in range(g2b):
        blocks.append(data[pos : pos + g2dc]); pos += g2dc
    ec_blocks = [rs_encode(b, ec) for b in blocks]

    out = []
    for i in range(max(len(b) for b in blocks)):
        for b in blocks:
            if i < len(b):
                out.append(b[i])
    for i in range(ec):
        for b in ec_blocks:
            out.append(b[i])
    return out


# ---------------------------------------------------------------------------
# Matrix construction
# ---------------------------------------------------------------------------


def _place_function_patterns(version: int):
    n = 17 + 4 * version
    m = np.full((n, n), -1, np.int8)  # -1 = free for data

    def finder(r, c):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                rr, cc = r + dr, c + dc
                if not (0 <= rr < n and 0 <= cc < n):
                    continue
                inside = 0 <= dr <= 6 and 0 <= dc <= 6
                ring = inside and (dr in (0, 6) or dc in (0, 6))
                core = inside and (2 <= dr <= 4 and 2 <= dc <= 4)
                m[rr, cc] = 1 if (ring or core) else 0

    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)

    # timing
    for i in range(8, n - 8):
        m[6, i] = m[i, 6] = 1 - (i % 2)

    # alignment patterns — placed at every grid position except the three that
    # coincide with finder corners (they DO overlay the timing lines at v≥7)
    centers = _ALIGN_POS[version]
    if centers:
        lo, hi = centers[0], centers[-1]
        skip = {(lo, lo), (lo, hi), (hi, lo)}
        for r in centers:
            for c in centers:
                if (r, c) in skip:
                    continue
                for dr in range(-2, 3):
                    for dc in range(-2, 3):
                        m[r + dr, c + dc] = 1 if max(abs(dr), abs(dc)) != 1 else 0

    # reserve format info areas
    for i in range(9):
        if m[8, i] == -1:
            m[8, i] = 0
        if m[i, 8] == -1:
            m[i, 8] = 0
    for i in range(8):
        if m[8, n - 1 - i] == -1:
            m[8, n - 1 - i] = 0
        if m[n - 1 - i, 8] == -1:
            m[n - 1 - i, 8] = 0
    m[n - 8, 8] = 1  # dark module

    # version info (v >= 7)
    if version >= 7:
        for r in range(6):
            for c in range(n - 11, n - 8):
                m[r, c] = 0
                m[c, r] = 0
    return m


_BCH_FORMAT_G = 0b10100110111
_BCH_VERSION_G = 0b1111100100101


def _bch(value: int, gen: int, total_bits: int, value_bits: int) -> int:
    v = value << (total_bits - value_bits)
    glen = gen.bit_length()
    r = v
    while r.bit_length() >= glen:
        r ^= gen << (r.bit_length() - glen)
    return (value << (total_bits - value_bits)) | r


def _format_bits(level: str, mask: int) -> int:
    val = (_LEVEL_BITS[level] << 3) | mask
    return _bch(val, _BCH_FORMAT_G, 15, 5) ^ 0b101010000010010


def _version_bits(version: int) -> int:
    return _bch(version, _BCH_VERSION_G, 18, 6)


_MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def encode_qr_matrix(payload, level: str = "M", mask: int = 0,
                     version: Optional[int] = None) -> np.ndarray:
    """Encode ``payload`` (str/bytes) → bool matrix (True = dark module)."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    if version is None:
        version = pick_version(len(payload), level)
    n = 17 + 4 * version

    template = _place_function_patterns(version)
    m = template.copy()
    codewords = _make_codewords(payload, version, level)

    # zigzag data placement
    bit_iter = iter(
        (byte >> (7 - k)) & 1 for byte in codewords for k in range(8)
    )
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:  # skip the vertical timing column entirely
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for cc in (col, col - 1):
                if template[r, cc] == -1:
                    bit = next(bit_iter, 0)
                    if _MASKS[mask](r, cc):
                        bit ^= 1
                    m[r, cc] = bit
        upward = not upward
        col -= 2

    # format info — two copies, bit i = (f >> i) & 1 (LSB first, per spec):
    # copy A hugs the top-left finder; copy B splits bottom-left/top-right
    f = _format_bits(level, mask)
    b = [(f >> i) & 1 for i in range(15)]
    coords_a = [(0, 8), (1, 8), (2, 8), (3, 8), (4, 8), (5, 8), (7, 8), (8, 8),
                (8, 7), (8, 5), (8, 4), (8, 3), (8, 2), (8, 1), (8, 0)]
    coords_b = [(8, n - 1), (8, n - 2), (8, n - 3), (8, n - 4), (8, n - 5),
                (8, n - 6), (8, n - 7), (8, n - 8),
                (n - 7, 8), (n - 6, 8), (n - 5, 8), (n - 4, 8), (n - 3, 8),
                (n - 2, 8), (n - 1, 8)]
    for (r, c), bit in zip(coords_a, b):
        m[r, c] = bit
    for (r, c), bit in zip(coords_b, b):
        m[r, c] = bit

    # version info (v >= 7): 18 bits in two 6x3 blocks
    if version >= 7:
        v = _version_bits(version)
        for i in range(18):
            bit = (v >> i) & 1
            m[i // 3, n - 11 + i % 3] = bit
            m[n - 11 + i % 3, i // 3] = bit

    return m.astype(bool)


def render_qr(payload, module_px: int = 4, border_modules: int = 4,
              level: str = "M", mask: int = 0) -> np.ndarray:
    """Encode and rasterize to a uint8 grayscale image (0=dark, 255=light)."""
    matrix = encode_qr_matrix(payload, level=level, mask=mask)
    img = np.where(matrix, 0, 255).astype(np.uint8)
    img = np.kron(img, np.ones((module_px, module_px), np.uint8))
    pad = border_modules * module_px
    return np.pad(img, pad, constant_values=255)
