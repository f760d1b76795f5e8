"""PyTorch port: ``cv2.QRCodeDetector``'s decoder rebuilt without OpenCV
(``twinvoice_tpu_torch/qr/cvdecode.py`` on ``csrc/host_qrdecode.cpp``)
against the installed OpenCV 5.0, and the default ``QrPipeline`` that runs it
against the JAX package's.

Tolerance: none; strings, ``ok`` flags, straight module grids and raises
equal (the grids where OpenCV's homography is a 4-point fit: where it refits
it by RANSAC and Levenberg-Marquardt, on version 2 and 7+ codes with
alignment markers found, the port reaches the same minimum but not the last
bit, and the payloads are held). Held: the primitives the decoder rebuilds (warpPerspective at
INTER_NEAREST, INTER_AREA resizes, perspectiveTransform; the homography's
float32 inverse; matchTemplate's maxima, which OpenCV computes with IPP's
FFT, held to 1e-6 and to equal locations); ``decode`` on exact quads of
codes at versions 1-40, levels L/M/Q/H, masks 0-7, numeric, alphanumeric,
byte, kanji and ECI, with codewords flipped to the correction limit and
past it, mirrored and transposed; crafted segment streams and non-UTF-8
payloads; ``detect_and_decode_multi`` / ``detect_and_decode`` on warped and
paired codes and on inputs where cv2 raises; the default scan on the QR
fixture's sweep pages against JAX's default scan; and the generator's state
after each ``opencv_decode`` candidate of a scan (cv2's read back through
``cv2.randu``: the low 16 bits of each draw).
"""

import os
import sys

import cv2
import numpy as np
import pytest

from twinvoice_tpu.qr import detect as jdetect
from twinvoice_tpu.qr.encode import encode_qr_matrix
from twinvoice_tpu_torch.ops.host_image import resize_area_u8
from twinvoice_tpu_torch.qr import cvdecode, locate
from twinvoice_tpu_torch.qr import detect as tdetect

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import make_torch_smoke_qrdecode as mk  # noqa: E402

QR_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_smoke_qr.npz")


def ptr(a):
    import ctypes

    return a.ctypes.data_as(ctypes.c_void_p)


def cv2_decode(gray, quad, alignment=True):
    det = cv2.QRCodeDetector()
    det.setUseAlignmentMarkers(alignment)
    try:
        text, straight = det.decode(gray, np.float32(quad).reshape(1, 4, 2))
    except cv2.error:
        return "err", None
    except UnicodeDecodeError:
        return "uni", None
    if straight is None or not straight.size:
        return None, None
    return text, straight


def port_decode(gray, quad, alignment=True):
    try:
        return cvdecode.decode_quad(gray, quad, alignment)
    except cvdecode.CvError:
        return "err", None
    except UnicodeDecodeError:
        return "uni", None


def refined(version):
    """Whether OpenCV refits the homography of a decoded code of ``version``
    on more than 4 points (RANSAC, then its Levenberg-Marquardt), which the
    port follows to its minimum but not to the last bit: version 2 (5
    points) and 7 and up (up to 9)."""
    return version == 2 or version >= 7


def assert_decodes_alike(gray, quad, version=None):
    """The payload (or the failure, or the raise) equal with alignment
    markers on and off; the straight module grid equal too, except where
    OpenCV refines its homography (``refined``)."""
    for alignment in (True, False):
        want, want_grid = cv2_decode(gray, quad, alignment)
        got, grid = port_decode(gray, quad, alignment)
        assert got == want, (alignment, got, want)
        exact = not alignment or (version is not None and not refined(version))
        if want_grid is not None and exact:
            np.testing.assert_array_equal(grid, want_grid)


def quad_of(m, px=4, border=4):
    a, b = border * px, (border + m.shape[0]) * px
    return [[a, a], [b, a], [b, b], [a, b]]


def cv2_calls(gray):
    return mk.cv2_results(gray)


# ------------------------------------------------------------------ primitives

def test_primitives_equal_cv2():
    lib = cvdecode.load()
    rng = np.random.default_rng(7)
    for t in range(40):
        img = (rng.random((int(rng.integers(30, 160)), int(rng.integers(30, 160)))) > 0.5)
        img = img.astype(np.uint8) * 255
        h, w = img.shape
        src = (np.float32([[0, 0], [w, 0], [w, h], [0, h]])
               + rng.normal(scale=12, size=(4, 2))).astype(np.float32)
        side = 251 if t % 2 else 251 + int(rng.integers(1, 120))
        dst = np.float32([[0, 0], [side, 0], [side, side], [0, side]])
        H = np.zeros(9)
        assert lib.qr_dec_homography(ptr(src), ptr(dst), 4, 0, 0.0, ptr(H))
        Hc = cv2.findHomography(src, dst)[0]
        np.testing.assert_allclose(H.reshape(3, 3), Hc, rtol=1e-12, atol=1e-12)
        # the warp of the port's own matrix is cv2's warp of cv2's
        out = np.zeros((side, side), np.uint8)
        assert lib.qr_dec_warp_nearest(ptr(img), h, w, ptr(H), side, side, ptr(out))
        np.testing.assert_array_equal(
            out, cv2.warpPerspective(img, Hc, (side, side), flags=cv2.INTER_NEAREST))
        pts = (rng.random((6, 2)) * 200).astype(np.float32)
        got = pts.copy()
        lib.qr_dec_perspective_transform(ptr(got), 6, ptr(np.ascontiguousarray(Hc.ravel())))
        np.testing.assert_array_equal(got, cv2.perspectiveTransform(pts[None], Hc)[0])
    for t in range(60):
        img = (rng.random((int(rng.integers(3, 90)), int(rng.integers(3, 90)))) * 255)
        img = img.astype(np.uint8)
        h, w = img.shape
        dw, dh = (3, 6) if t % 5 == 0 else (max(1, int(w * rng.uniform(0.2, 3.2))),
                                            max(1, int(h * rng.uniform(0.2, 3.2))))
        out = np.zeros((dh, dw), np.uint8)
        lib.qr_dec_resize_area(ptr(img), h, w, dw, dh, ptr(out))
        np.testing.assert_array_equal(out, cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA))
    marker = np.array([[0, 0, 0, 0, 0], [0, 1, 1, 1, 0], [0, 1, 0, 1, 0], [0, 1, 1, 1, 0],
                       [0, 0, 0, 0, 0]], np.uint8) * 255
    for k in (7, 12, 23, 31):
        tpl = cv2.resize(marker, (k, k), interpolation=cv2.INTER_AREA)
        win = cv2.resize((rng.random((6, 6)) > 0.5).astype(np.uint8) * 255,
                         (round(k * 8.8 / 5),) * 2, interpolation=cv2.INTER_NEAREST)
        win[2:2 + k, 3:3 + k] = tpl
        loc = np.zeros(2, np.int32)
        v = lib.qr_dec_match_template(ptr(win), win.shape[0], win.shape[1], ptr(tpl), k, k,
                                      ptr(loc))
        _, mv, _, ml = cv2.minMaxLoc(cv2.matchTemplate(win, tpl, cv2.TM_CCOEFF_NORMED))
        assert abs(v - mv) < 1e-6 and tuple(loc) == ml


# ------------------------------------------------------------ codes on quads

CODES = [(v, "LMQH"[i % 4], i % 8) for i, v in enumerate(
    (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 21, 22, 25, 28, 31, 34, 37, 40))]


@pytest.mark.parametrize("version,level,mask", CODES)
def test_byte_codes_equal_cv2(version, level, mask):
    from twinvoice_tpu.qr.encode import _data_capacity_bytes

    rng = np.random.default_rng(version * 10 + mask)
    n = min(int(rng.integers(2, 30)), _data_capacity_bytes(version, level) - 3)
    payload = bytes(rng.integers(33, 127, n).astype(np.uint8))
    m = encode_qr_matrix(payload, level=level, mask=mask, version=version)
    px = 4
    gray = mk.render(m, px)
    assert_decodes_alike(gray, quad_of(m, px), version)
    assert port_decode(gray, quad_of(m, px))[0] == payload.decode()


@pytest.mark.parametrize("mode", ["NUMERIC", "ALPHANUMERIC", "BYTE", "KANJI", "ECI", "AUTO"])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_cv2_encoder_modes_equal_cv2(mode, level):
    text = {"NUMERIC": "0123456789" * 3, "ALPHANUMERIC": "HELLO WORLD $%*+-./:",
            "BYTE": "café 珍珠", "KANJI": "漢",
            "ECI": "珍珠奶茶 eci", "AUTO": "AUTO 123 mixed"}[mode]
    params = cv2.QRCodeEncoder_Params()
    params.mode = getattr(cv2, f"QRCODE_ENCODER_MODE_{mode}")
    params.correction_level = level
    m = cv2.QRCodeEncoder_create(params).encode(text) < 128
    gray = mk.render(m, 4, border=2)
    assert_decodes_alike(gray, quad_of(m, 4, 2))
    assert cv2_calls(gray) == chip_results(gray)


DAMAGE = [(2, "L", 0, 4), (2, "L", 0, 5), (2, "L", 0, 6), (5, "Q", 1, 9), (5, "Q", 1, 10),
          (7, "M", 3, 9), (7, "M", 3, 10), (8, "L", 1, 11), (8, "L", 1, 12), (9, "L", 0, 15),
          (9, "L", 1, 15), (13, "H", 4, 11), (21, "M", 0, 12), (21, "Q", 5, 14),
          (29, "M", 0, 13), (40, "L", 7, 15)]


@pytest.mark.parametrize("version,level,block,k", DAMAGE)
def test_damaged_codes_equal_cv2(version, level, block, k):
    """Codewords flipped in one block, to the correction limit and past it:
    OpenCV's Reed-Solomon (an even number of syndromes, its Berlekamp-Massey,
    which skips the first update) and its extraction (the version blocks one
    module off; version 21's misprinted alignment centre) decide alike."""
    rng = np.random.default_rng(version * 100 + k)
    m = mk.damaged(version, level, block, k, rng)
    px = 3 if version < 20 else 2
    assert_decodes_alike(mk.render(m, px), quad_of(m, px), version)


@pytest.mark.parametrize("flip", ["mirror", "transpose"])
@pytest.mark.parametrize("version", [1, 3, 6, 10])
def test_mirrored_codes_equal_cv2(flip, version):
    m = encode_qr_matrix(b"MIRRORED 1234567", level="MQ"[version % 2], mask=version % 8,
                         version=version)
    m = m[:, ::-1] if flip == "mirror" else m.T
    gray = mk.render(m, 4)
    assert cv2_calls(gray) == chip_results(gray)


PAYLOADS = {
    "big5": "**珍珠奶茶:1:60".encode("big5"),
    "latin1": "café crème".encode("latin-1"), "c1": bytes([0x80, 0x85, 0x9F, 0x41]),
    "utf8": "**雞排:2:80".encode(), "nul": b"ab\x00cd", "overlong": b"A\xc0\x80B",
    "surrogate": b"x\xed\xa0\x80y", "f5": b"\xf5\x80\x80\x80z",
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_byte_payloads_equal_cv2(name):
    """ISO-8859-1 where the bytes are neither ASCII nor UTF-8 (Big5 comes back
    as mojibake); OpenCV's lax UTF-8 check passes overlong and surrogate
    forms, which cv2's binding refuses (``UnicodeDecodeError``); a NUL ends
    the string."""
    m = encode_qr_matrix(PAYLOADS[name], level="M", mask=2)
    gray = mk.render(m, 4)
    assert_decodes_alike(gray, quad_of(m), (m.shape[0] - 17) // 4)
    assert cv2_calls(gray) == chip_results(gray)


SEGMENTS = {
    "eci26": mk.eci_segment(26) + mk.byte_segment("珍珠".encode(), 5),
    "eci26_bad": mk.eci_segment(26) + mk.byte_segment(b"\xff\xfe", 5),
    "eci25": mk.eci_segment(25) + mk.byte_segment(b"\x00A", 5),
    "eci3_latin": mk.eci_segment(3) + mk.byte_segment("café".encode("latin-1"), 5),
    "eci_2byte": mk.eci_segment(1000) + mk.byte_segment(b"abc", 5),
    "eci_3byte": mk.eci_segment(100000) + mk.byte_segment(b"abc", 5),
    "byte_then_eci": mk.byte_segment(b"ab", 5) + mk.eci_segment(26) + mk.byte_segment(
        "é".encode(), 5),
    "numeric_bad": mk.bits_of(1, 4) + mk.bits_of(6, 10) + mk.bits_of(999, 10) + mk.bits_of(1023, 10),
    "alpha_bad": mk.bits_of(2, 4) + mk.bits_of(3, 9) + mk.bits_of(2047, 11) + mk.bits_of(63, 6),
    "structured": mk.bits_of(3, 4) + mk.bits_of(0, 4) + mk.bits_of(1, 4) + mk.bits_of(0x5A, 8)
    + mk.byte_segment(b"part", 5),
    "mode5": mk.bits_of(5, 4) + mk.bits_of(0, 20), "mode15": mk.bits_of(15, 4),
    "short_count": mk.bits_of(4, 4) + mk.bits_of(200, 8) + mk.bits_of(65, 8), "empty": [],
}


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_segment_streams_equal_cv2(name):
    """ECI designators of one to three bytes, an ECI that starts the payload
    over, out-of-range numeric and alphanumeric values, modes OpenCV refuses
    (cv2.error), a byte count past the data."""
    m = mk.matrix_of(*mk.blocks_of(SEGMENTS[name], 5, "L"), 5, "L", 3)
    assert_decodes_alike(mk.render(m, 4), quad_of(m), 5)


def test_structured_append_joined_as_cv2():
    params = cv2.QRCodeEncoder_Params()
    params.structure_number = 3
    parts = [np.kron(p, np.ones((3, 3), np.uint8)) for p in cv2.QRCodeEncoder_create(
        params).encodeStructuredAppend("STRUCTURED APPEND 0123456789 " * 3)]
    pad = [np.pad(p, 12, constant_values=255) for p in parts]
    for order in ([0, 1, 2], [2, 0, 1], [0, 2], [1, 0, 0, 2]):
        gray = np.hstack([pad[i] for i in order])
        assert cv2_calls(gray) == chip_results(gray), order


# ------------------------------------------------------------ detect-and-decode


def chip_results(gray):
    import chip_smoke

    return chip_smoke.cvdecode_results(gray)


def test_detect_and_decode_equal_cv2_on_warped_and_paired_codes():
    rng = np.random.default_rng(11)
    header = encode_qr_matrix("AB12345678114090912345678:00000120:0:0:0:AAAA", level="M", mask=1)
    items = encode_qr_matrix("**珍珠奶茶:1:60", level="L", mask=6)
    a, b = mk.render(header, 3), mk.render(items, 3)
    h = max(a.shape[0], b.shape[0])
    pair = np.hstack([np.pad(a, ((0, h - a.shape[0]), (0, 24)), constant_values=255),
                      np.pad(b, ((0, h - b.shape[0]), (0, 0)), constant_values=255)])
    cases = [pair, cv2.resize(pair, None, fx=2.3, fy=2.3, interpolation=cv2.INTER_LINEAR)]
    cases += [mk.warped(mk.render(header, 4), kind, rng)
              for kind in ("persp", "soft", "r7", "lowc", "blur")]
    for v in (2, 7, 15):
        m = encode_qr_matrix(bytes(rng.integers(48, 90, 20).astype(np.uint8)), level="Q",
                             mask=v % 8, version=v)
        img = mk.render(m, 4)
        h, w = img.shape
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = (src + rng.normal(scale=10, size=(4, 2))).astype(np.float32)
        cases.append(cv2.warpPerspective(img, cv2.getPerspectiveTransform(src, dst), (w, h),
                                         borderValue=255))
    for gray in cases:
        assert cv2_calls(gray) == chip_results(gray)


def test_raising_inputs_equal_cv2():
    """Inputs where cv2 raises ``cv2.error`` (an empty image; a refused mode
    in a located code) raise CvError; 20 pixels or less reads nothing."""
    with pytest.raises(cv2.error):
        cv2.QRCodeDetector().detectAndDecode(np.zeros((0, 0), np.uint8))
    with pytest.raises(cvdecode.CvError):
        cvdecode.detect_and_decode(np.zeros((0, 0), np.uint8))
    m = mk.matrix_of(*mk.blocks_of(mk.bits_of(5, 4) + mk.bits_of(0, 20), 5, "L"), 5, "L", 3)
    gray = mk.render(m, 4)
    assert cv2_calls(gray) == chip_results(gray) == {"multi": ["err"], "single": ["err"]}
    tiny = np.full((20, 20), 255, np.uint8)
    assert chip_results(tiny) == cv2_calls(tiny) == {"multi": ["ok", False, []],
                                                      "single": ["ok", ""]}
    with pytest.raises(cvdecode.CvError):  # a quad of zero area
        cvdecode.decode_quad(gray, [[5, 5], [5, 5], [5, 5], [5, 5]])
    with pytest.raises(cv2.error):
        cv2.QRCodeDetector().decode(gray, np.float32([[5, 5]] * 4).reshape(1, 4, 2))


# ------------------------------------------------------------ the default scan


@pytest.fixture(scope="module")
def sweep():
    with np.load(QR_FIXTURE) as z:
        portraits = {s: z[f"portrait_{s}"] for s in (0, 5)}
    return {f"{s}_{sc}": resize_area_u8(p, fx=sc, fy=sc)
            for s, p in portraits.items() for sc in mk.SWEEP_SCALES}


def test_default_scan_equals_jax_on_the_sweep(sweep):
    jq, tq = jdetect.QrPipeline(), tdetect.QrPipeline()
    assert tq.decoders == [tdetect.native_decode, tdetect.opencv_decode]
    differ = []
    for key, page in sweep.items():
        cv2.setRNGSeed(0)
        want = jq.scan(page)
        locate.set_rng_seed(0)
        tdetect.passes.clear()
        got = tq.scan(page)
        assert got == want, key
        assert not [k for k in tdetect.passes if "skip" in k]
        native = tdetect.QrPipeline(decoders=[tdetect.native_decode])
        locate.set_rng_seed(0)
        if native.scan(page) != got:
            differ.append(key)
    # the pages where cv2's decoder changes the result: 0.49, 0.54, 0.55, 0.61
    assert sorted(differ) == sorted(f"{s}_{sc}" for s in (0, 5) for sc in (0.49, 0.54, 0.55, 0.61))


class StopScan(BaseException):
    pass


def stopped_after(pipe, module, page, k, seed):
    """Scan ``page`` until the ``k``-th call of ``module.opencv_decode``
    returns. → the number of calls made."""
    calls = []
    original = module.opencv_decode

    def counted(rgb):
        out = original(rgb)
        calls.append(1)
        if len(calls) == k:
            raise StopScan
        return out

    pipe.decoders = [module.native_decode, counted]
    seed()
    try:
        pipe.scan(page)
    except StopScan:
        pass
    return len(calls)


@pytest.mark.parametrize("key", ["0_0.45", "0_0.49", "5_0.54", "0_0.55", "5_0.61"])
def test_generator_state_after_each_candidate(sweep, key):
    """The locator and the decoder share one per-thread generator: after each
    ``opencv_decode`` candidate of a scan (the region pass's locator calls
    before it and between), the next draws of cv2's ``theRNG()`` and of the
    port's generator are alike."""
    page = sweep[key]
    jq, tq = jdetect.QrPipeline(), tdetect.QrPipeline()
    total = stopped_after(jq, jdetect, page, 10 ** 6, lambda: cv2.setRNGSeed(0))
    assert total == stopped_after(tq, tdetect, page, 10 ** 6, lambda: locate.set_rng_seed(0))
    assert total >= 1
    for k in range(1, total + 1):
        stopped_after(jq, jdetect, page, k, lambda: cv2.setRNGSeed(0))
        want = np.zeros(8, np.int32)
        cv2.randu(want, 0, 1 << 16)
        stopped_after(tq, tdetect, page, k, lambda: locate.set_rng_seed(0))
        got = [locate.rng_next() & 0xFFFF for _ in range(8)]
        assert got == want.tolist(), (key, k)
