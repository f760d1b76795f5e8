"""PyTorch port: ``TorchOcrEngine`` on the CPU against ``JaxOcrEngine``, both
with the bundled recognizer, on crops rendered here.

Tolerance: texts exactly equal in every mode ("text", "amount", "invoice",
"date") under every decode policy ("greedy", "beam_lm", "cascade");
confidences within 1e-5 (a mean of float32 probabilities, or a margin
pseudo-confidence ``exp(Δ/T)`` of log-prob sums). The line split gives the
same parts, pixel for pixel, and the copied decoders and LM give equal
outputs on the same top-K arrays.
"""

import hashlib

import cv2
import numpy as np
import pytest

from twinvoice_tpu.ocr.jaxocr import charset as jcharset
from twinvoice_tpu.ocr.jaxocr import lm as jlm
from twinvoice_tpu.ocr.jaxocr.data import render_line
from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine
from twinvoice_tpu_torch.ocr.base import OcrResult
from twinvoice_tpu_torch.ocr.torchocr import charset as tcharset
from twinvoice_tpu_torch.ocr.torchocr import lm as tlm
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine, prepare_crop

CONF_ATOL = 1e-5
MODES = ("text", "amount", "invoice", "date")
POLICIES = ("greedy", "beam_lm", "cascade")
TEXTS = ("AB12345678", "QK-80417265", "2025-09-09", "2024/12/31", "4,580", "NT$120",
         "12999", "TOTAL 36", "ZX00992471", "2023.07.21")


def _scaled(img, f):
    h, w = img.shape
    return cv2.resize(img, (max(1, int(w * f)), max(1, int(h * f))),
                      interpolation=cv2.INTER_AREA if f < 1 else cv2.INTER_LINEAR)


def _tight(img):
    ys, xs = np.nonzero(img < 200)
    return img[max(0, ys.min() - 2):ys.max() + 3, max(0, xs.min() - 2):xs.max() + 3]


def make_crops(seed=0):
    """→ list of (label, crop): uint8 gray or RGB arrays and PIL images."""
    from PIL import Image

    from twinvoice_tpu.data.synthetic import render_invoice

    rng = np.random.default_rng(seed)
    crops = []
    for i, text in enumerate(TEXTS):
        line = _tight(render_line(text, rng))
        f = (0.6, 0.9, 1.4, 2.2, 3.0)[i % 5]
        m = (0, 3, 12, 30)[i % 4]
        crops.append((f"line {text} x{f} margin {m}",
                      np.pad(_scaled(line, f), m, constant_values=255)))
    for i, text in enumerate(TEXTS[:4]):
        crops.append((f"dot {text}", render_line(text, rng, dot=True)))
    a, b, c = (_scaled(_tight(render_line(t, rng)), 1.6) for t in TEXTS[4:7])
    w = max(a.shape[1], b.shape[1], c.shape[1])
    pad = [np.pad(x, ((0, 0), (0, w - x.shape[1])), constant_values=255) for x in (a, b, c)]
    gap = np.full((12, w), 255, np.uint8)
    crops.append(("two lines", np.vstack([pad[0], gap, pad[1]])))
    crops.append(("three lines", np.vstack([pad[0], gap, pad[1], gap, pad[2]])))
    crops.append(("two lines, touching", np.vstack([pad[1], pad[2]])))
    line = _tight(render_line(TEXTS[0], rng))
    crops.append(("inverted", 255 - line))
    crops.append(("low contrast", (line.astype(np.float32) * 0.15 + 190).astype(np.uint8)))
    crops.append(("flat", np.full((30, 80), 200, np.uint8)))
    crops.append(("tiny", line[:6, :10].copy()))
    for seed_inv, dot in ((3, False), (21, True)):
        img, boxes = render_invoice("AB12345678", "2025-09-09", 4580, seed=seed_inv,
                                    dot_print=dot)
        rgb = np.asarray(img)
        for field, (x1, y1, x2, y2) in boxes.items():
            crops.append((f"invoice {seed_inv} {field} RGB", rgb[y1:y2, x1:x2]))
        x1, y1, x2, y2 = boxes["invoice_no"]
        crops.append((f"invoice {seed_inv} PIL", img.crop((x1 - 6, y1 - 6, x2 + 6, y2 + 6))))
        assert isinstance(crops[-1][1], Image.Image)
    return crops


CROPS = make_crops()
# the mode × policy sweep reads a subset holding every kind of crop (scaled
# lines, dot-matrix, multi-line stacks, inverted, low-contrast, flat, tiny,
# RGB and PIL field crops); the mixed-mode test reads them all
SWEEP = [CROPS[i] for i in (0, 3, 6, 9, 10, 12, 14, 15, 16, 17, 18, 19, 20, 21, 23,
                            24, 26, 28)]


def _memoized(infer, rows_of):
    """``infer`` with its outputs kept per input: the decode policies differ
    only on the host, so the three policies of a mode reuse one forward."""
    cache = {}

    def call(*args):
        x = np.ascontiguousarray(rows_of(*args))
        key = (x.shape, hashlib.sha1(x.tobytes()).hexdigest())
        if key not in cache:
            cache[key] = infer(*args)
        return cache[key]

    return call


@pytest.fixture(scope="module")
def engines():
    je, te = JaxOcrEngine(), TorchOcrEngine(device="cpu")
    je._infer = _memoized(je._infer, lambda p, s, x: np.asarray(x))
    te._infer = _memoized(te._infer, lambda rows: np.stack(rows))
    return je, te


def _compare(got, want, labels):
    assert len(got) == len(want)
    for g, w, label in zip(got, want, labels):
        assert isinstance(g, OcrResult) and g.engine == "torchocr"
        assert g.text == w.text, (label, g.text, w.text)
        if w.confidence is None:
            assert g.confidence is None, label
        else:
            assert abs(g.confidence - w.confidence) <= CONF_ATOL, (label, g, w)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", MODES)
def test_read_batch_equals_jax(engines, mode, policy):
    je, te = engines
    je.decode = te.decode = policy
    images = [c for _, c in SWEEP] + [None]
    modes = [mode] * len(images)
    want = je.read_batch(images, modes=modes)
    got = te.read_batch(images, modes=modes)
    _compare(got, want, [label for label, _ in SWEEP] + ["None"])
    assert sum(bool(w.text) for w in want) >= len(SWEEP) // 2


def test_read_batch_mixed_modes_and_read(engines):
    je, te = engines
    je.decode = te.decode = "cascade"
    images = [c for _, c in CROPS]
    modes = [MODES[i % 4] for i in range(len(images))]
    _compare(te.read_batch(images, modes=modes), je.read_batch(images, modes=modes),
             [label for label, _ in CROPS])
    for (label, crop), mode in list(zip(CROPS, modes))[::14]:
        _compare([te.read(crop, mode)], [je.read(crop, mode)], [label])


def test_split_lines_same_parts(engines):
    _, te = engines
    n_split = 0
    for label, crop in CROPS:
        want = JaxOcrEngine._split_lines(crop)
        got = te._split_lines(crop)
        assert len(got) == len(want), label
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=label)
        n_split += len(want) > 1
    assert n_split >= 3


def test_prepare_crop_equals_jax():
    from twinvoice_tpu.ocr.jaxocr.engine import prepare_crop as jax_prepare_crop

    for label, crop in CROPS:
        want = jax_prepare_crop(crop)
        got = prepare_crop(crop)
        if want is None:
            assert got is None, label
        else:
            np.testing.assert_array_equal(got, want, err_msg=label)
    assert prepare_crop(np.zeros((0, 4), np.uint8)) is None


def test_unavailable_engine_reads_nothing(tmp_path):
    te = TorchOcrEngine(weights_dir=str(tmp_path / "missing.npz"), device="cpu")
    assert not te.available()
    assert te.read_batch([CROPS[0][1]]) == [OcrResult("", "torchocr")]


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` means the card: with none present the engine raises
    rather than fall back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOcrEngine()


@pytest.fixture(scope="module")
def topk_rows(engines):
    """JAX's device half on the prepared crops: the arrays both decoders read."""
    je, _ = engines
    rows = [r for r in (prepare_crop(c) for _, c in CROPS) if r is not None]
    out = je._infer(je._params, je._state, np.stack(rows)[..., None])
    return je.charset.chars, [np.asarray(a) for a in out]


def test_decoders_equal_on_the_same_topk(topk_rows):
    chars, (ids, _, tk_ids, tk_lp, blank_lp) = topk_rows
    jcs, tcs = jcharset.Charset(chars), tcharset.Charset(chars)
    jl, tl = jlm.default_lm(), tlm.default_lm()
    for k in range(0, len(ids), 2):
        assert tcs.greedy_ctc_decode(ids[k]) == jcs.greedy_ctc_decode(ids[k])
        for lm_j, lm_t in ((None, None), (jl, tl)):
            assert tcharset.beam_ctc_decode(tcs, tk_ids[k], tk_lp[k], blank_lp[k], lm=lm_t) == \
                jcharset.beam_ctc_decode(jcs, tk_ids[k], tk_lp[k], blank_lp[k], lm=lm_j)
        for mode in ("invoice", "date", "amount"):
            assert tcharset.constrained_ctc_decode(
                tcs, tk_ids[k], tk_lp[k], blank_lp[k], tcharset.FIELD_PATTERNS[mode]) == \
                jcharset.constrained_ctc_decode(
                    jcs, tk_ids[k], tk_lp[k], blank_lp[k], jcharset.FIELD_PATTERNS[mode])


def test_charset_and_patterns_are_copies():
    assert tcharset.CHARSET == jcharset.CHARSET
    assert tcharset.FIELD_PATTERNS == jcharset.FIELD_PATTERNS
    assert tcharset.unroll_pattern([("AB", 1, 3)]) == jcharset.unroll_pattern([("AB", 1, 3)])
    for text in ("AB12345678", "nt$1,250", "年", ""):
        assert tcharset.encode_text(text) == jcharset.encode_text(text)
        assert tcharset.decode_ids(tcharset.encode_text(text)) == \
            jcharset.decode_ids(jcharset.encode_text(text))


def test_lm_logp_equal():
    jl, tl = jlm.default_lm(), tlm.default_lm()
    assert (tl.V, tl.order) == (jl.V, jl.order)
    rng = np.random.default_rng(1)
    alphabet = list(jcharset.CHARSET) + ["$", "中"]
    for _ in range(500):
        ctx = "^" + "".join(rng.choice(alphabet, int(rng.integers(0, 6))))
        c = str(rng.choice(alphabet))
        assert tl.logp(ctx, c) == jl.logp(ctx, c)


def test_homoglyphs_and_constants_are_copies():
    assert TorchOcrEngine.CASCADE_MARGIN == JaxOcrEngine.CASCADE_MARGIN
    assert TorchOcrEngine.CONSTRAINED_TAU == JaxOcrEngine.CONSTRAINED_TAU
    assert TorchOcrEngine._HOMOGLYPH_PAIRS == JaxOcrEngine._HOMOGLYPH_PAIRS
    for a, b in (("AB-1234", "A8 I234"), ("O0", "00"), ("AB", "ABC")):
        assert TorchOcrEngine._homoglyph_equal(a, b) == JaxOcrEngine._homoglyph_equal(a, b)
