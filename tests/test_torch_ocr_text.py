"""PyTorch port, the recognizer's training text (``ocr/fonts``,
``ocr/torchocr/data.py``, ``charset.cjk_charset``, ``lm.CharNgramLM.build``)
against the JAX package: every comparison is exact. The samplers give the
same strings from one seeded generator and leave it in the same state; the
LM built from them has the same counts, and the default build is the
bundled ``lm4.json.gz``."""

import gzip
import json

import numpy as np
import pytest
import torch

from twinvoice_tpu.ocr.fonts import strokefont as jax_font
from twinvoice_tpu.ocr.fonts import tw_glyphs as jax_glyphs
from twinvoice_tpu.ocr.jaxocr import data as JD
from twinvoice_tpu.ocr.jaxocr import lm as JL
from twinvoice_tpu.ocr.jaxocr.charset import DEFAULT as JAX_DEFAULT
from twinvoice_tpu.ocr.jaxocr.charset import cjk_charset as jax_cjk_charset
from twinvoice_tpu_torch.ocr.fonts import strokefont, tw_glyphs
from twinvoice_tpu_torch.ocr.torchocr import data as TD
from twinvoice_tpu_torch.ocr.torchocr import lm as TL
from twinvoice_tpu_torch.ocr.torchocr.charset import DEFAULT, cjk_charset
from twinvoice_tpu_torch.ocr.torchocr.model import DEFAULT_WEIGHTS_PATH

SAMPLERS = ("random_field_text", "random_hard_text", "random_mixed_text")


def _charsets(name):
    return (DEFAULT, JAX_DEFAULT) if name == "ascii" else (cjk_charset(), jax_cjk_charset())


def test_glyph_data_and_coverage_equal_the_jax_fonts():
    assert tw_glyphs.COMPONENTS == jax_glyphs.COMPONENTS
    assert tw_glyphs.COMPOSE == jax_glyphs.COMPOSE
    assert strokefont.coverage() == jax_font.coverage()
    for ch in sorted(jax_font.coverage())[::7] + ["口", "發"]:
        assert strokefont.glyph_strokes(ch) == jax_font.glyph_strokes(ch)
    assert not strokefont.has_glyph("A") and not jax_font.has_glyph("A")


def test_cjk_charset_equals_the_jax_one_and_the_bundled_recognizers():
    cs = cjk_charset()
    assert cs.chars == jax_cjk_charset().chars and cs.num_classes == 420
    with np.load(DEFAULT_WEIGHTS_PATH) as z:
        assert str(z["charset"]) == cs.chars


@pytest.mark.parametrize("sampler,charset", [(s, c) for s in SAMPLERS for c in ("ascii", "cjk")]
                         + [("random_cjk_text", "cjk")])  # its pool is the CJK glyphs
@pytest.mark.parametrize("seed", [0, 7, 4242])
def test_samplers_give_jax_strings_and_generator_state(sampler, charset, seed):
    tcs, jcs = _charsets(charset)
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [getattr(TD, sampler)(a, tcs) for _ in range(500)]
    want = [getattr(JD, sampler)(b, jcs) for _ in range(500)]
    assert got == want
    assert a.bit_generator.state == b.bit_generator.state


def test_constants_equal_the_jax_module():
    assert TD.MAX_LABEL == JD.MAX_LABEL and TD._CJK_NAMES == JD._CJK_NAMES


@pytest.mark.parametrize("charset", ["ascii", "cjk"])
def test_encode_labels_as_make_batch_builds_them(charset):
    """``make_batch``'s label loop (data.py:441-460), replayed on the same
    texts, including lower case, unknown characters and texts longer than
    ``MAX_LABEL``."""
    tcs, jcs = _charsets(charset)
    rng = np.random.default_rng(3)
    texts = [JD.random_hard_text(rng, jcs) for _ in range(40)]
    texts += ["abc-12", "", "€€€", "X" * 30, "金額: 1,250 ü", "  a b  "]
    labels, pad, out = TD.encode_labels(texts, tcs)
    want_l = np.zeros((len(texts), JD.MAX_LABEL), np.int32)
    want_p = np.ones((len(texts), JD.MAX_LABEL), np.float32)
    want_t = []
    for i, text in enumerate(texts):
        ids = jcs.encode_text(text)[:JD.MAX_LABEL]
        want_t.append("".join(c for c in text.upper() if jcs.encode_text(c))[:len(ids)])
        want_l[i, :len(ids)] = ids
        want_p[i, :len(ids)] = 0.0
    assert labels.dtype == np.int32 and pad.dtype == np.float32
    np.testing.assert_array_equal(labels, want_l)
    np.testing.assert_array_equal(pad, want_p)
    assert out == want_t


def test_lines_to_tensor_is_make_batchs_float_bit_for_bit():
    u8 = np.arange(256, dtype=np.uint8)[None, None, :].repeat(32, 1).repeat(3, 0)
    u8[1] = np.random.default_rng(0).integers(0, 256, (32, 256))
    got = TD.lines_to_tensor(u8, "cpu")
    assert got.shape == (3, 1, 32, 256) and got.dtype == torch.float32 and got.is_contiguous()
    want = u8.astype(np.float32) / 255.0
    np.testing.assert_array_equal(got[:, 0].numpy().view(np.int32), want.view(np.int32))
    dev = TD.lines_to_tensor(torch.from_numpy(u8), "cpu")  # a tensor pool entry
    assert torch.equal(dev, got)


def test_read_line_npz_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    texts = [JD.random_field_text(rng) for _ in range(5)]
    labels, pad, texts = TD.encode_labels(texts)
    lines = rng.integers(0, 256, (5, 32, 256), dtype=np.uint8)
    np.savez(tmp_path / "l.npz", eval_lines=lines, eval_labels=labels, eval_label_pad=pad,
             eval_texts=np.asarray(texts))
    got = TD.read_line_npz(tmp_path / "l.npz", prefix="eval_")
    np.testing.assert_array_equal(got[0], lines)
    np.testing.assert_array_equal(got[1], labels)
    np.testing.assert_array_equal(got[2], pad)
    assert got[3] == texts


@pytest.mark.parametrize("charset", ["ascii", "cjk"])
def test_lm_build_equals_jax_at_3000_samples(charset):
    tcs, jcs = _charsets(charset)
    got = TL.CharNgramLM.build(tcs, n_samples=3000, seed=2)
    want = JL.CharNgramLM.build(jcs, n_samples=3000, seed=2)
    assert got.V == want.V and got.grams == want.grams
    for ctx, c in (("^AB", "1"), ("", "$"), ("12/", "0"), ("金", "額")):
        assert got.logp(ctx, c) == want.logp(ctx, c)


def test_lm_save_loads_in_both_packages(tmp_path):
    lm = TL.CharNgramLM.build(DEFAULT, n_samples=500, seed=4)
    lm.save(str(tmp_path / "a.json.gz"))
    back, jax_back = TL.CharNgramLM.load(str(tmp_path / "a.json.gz")), JL.CharNgramLM.load(
        str(tmp_path / "a.json.gz"))
    assert back.grams == lm.grams == jax_back.grams and back.V == jax_back.V == lm.V
    JL.CharNgramLM.build(JAX_DEFAULT, n_samples=500, seed=4).save(str(tmp_path / "b.json.gz"))
    with gzip.open(tmp_path / "a.json.gz", "rt") as a, gzip.open(tmp_path / "b.json.gz", "rt") as b:
        assert json.load(a) == json.load(b)


def test_default_lm_without_the_asset_builds_the_bundled_model(monkeypatch, tmp_path):
    """``default_lm``'s fallback: ``CharNgramLM.build(cjk_charset())`` at its
    defaults (120,000 samples, seed 1) gives the bundled ``lm4.json.gz``'s
    counts exactly, with no JAX; nothing is written."""
    bundled = TL.CharNgramLM.load()
    monkeypatch.setattr(TL, "DEFAULT_LM_PATH", str(tmp_path / "missing.json.gz"))
    monkeypatch.setattr(TL, "_default", None)
    built = TL.default_lm()
    assert built.V == bundled.V == 422
    assert built.grams == bundled.grams
    assert TL.default_lm() is built and not list(tmp_path.iterdir())
