"""PyTorch port: the training renderers (``ocr/torchocr/data.py``,
``ocr/torchocr/textness.py``) and the OpenCV steps they run, against the
JAX package on the CPU.

Held byte for byte, with the generator's state equal after every call:
``dot_matrix``; ``render_line`` on every branch (CJK on the stroke font
with a TrueType ASCII font, ``synth_style``, per-character and whole-string
TrueType text, rotation, morphology and shear, ``dot`` and ``dot_hard`` at
both scales, the elastic warp, the photometric block); ``make_batch`` with
each fraction and with the CJK charset; ``render_textpage`` unperturbed
(perturbed, within the perturbation engine's own bound) and the textness
``make_batch``'s labels. The registry is whole on both sides (the 14
training fonts, Atkinson and Minecraft auto-hinted by FreeType and by the
port), and OpenCV runs its own code (``cv2.ipp.setUseIPP(False)``: with IPP, its float
resizes differ in the last bits); the OpenCV steps are held under both.

``train`` with ``batches=None`` asks for the same batches from the same
generator states as JAX's ``train`` (a fresh batch each step, or a cached
pool), with the renderers and the steps stubbed: no JAX compile.
"""

import os

import cv2
import numpy as np
import pytest

import twinvoice_tpu.data.synthetic as jax_synthetic
import twinvoice_tpu.ocr.jaxocr.data as J
import twinvoice_tpu_torch.data.synthetic as port_synthetic
import twinvoice_tpu_torch.ocr.torchocr.data as P
from twinvoice_tpu.ocr.jaxocr import textness as JT
from twinvoice_tpu.ocr.jaxocr.charset import cjk_charset as jax_cjk
from twinvoice_tpu.ocr.fonts import latin_glyphs as jax_latin
from twinvoice_tpu_torch.ocr.fonts import latin_glyphs as port_latin
from twinvoice_tpu_torch.ocr.torchocr import textness as PT
from twinvoice_tpu_torch.ocr.torchocr.charset import cjk_charset as port_cjk
from twinvoice_tpu_torch.ops import host_filter, host_image, host_warp


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture
def registry():
    """Both registries whole: JAX's 14 training fonts and the port's, the
    same faces in the same order."""
    jf, pf = jax_synthetic.train_fonts(), port_synthetic.train_fonts()
    assert [os.path.basename(f) for f in jf] == [os.path.basename(f) for f in pf]
    assert len(jf) == 14 and J._FONT_PATHS == jf and P._FONT_PATHS == pf


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("ipp", [True, False])
def test_opencv_steps_equal_cv2(ipp):
    """dilate, warpAffine (uint8, linear, constant border), INTER_AREA
    float shrinks (the 2×2 integer one included), remap (float maps,
    linear, replicate) under IPP on and off; INTER_LINEAR and INTER_CUBIC
    float resizes against OpenCV's own code (IPP off), at render_line's
    shapes."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        rng = np.random.default_rng(31)
        for i in range(25):
            t = rng.integers(0, 256, (int(rng.integers(8, 40)), int(rng.integers(8, 200))), np.uint8)
            k = np.ones((2, 2), np.uint8)
            assert _same(host_image.dilate2x2(t), cv2.dilate(t, k))
            assert _same(host_image.erode2x2(t), cv2.erode(t, k))
            shear = float(rng.uniform(-0.25, 0.25))
            h0, w0 = t.shape
            m = np.array([[1.0, shear, abs(shear) * h0], [0.0, 1.0, 0.0]], np.float32)
            ds = (int(w0 + abs(shear) * h0 + 2), h0)
            assert _same(host_warp.warp_affine_u8(t, m, ds, 255),
                         cv2.warpAffine(t, m, ds, flags=cv2.INTER_LINEAR,
                                        borderMode=cv2.BORDER_CONSTANT, borderValue=255))
            img = (rng.random((32, 256)) * 255).astype(np.float32)
            s = float(rng.uniform(0.46, 0.97))
            sw, sh = (128, 16) if i == 0 else (max(8, int(256 * s)), max(8, int(32 * s)))
            assert _same(host_image.resize_area_f32(img, sw, sh),
                         cv2.resize(img, (sw, sh), interpolation=cv2.INTER_AREA))
            g = rng.normal(0, 1.3, (4, 16)).astype(np.float32)
            xs, ys = np.meshgrid(np.arange(256, dtype=np.float32), np.arange(32, dtype=np.float32))
            gx = host_filter.resize_cubic_f32(g, 256, 32)
            assert _same(host_warp.remap_linear_f32(img, xs + gx, ys - gx),
                         cv2.remap(img, xs + gx, ys - gx, cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_REPLICATE))
            if not ipp:
                small = (rng.random((sh, sw)) * 255).astype(np.float32)
                assert _same(host_image.resize_linear_f32(small, 256, 32),
                             cv2.resize(small, (256, 32), interpolation=cv2.INTER_LINEAR))
                assert _same(gx, cv2.resize(g, (256, 32), interpolation=cv2.INTER_CUBIC))
    finally:
        cv2.ipp.setUseIPP(was)


def _state(rng):
    return rng.bit_generator.state


def test_dot_matrix_equals_jax():
    rng = np.random.default_rng(4)
    for pitch in (None, 2, 3):
        img = (rng.random((32, 256)) * 255).astype(np.float32)
        seed = int(rng.integers(1 << 30))
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        assert _same(J.dot_matrix(img, r1, pitch), P.dot_matrix(img, r2, pitch))
        assert _state(r1) == _state(r2)


_BRANCHES = [
    ("field", dict()),
    ("field", dict(sev=1.7)),
    ("field", dict(dot=True)),
    ("field", dict(dot=True, dot_hard=True)),
    ("field", dict(sev=1.5, dot=True)),
    ("cjk", dict()),
    ("cjk", dict(dot=True, sev=1.3)),
    ("synth", dict()),
    ("synth", dict(sev=1.6, dot=True)),
]


@pytest.mark.parametrize("kind,kw", _BRANCHES, ids=[f"{k}-{'-'.join(kw) or 'plain'}"
                                                     for k, kw in _BRANCHES])
def test_render_line_equals_jax(registry, no_ipp, kind, kw):
    """24 seeds a branch: the text (field strings, CJK item lines, or a
    synthetic Latin typeface), then render_line from equal generators."""
    jcs, pcs = jax_cjk(), port_cjk()
    for seed in range(24):
        src = np.random.default_rng(10_000 + seed)
        if kind == "cjk":
            text = J.random_cjk_text(src, jcs)
        else:
            text = J.random_field_text(src)
        jstyle = pstyle = None
        if kind == "synth":
            s1, s2 = np.random.default_rng(seed), np.random.default_rng(seed)
            jstyle, pstyle = jax_latin.sample_style(s1), port_latin.sample_style(s2)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a = J.render_line(text, r1, synth_style=jstyle, **kw)
        b = P.render_line(text, r2, synth_style=pstyle, **kw)
        assert _same(a, b), (kind, kw, seed, text, int((a != b).sum()))
        assert _state(r1) == _state(r2), (kind, kw, seed)


_FRACS = [dict(), dict(hard_frac=0.5), dict(sev_frac=0.5), dict(dot_frac=0.5),
          dict(dot_frac=0.6, dot_hard_frac=0.5), dict(synth_frac=0.5), dict(mixed_frac=0.5)]


@pytest.mark.parametrize("fracs", _FRACS, ids=lambda f: "-".join(f) or "default")
@pytest.mark.parametrize("cjk", [False, True], ids=["ascii", "cjk"])
def test_make_batch_equals_jax(registry, no_ipp, fracs, cjk):
    jcs = jax_cjk() if cjk else J.DEFAULT
    pcs = port_cjk() if cjk else P.DEFAULT
    r1, r2 = np.random.default_rng(77), np.random.default_rng(77)
    want = J.make_batch(12, r1, jcs, **fracs)
    got = P.make_batch(12, r2, pcs, **fracs)
    for w, g in zip(want[:3], got[:3]):
        assert _same(w, g)
    assert want[3] == got[3] and _state(r1) == _state(r2)


def test_render_textpage_and_batch_equal_jax(registry, no_ipp):
    """Pages drawn without perturbation and perturbed ones (``augment.perturb``
    at severity 0.5; seed 5115 is one whose crumple field once flipped a
    byte) equal JAX's byte for byte, with equal masks and generator states;
    the textness ``make_batch`` too."""
    for seed in list(range(6)) + [5115]:
        for severity in (0.0, 0.5):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            (g1, m1), (g2, m2) = (JT.render_textpage(r1, severity=severity),
                                  PT.render_textpage(r2, severity=severity))
            assert _same(m1, m2) and _state(r1) == _state(r2), (seed, severity)
            assert _same(g1, g2), (seed, severity)
    r1, r2 = np.random.default_rng(40), np.random.default_rng(40)
    (i1, l1), (i2, l2) = JT.make_batch(2, r1), PT.make_batch(2, r2)
    assert _same(l1, l2) and _state(r1) == _state(r2)
    assert _same(i1, i2)


def test_perturbed_page_equals_jax(registry, no_ipp):
    """The page that once differed (``render_textpage(default_rng(100161),
    severity=1.0)``: a blur of a float64 image, thermal fade, gamma, JPEG
    q67) equals JAX's: image, mask and generator state."""
    r1, r2 = np.random.default_rng(100161), np.random.default_rng(100161)
    (g1, m1), (g2, m2) = (JT.render_textpage(r1, severity=1.0),
                          PT.render_textpage(r2, severity=1.0))
    assert _same(m1, m2) and _state(r1) == _state(r2)
    assert _same(g1, g2)


def test_dft_motion_page_is_pinned(registry, no_ipp):
    """The page that once differed (``render_textpage(default_rng(200257),
    severity=1.0)``: a 13×13 motion kernel, which OpenCV filters through its
    DFT, as the port now does) equals JAX's: image, mask and generator
    state."""
    r1, r2 = np.random.default_rng(200257), np.random.default_rng(200257)
    (g1, m1), (g2, m2) = (JT.render_textpage(r1, severity=1.0),
                          PT.render_textpage(r2, severity=1.0))
    assert _same(m1, m2) and _state(r1) == _state(r2)
    assert _same(g1, g2)


def _record(calls):
    """A stand-in batch maker: records (size, generator state, charset,
    fractions) and draws a little, as a renderer would."""
    def make(batch_size, rng, charset=None, **fracs):
        calls.append((batch_size, str(_state(rng)), getattr(charset, "chars", None),
                      tuple(sorted((k, v) for k, v in fracs.items() if v))))
        rng.random(3)
        lines = np.full((batch_size, 32, 256), 200, np.uint8)
        labels = np.zeros((batch_size, 24), np.int32)
        labels[:, 0] = 1
        pad = np.ones((batch_size, 24), np.float32)
        pad[:, 0] = 0
        return lines, labels, pad, ["0"] * batch_size
    return make


@pytest.mark.parametrize("cache", [0, 3])
def test_train_renders_as_jax(monkeypatch, tmp_path, cache):
    """The port's ``train`` without batches asks its renderer for JAX's
    batches: the same sizes, fractions and generator states, step by step,
    then the four evaluation batches from ``default_rng(seed + 1)``."""
    import jax.numpy as jnp

    from twinvoice_tpu.ocr.jaxocr import train as jtrain
    from twinvoice_tpu_torch.ocr.torchocr import train as ptrain

    jcalls, pcalls = [], []
    jmake = _record(jcalls)

    def jax_make_batch(batch_size, rng, charset=J.DEFAULT, **fracs):
        lines, labels, pad, texts = jmake(batch_size, rng, charset, **fracs)
        return lines[..., None].astype(np.float32) / 255.0, labels, pad, texts

    monkeypatch.setattr(jtrain.D, "make_batch", jax_make_batch)
    monkeypatch.setattr(jtrain, "init_crnn", lambda key, **kw: ({"w": jnp.zeros(2)}, {}))
    monkeypatch.setattr(jtrain, "make_train_step",
                        lambda opt, arch: lambda p, s, o, x, y, m: (p, s, o, 0.0))
    monkeypatch.setattr(jtrain, "crnn_apply",
                        lambda p, s, x, train, arch: (jnp.zeros((x.shape[0], 4, 3)), s))
    monkeypatch.setattr(jtrain, "save_weights", lambda *a, **k: None)
    fracs = dict(hard_frac=0.1, sev_frac=0.2, dot_frac=0.3, synth_frac=0.4, dot_hard_frac=0.5)
    jtrain.train(steps=101, batch_size=2, seed=5, out_dir=str(tmp_path / "j"), log=lambda m: None,
                 cache_batches=cache, **fracs)

    monkeypatch.setattr(ptrain.D, "make_lines", _record(pcalls))
    monkeypatch.setattr(ptrain, "make_train_step",
                        lambda arch, device=None: lambda p, s, o, x, y, m, lr: (p, s, 0.0))
    monkeypatch.setattr(ptrain, "greedy_texts", lambda p, s, x, cs, arch: ["0"] * len(x))
    monkeypatch.setattr(ptrain, "save_weights", lambda *a, **k: None)
    ptrain.train(str(tmp_path / "p"), steps=101, batch_size=2, seed=5, log=lambda m: None,
                 cache_batches=cache, device="cpu", **fracs)
    assert len(pcalls) == (cache or 101) + 4
    assert pcalls == jcalls
