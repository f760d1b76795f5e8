"""PyTorch port: the CTC recognizer's forward (``ocr/torchocr/model.py``), its
weights, and the device half of the engine (``engine.posteriors``) against
the JAX package.

Tolerances: logits within 1e-5 of the largest |logit| (float32 convs in a
different order; measured ≤ 7e-7 on the bundled weights); log-probs within
1e-4 (measured ≤ 2.8e-5, the logits' error carried through the log-softmax)
and confidences within 1e-5. The argmax and the top-8 ids are equal wherever
the values they rank are more than 2e-4 apart, and exactly equal at planted
ties (``lax.top_k`` and ``jnp.argmax`` both break ties to the lowest index).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twinvoice_tpu.ocr.jaxocr.model import crnn_apply as jax_crnn_apply
from twinvoice_tpu.ocr.jaxocr.train import load_weights_ex
from twinvoice_tpu_torch.ocr.torchocr import model as tm
from twinvoice_tpu_torch.ocr.torchocr.engine import infer_rows, posteriors

CHANNELS = (32, 64, 96, 128)  # the bundled recognizer's widths
CONTEXT = 256
CLASSES = 420
LOGIT_RTOL = 1e-5
LP_ATOL = 1e-4
CONF_ATOL = 1e-5


def random_crnn(rng, channels=CHANNELS, context=CONTEXT, classes=CLASSES):
    """A JAX-layout ``(params, state)`` tree in numpy with ``init_crnn``'s
    shapes, random weights and BatchNorm statistics."""
    def conv(kh, kw, ci, co):
        return {"kernel": (rng.normal(0, 1, (kh, kw, ci, co)) / np.sqrt(kh * kw * ci)
                           ).astype(np.float32),
                "bias": rng.normal(0, 0.1, co).astype(np.float32)}

    def bn(c):
        return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": rng.normal(0, 0.2, c).astype(np.float32)},
                {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                 "var": rng.uniform(0.3, 2.0, c).astype(np.float32)})

    p = {"conv": [], "bn": [], "ctx": [], "ctx_bn": []}
    s = {"bn": [], "ctx_bn": []}
    cin = 1
    for c in channels:
        p["conv"].append(conv(3, 3, cin, c))
        bp, bs = bn(c)
        p["bn"].append(bp)
        s["bn"].append(bs)
        cin = c
    p["proj"] = conv(1, 1, channels[-1] * 4, context)
    for _ in range(2):
        p["ctx"].append(conv(1, 5, context, context))
        bp, bs = bn(context)
        p["ctx_bn"].append(bp)
        s["ctx_bn"].append(bs)
    p["head"] = conv(1, 1, context, classes)
    return p, s


_jax_apply = jax.jit(lambda p, s, x, arch: jax_crnn_apply(p, s, x, train=False, arch=arch)[0],
                     static_argnums=3)


def _rows(seed, n=6):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 32, 256)).astype(np.float32)
    x[: n // 2] = np.where(x[: n // 2] > 0.7, 1.0, 0.2)  # line-like contrast
    return x


def _port_logits(p, s, x, arch):
    tp, ts = tm.crnn_params_from_jax(p, s)
    with torch.inference_mode():
        return tm.crnn_apply(tp, ts, torch.from_numpy(x)[:, None], arch=arch)[0].numpy()


def _assert_logits(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def bundled():
    return load_weights_ex()


@pytest.mark.parametrize("arch", ["t32", "t64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_crnn_full_width_random_trees(arch, seed):
    p, s = random_crnn(np.random.default_rng(seed))
    x = _rows(seed)
    want = np.asarray(_jax_apply(p, s, jnp.asarray(x[..., None]), arch))
    got = _port_logits(p, s, x, arch)
    assert got.shape == want.shape == (len(x), 32 if arch == "t32" else 64, CLASSES)
    _assert_logits(got, want)


@pytest.mark.parametrize("arch", ["t32", "t64"])
def test_crnn_bundled_weights(bundled, arch):
    """The bundled weights (trained for t64) through both pooling plans."""
    p, s, _, _ = bundled
    p, s = jax.tree.map(np.asarray, (p, s))
    x = _rows(5, n=8)
    want = np.asarray(_jax_apply(p, s, jnp.asarray(x[..., None]), arch))
    _assert_logits(_port_logits(p, s, x, arch), want)


@pytest.mark.parametrize("feature", [0, 1, 127, 128, 300, 511])
def test_flatten_order_with_a_single_feature_proj(feature):
    """``proj`` reads one flattened feature (h·C + c, h-major and c-minor in
    JAX) into channel 0 and the context and head pass it through, so logit 0
    is that feature's sequence: any other flatten order reads another one."""
    rng = np.random.default_rng(feature)
    p, s = random_crnn(rng, context=8, classes=8)
    p["bn"][3]["bias"][:] = 1.0  # every trunk feature alive after its ReLU
    p["proj"]["kernel"][:] = 0
    p["proj"]["kernel"][0, 0, feature, 0] = 1.0
    p["proj"]["bias"][:] = 0
    for cp, bp, bs in zip(p["ctx"], p["ctx_bn"], s["ctx_bn"]):
        cp["kernel"][:] = 0
        cp["bias"][:] = 0
        bp["bias"][:] = 0
        bs["mean"][:] = 0
    p["head"]["kernel"][:] = np.eye(8, dtype=np.float32)[None, None]
    p["head"]["bias"][:] = 0
    x = _rows(feature + 1, n=2)
    want = np.asarray(_jax_apply(p, s, jnp.asarray(x[..., None]), "t64"))
    got = _port_logits(p, s, x, "t64")
    assert np.ptp(want[..., 0]) > 0  # the feature varies along the line
    _assert_logits(got, want)
    # the port's trunk read directly: feature (h, c) of time step t
    tp, ts = tm.crnn_params_from_jax(p, s)
    h = torch.from_numpy(x)[:, None]
    with torch.inference_mode():
        for i in range(4):
            h = torch.nn.functional.conv2d(h, tp["conv"][i]["weight"], tp["conv"][i]["bias"],
                                           padding=1)
            h = torch.relu(tm._bn_eval(h, tp["bn"][i], ts["bn"][i]))
            if i < 3:
                h = torch.nn.functional.max_pool2d(h, (2, 1) if i == 2 else 2)
    hh, c = divmod(feature, h.shape[1])
    np.testing.assert_allclose(got[..., 0], np.maximum(h[:, c, hh].numpy(), 0),
                               rtol=0, atol=LOGIT_RTOL * np.abs(want).max())


def _jax_posteriors(logits):
    """JAX's device half after the model (``engine.py:_infer``)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    probs = jnp.exp(logp)
    ids = jnp.argmax(logits, axis=-1)
    top = jnp.max(probs, axis=-1)
    nonblank = ids != 0
    conf = jnp.sum(top * nonblank, axis=-1) / jnp.maximum(jnp.sum(nonblank, axis=-1), 1)
    tk_lp, tk_ids = jax.lax.top_k(logp, 8)
    return ids, conf, tk_ids, tk_lp, logp[..., 0]


def test_posteriors_planted_ties():
    """Exact ties in the logits: the argmax and the top-8 break them to the
    lowest index, as ``jnp.argmax`` and ``lax.top_k`` do (``torch.topk`` does
    not: on [1, 3, 3, 2, 3] it gives [2, 4, 1] for lax's [1, 2, 4])."""
    rng = np.random.default_rng(3)
    logits = rng.integers(-4, 5, (4, 16, 40)).astype(np.float32)  # many ties
    logits[0, 0, :5] = [1, 3, 3, 2, 3]
    logits[0, 0, 5:] = -10
    logits[1, :, :] = 0.5  # a whole frame of ties: blank wins, ids 0..7
    logits[2, :, 0] = logits[2].max(-1)  # blank tied for the top
    want = jax.jit(_jax_posteriors)(jnp.asarray(logits))
    got = posteriors(torch.from_numpy(logits))
    for name, w, g in zip(("ids", "conf", "tk_ids", "tk_lp", "blank_lp"), want, got):
        w, g = np.asarray(w), g.numpy()
        if name in ("ids", "tk_ids"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=LP_ATOL, err_msg=name)
    assert got[2][0, 0, :3].tolist() == [1, 2, 4]
    assert got[2][1, 0].tolist() == list(range(8))


def _compare_device_half(got, want):
    ids, conf, tk_ids, tk_lp, blank_lp = (np.asarray(a) for a in want)
    g_ids, g_conf, g_tk_ids, g_tk_lp, g_blank = got
    np.testing.assert_allclose(g_conf, conf, rtol=0, atol=CONF_ATOL)
    np.testing.assert_allclose(g_tk_lp, tk_lp, rtol=0, atol=LP_ATOL)
    np.testing.assert_allclose(g_blank, blank_lp, rtol=0, atol=LP_ATOL)
    gap = tk_lp[..., 0] - tk_lp[..., 1]
    clear = gap > 2 * LP_ATOL
    np.testing.assert_array_equal(g_ids[clear], ids[clear])
    # each top-8 slot whose value stands clear of its neighbours holds the same id
    d = np.diff(tk_lp, axis=-1)
    apart = np.ones(tk_lp.shape, bool)
    apart[..., :-1] &= -d > 2 * LP_ATOL
    apart[..., 1:] &= -d > 2 * LP_ATOL
    np.testing.assert_array_equal(g_tk_ids[apart], tk_ids[apart])
    return int((~clear).sum())


@pytest.mark.parametrize("arch", ["t32", "t64"])
def test_device_half_against_jitted_infer(bundled, arch):
    """``infer_rows`` against ``JaxOcrEngine._infer`` (jitted) on the same rows,
    bundled weights, both pooling plans."""
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine

    p, s, charset, _ = bundled
    eng = JaxOcrEngine(params=p, state=s, charset=charset, arch=arch)
    x = _rows(11, n=10)
    want = eng._infer(p, s, jnp.asarray(x[..., None]))
    tp, ts = tm.crnn_params_from_jax(*jax.tree.map(np.asarray, (p, s)))
    with torch.inference_mode():
        got = [t.numpy() for t in infer_rows(tp, ts, torch.from_numpy(x)[:, None], arch=arch)]
    assert got[0].dtype == np.int64 and got[2].shape == (10, 32 if arch == "t32" else 64, 8)
    _compare_device_half(got, want)


def test_load_crnn_weights_matches_load_weights_ex(bundled):
    p, s, charset, arch = bundled
    tp, ts, tcharset, tarch = tm.load_crnn_weights()
    assert tcharset.chars == charset.chars and tarch == arch == "t64"
    assert tcharset.num_classes == CLASSES
    want_p, want_s = tm.crnn_params_from_jax(*jax.tree.map(np.asarray, (p, s)))
    got = jax.tree_util.tree_leaves_with_path((tp, ts))
    want = jax.tree_util.tree_leaves_with_path((want_p, want_s))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(k))
    assert tuple(t["weight"].shape[0] for t in tp["conv"]) == CHANNELS
    assert tp["proj"]["weight"].shape == (CONTEXT, 4 * CHANNELS[-1], 1, 1)
    assert tp["ctx"][0]["weight"].shape == (CONTEXT, CONTEXT, 1, 5)
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == sum(
        np.size(a) for a in jax.tree.leaves(p))


def test_load_crnn_weights_without_charset_or_arch(tmp_path):
    """Older files: the ASCII charset and the legacy t32 arch, as JAX's loader."""
    from twinvoice_tpu.ocr.jaxocr.charset import CHARSET, NUM_CLASSES

    p, s = random_crnn(np.random.default_rng(2), classes=NUM_CLASSES)
    flat = {}
    for prefix, tree in (("p", p), ("s", s)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/" + jax.tree_util.keystr(path)] = leaf
    path = tmp_path / "old.npz"
    np.savez(path, **flat)
    jp, js, jcs, jarch = load_weights_ex(str(path))
    tp, ts, tcs, tarch = tm.load_crnn_weights(str(path))
    assert (tcs.chars, tarch) == (jcs.chars, jarch) == (CHARSET, "t32")
    x = _rows(4, n=2)
    want = np.asarray(_jax_apply(jp, js, jnp.asarray(x[..., None]), "t32"))
    with torch.inference_mode():
        got = tm.crnn_apply(tp, ts, torch.from_numpy(x)[:, None], arch=tarch)[0].numpy()
    _assert_logits(got, want)


def test_load_crnn_weights_rejects_a_key_that_is_neither_leaf_nor_metadata(tmp_path):
    """Only the recognizer's own metadata keys are skipped: any other key
    without a ``p/``/``s/`` path is a malformed file, and loading it fails."""
    p, s = random_crnn(np.random.default_rng(3))
    flat = {"charset": np.asarray("0123"), "arch": np.asarray("t64"), "extra": np.zeros(1)}
    for prefix, tree in (("p", p), ("s", s)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/" + jax.tree_util.keystr(path)] = leaf
    path = tmp_path / "bad.npz"
    np.savez(path, **flat)
    with pytest.raises(ValueError):
        tm.load_crnn_weights(str(path))
    del flat["extra"]
    np.savez(path, **flat)
    assert tm.load_crnn_weights(str(path))[3] == "t64"
