"""PyTorch port, the recognizer's training (``ocr/torchocr/train.py`` and the
train-mode ``model.crnn_apply``) against the JAX trainer, at small widths
(channels (8, 16, 16, 16), context 32, 12 classes) and at t32 and t64.

Tolerances:
- ``ctc_loss`` on rows whose labels fit the frames: losses within 1e-6
  relative of ``optax.ctc_loss``, gradients within 5e-4 of their largest
  element (measured ≤ 1.2e-4 at T = 64: two float32 recursions over 64
  frames). On a row that does not fit
  (optax's finite ≈ 1e5 loss) the loss within 1e-6 relative, and the
  gradient held to optax's float64 within float32 optax's own distance from
  it: at a loss of 1e5 float32 keeps about three decimals, and the float32
  recursions differ (8.4e-4 of optax's largest element from float64,
  the port's 1.7e-4, on the case below).
- The schedules: exactly optax's float32 values at every step.
- The train-mode forward: logits within 1e-5 of the largest |logit|, new
  BatchNorm state within 1e-5 relative.
- 3 steps: the step-1 loss within 1e-5 relative of a float64 step (JAX,
  from the formulas, ``scripts/make_torch_smoke_ocrtrain.py:crnn64``) and
  of JAX's within JAX's distance from it; each step-1 gradient within 1e-3
  of its float64 norm plus JAX's own distance; after 3 steps every leaf
  within 1e-2 of its step from JAX's, but the pre-BN conv biases, whose
  exact gradient is 0 (Adam turns their float32 noise into ±lr steps), held
  to Adam's bound instead.
- ``evaluate``, the weight files and ``train``'s trajectory: exact.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from twinvoice_tpu.ocr.jaxocr import data as JD
from twinvoice_tpu.ocr.jaxocr import train as JT
from twinvoice_tpu.ocr.jaxocr.charset import Charset as JaxCharset
from twinvoice_tpu.ocr.jaxocr.model import crnn_apply as jax_crnn_apply
from twinvoice_tpu.ocr.jaxocr.model import init_crnn as jax_init_crnn
from twinvoice_tpu_torch.ocr.torchocr import data as TD
from twinvoice_tpu_torch.ocr.torchocr import model as M
from twinvoice_tpu_torch.ocr.torchocr import train as T
from twinvoice_tpu_torch.ocr.torchocr.charset import DEFAULT
from twinvoice_tpu_torch.weights import keystr_items

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH, CTX, K = (8, 16, 16, 16), 32, 12


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_ocrtrain.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_ocrtrain", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small(seed=0, classes=K):
    return M.init_crnn(torch.Generator().manual_seed(seed), num_classes=classes, channels=CH,
                       context=CTX)


def leaves(tree):
    """{keystr: numpy copy} of a tree's leaves; a tuple of trees gives each
    tree's leaves under its index."""
    if isinstance(tree, tuple):
        return {f"[{i}]{k}": v for i, t in enumerate(tree) for k, v in leaves(t).items()}
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in keystr_items(tree)}


def jax_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def labels_batch(rng, b, classes=K, n_max=10, frames=None):
    """Random labels in 1..classes-1 with repeats, lengths 0..n_max, padded
    to 24 (``MAX_LABEL``)."""
    labels = np.zeros((b, 24), np.int32)
    pad = np.ones((b, 24), np.float32)
    for i in range(b):
        n = int(rng.integers(0, n_max + 1)) if i else n_max
        row = rng.integers(1, classes, n)
        if n > 2:
            row[1] = row[0]  # an adjacent repeat
        labels[i, :n], pad[i, :n] = row, 0.0
    return labels, pad


def optax_ctc(logits, labels, pad, dtype=jnp.float32):
    with jax.enable_x64(dtype == jnp.float64):
        lg = jnp.asarray(logits, dtype)

        def mean_loss(lg):
            return jnp.mean(optax.ctc_loss(lg, jnp.zeros(lg.shape[:2], dtype), jnp.asarray(labels),
                                           jnp.asarray(pad, dtype)))

        loss = np.asarray(optax.ctc_loss(lg, jnp.zeros(lg.shape[:2], dtype), jnp.asarray(labels),
                                         jnp.asarray(pad, dtype)))
        return loss, np.asarray(jax.grad(mean_loss)(lg))


def port_ctc(fn, logits, labels, pad):
    x = torch.from_numpy(np.asarray(logits, np.float32)).requires_grad_()
    loss = fn(x, labels, pad)
    loss.mean().backward()
    return loss.detach().numpy(), x.grad.numpy()


# -- the loss ------------------------------------------------------------------


@pytest.mark.parametrize("frames", [32, 64])
@pytest.mark.parametrize("fn", ["ctc_loss", "ctc_loss_plain"])
def test_ctc_loss_equals_optax_on_feasible_rows(frames, fn):
    """Repeats, padding, empty labels and the full 24, at T = 32 and 64."""
    rng = np.random.default_rng(frames)
    logits = rng.normal(0, 3, (8, frames, K)).astype(np.float32)
    labels, pad = labels_batch(rng, 8, n_max=12)
    labels[1], pad[1] = np.arange(24) % (K - 1) + 1, 0.0  # 24 labels, no repeat
    assert T.ctc_feasible(labels, pad, frames).all()
    got, gg = port_ctc(getattr(T, fn), logits, labels, pad)
    want, wg = optax_ctc(logits, labels, pad)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.abs(gg - wg).max() <= 5e-4 * np.abs(wg).max()


def test_ctc_loss_on_infeasible_rows_is_optaxs_finite_value():
    """Rows whose labels and repeats outnumber the frames (T = 12): optax's
    ε-smoothed value, not torch's ``inf``; the gradient as close to optax's
    float64 one as float32 optax is."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (6, 12, 7)).astype(np.float32)
    rows = [[1, 2, 3], [2, 2, 2, 3], [1] * 7, [1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6, 1], [3], []]
    labels, pad = np.zeros((6, 24), np.int32), np.ones((6, 24), np.float32)
    for i, r in enumerate(rows):
        labels[i, :len(r)], pad[i, :len(r)] = r, 0.0
    np.testing.assert_array_equal(T.ctc_feasible(labels, pad, 12),
                                  [True, True, False, False, True, True])
    assert not np.isfinite(F.ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1).permute(
        1, 0, 2), torch.from_numpy(labels).long(), (12,) * 6,
        tuple(T.label_lengths(pad)), reduction="none").numpy()[2:4]).any()
    got, gg = port_ctc(T.ctc_loss, logits, labels, pad)
    want, wg = optax_ctc(logits, labels, pad)
    _, g64 = optax_ctc(logits, labels, pad, jnp.float64)
    assert np.isfinite(got).all() and got[2] > 9e4
    np.testing.assert_allclose(got, want, rtol=1e-6)
    scale = np.abs(g64).max()
    jax_err = np.abs(wg - g64).max() / scale
    assert np.abs(gg - g64).max() / scale <= jax_err * 1.01 + 1e-6
    ok = np.array([0, 1, 4, 5])
    assert np.abs(gg[ok] - wg[ok]).max() <= 5e-4 * scale


def test_ctc_feasible_counts_labels_and_repeats():
    labels = np.zeros((4, 24), np.int32)
    pad = np.ones((4, 24), np.float32)
    for i, r in enumerate([[5] * 4, [1, 2] * 3, [7, 7, 1], []]):
        labels[i, :len(r)], pad[i, :len(r)] = r, 0.0
    # needs: 4 + 3 repeats = 7, 6, 3 + 1 = 4, 0
    np.testing.assert_array_equal(T.ctc_feasible(labels, pad, 6), [False, True, True, True])
    np.testing.assert_array_equal(T.ctc_feasible(labels, pad, 7), [True] * 4)
    np.testing.assert_array_equal(T.label_lengths(pad), [4, 6, 3, 0])


# -- the schedules -------------------------------------------------------------


@pytest.mark.parametrize("kind,args", [
    ("warmup", (0.0, 3e-4, 100, 3000)), ("warmup", (1e-5, 2e-3, 10, 200)),
    ("cosine", (2e-3, 1500)), ("cosine", (2e-3, 3))])
def test_schedules_equal_optax_in_float32_at_every_step(kind, args):
    if kind == "warmup":
        ours, theirs = T.warmup_cosine_decay(*args), optax.warmup_cosine_decay_schedule(*args)
    else:
        ours, theirs = T.cosine_decay(*args), optax.cosine_decay_schedule(*args)
    n = args[-1] + 5
    got = np.array([ours(i) for i in range(n)], np.float64)
    want = np.array([np.float32(theirs(i)) for i in range(n)], np.float64)
    np.testing.assert_array_equal(got, want)


def test_cosine_decay_rejects_a_nonpositive_span():
    with pytest.raises(ValueError):
        T.warmup_cosine_decay(0.0, 3e-4, 100, 50)
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 50)


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, T.WIDE, {"channels": CH, "context": CTX}])
def test_init_crnn_has_jax_shapes_and_distributions(kw):
    tp, ts = M.init_crnn(torch.Generator().manual_seed(0), num_classes=K, **kw)
    jp, js = jax_init_crnn(jax.random.key(0), num_classes=K, **kw)
    got_p, got_s = M.crnn_params_to_jax(tp, ts)
    assert {k: v.shape for k, v in leaves(got_p).items()} == \
        {k: v.shape for k, v in jax_leaves(jp).items()}
    for k, v in leaves(got_s).items():
        np.testing.assert_array_equal(v, jax_leaves(js)[k])
    for k, v in leaves(got_p).items():
        if "bn" in k:
            np.testing.assert_array_equal(v, jax_leaves(jp)[k])
        else:  # U(±1/√fan_in), weights and biases
            fan = np.prod(jax_leaves(jp)[k.replace("bias", "kernel")].shape[:3])
            assert np.abs(v).max() <= 1 / np.sqrt(fan) and np.abs(v).max() > 0.5 / np.sqrt(fan)


def test_crnn_params_round_trip_is_exact():
    tp, ts = small(3)
    jp, js = M.crnn_params_to_jax(tp, ts)
    _same(leaves((tp, ts)), leaves(M.crnn_params_from_jax(jp, js)))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


_jax_train_apply = jax.jit(lambda p, s, x, arch: jax_crnn_apply(p, s, x, train=True, arch=arch),
                           static_argnums=3)


@pytest.mark.parametrize("arch", ["t32", "t64"])
def test_train_forward_and_bn_state_match_jax(arch):
    tp, ts = small(1)
    jp, js = M.crnn_params_to_jax(tp, ts)
    x = np.random.default_rng(2).random((4, 32, 256)).astype(np.float32)
    logits, new = M.crnn_apply(tp, ts, torch.from_numpy(x)[:, None], arch=arch, train=True)
    want, jnew = _jax_train_apply(jp, js, jnp.asarray(x[..., None]), arch)
    want = np.asarray(want)
    assert logits.shape == want.shape == (4, 32 if arch == "t32" else 64, K)
    assert np.abs(logits.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    got_s = leaves(M.crnn_params_to_jax(tp, new)[1])
    for k, v in jax_leaves(jnew).items():
        assert np.linalg.norm(got_s[k] - v) <= 1e-5 * np.linalg.norm(v), k
    assert all(not t.requires_grad for t in leaves(new).values() if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("window", [(2, 1), (2, 2)])
def test_pool_sends_tied_gradients_where_xla_does(window):
    """Windows full of ties (values from {0, 1, 2}): the gradient lands on
    the first maximum in row-major order, as XLA's ``select_and_scatter``
    (select ``ge``) sends it."""
    x = np.random.default_rng(0).integers(0, 3, (2, 3, 8, 6)).astype(np.float32)
    up = np.random.default_rng(1).normal(size=(2, 3, 4, 6 // window[1])).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    (F.max_pool2d(t, window) * torch.from_numpy(up)).sum().backward()
    win = (1, 1) + window

    def f(a):
        return jnp.sum(lax.reduce_window(a, -jnp.inf, lax.max, win, win, "VALID") * up)

    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(x))))


# -- the steps -----------------------------------------------------------------


def _batch(seed, b=6):
    rng = np.random.default_rng(seed)
    x = rng.random((b, 32, 256)).astype(np.float32)
    labels, pad = labels_batch(rng, b, n_max=9)
    return x, labels, pad


@pytest.mark.parametrize("arch", ["t32", "t64"])
def test_three_steps_match_jax_and_a_float64_step(arch):
    x, labels, pad = _batch(4)
    tp, ts = small(5)
    jp, js = M.crnn_params_to_jax(tp, ts)
    start = leaves(jp)
    opt = optax.adamw(3e-4, weight_decay=1e-5)
    jstep = JT.make_train_step(opt, arch=arch)
    p, s = jax.tree.map(jnp.array, jp), jax.tree.map(jnp.array, js)
    o, jl = opt.init(p), []

    def jloss(p):
        logits, _ = jax_crnn_apply(p, js, jnp.asarray(x[..., None]), train=True, arch=arch)
        return jnp.mean(optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]), labels, pad))

    jg = jax_leaves(jax.jit(jax.grad(jloss))(jp))
    for _ in range(3):
        p, s, o, loss = jstep(p, s, o, jnp.asarray(x[..., None]), jnp.asarray(labels),
                              jnp.asarray(pad))
        jl.append(float(loss))
    crnn64 = _script().crnn64
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def loss64(q):
            logits, _ = crnn64(q, to64(js), jnp.asarray(x[..., None], jnp.float64), arch)
            return jnp.mean(optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]), labels,
                                           jnp.asarray(pad, jnp.float64)))

        l64, g64 = jax.value_and_grad(loss64)(to64(jp))
        l64, g64 = float(l64), jax_leaves(g64)

    step = T.make_train_step(arch, device="cpu")
    optim = T.make_optimizer(tp)
    tl = []
    for i in range(3):
        tp, ts, loss = step(tp, ts, optim, torch.from_numpy(x)[:, None], labels, pad, 3e-4)
        tl.append(float(loss))
        if i == 0:
            tg = leaves(M.crnn_params_to_jax(_grads(tp), ts)[0])
    assert abs(tl[0] - l64) / l64 <= 1e-5
    assert abs(tl[0] - jl[0]) <= abs(jl[0] - l64) * 1.01 + 1e-5 * l64
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for k, g in g64.items():
        norm = np.linalg.norm(g)
        if _pre_bn_bias(k):
            assert np.linalg.norm(tg[k]) <= 1e-3 * np.linalg.norm(g64[k.replace("bias", "kernel")])
            continue
        jax_err = np.linalg.norm(jg[k] - g) / norm
        assert np.linalg.norm(tg[k] - g) / norm <= jax_err + 1e-3, k
    after, jafter = leaves(M.crnn_params_to_jax(tp, ts)[0]), jax_leaves(p)
    for k, v in jafter.items():
        moved = np.linalg.norm(v - start[k])
        if _pre_bn_bias(k):
            assert np.linalg.norm(after[k] - start[k]) <= 3.03 * 3e-4 * np.sqrt(v.size)
        else:
            assert np.linalg.norm(after[k] - v) <= 1e-2 * moved, k


def _pre_bn_bias(key):
    return key.startswith(("['conv']", "['ctx']")) and key.endswith("['bias']")


def _grads(params):
    """The params tree with each leaf replaced by its ``.grad``."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t.grad
    return walk(params)


# -- evaluation and weights ------------------------------------------------------


def test_evaluate_equals_jax_evaluate_on_rendered_lines():
    """The bundled recognizer on 16 lines JAX renders from one seed: the
    port reads them as uint8 (``np.rint(img·255)``, exact) and gives JAX's
    exact-match rate and CER."""
    params, state, charset, arch = JT.load_weights_ex()
    want = JT.evaluate(params, state, np.random.default_rng(99), n_batches=1, batch_size=16,
                       charset=charset, arch=arch)
    imgs, _, _, texts = JD.make_batch(16, np.random.default_rng(99), charset)
    lines = np.rint(imgs[..., 0] * 255).astype(np.uint8)
    assert np.array_equal(lines / np.float32(255), imgs[..., 0])
    tp, ts, tcs, tarch = T.load_weights_ex()
    got = T.evaluate(tp, ts, [(lines[:10], texts[:10]), (lines[10:], texts[10:])], tcs, tarch,
                     device="cpu")
    assert got == want


def test_levenshtein_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = "".join(rng.choice(list("AB1-金"), int(rng.integers(0, 8))))
        b = "".join(rng.choice(list("AB1-金"), int(rng.integers(0, 8))))
        assert T._levenshtein(a, b) == JT._levenshtein(a, b)


@pytest.mark.parametrize("arch,cjk", [("t32", False), ("t64", True)])
def test_weight_files_load_in_both_packages(tmp_path, arch, cjk):
    from twinvoice_tpu_torch.ocr.torchocr.charset import cjk_charset

    cs = cjk_charset() if cjk else DEFAULT
    tp, ts = small(6, classes=cs.num_classes)
    T.save_weights(tmp_path / "port.npz", tp, ts, cs, arch=arch)
    jp, js, jcs, jarch = JT.load_weights_ex(str(tmp_path / "port.npz"))
    assert jcs.chars == cs.chars and jarch == arch
    want_p, want_s = M.crnn_params_to_jax(tp, ts)
    for a, b in ((jax_leaves(jp), leaves(want_p)), (jax_leaves(js), leaves(want_s))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with np.load(tmp_path / "port.npz") as z:
        assert tuple(z["channels"]) == CH and int(z["context"]) == CTX
    # and back: the JAX trainer's file read by the port
    JT.save_weights(str(tmp_path / "jax.npz"), jp, js, JaxCharset(cs.chars), arch=arch)
    bp, bs, bcs, barch = T.load_weights_ex(str(tmp_path / "jax.npz"))
    assert bcs.chars == cs.chars and barch == arch
    _same(leaves((bp, bs)), leaves((tp, ts)))


# -- the loop ------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """101 steps of small ops on one intra-op thread: under the suite's
    parallel workers each process's thread pool would oversubscribe the
    cores, and every small op would wait for its pool (minutes, not
    seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(seed, n=16):
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, 256, (n, 32, 256), dtype=np.uint8)
    texts = [JD.random_field_text(rng) for _ in range(n)]
    labels, pad, texts = TD.encode_labels(texts)
    return lines, labels, pad, texts


def test_train_follows_its_schedule_and_pool_draws(tmp_path, one_thread):
    """``train`` from a small saved model over a pool of two b8 batches:
    the same params as the steps taken by hand with the schedule's lr and
    ``rng.integers`` draws; the file it saves reads back to them; its
    metrics are ``evaluate``'s."""
    tp, ts = small(7, classes=DEFAULT.num_classes)
    T.save_weights(tmp_path / "start.npz", tp, ts, DEFAULT, arch="t32")
    lines, labels, pad, texts = _pool(8)
    evalb = [(lines[:8], texts[:8])]
    log = []
    params, state, metrics = T.train(
        str(tmp_path / "out.npz"), steps=101, batch_size=8, seed=3,
        batches=(lines, labels, pad), eval_batches=evalb, charset=DEFAULT, arch="t32",
        resume_from=str(tmp_path / "start.npz"), device="cpu", log=log.append)
    rng = np.random.default_rng(3)
    sched = T.warmup_cosine_decay(0.0, 3e-4, 100, 101)
    hp, hs, _, _ = T.load_weights_ex(str(tmp_path / "start.npz"))
    opt, step = T.make_optimizer(hp), T.make_train_step("t32", device="cpu")
    for it in range(101):
        i = 8 * int(rng.integers(0, 2))
        hp, hs, _ = step(hp, hs, opt, TD.lines_to_tensor(lines[i:i + 8], "cpu"),
                         labels[i:i + 8], pad[i:i + 8], sched(it))
    _same(leaves((params, state)), leaves((hp, hs)))
    _same(leaves(tuple(T.load_weights_ex(str(tmp_path / "out.npz"))[:2])), leaves((hp, hs)))
    assert metrics == dict(zip(("exact", "cer"), T.evaluate(hp, hs, evalb, DEFAULT, "t32",
                                                            device="cpu")))
    assert any("warm-starting" in m for m in log) and any("step 1/101" in m for m in log)


def test_train_rejects_a_resume_file_of_another_arch(tmp_path):
    tp, ts = small(7, classes=DEFAULT.num_classes)
    T.save_weights(tmp_path / "start.npz", tp, ts, DEFAULT, arch="t32")
    lines, labels, pad, texts = _pool(8)
    with pytest.raises(ValueError, match="arch"):
        T.train(str(tmp_path / "out.npz"), steps=101, batch_size=8,
                batches=(lines, labels, pad), eval_batches=[(lines, texts)], arch="t64",
                resume_from=str(tmp_path / "start.npz"), device="cpu", log=lambda m: None)


def test_main_trains_from_a_line_npz(tmp_path, capsys, one_thread):
    tp, ts = small(9, classes=DEFAULT.num_classes)
    T.save_weights(tmp_path / "start.npz", tp, ts, DEFAULT, arch="t32")
    lines, labels, pad, texts = _pool(10)
    np.savez(tmp_path / "lines.npz", charset=np.array(DEFAULT.chars), lines=lines, labels=labels,
             label_pad=pad, texts=np.asarray(texts), eval_lines=lines[:8],
             eval_labels=labels[:8], eval_label_pad=pad[:8], eval_texts=np.asarray(texts[:8]))
    T.main([str(tmp_path / "lines.npz"), str(tmp_path / "out.npz"), "101", "--t32",
            "--batch=8", "--device=cpu", f"--resume={tmp_path / 'start.npz'}"])
    assert "saved weights to" in capsys.readouterr().out
    p, s, cs, arch = JT.load_weights_ex(str(tmp_path / "out.npz"))
    assert arch == "t32" and cs.chars == DEFAULT.chars
