"""CTC training for the recognizer on one device: the port of
``twinvoice_tpu/ocr/jaxocr/train.py``.

What the JAX trainer computes, step for step: the mean over the batch of
``optax.ctc_loss`` (blank 0, every frame valid) on train-mode logits, AdamW
(betas 0.9/0.999, eps 1e-8, weight decay 1e-5 on every leaf, as
``optax.adamw``) at optax's ``warmup_cosine_decay_schedule(0, lr, 100,
steps)``, lr 3e-4, batch 64, the ``t64`` arch; a snapshot every 1000 steps,
exact-match and CER on held-out lines, and the weights in the JAX package's
npz format, which either package loads.

Its lines come from the port's own renderer (``data.make_lines``, JAX's
``make_batch`` without Pillow or OpenCV): a fresh batch each step, a cached
pool (``cache_batches``, with ``refresh``'s re-rendering thread), both from
JAX's generator in JAX's order; or from the caller (``batches``, e.g. an npz
of lines, ``train_from_npz``), whose pool the rng only indexes.

    python -m twinvoice_tpu_torch.ocr.torchocr.train LINES.npz OUT.npz [steps]
        [--resume=weights.npz] [--lr=3e-4] [--batch=64] [--t32] [--wide]
        [--device=cpu]
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.models.unet import _tree_map, tree_leaves
from twinvoice_tpu_torch.ocr.torchocr.charset import DEFAULT, Charset
from twinvoice_tpu_torch.ocr.torchocr import data as D
from twinvoice_tpu_torch.ocr.torchocr.data import lines_to_tensor, read_line_npz
from twinvoice_tpu_torch.ocr.torchocr.model import (
    crnn_apply,
    crnn_params_to_jax,
    init_crnn,
    load_crnn_weights,
)
from twinvoice_tpu_torch.weights import keystr_items

LOG_EPSILON = -1e5   # optax.ctc_loss's stand-in for log(0)
WEIGHT_DECAY = 1e-5
WARMUP_STEPS = 100
WIDE = {"channels": (48, 96, 144, 192), "context": 384}

# a weights file reads the same in both packages
load_weights_ex = load_crnn_weights


# -- the loss ------------------------------------------------------------------


def label_lengths(label_pad) -> np.ndarray:
    """(B, N) paddings (1.0 padded, right-padded) → int64 (B,) lengths, as
    optax counts them: N − Σ pad."""
    pad = np.asarray(label_pad, np.float32)
    return pad.shape[1] - pad.sum(axis=1).astype(np.int64)


def ctc_feasible(labels, label_pad, frames: int) -> np.ndarray:
    """bool (B,): whether a row's labels fit ``frames`` frames: its L labels
    and one blank between each adjacent repeat, L + repeats ≤ frames."""
    labels = np.asarray(labels)
    lengths = label_lengths(label_pad)
    same = labels[:, 1:] == labels[:, :-1]
    repeats = np.array([same[i, :max(n - 1, 0)].sum() for i, n in enumerate(lengths)])
    return lengths + repeats <= frames


def ctc_loss_plain(logits, labels, label_pad, log_epsilon: float = LOG_EPSILON):
    """``optax.ctc_loss`` with every frame valid, in plain PyTorch: the
    per-sequence loss −log α over its log-space recursion, which stands
    ``log_epsilon`` for log 0 and so stays finite (≈ −log_epsilon) on a row
    whose labels do not fit the frames. With ``lp`` the log-softmax,
    ``rep[n]`` = [label n == label n+1], φ (N+1 blank states, φ₀ = 0, the
    rest ε) and e (N label states, all ε), each frame t:

        φ'[1:] = logaddexp(φ[1:], e + ε·rep)             label → blank
        e_t    = logaddexp(φ'[:-1] + lp[t, y], e + lp[t, y])
        φ_t    = φ' + lp[t, blank];  φ_t[1:] = logaddexp(φ_t[1:],
                 e + lp[t, blank] + ε·(1 − rep))

    and the loss is −logaddexp(φ_T[L], e_T[L−1]) (−φ_T[0] for L = 0).
    ``labels``/``label_pad`` (B, N) may be host arrays or tensors."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    b, t_max, _ = lp.shape
    dev = lp.device
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
    lengths = torch.as_tensor(label_lengths(label_pad), device=dev)
    n = labels.shape[1]
    rep = F.pad((labels[:, :-1] == labels[:, 1:]).to(torch.float32), (0, 1))
    lp_emit = torch.gather(lp, 2, labels[:, None, :].expand(b, t_max, n))
    lp_phi = lp[:, :, :1]
    phi = torch.full((b, n + 1), log_epsilon, device=dev)
    phi = torch.cat([torch.zeros((b, 1), device=dev), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), log_epsilon, device=dev)

    def update(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=1)

    for t in range(t_max):
        prev = update(phi, emit + log_epsilon * rep)
        next_emit = torch.logaddexp(prev[:, :-1] + lp_emit[:, t], emit + lp_emit[:, t])
        next_phi = update(prev + lp_phi[:, t], emit + lp_phi[:, t] + log_epsilon * (1.0 - rep))
        phi, emit = next_phi, next_emit
    last = update(phi, emit)
    return -torch.gather(last, 1, lengths[:, None])[:, 0]


def ctc_loss(logits, labels, label_pad):
    """``optax.ctc_loss``'s contract: logits (B, T, K) → one unnormalised
    loss per sequence (B,), the log-softmax taken inside in float32, blank
    0, every frame valid. ``labels`` (B, N) int and ``label_pad`` (B, N)
    (1.0 where padded) are host arrays (numpy or CPU tensors).

    Rows whose labels fit the frames go through ``F.ctc_loss`` (equal to
    optax within float32 rounding; its backward assumes log-softmaxed
    input, so that is what it gets). PyTorch gives ``inf`` on the others,
    optax a finite value and gradient from its ε-smoothed recursion: those
    rows, found on the host, go through :func:`ctc_loss_plain`."""
    b, t_max, _ = logits.shape
    dev = logits.device
    labels = np.asarray(labels, np.int64)
    lengths = label_lengths(label_pad)
    ok = ctc_feasible(labels, label_pad, t_max)

    def torch_ctc(rows):
        lp = torch.log_softmax(logits[rows].to(torch.float32), dim=-1)
        return F.ctc_loss(lp.permute(1, 0, 2), torch.from_numpy(labels[rows]).to(dev),
                          torch.full((len(rows),), t_max, dtype=torch.int64),
                          torch.from_numpy(lengths[rows]), blank=0, reduction="none")

    if ok.all():
        return torch_ctc(np.arange(b))
    loss = torch.zeros(b, device=dev)
    bad = np.flatnonzero(~ok)
    loss = loss.index_copy(0, torch.from_numpy(bad).to(dev),
                           ctc_loss_plain(logits[bad], labels[bad],
                                          np.asarray(label_pad)[bad]))
    good = np.flatnonzero(ok)
    if len(good):
        loss = loss.index_copy(0, torch.from_numpy(good).to(dev), torch_ctc(good))
    return loss


# -- the schedules -------------------------------------------------------------


def _libm_cosf():
    """The C library's float32 cosine, the function XLA's CPU code calls for
    ``cos`` (so optax's schedules round as they do in the JAX package)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def cosine_decay(init_value: float, decay_steps: int):
    """optax's ``cosine_decay_schedule(init_value, decay_steps)`` (alpha 0,
    exponent 1), each operation rounded to float32 as optax's unjitted
    evaluation rounds it: count → init·0.5·(1 + cos(π·min(count, T)/T)), as
    a Python float."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")
    f32, cosf = np.float32, _libm_cosf()
    pi, steps, init = f32(np.pi), f32(decay_steps), f32(init_value)

    def schedule(count: int) -> float:
        arg = f32(f32(pi * f32(min(count, decay_steps))) / steps)
        return float(init * f32(f32(0.5) * f32(f32(1) + f32(cosf(arg)))))

    return schedule


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int):
    """optax's ``warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps)`` (end value 0), in float32 as optax rounds
    it: linear from ``init_value`` to ``peak_value`` over the warmup, then
    :func:`cosine_decay` over ``decay_steps − warmup_steps``. The first
    update uses count 0, so with ``init_value`` 0 it moves nothing."""
    f32 = np.float32
    cos = cosine_decay(peak_value, decay_steps - warmup_steps)
    span, end = f32(init_value - peak_value), f32(peak_value)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return cos(count - warmup_steps)
        frac = f32(f32(1) - f32(f32(max(count, 0)) / f32(warmup_steps)))
        return float(f32(span * frac) + end)

    return schedule


# -- the step ------------------------------------------------------------------


def make_optimizer(params, weight_decay: float = WEIGHT_DECAY):
    """AdamW over every leaf of ``params`` (marked as requiring gradients),
    in ``tree_leaves`` order; the learning rate is set by each step."""
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    return torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_train_step(arch: str = "t64", *, device=None):
    """signature: (params, state, optimizer, images, labels, label_pad, lr)
    → (params, new_state, loss), on ``device`` (``None`` means the card).

    ``images`` is a float32 (B, 1, 32, 256) tensor (moved to ``device`` if
    it is elsewhere), ``labels``/``label_pad`` host arrays, ``lr`` a Python
    float. The params are updated in place (the same tensors come back),
    the gradients stay in their ``.grad``, and ``loss`` is a 0-d tensor on
    the device (no synchronisation)."""
    device = resolve_device(device)

    def step(params, state, optimizer, images, labels, label_pad, lr):
        images = images.to(device, non_blocking=True)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        logits, new_state = crnn_apply(params, state, images, arch=arch, train=True)
        loss = torch.mean(ctc_loss(logits, labels, label_pad))
        loss.backward()
        optimizer.step()
        return params, new_state, loss.detach()

    return step


# -- evaluation ----------------------------------------------------------------


@torch.no_grad()
def greedy_texts(params, state, images, charset: Charset, arch: str):
    """Eval-mode logits' per-frame argmax (ties to the first class), greedy
    CTC-decoded → one string a line."""
    logits, _ = crnn_apply(params, state, images, arch=arch)
    ids = torch.argmax(logits, dim=-1).cpu().numpy()
    return [charset.greedy_ctc_decode(row) for row in ids]


def render_eval_batches(rng: np.random.Generator, n_batches: int = 4, batch_size: int = 64,
                        charset: Charset = DEFAULT):
    """JAX's ``evaluate`` draws: ``n_batches`` fresh ``make_batch(batch_size,
    rng, charset)`` → a list of ``(lines uint8, texts)``."""
    out = []
    for _ in range(n_batches):
        lines, _, _, texts = D.make_lines(batch_size, rng, charset)
        out.append((lines, texts))
    return out


def evaluate(params, state, batches, charset: Charset = DEFAULT, arch: str = "t32", *,
             device=None):
    """→ (exact-match rate, char error rate) over ``batches``, an iterable of
    ``(lines uint8 (B, 32, 256), texts)``; the params on ``device``."""
    device = resolve_device(device)
    exact = total = errs = chars = 0
    for lines, texts in batches:
        for got, text in zip(greedy_texts(params, state, lines_to_tensor(lines, device),
                                          charset, arch), texts):
            exact += got == text
            total += 1
            errs += _levenshtein(got, text)
            chars += max(1, len(text))
    return exact / total, errs / chars


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


# -- weights -------------------------------------------------------------------


def save_weights(out_path, params, state, charset: Charset = DEFAULT, arch: str = "t32"):
    """The JAX package's npz: ``p/<keystr>`` and ``s/<keystr>`` leaves in its
    layout (HWIO kernels), the charset, the arch and the trunk widths, so
    the file describes itself and either package's loader reads it."""
    jp, js = crnn_params_to_jax(params, state)
    flat = {"charset": np.array(charset.chars), "arch": np.array(arch),
            "channels": np.array([c["kernel"].shape[-1] for c in jp["conv"]], np.int32),
            "context": np.array(jp["proj"]["kernel"].shape[-1], np.int32)}
    for prefix, tree in (("p", jp), ("s", js)):
        for key, leaf in keystr_items(tree):
            flat[f"{prefix}/{key}"] = leaf
    np.savez_compressed(out_path, **flat)


# -- the loop ------------------------------------------------------------------


def train(out_dir, steps: int = 3000, batch_size: int = 64, lr: float = 3e-4, seed: int = 0,
          *, batches=None, eval_batches=None, log=print, charset: Charset = DEFAULT,
          cache_batches: int = 0, arch: str = "t64", resume_from=None,
          hard_frac: float = 0.0, sev_frac: float = 0.0, dot_frac: float = 0.0,
          mixed_frac: float = 0.0, synth_frac: float = 0.0, dot_hard_frac: float = 0.0,
          wide: bool = False, refresh: bool = False, device=None):
    """Train from ``resume_from``'s weights (whose arch and charset must be
    these) or a fresh init from ``seed`` (``wide``: the wider trunk) for
    ``steps`` steps, and save to ``out_dir`` (a snapshot every 1000 steps,
    then the final weights). Returns ``(params, state, {"exact", "cer"})``.

    Without ``batches`` the lines are rendered as JAX's ``train`` renders
    them, from ``default_rng(seed)`` with JAX's fractions (``hard_frac``,
    ``sev_frac``, ``dot_frac``, ``mixed_frac``, ``synth_frac``,
    ``dot_hard_frac``): a fresh batch each step, or, with ``cache_batches``,
    a pool rendered once and drawn by ``rng.integers(0, len(pool))`` (with
    ``refresh``, a daemon thread re-renders random entries in place from
    ``default_rng(seed + 987_654)``). Given ``batches`` — ``(lines uint8
    (N, 32, 256), labels (N, 24), label_pad (N, 24))`` — the pool is cut
    from them into N // batch_size batches. The pool is held on the device.

    ``eval_batches``: held-out ``(lines, texts)`` pairs for
    :func:`evaluate`; without them, JAX's four fresh batches of 64 from
    ``default_rng(seed + 1)``.

    It sets no global flag: for float32 parity with the JAX trainer on a
    card, the caller turns TF32 off first."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if resume_from:
        params, state, cs2, a2 = load_weights_ex(resume_from)
        if a2 != arch or cs2.chars != charset.chars:
            raise ValueError(f"{resume_from}: arch {a2!r} and its charset do not match "
                             f"arch {arch!r} and the given charset")
        log(f"warm-starting from {resume_from}")
    else:
        params, state = init_crnn(torch.Generator().manual_seed(seed),
                                  num_classes=charset.num_classes, **(WIDE if wide else {}))
    params, state = (_tree_map(lambda t: t.to(device), tree) for tree in (params, state))
    optimizer = make_optimizer(params)
    schedule = warmup_cosine_decay(0.0, lr, WARMUP_STEPS, steps)
    step_fn = make_train_step(arch, device=device)

    fracs = dict(hard_frac=hard_frac, sev_frac=sev_frac, dot_frac=dot_frac,
                 mixed_frac=mixed_frac, synth_frac=synth_frac, dot_hard_frac=dot_hard_frac)

    def render(r):
        lines_, labels_, pad_, _ = D.make_lines(batch_size, r, charset, **fracs)
        return torch.as_tensor(lines_).to(device), labels_, pad_

    pool = None
    stop_refresh: list = []
    if batches is not None:
        lines, labels, pad = batches
        pool = [(torch.as_tensor(lines[i:i + batch_size]).to(device),
                 labels[i:i + batch_size], pad[i:i + batch_size])
                for i in range(0, len(lines) - batch_size + 1, batch_size)]
        if not pool:
            raise ValueError(f"{len(lines)} lines make no batch of {batch_size}")
        log(f"pool of {len(pool)} batches of {batch_size} on {device}")
    elif cache_batches:
        t0 = time.time()
        pool = [render(rng) for _ in range(cache_batches)]
        log(f"pre-rendered {cache_batches} batches in {time.time() - t0:.0f}s")
        if refresh:
            import threading

            def _refresher():
                rr = np.random.default_rng(seed + 987_654)
                while not stop_refresh:
                    i = int(rr.integers(0, len(pool)))
                    pool[i] = render(rr)

            threading.Thread(target=_refresher, daemon=True).start()
            log("cache refresher running (continuous in-place re-render)")

    t0 = time.time()
    for it in range(1, steps + 1):
        if pool is not None:
            imgs, lab, pd = pool[int(rng.integers(0, len(pool)))]
        else:
            imgs, lab, pd = render(rng)
        params, state, loss = step_fn(params, state, optimizer, lines_to_tensor(imgs, device),
                                      lab, pd, schedule(it - 1))
        if it % 200 == 0 or it == 1:
            log(f"step {it}/{steps} loss {float(loss):.4f} ({time.time() - t0:.0f}s)")
        if it % 1000 == 0 and it < steps:
            # periodic snapshot: a long run must survive a kill
            save_weights(out_dir, params, state, charset, arch=arch)
            log(f"snapshot saved at step {it}")
    stop_refresh.append(True)
    if eval_batches is None:
        eval_batches = render_eval_batches(np.random.default_rng(seed + 1), charset=charset)
    acc, cer = evaluate(params, state, eval_batches, charset, arch, device=device)
    log(f"eval: exact={acc:.3f} cer={cer:.4f}")
    save_weights(out_dir, params, state, charset, arch=arch)
    log(f"saved weights to {out_dir}")
    return params, state, {"exact": acc, "cer": cer}


def train_from_npz(src, out, steps: int = 3000, batch_size: int = 64, lr: float = 3e-4,
                   *, arch: str = "t64", resume_from=None, wide: bool = False, device=None,
                   log=print):
    """:func:`train` on a file of pre-rendered lines (``read_line_npz``'s
    keys, the held-out ones under ``eval_``; its ``charset`` if it has one),
    saving to ``out``."""
    with np.load(src) as z:
        charset = Charset(str(z["charset"])) if "charset" in z.files else DEFAULT
    lines, labels, pad, _ = read_line_npz(src)
    eval_lines, _, _, eval_texts = read_line_npz(src, prefix="eval_")
    return train(out, steps=steps, batch_size=batch_size, lr=lr,
                 batches=(lines, labels, pad),
                 eval_batches=[(eval_lines[i:i + batch_size], eval_texts[i:i + batch_size])
                               for i in range(0, len(eval_lines), batch_size)],
                 charset=charset, arch=arch, resume_from=resume_from, wide=wide,
                 device=device, log=log)


def main(argv):
    args = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    if len(args) < 2:
        raise SystemExit(__doc__)
    train_from_npz(args[0], args[1], steps=int(args[2]) if len(args) > 2 else 3000,
                   batch_size=int(opts.get("batch", 64)), lr=float(opts.get("lr", 3e-4)),
                   arch="t32" if "t32" in opts else "t64", resume_from=opts.get("resume"),
                   wide="wide" in opts, device=opts.get("device"))


if __name__ == "__main__":
    main(sys.argv[1:])
