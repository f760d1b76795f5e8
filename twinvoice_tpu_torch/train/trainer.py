"""Training loop (``twinvoice_tpu.train.trainer``): AdamW + cosine warm
restarts on one device.

What the JAX trainer computes, step for step: global batch 4, AdamW (lr 1e-3,
weight decay 1e-4 on every leaf, as ``optax.adamw``), the learning rate held
for an epoch at ``CosineAnnealingWarmRestarts(T_0=10, T_mult=2)``'s value
rounded to float32, loss ``0.85·dice + 0.15·focal``, train-mode BatchNorm
with functional running statistics, the best checkpoint on the lowest average
*training* loss, a visual dump of each epoch's first batch, an optional
validation split with per-class IoU, and resume from a checkpoint (the
port's own, or the JAX package's Orbax directory: ``checkpoint.restore``).

The step runs eagerly (autograd, then ``optimizer.step()``), keeps the loss on
the device, and the loop synchronises once an epoch (or every ``sync_every``
steps). Batches are uploaded ahead of the step by a worker thread, from
pinned memory on a side stream.

Across ranks (``mesh``, a ``core.mesh.Mesh`` over ``torch.distributed``):
each rank computes its part of the loss of its block of the global batch
(``unet_apply(mesh=...)``, BatchNorm statistics over the whole batch), the
parameter gradients are summed over the ``batch`` axis in one all-reduce (so
they are the global mean loss's), and each rank steps its slices of the
model-sharded leaves and of their optimizer moments (``shard_train_state``).
``fit(mesh=...)`` runs on every rank; rank 0 logs, writes the visual dumps
and saves whole (gathered) checkpoints, which the one-rank ``fit`` resumes
from, and the reverse.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.config import Config, TrainConfig, UNetConfig
from twinvoice_tpu_torch.core.collectives import reduce_sum
from twinvoice_tpu_torch.core.mesh import (
    gather_leaf,
    gather_tree,
    param_shardings,
    parallel,
    shard_batch,
    shard_leaf,
    shard_tree,
)
from twinvoice_tpu_torch.models.unet import _tree_map, init_unet, tree_leaves, unet_apply
from twinvoice_tpu_torch.train import checkpoint as ckpt
from twinvoice_tpu_torch.train.losses import invoice_loss
from twinvoice_tpu_torch.train.metrics import per_class_iou
from twinvoice_tpu_torch.train.schedule import cosine_warm_restarts
from twinvoice_tpu_torch.train.visualize import dump_epoch_visual

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    params: Any
    bn_state: Any
    optimizer: torch.optim.Optimizer
    epoch: int = 0          # completed epochs
    best_loss: float = float("inf")
    shardings: Any = None   # {"params": specs, "bn_state": specs} once sharded


def make_optimizer(params, cfg: TrainConfig):
    """AdamW over every leaf of ``params`` (which it marks as requiring
    gradients); the learning rate is set by each step."""
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    return torch.optim.AdamW(leaves, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def make_train_step(model_cfg: UNetConfig, cfg: TrainConfig, *, device=None, mesh=None):
    """signature: (params, bn_state, optimizer, images, masks, lr)
    → (params, bn_state, loss), on ``device`` (``None`` means the card).

    ``images``/``masks`` are NCHW tensors (moved to ``device`` if they are
    elsewhere), ``lr`` a Python float; the params live on ``device``. The
    params are updated in place (the same tensors come back), the gradients
    stay in their ``.grad``, and ``loss`` is a 0-d tensor on the device (no
    synchronisation).

    With a ``mesh`` of more than one rank, every rank calls the step with the
    global batch and its state from :func:`shard_train_state`, and computes
    on its block of the batch; the loss is the global batch's on every rank,
    and the gradients are the global mean loss's."""
    device = resolve_device(device)
    mesh = mesh if parallel(mesh) else None

    def step(params, bn_state, optimizer, images, masks, lr):
        if mesh is not None:
            images = shard_batch(images, mesh).contiguous()
            masks = shard_batch(masks, mesh).contiguous()
        images = images.to(device, non_blocking=True)
        masks = masks.to(device, non_blocking=True)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        logits, new_bn = unet_apply(params, bn_state, images, cfg=model_cfg, train=True,
                                    remat=cfg.remat, fast_norm=cfg.fast_norm, mesh=mesh)
        loss = invoice_loss(logits, masks, cfg.loss, mesh=mesh)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            batch = mesh.axis("batch")
            _sum_grads(optimizer, batch)
            loss = reduce_sum(loss.clone(), batch)
        optimizer.step()
        return params, new_bn, loss

    return step


def _sum_grads(optimizer, axis):
    """Sum every parameter's gradient over ``axis`` in one all-reduce."""
    grads = [p.grad for group in optimizer.param_groups for p in group["params"]
             if p.grad is not None]
    flat = reduce_sum(torch.cat([g.reshape(-1) for g in grads]), axis)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _rebuild(state, params, bn_state, param_specs, shardings, leaf_fn):
    """A ``TrainState`` over ``params``, with ``state``'s optimizer (class,
    settings, step counts) and its moments mapped by ``leaf_fn(tensor, spec)``
    (``spec``: the matching param's in ``param_specs``)."""
    old = state.optimizer
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    # the saved param groups carry every setting of the optimizer
    optimizer = type(old)(leaves, lr=old.defaults["lr"])
    specs = tree_leaves(param_specs)
    optimizer.load_state_dict(ckpt.map_optimizer_state(
        old.state_dict(), lambda i, t: leaf_fn(t, specs[i])))
    return TrainState(params, bn_state, optimizer, state.epoch, state.best_loss, shardings)


def shard_train_state(state: TrainState, mesh):
    """Each rank keeps its slice of each model-sharded leaf (``core.mesh``'s
    rule) of the params, the BN state and the optimizer's moments. ``state``
    holds the whole tree (every rank the same)."""
    specs = {"params": param_shardings(mesh, state.params),
             "bn_state": param_shardings(mesh, state.bn_state)}
    params = shard_tree(_tree_map(lambda t: t.detach(), state.params), mesh, specs["params"])
    bn_state = shard_tree(state.bn_state, mesh, specs["bn_state"])
    return _rebuild(state, params, bn_state, specs["params"], specs,
                    lambda t, spec: shard_leaf(t, spec, mesh))


def gather_train_state(state: TrainState, mesh):
    """The whole train state from each rank's slices (a collective: every
    rank calls it); ``state`` itself where nothing is sharded (no mesh, or
    no ``model`` axis)."""
    specs = state.shardings
    if specs is None or mesh.shape["model"] == 1:
        return state
    params = gather_tree(state.params, mesh, specs["params"])
    bn_state = gather_tree(state.bn_state, mesh, specs["bn_state"])
    return _rebuild(state, params, bn_state, specs["params"], None,
                    lambda t, spec: gather_leaf(t, spec, mesh))


def make_eval_step(model_cfg: UNetConfig, cfg: TrainConfig, thresholds=(0.25, 0.40, 0.30)):
    """signature: (params, bn_state, images, masks) → (loss, per-class IoU),
    eval-mode BatchNorm, IoU of ``sigmoid > thresholds`` against ``masks > 0.5``."""
    thr = torch.tensor(thresholds, dtype=torch.float32)

    @torch.no_grad()
    def step(params, bn_state, images, masks):
        logits, _ = unet_apply(params, bn_state, images, cfg=model_cfg, train=False)
        loss = invoice_loss(logits, masks, cfg.loss)
        prob = torch.sigmoid(logits.to(torch.float32))
        iou = per_class_iou(prob > thr.to(prob.device)[:, None, None], masks > 0.5)
        return loss, iou

    return step


def to_device_batch(images, masks, dtype, device):
    """NHWC float32 numpy batch → contiguous NCHW tensors in ``dtype`` on
    ``device``. To a card the copy is asynchronous, from pinned memory, on
    the current stream. NCHW-contiguous, not channels-last: on an H100 its
    steps were the faster ones, and on the CPU PyTorch sums a channels-last
    tensor over N, H and W one element after another, so BatchNorm's
    statistics would lose precision."""

    def one(a):
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        return t.to(dtype).permute(0, 3, 1, 2).contiguous()

    return one(images), one(masks)


def _prefetch_batches(gen, size, dtype, device):
    """Run a host batch generator on a worker thread, ``size`` batches ahead.

    The worker also uploads each batch (``to_device_batch``), on a side
    stream of the card, so the host's batch preparation and the copies
    overlap the device's compute on the steps before. Before the main stream
    uses a batch it waits on the event recorded after its upload, and each
    tensor is marked as used by the main stream (``record_stream``) so that
    its memory is not handed back to the side stream while the step still
    reads it. ``size=0`` is the synchronous path. Batch order is the
    generator's own, so the losses are the same either way.
    """
    if size <= 0:
        for images, masks in gen:
            yield to_device_batch(images, masks, dtype, device)
        return

    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end, err = object(), object()

    def worker():
        try:
            for images, masks in gen:
                if cuda:
                    with torch.cuda.stream(side):
                        batch = to_device_batch(images, masks, dtype, device)
                        ready = torch.cuda.Event()
                        ready.record(side)
                else:
                    batch, ready = to_device_batch(images, masks, dtype, device), None
                q.put((batch, ready))
            q.put(end)
        except BaseException as e:  # surface loader errors on the main thread
            q.put((err, e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if item[0] is err:
            raise item[1]
        batch, ready = item
        if ready is not None:
            main = torch.cuda.current_stream(device)
            main.wait_event(ready)
            for t in batch:
                t.record_stream(main)
        yield batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(
    dataset,
    cfg: Config = Config(),
    *,
    mesh=None,
    device=None,
    resume_dir: Optional[str] = None,
    log: Callable[[str], None] = print,
    on_epoch_end: Optional[Callable] = None,
):
    """Full training run on ``device`` (``None`` means the card).
    ``dataset`` is a ``data.dataset.ArrayDataset``. Returns
    ``(state: TrainState, history: list[dict])``.

    With a ``mesh`` (``core.mesh.make_mesh``) of more than one rank it runs
    on every rank: each draws the same batch order, uploads every full batch
    and computes on its block of it; the state it returns is its slices, the
    history the same on every rank. Rank 0 logs, dumps the visuals and saves
    the whole (gathered) state; ``on_epoch_end`` runs on every rank.

    It sets no global flag: for float32 parity with the JAX trainer on a
    card, the caller turns TF32 off first
    (``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False``).
    """
    device = resolve_device(device)
    mesh = mesh if parallel(mesh) else None
    lead = mesh is None or mesh.rank == 0
    tcfg, mcfg = cfg.train, cfg.model
    dtype = DTYPES[tcfg.dtype]

    params, bn_state = init_unet(torch.Generator().manual_seed(tcfg.seed), mcfg,
                                 device=device)
    state = TrainState(params, bn_state, make_optimizer(params, tcfg))
    if mesh is not None:
        state = shard_train_state(state, mesh)

    if resume_dir and ckpt.has_checkpoint(resume_dir):
        state = ckpt.restore(resume_dir, state, mesh)
        if lead:
            log(f"resumed from {resume_dir} at epoch {state.epoch}")

    train_step = make_train_step(mcfg, tcfg, device=device, mesh=mesh)
    schedule = cosine_warm_restarts(
        tcfg.lr, tcfg.warm_restart_t0, tcfg.warm_restart_tmult, tcfg.eta_min
    )

    val_set = None
    if tcfg.val_fraction > 0:
        dataset, val_set = dataset.split(tcfg.val_fraction, seed=tcfg.seed)
        eval_step = make_eval_step(mcfg, tcfg)

    history = []
    loader_rng = np.random.default_rng(tcfg.seed)
    if lead:
        os.makedirs(tcfg.checkpoint_dir, exist_ok=True)

    for epoch in range(state.epoch + 1, tcfg.epochs + 1):
        t0 = time.time()
        losses = []
        lr = float(np.float32(schedule(epoch - 1)))
        for bi, (images, masks) in enumerate(_prefetch_batches(
            dataset.batches(tcfg.batch_size, rng=loader_rng, dtype=np.float32),
            tcfg.prefetch, dtype, device,
        )):
            state.params, state.bn_state, loss = train_step(
                state.params, state.bn_state, state.optimizer, images, masks, lr
            )
            # the loss stays on the device: one sync at the epoch's end, or
            # every ``sync_every`` steps to bound how far the host runs ahead
            losses.append(loss)
            if tcfg.sync_every and (bi + 1) % tcfg.sync_every == 0:
                _sync(device)
            if bi == 0 and tcfg.visualize:
                whole = gather_train_state(state, mesh)
                if lead:
                    dump_epoch_visual(
                        images[0].permute(1, 2, 0).to(torch.float32).cpu().numpy(),
                        masks[0].permute(1, 2, 0).to(torch.float32).cpu().numpy(),
                        whole.params, whole.bn_state, mcfg,
                        tcfg.visualize_dir, f"epoch{epoch:03d}",
                    )
        avg = float(torch.mean(torch.stack(losses))) if losses else 0.0
        state.epoch = epoch
        whole = gather_train_state(state, mesh)
        rec = {"epoch": epoch, "loss": avg, "lr": lr, "sec": time.time() - t0}
        if val_set is not None and len(val_set):
            vloss, viou = 0.0, np.zeros(mcfg.num_classes)
            vb = 0
            for images, masks in val_set.batches(
                tcfg.batch_size, shuffle=False, dtype=np.float32
            ):
                loss_v, iou_v = eval_step(whole.params, whole.bn_state,
                                          *to_device_batch(images, masks, dtype, device))
                vloss += float(loss_v)
                viou += iou_v.cpu().numpy()
                vb += 1
            rec["val_loss"] = vloss / max(vb, 1)
            rec["val_iou"] = (viou / max(vb, 1)).tolist()
        history.append(rec)
        extra = (
            f" | val {rec['val_loss']:.4f} iou {np.mean(rec['val_iou']):.3f}"
            if "val_loss" in rec else ""
        )
        if lead:
            log(f"epoch {epoch} | loss {avg:.6f} | lr {lr:.2e} | {rec['sec']:.1f}s{extra}")

        if avg < state.best_loss:
            state.best_loss = whole.best_loss = avg
            if lead:
                ckpt.save(os.path.join(tcfg.checkpoint_dir, "best"), whole)
        if lead:
            ckpt.save(os.path.join(tcfg.checkpoint_dir, "latest"), whole)
        if on_epoch_end:
            on_epoch_end(state, rec)

    if mesh is not None:
        dist.barrier()  # rank 0's checkpoints are written before any rank returns
    return state, history
