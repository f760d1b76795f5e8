"""Pipeline parallelism: GPipe-style microbatched stage execution
(``twinvoice_tpu.parallel.pipeline``).

S homogeneous stages lie on the mesh's ``stage`` axis, one a rank, and the
microbatches stream from stage to stage in the classic (M + S − 1)-step
GPipe schedule. JAX passes each output rightward with ``ppermute``; the port
writes it into the next stage's slot of a zero buffer and all-reduces that
(exact: every slot holds one rank's values and zeros). Stages must share
their input and output shape (a homogeneous tower); the U-Net's pyramid
stages are not, so its axes stay data, model and spatial.
"""

from __future__ import annotations

import torch

from twinvoice_tpu_torch.core.collectives import sum_over
from twinvoice_tpu_torch.core.mesh import Mesh
from twinvoice_tpu_torch.models.unet import _tree_map


def pipeline_apply(stage_fn, stage_params, x_micro, mesh: Mesh, axis: str = "stage"):
    """Run microbatches through S pipelined stages, on every rank of ``axis``.

    - ``stage_fn(params_i, x) -> y`` with ``y.shape == x.shape``
    - ``stage_params``: a tree whose leaves have a leading stage dim S (the
      same on every rank; each takes its own stage's slice)
    - ``x_micro``: (M, *item_shape) microbatches (the same on every rank;
      only stage 0 reads them)
    Returns the (M, *item_shape) outputs of the last stage, on every rank.
    """
    ax = mesh.axis(axis)
    n_stages, stage = ax.size, ax.index
    n_micro = x_micro.shape[0]
    params = _tree_map(lambda a: a[stage], stage_params)
    buf = torch.zeros_like(x_micro[0])       # my input from the stage on my left
    outs = None
    for t in range(n_micro + n_stages - 1):
        if stage == 0:
            buf = x_micro[t] if t < n_micro else torch.zeros_like(x_micro[0])
        out = stage_fn(params, buf)
        if outs is None:
            outs = out.new_zeros((n_micro,) + tuple(out.shape))
        # pass my output rightward: each stage writes its right neighbour's slot
        slots = out.new_zeros((n_stages,) + tuple(out.shape))
        if stage < n_stages - 1:
            slots[stage + 1] = out
        buf = sum_over(slots, ax)[stage]
        # the last stage emits a finished microbatch at steps >= S − 1
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = out
    # only the last stage holds outputs: the sum puts them on every rank
    return sum_over(outs, ax)


def stack_stage_params(params_list):
    """List of per-stage param trees → one tree with a leading stage dim."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in params_list]) for k in first}
    if isinstance(first, list):
        return [stack_stage_params([p[i] for p in params_list]) for i in range(len(first))]
    return torch.stack(params_list)
