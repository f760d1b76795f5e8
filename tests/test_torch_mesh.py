"""PyTorch port: the rank grid (``core.mesh``), its sharding rule against the
JAX package's ``param_shardings`` on the 2×2×2 (and 2×4×1) JAX mesh, leaf by
leaf, ``MeshConfig`` and the precision ``Policy``."""

import dataclasses
import datetime

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from twinvoice_tpu.config import Config as JaxConfig
from twinvoice_tpu.config import MeshConfig as JaxMeshConfig
from twinvoice_tpu.core.mesh import make_mesh as jax_make_mesh
from twinvoice_tpu.core.mesh import param_shardings as jax_param_shardings
from twinvoice_tpu.core.precision import Policy as JaxPolicy
from twinvoice_tpu_torch.config import Config, MeshConfig
from twinvoice_tpu_torch.core.collectives import sum_over
from twinvoice_tpu_torch.core.mesh import (
    batch_sharding,
    make_mesh,
    model_sharded,
    param_shardings,
    shard_batch,
    shard_tree,
)
from twinvoice_tpu_torch.core.precision import Policy
from twinvoice_tpu_torch.weights import from_jax_params, keystr_items

from tests.torch_port_cases import random_unet

LAYOUTS = [(MeshConfig(), 1), (MeshConfig(), 8), (MeshConfig(model=2), 8),
           (MeshConfig(data=2, model=2, spatial=2), 8), (MeshConfig(spatial=4), 4),
           (MeshConfig(data=2, model=4), 8)]


def jax_mesh(cfg, world):
    return jax_make_mesh(JaxMeshConfig(**dataclasses.asdict(cfg)), jax.devices("cpu")[:world])


def test_mesh_config_and_its_place_in_config_match_jax():
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JaxMeshConfig())
    assert dataclasses.asdict(Config().mesh) == dataclasses.asdict(JaxConfig().mesh)


@pytest.mark.parametrize("cfg,world", LAYOUTS)
def test_make_mesh_lays_ranks_out_as_jax_lays_devices(cfg, world):
    """Without a process group ``make_mesh`` is the layout alone: the same
    axis sizes and row-major order as JAX's mesh over ``world`` devices,
    rank 0's place on each axis, and no group."""
    mesh, jm = make_mesh(cfg, world=world), jax_mesh(cfg, world)
    assert mesh.axis_names == jm.axis_names
    assert mesh.shape == dict(jm.shape)
    np.testing.assert_array_equal(mesh.devices, np.vectorize(lambda d: d.id)(jm.devices))
    batch = mesh.shape["data"] * mesh.shape["spatial"]
    for name, size in list(mesh.shape.items()) + [("batch", batch)]:
        ax = mesh.axis(name)
        assert (ax.size, ax.index, ax.group, mesh.rank) == (size, 0, None, 0)


@pytest.mark.parametrize("cfg,world", [(MeshConfig(model=3), 8), (MeshConfig(data=3), 8),
                                       (MeshConfig(spatial=16), 8), (MeshConfig(data=2), 1)])
def test_make_mesh_rejects_what_jax_rejects_with_its_message(cfg, world):
    with pytest.raises(AssertionError) as want:
        jax_mesh(cfg, world)
    with pytest.raises(ValueError) as got:
        make_mesh(cfg, world=world)
    assert str(got.value) == str(want.value)


def test_a_layout_of_several_ranks_has_no_collectives():
    """A collective over an axis of several ranks on a mesh laid out
    without a process group raises; over an axis of one it is the identity."""
    mesh = make_mesh(MeshConfig(data=2, spatial=2), world=4)
    x = torch.ones(3)
    assert sum_over(x, mesh.axis("model")) is x
    with pytest.raises(ValueError, match="process group"):
        sum_over(x, mesh.axis("data"))


def test_mesh_over_a_process_group_must_span_it(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=30))
    try:
        mesh = make_mesh()
        assert mesh.world == 1 and mesh.distributed and mesh.axis("batch").group is None
        with pytest.raises(ValueError, match="over a process group of 1"):
            make_mesh(MeshConfig(data=2), world=2)
    finally:
        dist.destroy_process_group()


def test_batch_sharding_is_jax_data_spatial_block():
    """Rank 0 of a 2×2×2 layout holds images 0–3 and rows 0–15 of a b8 32²
    batch, in NCHW and NHWC alike; sizes the axes do not divide raise."""
    mesh = make_mesh(MeshConfig(data=2, model=2, spatial=2), world=8)
    assert batch_sharding(mesh, 8, 32) == (slice(0, 4), slice(0, 16))
    x = np.arange(8 * 32 * 5 * 3).reshape(8, 32, 5, 3)
    np.testing.assert_array_equal(shard_batch(x, mesh, 1), x[:4, :16])
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(shard_batch(t, mesh).numpy(), t[:4, :, :16].numpy())
    with pytest.raises(ValueError, match="divisible"):
        batch_sharding(mesh, 8, 30 + 1)


def _port_spec(key, jspec, ndim):
    """JAX's spec of a leaf in the port's layout: a conv's Co is dim 3 of
    HWIO and dim 0 of OIHW; a transpose conv's dim 3 of (2,2,Ci,Co) and dim
    1 of (Ci,Co,2,2); a vector's dim 0 either way."""
    if jspec == P():
        return ()
    assert list(jspec).index("model") == ndim - 1
    co = {4: 1 if key.startswith("['up']") else 0, 1: 0}[ndim]
    return tuple("model" if d == co else None for d in range(ndim))


@pytest.mark.parametrize("cfg", [MeshConfig(data=2, model=2, spatial=2),
                                 MeshConfig(data=2, model=4)])
def test_param_shardings_match_jax_leaf_by_leaf(cfg):
    """The out-channel rule on a base-4 tree: each param and BN-state leaf
    sharded over ``model`` exactly where JAX's ``param_shardings`` shards
    it (at ``model=4`` the 4-channel level stays replicated: 4 < 2·4), the
    3-class out conv replicated; ``shard_tree`` cuts the matching slices."""
    _, params, state = random_unet(0, base_width=4)
    jm, mesh = jax_mesh(cfg, 8), make_mesh(cfg, world=8)
    tp, ts = from_jax_params(params, state)
    n_sharded = 0
    for jtree, tree in ((params, tp), (state, ts)):
        jspecs = dict(keystr_items(jax.tree.map(lambda s: s.spec, jax_param_shardings(jm, jtree),
                                                is_leaf=lambda s: hasattr(s, "spec"))))
        specs = dict(keystr_items(param_shardings(mesh, tree)))
        leaves = dict(keystr_items(tree))
        cut = dict(keystr_items(shard_tree(tree, mesh, param_shardings(mesh, tree))))
        assert len(specs) == len(jspecs)
        for jkey, jspec in jspecs.items():
            key = jkey.replace("['kernel']", "['weight']")
            assert specs[key] == _port_spec(jkey, jspec, leaves[key].dim()), key
            want = leaves[key]
            if specs[key]:
                d = specs[key].index("model")
                want = want.narrow(d, 0, want.shape[d] // cfg.model)
                n_sharded += 1
            torch.testing.assert_close(cut[key], want, rtol=0, atol=0)
    assert n_sharded > 0
    assert param_shardings(mesh, tp)["out"]["weight"] == () and not model_sharded(mesh, 3)


def test_policy_matches_jax():
    """``parity()`` and ``fast()`` give JAX's dtypes; ``cast_params`` and
    ``cast_input`` round to bf16 as JAX does (to nearest, ties to even)."""
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for make in ("parity", "fast"):
        got, want = getattr(Policy, make)(), getattr(JaxPolicy, make)()
        for f in ("param_dtype", "compute_dtype", "accum_dtype"):
            assert names[getattr(got, f)] == np.dtype(getattr(want, f)).name
    _, params, _ = random_unet(0, base_width=4)
    jcast = JaxPolicy.fast().cast_params(params)
    got = Policy.fast().cast_params(from_jax_params(params, random_unet(0, 4)[2])[0])
    for key, leaf in keystr_items(jcast):
        key = key.replace("['kernel']", "['weight']")
        t = dict(keystr_items(got))[key]
        assert t.dtype == torch.bfloat16
        want = np.asarray(leaf).astype(np.float32)
        have = t.float().numpy()
        if have.ndim == 4:
            have = have.transpose((2, 3, 0, 1) if "['up']" in key else (2, 3, 1, 0))
        np.testing.assert_array_equal(have, want, err_msg=key)
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    assert Policy.fast().cast_input(torch.from_numpy(x)).dtype == torch.bfloat16
    np.testing.assert_array_equal(Policy.fast().cast_input(torch.from_numpy(x)).float().numpy(),
                                  x.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert Policy.parity().cast_input(torch.from_numpy(x)).dtype == torch.float32
