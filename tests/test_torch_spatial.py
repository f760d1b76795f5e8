"""PyTorch port: spatial (H-sharded) convs and the folded U-Net with explicit
halos (``parallel.spatial``) on 4 gloo ranks (``tests/torch_dist.py``),
against the JAX package's dense and 8-shard outputs on JAX's four cases
(``tests/distributed/test_spatial.py``), at JAX's tolerances: 1e-5 for the
convs, 2e-4 for the U-Nets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from twinvoice_tpu.config import MeshConfig as JaxMeshConfig
from twinvoice_tpu.core.mesh import make_mesh as jax_make_mesh
from twinvoice_tpu.models.unet import fold_unet, unet_apply_folded
from twinvoice_tpu.ops.conv import conv2d
from twinvoice_tpu.parallel.spatial import (
    conv3x3_spatial,
    spatial_shard_apply,
    spatial_unet_forward,
)

from tests import torch_dist
from tests.torch_port_cases import random_unet

RANKS = 4


def numpy_conv(rng, cin, cout):
    """A 3×3 conv's params in JAX's layout, torch's default init bounds."""
    bound = 1.0 / np.sqrt(9 * cin)
    return {"kernel": rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, cout).astype(np.float32)}


def dense_conv(x, p):
    return conv2d(x, p["kernel"], p["bias"], padding=((1, 1), (1, 1)))


@pytest.fixture(scope="module")
def cases():
    """JAX's four cases, inputs drawn as there (the ``rng`` fixture's seed 0,
    one generator per case): one conv 8→8 on (2, 32, 16, 8); two stacked
    4→4 convs on (1, 16, 8, 4); the depth-4 U-Net on (1, 256, 64, 3) and the
    depth-3 one on (2, 64, 48, 3), base width 4. The params are numpy
    (``random_unet``; an eager JAX init costs tens of seconds here). Each
    with JAX's dense output and its 8-shard ``shard_map`` output."""
    mesh = jax_make_mesh(JaxMeshConfig(data=1, model=1, spatial=8), jax.devices("cpu"))
    prng = np.random.default_rng(11)
    x = np.random.default_rng(0).standard_normal((2, 32, 16, 8)).astype(np.float32)
    p = numpy_conv(prng, 8, 8)
    one = spatial_shard_apply(lambda xs, pp: conv3x3_spatial(xs, pp, "spatial"), mesh)
    conv = {"in": (x, p), "dense": np.asarray(jax.jit(dense_conv)(x, p)),
            "jax": np.asarray(jax.jit(one)(x, p))}

    x = np.random.default_rng(0).standard_normal((1, 16, 8, 4)).astype(np.float32)
    p1, p2 = numpy_conv(prng, 4, 4), numpy_conv(prng, 4, 4)

    def two(xs, pp):
        return conv3x3_spatial(jax.nn.relu(conv3x3_spatial(xs, pp[0], "spatial")), pp[1],
                               "spatial")

    stacked = {"in": (x, p1, p2),
               "dense": np.asarray(jax.jit(lambda x: dense_conv(
                   jax.nn.relu(dense_conv(x, p1)), p2))(x)),
               "jax": np.asarray(jax.jit(spatial_shard_apply(two, mesh))(x, (p1, p2)))}

    unets = []
    for seed, depth, shape in ((3, 4, (1, 256, 64, 3)), (4, 3, (2, 64, 48, 3))):
        cfg, params, state = random_unet(seed, base_width=4, depth=depth)
        folded = jax.jit(fold_unet, static_argnames="cfg")(
            jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state), cfg=cfg)
        x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
        unets.append({"in": (depth, x, params, state),
                      "dense": np.asarray(jax.jit(unet_apply_folded)(folded, x)),
                      "jax": np.asarray(jax.jit(
                          lambda f, x: spatial_unet_forward(f, x, mesh))(folded, x))})
    return {"conv": conv, "stacked": stacked, "unets": unets}


@pytest.fixture(scope="module")
def port(cases, tmp_path_factory):
    return torch_dist.run_ranks(
        torch_dist.spatial_ranks, RANKS, tmp_path_factory.mktemp("spatial"),
        cases["conv"]["in"], cases["stacked"]["in"], [u["in"] for u in cases["unets"]])


def assert_both(got, case, tol):
    np.testing.assert_allclose(got, case["dense"], atol=tol, rtol=tol)
    np.testing.assert_allclose(got, case["jax"], atol=tol, rtol=tol)


def test_sharded_conv_matches_dense(cases, port):
    for r in port:
        assert_both(r["conv"], cases["conv"], 1e-5)


def test_two_stacked_convs(cases, port):
    """Halo exchange per layer composes across depth."""
    for r in port:
        assert_both(r["stacked"], cases["stacked"], 1e-5)


def test_full_unet_spatial_matches_dense(cases, port):
    """The whole folded U-Net H-sharded over 4 ranks with halo-2 exchanges
    (local H 64 at 256², divisible by 2^4): pool, transpose conv and skips
    across shard boundaries included."""
    for r in port:
        assert_both(r["unets"][0], cases["unets"][0], 2e-4)


def test_full_unet_spatial_depth3_uneven_widths(cases, port):
    """Depth 3 and a non-square 64×48 input (local H 16)."""
    for r in port:
        assert_both(r["unets"][1], cases["unets"][1], 2e-4)
