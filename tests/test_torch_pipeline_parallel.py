"""PyTorch port: the GPipe schedule (``parallel.pipeline``) on gloo ranks
(``tests/torch_dist.py``) against the sequential run and the JAX package's
``pipeline_apply`` on JAX's two cases (``tests/distributed/test_pipeline.py``):
the 4-stage tanh tower at 1e-5, the 2-stage identity at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from twinvoice_tpu.parallel.pipeline import pipeline_apply, stack_stage_params

from tests import torch_dist


def _mesh(n):
    return Mesh(np.asarray(jax.devices("cpu")[:n]), ("stage",))


@pytest.fixture(scope="module")
def tower():
    """JAX's case: 4 stages tanh(x·W + b), dim 16, 6 microbatches of 2."""
    n_stages, n_micro, dim = 4, 6, 16
    keys = jax.random.split(jax.random.key(0), n_stages)
    params = [{"w": np.asarray(jax.random.normal(k, (dim, dim)) * 0.3),
               "b": np.zeros((dim,), np.float32)} for k in keys]
    x = np.random.default_rng(0).standard_normal((n_micro, 2, dim)).astype(np.float32)
    seq = x
    for p in params:
        seq = np.asarray(jnp.tanh(jnp.asarray(seq) @ p["w"] + p["b"]))

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    jp = pipeline_apply(stage, stack_stage_params(
        [jax.tree.map(jnp.asarray, p) for p in params]), jnp.asarray(x), _mesh(n_stages))
    return {"params": params, "x": x, "seq": seq, "jax": np.asarray(jp)}


def test_pipeline_matches_sequential(tower, tmp_path):
    ranks = torch_dist.run_ranks(torch_dist.pipeline_ranks, 4, tmp_path, tower["params"],
                                 tower["x"], None)
    for r in ranks:
        np.testing.assert_allclose(r["tower"], tower["seq"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["tower"], tower["jax"], atol=1e-5, rtol=1e-5)


def test_pipeline_two_stages(tmp_path):
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    jp = pipeline_apply(lambda p, h: h @ p["w"], stack_stage_params(
        [{"w": jnp.eye(8) * 2.0}, {"w": jnp.eye(8) * 0.5}]), jnp.asarray(x), _mesh(2))
    ranks = torch_dist.run_ranks(torch_dist.pipeline_ranks, 2, tmp_path, None, None, x)
    for r in ranks:
        np.testing.assert_allclose(r["identity"], x, atol=1e-6)
        np.testing.assert_allclose(r["identity"], np.asarray(jp), atol=1e-6)
