"""Backend-facing settings: the compile-cache location, state
donation, and the precision of the f32 matrix products that a GPU
would otherwise run in TF32."""

import os

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from fluca_tpu.mesh.cart import CartMesh
from fluca_tpu.ns.bc import zero_velocity_bc
from fluca_tpu.ns.cnlinear import CNLinearSolver
from fluca_tpu.solvers.krylov import fgmres, tree_dot
from fluca_tpu.solvers.mg import PoissonMG
from fluca_tpu.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_dir_restored():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_respects_env(monkeypatch, cache_dir_restored):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert config.use_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch,
                                              cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.use_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_path_is_stable(monkeypatch, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.use_compile_cache() == config.use_compile_cache()
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_no_donation_on_cpu():
    assert jax.default_backend() == "cpu"
    assert CNLinearSolver._donate() == ()


def _dot_precisions(jaxpr):
    """Precision config of every dot_general in a jaxpr, sub-jaxprs
    included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            subs = p if isinstance(p, (tuple, list)) else (p,)
            for s in subs:
                if isinstance(s, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(s.jaxpr)
                elif isinstance(s, jax.extend.core.Jaxpr):
                    out += _dot_precisions(s)
    return out


def _all_highest(precs):
    H = jax.lax.Precision.HIGHEST
    return precs and all(p is not None and all(q == H for q in p)
                         for p in precs)


def test_coarse_solve_and_tree_dot_ask_for_highest():
    mesh = CartMesh.create((8, 8))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    mg = PoissonMG(mesh, [zero_velocity_bc()] * 4, scale=1.0,
                   dtype=jnp.float32, coarse_size=64)
    r = jnp.ones((8, 8), jnp.float32)
    assert _all_highest(_dot_precisions(
        jax.make_jaxpr(mg.precondition)(r).jaxpr))
    assert _all_highest(_dot_precisions(
        jax.make_jaxpr(tree_dot)((r, r), (r, r)).jaxpr))


def test_fgmres_update_asks_for_highest():
    b = jnp.ones((6,), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda b: fgmres(lambda x: 2.0 * x + 0.5 * jnp.roll(x, 1), b,
                         rtol=1e-6, restart=4, maxiter=8).x
    )(b).jaxpr
    # Gram-Schmidt dots, back-substitution and the basis update (the
    # operator itself has no product)
    precs = _dot_precisions(jaxpr)
    assert len(precs) >= 3
    assert _all_highest(precs)
