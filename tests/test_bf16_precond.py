"""Reduced-precision ABF preconditioner plumbing in the suite.

CPU coverage runs the SAME plumbing — the precond-dtype twin MG
hierarchy, the _precond_ctx cast/rebuild paths, the fixed-trip inner
forms on reduced trees, the scope="mom"/"both" split — with
precond_dtype="float32" under an f64 solve. bfloat16 itself cannot be
compile-tested on CPU at ANY size: XLA CPU scalarizes bf16 step
programs (measured 2026-08-21: one 8x8 cavity bf16 step sat >30 min
in compile where the f32 twin takes seconds; CLAUDE.md documents the
same at 16^2), so the bf16 numerics run on the GPU, in the channel
512x256x256 phase of chip_smoke.py (retention gate) and in the
gpu-marked test below.

The ABF preconditioner runs under a FLEXIBLE outer iteration, so a
reduced-precision M changes the contraction rate, never the converged
answer — at fixed budgets the solution must stay close to the
full-precision one (CNLinearConfig.precond_dtype).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluca_tpu.ns.cnlinear import CNLinearConfig


def _run_cavity(cfg, nsteps=5, N=16, dtype=jnp.float64):
    from fluca_tpu.models.cavity import setup_cavity_2d

    ns = setup_cavity_2d(N=N, Re=100.0, dt=0.01,
                         max_steps=10**9, dtype=dtype)
    ns.impl.cfg = cfg
    ns.step()
    ns.advance(nsteps - 1)
    return tuple(np.asarray(v) for v in ns.state["v"])


def _run_channel(cfg, nsteps=5, N=(8, 8, 8), dtype=jnp.float64):
    from fluca_tpu.models.channel import setup_channel_3d

    ns = setup_channel_3d(N=N, dt=1e-3, max_steps=10**9,
                          stretch_y=1.5, dtype=dtype)
    ns.impl.cfg = cfg
    ns.step()
    ns.advance(nsteps - 1)
    return tuple(np.asarray(v) for v in ns.state["v"])


@pytest.mark.parametrize("scope", ["both", "mom"])
def test_f32_precond_cavity2d_matches_f64(scope):
    ref = _run_cavity(CNLinearConfig.production(3, 8, 6))
    cfg = CNLinearConfig.production(3, 8, 6)
    cfg.precond_dtype = "float32"
    cfg.precond_scope = scope
    got = _run_cavity(cfg)
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert np.all(np.isfinite(g))
        # f32-M under f64 at fixed budgets: the contraction barely
        # changes, the answer agrees to ~single-precision depth
        np.testing.assert_allclose(g, r, atol=1e-5 * scale)


@pytest.mark.parametrize("scope", ["both", "mom"])
def test_f32_precond_channel3d_matches_f64(scope):
    ref = _run_channel(CNLinearConfig.production(2, 4, 3))
    cfg = CNLinearConfig.production(2, 4, 3)
    cfg.precond_dtype = "float32"
    cfg.precond_scope = scope
    got = _run_channel(cfg)
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, r, atol=1e-4 * scale)


def test_f32_production_presets_tiny_cavity():
    """f32 solver dtype end-to-end at a tiny low-CFL cavity:
    production and production_fast stay finite and agree (the regime
    where the fast path is pinned against production by
    tests/test_fastpath.py at larger sizes)."""
    ref = _run_cavity(CNLinearConfig.production(), dtype=jnp.float32)
    fast = _run_cavity(CNLinearConfig.production_fast(),
                       dtype=jnp.float32)
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(fast, ref):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, r, atol=2e-3 * scale)


@pytest.mark.gpu
def test_bf16_precond_cavity2d_matches_f32(gpu):
    # bf16 step programs cannot be compiled on XLA CPU in reasonable
    # time at any size (>30 min for one 8x8 step), so this runs on
    # the GPU only
    cfg = CNLinearConfig.production(3, 8, 6)
    cfg.precond_dtype = "bfloat16"
    got = _run_cavity(cfg, dtype=jnp.float32)
    assert all(np.all(np.isfinite(g)) for g in got)
