"""chip_smoke.py on the CPU at tiny sizes: its numpy float64 layer
references against dense assembled operators and the XLA path, its
comparators and tolerances, its phase selection, and its refusal to
run without a GPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from test_stencil_dense import (
    KINDS, dense_momentum, kron_axis, make_mesh, random_factors, to_dev,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from fluca_tpu.ns.operators import NSOperators  # noqa: E402
from fluca_tpu.solvers.mg import PoissonMG  # noqa: E402


@pytest.mark.parametrize("kind", KINDS)
def test_band_sum_matches_dense(kind):
    mesh, bcs = make_mesh(3, kind)
    mg = PoissonMG(mesh, bcs, scale=1.0, dtype=jnp.float64)
    x = np.random.default_rng(0).standard_normal(mesh.cell_shape)
    rows = np.array([0, 2, mesh.N[0] - 1])
    for d, st in enumerate(mg.levels[0].host_dgst):
        want = (kron_axis(st.to_dense(mesh.N[d]), mesh.N, d)
                @ x.ravel()).reshape(mesh.cell_shape)[rows]
        got = chip_smoke.band_sum_np(st, x, d, rows)
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_poisson_reference_matches_xla(kind, dim):
    mesh, bcs = make_mesh(dim, kind)
    mg = PoissonMG(mesh, bcs, scale=0.37, dtype=jnp.float64)
    lvl = mg.levels[0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(mesh.cell_shape)
    b = rng.standard_normal(mesh.cell_shape)
    rows = chip_smoke._rows(mesh.N[0])
    ap, res, jac = chip_smoke.poisson_np(lvl, x, b, rows, mg.omega)
    X, B = jnp.asarray(x), jnp.asarray(b)
    for got, want in (
        (mg.apply_op(X), ap),
        (mg._residual(lvl, X, B), res),
        (mg._smooth(lvl, X, B, 1), jac),
    ):
        assert chip_smoke.max_rel(np.asarray(got)[rows], want) < 1e-13


@pytest.mark.parametrize("kind", KINDS)
def test_momentum_reference_matches_dense(kind):
    mesh, bcs = make_mesh(3, kind, (8, 4, 6))
    rho, mu, dt = 1.0, 0.05, 0.01
    ops = NSOperators(mesh, bcs, rho, mu, dt, jnp.float64)
    rng = np.random.default_rng(4)
    U0, v0f = random_factors(mesh, rng)
    v = [rng.standard_normal(mesh.cell_shape) for _ in range(3)]
    rows = chip_smoke._rows(mesh.N[0])
    got = chip_smoke.momentum_np(mesh, ops.axbcs, rho, mu, dt, v, U0,
                                 v0f, rows)
    A = dense_momentum(mesh, ops.axbcs, rho, mu, dt, U0, v0f)
    want = (A @ np.concatenate([x.ravel() for x in v])).reshape(
        (3,) + mesh.cell_shape)
    for c in range(3):
        np.testing.assert_allclose(got[c], want[c][rows], rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    coeffs = ops.build_momentum_coeffs(to_dev(U0), to_dev(v0f))
    xla = ops.apply_A_coeffs(to_dev(tuple(v)), coeffs)
    for c in range(3):
        assert chip_smoke.max_rel(np.asarray(xla[c])[rows], got[c]) \
            < 1e-13


def test_comparators_and_limits():
    a = np.ones((4, 4))
    assert chip_smoke.rel_l2(a, a) == 0.0
    assert chip_smoke.rel_l2(1.01 * a, a) == pytest.approx(0.01)
    assert chip_smoke.rel_l2([a, 2 * a], [a, a]) == pytest.approx(
        np.sqrt(16 / 32))
    assert chip_smoke.max_rel(a + 1e-6, a) == pytest.approx(1e-6)
    chip_smoke.check("x", 1e-6, chip_smoke.LAYER_RTOL)
    with pytest.raises(AssertionError):
        chip_smoke.check("x", 2e-5, chip_smoke.LAYER_RTOL)
    with pytest.raises(AssertionError):
        chip_smoke.check("x", float("nan"), 1.0)
    # the limits the phases gate on
    assert chip_smoke.LAYER_RTOL == 1e-5
    assert chip_smoke.CAVITY_RTOL == 1e-4
    assert chip_smoke.TGV_FRAC == 0.02
    assert chip_smoke.FOUR_RTOL == 1e-4
    assert chip_smoke.FOUR_P_RTOL == 1e-2


@pytest.mark.parametrize("argv,want", [
    ([], ["device", "app", "channel", "reference", "layers"]),
    (["--four"], ["device", "four"]),
])
def test_phase_selection(argv, want):
    assert chip_smoke.select_phases(argv) == want


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_slope_timer_runs():
    x = jnp.ones((16, 16))
    t = chip_smoke.slope_seconds(lambda y, a: y * a["s"], x,
                                 {"s": jnp.float64(1.0)}, lo=1, hi=3,
                                 repeats=1)
    assert np.isfinite(t)
