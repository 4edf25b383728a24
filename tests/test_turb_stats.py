"""Turbulence-statistics pipeline (examples/channel_turb.py):
seeded CI-scale checks of the u_tau / fluctuation-energy / mean-
profile computations that back CHANNEL_TURB.json (VERDICT r3 item
6's CI-scale regression — the statistics, since actual sustained
turbulence needs the full-size GPU run)."""

import numpy as np

import jax.numpy as jnp

from fluca_tpu.models.channel import setup_channel_3d


def _stats(ns):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from examples.channel_turb import turb_stats

    return turb_stats(ns)


def test_u_tau_of_laminar_profile():
    """For the unperturbed laminar profile u = (Re_tau/2) u_tau
    (1 - ((y-d)/d)^2): du/dy|wall = Re_tau u_tau / d, so
    tau_w = nu du/dy = u_tau^2 exactly (that identity is WHY the
    forcing balance recovers u_tau = 1); the first-cell-center
    finite difference recovers it to O(y1/delta)."""
    ns = setup_channel_3d(
        N=(16, 32, 16), dt=1e-3, max_steps=2, perturb=0.0,
        stretch_y=2.0, dtype=jnp.float64,
    )
    E, u_tau, profs = _stats(ns)
    assert E < 1e-20  # no fluctuations about the xz-mean
    # y1 is deep in the viscous layer on the stretched grid
    assert abs(u_tau - 1.0) < 0.02, u_tau
    # profile is the laminar parabola
    cy = np.asarray(ns.mesh.centers(1))
    exact = 90.0 * (1.0 - (cy - 1.0) ** 2)
    np.testing.assert_allclose(profs["U"], exact, rtol=1e-12)
    # the r5 Reynolds-stress profiles: identically zero for a pure
    # mean profile (no fluctuations to correlate)
    for key in ("uv", "uu", "vv", "ww"):
        assert float(np.abs(profs[key]).max()) < 1e-20, key


def test_fluctuation_energy_of_seeded_field():
    """E_turb measures energy about the xz-mean: a pure-profile
    field has none; adding a known sinusoidal fluctuation adds
    exactly its energy."""
    ns = setup_channel_3d(
        N=(16, 16, 16), dt=1e-3, max_steps=2, perturb=0.0,
        dtype=jnp.float64,
    )
    E0, _, _ = _stats(ns)
    assert E0 < 1e-20
    shape = ns.mesh.cell_shape
    x = np.arange(shape[0])
    pert = 0.3 * np.sin(2 * np.pi * x / shape[0])
    v = list(ns.state["v"])
    v[1] = v[1] + jnp.asarray(
        np.broadcast_to(pert[:, None, None], shape)
    )
    ns.state["v"] = tuple(v)
    E1, _, _ = _stats(ns)
    # E = 0.5 <(0.3 sin)^2> = 0.5 * 0.09/2
    np.testing.assert_allclose(E1, 0.5 * 0.09 / 2, rtol=1e-10)
