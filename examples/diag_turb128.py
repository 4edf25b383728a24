"""Diagnose the 128^3 wall-clustered channel fluctuation collapse
(r5: E_turb 38 -> 4e-7 within 500 steps under f32 production o3/m8/s6
— too fast for viscous decay of large-scale rolls by 3 orders of
magnitude, so either the fixed budgets under-resolve at this
stiffness (first cell y+ ~ 0.2, cell aspect ~ 28) or something is
structurally wrong at this config).

Runs short (400-step) probes and prints the E trajectory + rnorm:
  production      o3/m8/s6   (the collapsing config)
  production-big  o5/m12/s10 (budget hypothesis)
  tolerance       fgmres rtol 1e-5, 100 steps (ground truth)
Pass a label substring to run one case:
  python examples/diag_turb128.py [production|big|tol]
"""

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()

import numpy as np


def E_and_utau(ns):
    v = [np.asarray(x, np.float64) for x in ns.state["v"]]
    cy = np.asarray(ns.mesh.centers(1))
    Umean = v[0].mean(axis=(0, 2))
    up = v[0] - Umean[None, :, None]
    E = 0.5 * float((up**2 + v[1] ** 2 + v[2] ** 2).mean())
    nu = ns.mu / ns.rho
    dudy = 0.5 * (Umean[0] / cy[0] + Umean[-1] / (2.0 - cy[-1]))
    return E, float(np.sqrt(max(nu * dudy, 0.0)))


def run(label, cfg, nsteps=400, chunk=100):
    import jax.numpy as jnp

    from fluca_tpu.models.channel import setup_channel_3d

    cfg.diag_rhs_norm = True
    ns = setup_channel_3d(
        N=(128, 128, 128), dt=5e-4, max_steps=10**9, stretch_y=2.0,
        perturb=0.2, perturb_mode="rolls", dtype=jnp.float32,
    )
    ns.impl.cfg = cfg
    E0, ut0 = E_and_utau(ns)
    print(f"--- {label}: E0={E0:.3f} u_tau0={ut0:.3f}", flush=True)
    ns.step()
    d = ns.last_diag
    print(f"  step1 rnorm={float(d['ksp_rnorm']):.4g} "
          f"rel={float(d['ksp_rnorm'])/float(d['rhs_norm']):.3e}",
          flush=True)
    for k in range(nsteps // chunk):
        t0 = time.time()
        ns.advance(chunk)
        E, ut = E_and_utau(ns)
        d = ns.last_diag
        print(
            f"  t={ns.t:7.4f} E={E:10.4e} u_tau={ut:.4f} "
            f"rnorm={float(d['ksp_rnorm']):.4g} "
            f"({chunk/(time.time()-t0):.1f} steps/s)",
            flush=True,
        )
        if not np.isfinite(E):
            break
    del ns
    gc.collect()


def main():
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    only = sys.argv[1] if len(sys.argv) > 1 else None

    cases = []
    cases.append(("production", CNLinearConfig.production(), 400))
    cases.append(
        ("big-budgets", CNLinearConfig.production(5, 12, 10), 400)
    )
    tol = CNLinearConfig()  # fgmres rtol 1e-5
    cases.append(("tolerance-1e-5", tol, 100))

    for label, cfg, nsteps in cases:
        if only and only not in label:
            continue
        run(label, cfg, nsteps=nsteps)


if __name__ == "__main__":
    main()
