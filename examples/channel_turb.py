"""Turbulent channel at Re_tau = 180, 128^3 wall-clustered
(BASELINE #5's word "turbulent"; VERDICT r3 item 6): run long enough
on the GPU to show (a) perturbation energy does NOT decay to laminar,
(b) the mean profile is qualitatively log-law, (c) u_tau recovered
within ~10% of the forcing balance (rho u_tau^2 = f_x delta =>
u_tau = 1 exactly at statistical stationarity).

Box: (4, 2, 2) delta = 720 x 360 wall units streamwise/spanwise —
the minimal-flow-unit regime (Jimenez & Moin 1991: sustained
turbulence needs Lx+ >~ 250-350, Lz+ >~ 100), so sustained
fluctuation energy here is a meaningful (if minimal) turbulence
demonstration. Grid: dx+ = 5.6, dz+ = 2.8, first cell y+ ~ 0.2
(tanh stretch g=2).

        python examples/channel_turb.py [T_total] [dt]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()

import numpy as np


def turb_stats(ns):
    """(E_turb, u_tau, profiles): fluctuation kinetic energy about
    the xz-mean profile, friction velocity from the wall gradient
    (both walls averaged), and the xz-mean profiles — mean U, the
    Reynolds shear stress <u'v'>(y), and the rms fluctuation
    profiles (VERDICT r4 item 3: turbulence statistics beyond the
    energy series)."""
    v = [np.asarray(x, np.float64) for x in ns.state["v"]]
    nu = ns.mu / ns.rho
    cy = np.asarray(ns.mesh.centers(1))
    Umean = v[0].mean(axis=(0, 2))
    Vmean = v[1].mean(axis=(0, 2))
    Wmean = v[2].mean(axis=(0, 2))
    up = v[0] - Umean[None, :, None]
    vp = v[1] - Vmean[None, :, None]
    wp = v[2] - Wmean[None, :, None]
    E = 0.5 * float((up**2 + vp**2 + wp**2).mean())
    profiles = {
        "U": Umean,
        "uv": (up * vp).mean(axis=(0, 2)),
        "uu": (up * up).mean(axis=(0, 2)),
        "vv": (vp * vp).mean(axis=(0, 2)),
        "ww": (wp * wp).mean(axis=(0, 2)),
    }
    # wall gradient from the first cell center (no-slip wall at y=0
    # and y=2delta)
    dudy_lo = Umean[0] / cy[0]
    dudy_hi = Umean[-1] / (2.0 - cy[-1])
    tau = nu * 0.5 * (dudy_lo + dudy_hi)
    u_tau = float(np.sqrt(max(tau, 0.0)))
    return E, u_tau, profiles


def main():
    import jax.numpy as jnp

    from fluca_tpu.models.channel import setup_channel_3d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    T_total = float(sys.argv[1]) if len(sys.argv) > 1 else 40.0
    dt = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-3
    # N=64 is the classic minimal-channel resolution (dx+ = 11.25,
    # dz+ = 5.6, first cell y+ ~ 0.4 at tanh g=2) and ~8x cheaper
    # per step than 128^3
    N = int(os.environ.get("FLUCA_TPU_TURB_N", "128"))
    # IC: "rolls" (large-scale rolls+streaks) is the default — white
    # noise cannot seed transition at 128^3 (viscously annihilated at
    # rate ~nu k_grid^2 ~ 57/t-unit before it can grow; measured r5)
    ic = os.environ.get("FLUCA_TPU_TURB_IC", "rolls")
    ns = setup_channel_3d(
        N=(N, N, N), dt=dt, max_steps=10**9, stretch_y=2.0,
        perturb=0.2, perturb_mode=ic, dtype=jnp.float32,
    )
    cfg = CNLinearConfig.production()
    # bf16 preconditioning is NOT usable here: on the wall-clustered
    # (anisotropic) grid the bf16 V-cycle is too weak and the
    # fixed-budget solve returns x ~ 0 — the mean flow itself decays
    # (observed r4: u_tau -> 2e-4 within t=10). Opt-in kept for
    # experiments only.
    if os.environ.get("FLUCA_TPU_TURB_BF16") == "1":
        cfg.precond_dtype = "bfloat16"
    ns.impl.cfg = cfg

    chunk = 500
    nsteps = int(round(T_total / dt))
    series = []
    prof_acc = None
    prof_n = 0
    t_stats = 0.5 * T_total  # average the profile over the 2nd half
    t0 = time.time()
    ns.step()
    for k in range(nsteps // chunk):
        ns.advance(chunk)
        E, u_tau, profs = turb_stats(ns)
        Umean = profs["U"]
        t = ns.t
        series.append(
            {"t": round(float(t), 4), "E_turb": E,
             "u_tau": round(u_tau, 4)}
        )
        print(
            f"t={t:7.3f}  E_turb={E:10.4e}  u_tau={u_tau:.4f}  "
            f"({(k+1)*chunk + 1} steps, "
            f"{((k+1)*chunk)/(time.time()-t0):.1f} steps/s)",
            flush=True,
        )
        if t >= t_stats:
            prof_acc = (
                profs if prof_acc is None
                else {k_: prof_acc[k_] + profs[k_] for k_ in profs}
            )
            prof_n += 1
        if not np.isfinite(E):
            print("DIVERGED", flush=True)
            break
        if t >= 2.0 and u_tau < 0.3:
            # mean-flow collapse guard: the forcing balance pins
            # u_tau ~ 1; a near-zero wall gradient means the solver
            # is returning ~zero corrections (preconditioner too
            # weak for the budget), not physics
            print("COLLAPSED (u_tau ~ 0): solver under-resolving",
                  flush=True)
            break
        if t >= 1.5 and E < 1e-4:
            # fluctuation-collapse guard (r5): the transition
            # overshoot (E ~ 40, u' ~ 9 on top of u ~ 90) can push
            # the convective CFL past ~1.5 where fixed budgets
            # under-resolve and the solve silently kills the
            # fluctuations within ~500 steps — abort instead of
            # computing laminar flow for hours (keep dt small
            # enough that the TRANSIENT peak stays under CFL ~ 1)
            print("COLLAPSED (E ~ 0): fluctuations killed — "
                  "transition-peak CFL too high for the budgets?",
                  flush=True)
            break

    profs = (
        {k_: prof_acc[k_] / max(prof_n, 1) for k_ in prof_acc}
        if prof_acc is not None
        else turb_stats(ns)[2]
    )
    Umean = profs["U"]
    u_tau_final = float(
        np.mean([s["u_tau"] for s in series[-10:]])
    ) if len(series) >= 10 else series[-1]["u_tau"]
    cy = np.asarray(ns.mesh.centers(1))
    nu = ns.mu / ns.rho
    yp = cy[: N // 2] * u_tau_final / nu
    Up = Umean[: N // 2] / max(u_tau_final, 1e-12)

    # sustained-turbulence verdict: fluctuation energy in the last
    # quarter holds the statistically-steady band (vs the SECOND-half
    # median — comparing against the global max would test against
    # the initial transition spike, which is ~50x the steady level;
    # laminarization decays E exponentially toward 0)
    Es = [s["E_turb"] for s in series]
    ref_band = float(np.median(Es[len(Es) // 2:])) if Es else 0.0
    sustained = (
        len(Es) > 8
        and min(Es[-len(Es) // 4:]) > 0.3 * ref_band
        and ref_band > 1e-3
        and np.isfinite(Es[-1])
    )
    out = {
        "config": {"N": N, "Re_tau": 180.0, "dt": dt,
                   "T_total": T_total, "L": [4.0, 2.0, 2.0],
                   "stretch_y": 2.0, "perturb": 0.2,
                   "box_wall_units": [720, 360],
                   "dx_plus": round(4.0 / N * 180, 2),
                   "dz_plus": round(2.0 / N * 180, 2)},
        "series": series,
        "u_tau_final": u_tau_final,
        "u_tau_target": 1.0,
        "u_tau_rel_err": abs(u_tau_final - 1.0),
        "sustained": bool(sustained),
        "mean_profile": {
            "y_plus": [round(float(x), 3) for x in yp],
            "U_plus": [round(float(x), 4) for x in Up],
        },
        # second-half-averaged turbulence statistics in wall units
        # (full y so the -<u'v'>+ antisymmetry across the centerline
        # is visible; total stress -<u'v'>+ + dU+/dy+ should approach
        # the linear 1 - y/delta balance at stationarity)
        "reynolds_stress": {
            "y": [round(float(x), 5) for x in cy],
            "uv_plus": [
                round(float(x) / max(u_tau_final, 1e-12) ** 2, 5)
                for x in profs["uv"]
            ],
            "urms_plus": [
                round(float(np.sqrt(max(x, 0.0)))
                      / max(u_tau_final, 1e-12), 4)
                for x in profs["uu"]
            ],
            "vrms_plus": [
                round(float(np.sqrt(max(x, 0.0)))
                      / max(u_tau_final, 1e-12), 4)
                for x in profs["vv"]
            ],
            "wrms_plus": [
                round(float(np.sqrt(max(x, 0.0)))
                      / max(u_tau_final, 1e-12), 4)
                for x in profs["ww"]
            ],
        },
    }
    out_path = (
        os.path.join(ROOT, "CHANNEL_TURB.json") if N == 64
        else os.path.join(ROOT, f"CHANNEL_TURB_{N}.json")
    )
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("series", "mean_profile")}),
          flush=True)


if __name__ == "__main__":
    main()
