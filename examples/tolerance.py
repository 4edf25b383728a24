"""Reference accuracy-contract demonstration at flagship sizes
(VERDICT r4 missing #1): the reference's default stopping rule is
KSP rtol 1e-5 on the unpreconditioned residual every step
(fluca/src/ns/interface/nssol.c:22-25). This script

1. runs the TOLERANCE-based fgmres path (reference semantics) at
   128^3 and at 512x256x256, recording steps/s, outer iterations and
   the achieved relative residual, and
2. maps every production fixed-budget preset to its EFFECTIVE
   per-step rtol (ksp_rnorm / ||rhs||) at both shapes — converting
   "fixed budgets are fine" from assertion to measurement — including
   the f32-vs-bf16mom rnorm pair at the true 512 shape (r4 weak #3).

Writes TOLERANCE.json.

  python examples/tolerance.py
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


def run_config(N, cfg, label, nsteps=10, dt=None):
    import jax.numpy as jnp

    from fluca_tpu.models.channel import setup_channel_3d

    cfg.diag_rhs_norm = True
    ns = setup_channel_3d(
        N=N, dt=dt, max_steps=10**9, stretch_y=2.0,
        dtype=jnp.float32,
    )
    ns.impl.cfg = cfg
    rec = {"label": label, "N": list(N), "dt": dt}
    try:
        u0 = float(np.abs(np.asarray(ns.state["v"][0])).mean())
        t0 = time.time()
        ns.step()
        rec["compile_s"] = round(time.time() - t0, 1)
        rels, its = [], []
        t0 = time.time()
        for _ in range(nsteps):
            ns.step()
            d = ns.last_diag
            rels.append(float(d["ksp_rnorm"])
                        / max(float(d["rhs_norm"]), 1e-30))
            its.append(int(d["ksp_iters"]))
        wall = time.time() - t0
        u1 = float(np.abs(np.asarray(ns.state["v"][0])).mean())
        rec.update({
            "steps_per_sec": round(nsteps / wall, 3),
            "outer_iters": its,
            "achieved_rtol_per_step": [f"{r:.2e}" for r in rels],
            "achieved_rtol_last": float(f"{rels[-1]:.3e}"),
            "ksp_rnorm_last": round(float(ns.last_diag["ksp_rnorm"]),
                                    3),
            "rhs_norm_last": round(float(ns.last_diag["rhs_norm"]),
                                   3),
            "retention": round(u1 / u0, 4),
        })
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        del ns
        gc.collect()
    print(json.dumps(rec), flush=True)
    return rec


def main():
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    results = {"note": (
        "achieved_rtol = ksp_rnorm / ||rhs|| per step (the "
        "reference's unpreconditioned relative residual, "
        "nssol.c:24-25). Tolerance rows run the while-loop fgmres "
        "path with rtol 1e-5; production rows are fixed-budget "
        "presets whose effective rtol is being measured. "
        "steps/s here uses per-step host syncs (diagnostics "
        "readback) - NOT comparable to the scan-fast-path bench "
        "numbers."), "rows": []}

    # optional label filter (argv[1], comma-separated substrings):
    # run only matching rows and merge into the existing artifact
    only = sys.argv[1].split(",") if len(sys.argv) > 1 else None
    path = os.path.join(ROOT, "TOLERANCE.json")
    if only and os.path.exists(path):
        with open(path) as f:
            prior = json.load(f)
        results["rows"] = [
            r for r in prior.get("rows", [])
            if not any(o in r.get("label", "") for o in only)
        ]

    real_run = globals()["run_config"]

    def run_config(N, cfg, label, **kw):  # noqa: ANN001
        if only and not any(o in label for o in only):
            return {"label": label, "skipped": True}
        return real_run(N, cfg, label, **kw)

    def save():
        rows = [r for r in results["rows"]
                if not r.get("skipped")]
        with open(path, "w") as f:
            json.dump({**results, "rows": rows}, f, indent=1)

    N128 = (128, 128, 128)
    # NOTE (r5 measurement): the bench's throughput dt=2e-3 is
    # convective CFL ~ 5.8 at 128^3 (centerline u ~ 90, h_x = 4/128)
    # — throughput is dt-independent but ACCURACY is not: at CFL 5.8
    # the fixed budgets under-resolve and the driven flow decays
    # (the r3 channel512 failure mode), while the rtol-1e-5 fgmres
    # path still converges (17-26 outers) and retains the flow.
    # Both dts are recorded: the CFL-5.8 rows document that contrast;
    # the CFL-0.86 rows are the production-condition mapping.
    DT128_CFL6 = 2e-3
    DT128 = 3e-4  # CFL ~ 0.86 — a production step

    # -- 128^3 ---------------------------------------------------------
    cfg = CNLinearConfig()  # reference defaults: fgmres rtol 1e-5
    results["rows"].append(
        run_config(N128, cfg, "tol1e-5_fgmres_128_cfl5.8",
                   dt=DT128_CFL6)
    )
    save()
    results["rows"].append(run_config(
        N128, CNLinearConfig.production(),
        "production_o3m8s6_128_cfl5.8", dt=DT128_CFL6,
    ))
    save()
    c = CNLinearConfig.production()
    c.precond_dtype = "bfloat16"
    c.precond_scope = "mom"
    results["rows"].append(
        run_config(N128, c, "production_o3m8s6_bf16mom_128_cfl5.8",
                   dt=DT128_CFL6)
    )
    save()
    results["rows"].append(run_config(
        N128, CNLinearConfig.production_fast(),
        "production_fast_gcr_128_cfl5.8", dt=DT128_CFL6,
    ))
    save()
    # production-condition mapping (CFL ~ 0.86)
    cfg = CNLinearConfig()
    results["rows"].append(
        run_config(N128, cfg, "tol1e-5_fgmres_128_cfl0.86", dt=DT128)
    )
    save()
    results["rows"].append(run_config(
        N128, CNLinearConfig.production(),
        "production_o3m8s6_128_cfl0.86", dt=DT128,
    ))
    save()
    c = CNLinearConfig.production()
    c.precond_dtype = "bfloat16"
    c.precond_scope = "mom"
    results["rows"].append(
        run_config(N128, c, "production_o3m8s6_bf16mom_128_cfl0.86",
                   dt=DT128)
    )
    save()

    # -- 512x256x256 (BASELINE #5 shape) ------------------------------
    N512 = (512, 256, 256)
    DT512 = 5e-5  # CFL ~ 0.6 (bench.py channel512)

    # tolerance path: restart clamped by HBM (each coupled basis
    # vector is 7 x 134 MB; fgmres keeps ~2*restart of them)
    cfg = CNLinearConfig()
    cfg.restart = 4
    cfg.maxiter = 12
    results["rows"].append(
        run_config(N512, cfg, "tol1e-5_fgmres_r4_512", nsteps=3,
                   dt=DT512)
    )
    save()
    # the f32-vs-bf16mom pair at the true shape, same budgets (o2
    # fits HBM in f32; o3 f32 does not - r3 measurement)
    results["rows"].append(run_config(
        N512, CNLinearConfig.production(2, 8, 6),
        "production_o2m8s6_f32_512", dt=DT512,
    ))
    save()
    c = CNLinearConfig.production(2, 8, 6)
    c.precond_dtype = "bfloat16"
    c.precond_scope = "mom"
    results["rows"].append(run_config(
        N512, c, "production_o2m8s6_bf16mom_512", dt=DT512,
    ))
    save()
    c = CNLinearConfig.production(3, 8, 6)
    c.precond_dtype = "bfloat16"
    c.precond_scope = "mom"
    results["rows"].append(run_config(
        N512, c, "production_o3m8s6_bf16mom_512", dt=DT512,
    ))
    save()
    # reference-tolerance contract AT the 512 shape without Krylov
    # basis memory (the fgmres row above OOMs: a stacked
    # [restart+1, 235M] basis sublane-pads ~1.6-2.7x, krylov.py:490
    # — 7 GB for 5 vectors): Richardson outer = x += M(b - Ax) with
    # the ABF preconditioner, ZERO basis buffers. A fixed budget
    # whose achieved rtol lands under 1e-5 every step meets the
    # contract (nssol.c:22-25 is a stopping criterion, not a method).
    c = CNLinearConfig.production(8, 6, 8)
    c.mom_solver = "jacobi"
    c.outer_type = "richardson"
    c.precond_dtype = "bfloat16"
    c.precond_scope = "mom"
    results["rows"].append(run_config(
        N512, c, "tolcontract_richardson_o8jac6s8_bf16mom_512",
        dt=DT512,
    ))
    save()
    # o8 plateaus at 2.2e-5 (contraction ~0.26/iter); two more
    # iterations land the per-step plateau under the 1e-5 contract
    c = CNLinearConfig.production(10, 6, 8)
    c.mom_solver = "jacobi"
    c.outer_type = "richardson"
    c.precond_dtype = "bfloat16"
    c.precond_scope = "mom"
    results["rows"].append(run_config(
        N512, c, "tolcontract_richardson_o10jac6s8_bf16mom_512",
        dt=DT512,
    ))
    save()
    # the r5 shipped bench config (TUNE512 winner): its effective
    # per-step rtol is the accuracy contract the 2.9 steps/s carries
    c = CNLinearConfig.production(2, 6, 8)
    c.mom_solver = "jacobi"
    c.precond_dtype = "bfloat16"
    c.precond_scope = "mom"
    results["rows"].append(run_config(
        N512, c, "production_o2jac6s8_bf16mom_512", dt=DT512,
    ))
    save()


if __name__ == "__main__":
    main()
