"""channel512 solver-combo tuning under the solve-quality gates.

Damped-Jacobi momentum sweeps need no dot products (A = I + dt C -
b L is diagonally dominant at this CFL-0.6 dt; earlier divergences
were the Richardson outer and the anisotropic V-cycle Schur, neither
of which is in play here — GCR outer + CG Schur stay).

Every candidate passes the 10-step mean-flow retention gate and
records the coupled rnorm (bench ceiling 500); a faster-but-looser
combo is rejected, not shipped.

  python examples/tune512.py
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


CANDIDATES = [
    # label, outer, mom_solver, m, s, precond_dtype, scope
    ("o3_bicgstab8_s6_bf16mom", 3, "bicgstab", 8, 6, "bfloat16", "mom"),
    ("o3_jacobi8_s6_bf16mom", 3, "jacobi", 8, 6, "bfloat16", "mom"),
    ("o3_jacobi6_s6_bf16mom", 3, "jacobi", 6, 6, "bfloat16", "mom"),
    ("o3_jacobi6_s4_bf16mom", 3, "jacobi", 6, 4, "bfloat16", "mom"),
    ("o3_gcr8_s6_bf16mom", 3, "gcr", 8, 6, "bfloat16", "mom"),
    # outer=2 removes a whole (mom + Schur + coupled-apply) block —
    # the quality gates decide whether the looser solve is shippable
    ("o2_jacobi6_s6_bf16mom", 2, "jacobi", 6, 6, "bfloat16", "mom"),
    ("o2_jacobi8_s6_bf16mom", 2, "jacobi", 8, 6, "bfloat16", "mom"),
    ("o2_jacobi6_s8_bf16mom", 2, "jacobi", 6, 8, "bfloat16", "mom"),
    ("o3_jacobi6_s5_bf16mom", 3, "jacobi", 6, 5, "bfloat16", "mom"),
    # o2 quality recovery (first o2 pass): the o2 rnorm breach was the
    # SCHUR budget, not the outer count — s8 matches o3/s6 quality
    # (rnorm_30 350.0 vs 359). Shave candidates around that point:
    ("o2_jacobi6_s7_bf16mom", 2, "jacobi", 6, 7, "bfloat16", "mom"),
    ("o2_jacobi5_s8_bf16mom", 2, "jacobi", 5, 8, "bfloat16", "mom"),
]


def run_candidate(label, outer, mom_solver, m, s, pdt, scope):
    import jax
    import jax.numpy as jnp

    from fluca_tpu.models.channel import setup_channel_3d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    N = (512, 256, 256)
    ns = setup_channel_3d(N=N, dt=5e-5, max_steps=10**9,
                          stretch_y=2.0, dtype=jnp.float32)
    cfg = CNLinearConfig.production(outer, m, s)
    cfg.mom_solver = mom_solver
    cfg.precond_dtype = pdt
    cfg.precond_scope = scope
    ns.impl.cfg = cfg
    rec = {"label": label, "outer": outer, "mom": [mom_solver, m],
           "schur": ["cg", s], "precond": [pdt, scope]}
    try:
        u0 = float(np.abs(np.asarray(ns.state["v"][0])).mean())
        t0 = time.time()
        ns.step()
        rec["compile_s"] = round(time.time() - t0, 1)
        # retention gate (10 steps) — the advance(10) program is also
        # the timing unit, so one scan compile serves both
        t0 = time.time()
        ns.advance(10)
        rec["scan_compile_s"] = round(time.time() - t0, 1)
        u1 = float(np.abs(np.asarray(ns.state["v"][0])).mean())
        rec["retention_10"] = round(u1 / u0, 4)
        rec["ksp_rnorm"] = round(float(ns.last_diag["ksp_rnorm"]), 2)
        if not np.isfinite(u1) or u1 < 0.9 * u0:
            rec["verdict"] = "REJECT: mean flow decayed"
            return rec
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            ns.advance(10)
            # scalar device-reduction sync (not a 134 MB field
            # download inside the timed window — see
            # bench._advance_throughput)
            float(jnp.sum(ns.state["v"][0]))
            best = min(best, time.time() - t0)
        rec["steps_per_sec"] = round(10 / best, 3)
        rec["ms_per_step"] = round(best * 100, 1)
        rec["ksp_rnorm_30"] = round(
            float(ns.last_diag["ksp_rnorm"]), 2
        )
        u2 = float(np.abs(np.asarray(ns.state["v"][0])).mean())
        rec["retention_40"] = round(u2 / u0, 4)
        ok = (
            np.isfinite(u2) and u2 >= 0.9 * u0
            and rec["ksp_rnorm_30"] <= 500.0
        )
        rec["verdict"] = "PASS" if ok else "REJECT: quality gate"
    except Exception as e:
        rec["verdict"] = f"FAILED {type(e).__name__}: {e}"
    finally:
        del ns
        gc.collect()
    return rec


def main():
    results = []
    only = sys.argv[1].split(",") if len(sys.argv) > 1 else None
    if only and os.path.exists(os.path.join(ROOT, "TUNE512.json")):
        # filtered runs append to the committed sweep instead of
        # clobbering it (earlier candidates stay; re-runs replace)
        with open(os.path.join(ROOT, "TUNE512.json")) as f:
            results = [r for r in json.load(f)
                       if not any(o in r.get("label", "")
                                  for o in only)]
    for cand in CANDIDATES:
        if only and not any(o in cand[0] for o in only):
            continue
        print(f"--- {cand[0]}", flush=True)
        rec = run_candidate(*cand)
        results.append(rec)
        print(json.dumps(rec), flush=True)
        # persist incrementally (HBM exhaustion later must not lose
        # earlier measurements)
        with open(os.path.join(ROOT, "TUNE512.json"), "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
