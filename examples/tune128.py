"""A/B of fixed-budget solver combos on the channel 128^3 f32
config (VERDICT r4 items 1+3): step time AND 30-step accuracy of each
combo vs the reference-semantics production preset, plus a direct
reproduction run of the production_fast (richardson outer) preset
that diverged in the r3 bench.

  python examples/tune128.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def throughput(ns, steps=30):
    ns.step()
    ns.advance(steps)
    np.asarray(ns.state["v"][0])
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        ns.advance(steps)
        np.asarray(ns.state["v"][0])
        best = min(best, time.time() - t0)
    return steps / best


def run_combo(cfg, label, nsteps=31, measure=True):
    from fluca_tpu.models.channel import setup_channel_3d

    ns = setup_channel_3d(
        N=(128, 128, 128), dt=2e-3, max_steps=10**9,
        dtype=jnp.float32,
    )
    ns.impl.cfg = cfg
    out = {"label": label}
    try:
        if measure:
            sps = throughput(ns)
            out["steps_per_sec"] = round(sps, 2)
            out["ms_per_step"] = round(1e3 / sps, 2)
        else:
            ns.step()
            ns.advance(nsteps - 1)
        v = np.asarray(ns.state["v"][0])
        out["finite"] = bool(np.isfinite(v).all())
        out["state"] = {
            k: np.asarray(x)
            for k, x in [("vx", ns.state["v"][0]),
                         ("p", ns.state["p"])]
        }
        out["rnorm"] = float(ns.last_diag["ksp_rnorm"]) if getattr(
            ns, "last_diag", None) else None
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def main():
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    results = []

    prod = run_combo(CNLinearConfig.production(),
                     "production(gcr+bicgstab_fixed+cg_fixed)")
    results.append(prod)
    print(json.dumps({k: v for k, v in prod.items() if k != "state"}),
          flush=True)

    # bf16 ABF preconditioner under the f32 GCR outer: at >= 134 MB
    # f32 fields the HBM streams at HALF rate (PROBE512.json), and
    # the inner solves are ~80% of the step — bf16 inner state halves
    # bytes AND (at 512-class sizes) doubles the achievable rate.
    # Scope/outer variants: a weaker M may need an extra outer.
    for label, outer, scope in [
        ("production+bf16_precond", 3, "both"),
        ("production+bf16_mom_only", 3, "mom"),
        ("production_o4+bf16_precond", 4, "both"),
    ]:
        p16 = CNLinearConfig.production(outer, 8, 6)
        p16.precond_dtype = "bfloat16"
        p16.precond_scope = scope
        r = run_combo(p16, label)
        results.append(r)
        print(json.dumps(
            {k: v for k, v in r.items() if k != "state"}
        ), flush=True)

    mix = CNLinearConfig.production_fast()
    r = run_combo(mix, "gcr+jacobi+vcycle")
    results.append(r)
    print(json.dumps({k: v for k, v in r.items() if k != "state"}),
          flush=True)

    fast = CNLinearConfig.production_fast(
        outer_type="richardson"
    )
    fast = run_combo(fast,
                     "production_fast(richardson+jacobi+vcycle)")
    results.append(fast)
    print(json.dumps({k: v for k, v in fast.items() if k != "state"}),
          flush=True)

    # accuracy vs production after the same number of steps
    ref = prod.get("state")
    summary = []
    for r in results:
        row = {k: v for k, v in r.items() if k != "state"}
        if ref is not None and r.get("state") is not None:
            dv = np.abs(r["state"]["vx"] - ref["vx"]).max()
            row["max_dvx_vs_production"] = float(dv)
        summary.append(row)
    with open(os.path.join(ROOT, "TUNE128.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
