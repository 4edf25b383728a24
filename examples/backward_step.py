"""Backward-facing step validation run (expansion ratio 2).

Runs to steady state and reports the lower-wall reattachment length
x_r/S against the literature (Armaly et al. 1983 experiment ~3.0 at
Re=100; 2-D computations 2.8-3.1). Usage:

  python examples/backward_step.py [--re 100] [--nx 512] [--ny 64]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--length", type=float, default=10.0)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--tmax", type=float, default=80.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from fluca_tpu.models.bfs import reattachment_length, setup_bfs_2d

    S = 0.5
    max_steps = int(args.tmax / args.dt) + 1
    ns = setup_bfs_2d(
        N=(args.nx, args.ny), L=args.length, Re=args.re,
        dt=args.dt, max_steps=max_steps,
    )
    print(f"platform={jax.devices()[0].platform} grid="
          f"{args.nx}x{args.ny} Re={args.re} dt={args.dt}", flush=True)

    chunk = max(1, min(200, max_steps - 2))
    ns.step()
    u_prev = np.asarray(ns.state["v"][0])
    t0 = time.time()
    while ns.step_index < max_steps - chunk:
        ns.advance(chunk)
        u = np.asarray(ns.state["v"][0])
        if not np.all(np.isfinite(u)):
            print("DIVERGED", flush=True)
            return 1
        du = float(np.max(np.abs(u - u_prev))) / (chunk * args.dt)
        xr = reattachment_length(ns)
        print(f"t={ns.t:7.2f}  max|du/dt|={du:.3e}  "
              f"x_r/S={xr / S:.3f}", flush=True)
        u_prev = u
        if du < 1e-6:
            break
    wall = time.time() - t0

    # 2-D literature bands for ER=2 (Armaly et al. 1983 exp + 2-D
    # computations incl. Gartling 1990 at Re=800, x_r = 6.10 H =
    # 12.2 S); above Re~400 the experiment exceeds 2-D values due to
    # three-dimensionality, so bands are the 2-D computational ones.
    lit = {
        100.0: (2.4, 3.6, "exp ~3.0, 2-D 2.8-3.2"),
        200.0: (4.5, 5.9, "exp ~5.2, 2-D 4.9-5.4"),
        400.0: (7.6, 9.3, "2-D 8.2-8.7 (exp ~8.9)"),
        600.0: (9.5, 11.8, "2-D 10.3-11.0"),
        800.0: (11.0, 13.4, "Gartling 12.2 (2-D)"),
    }
    band = lit.get(args.re)
    xr = reattachment_length(ns)
    result = {
        "re": args.re,
        "grid": [args.nx, args.ny],
        "x_r_over_S": round(xr / S, 3),
        "literature": band[2] if band else "n/a for this Re",
        "t_final": round(float(ns.t), 2),
        "wall_s": round(wall, 1),
    }
    print(json.dumps(result), flush=True)
    if band and not (band[0] <= xr / S <= band[1]):
        print("OUT OF LITERATURE RANGE", flush=True)
        return 1
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
