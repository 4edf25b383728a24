"""Decompose the 3-D step cost at 128^3 (channel config) on the GPU.

Strategy: the production preset runs fixed budgets (outer o, momentum
m, Schur s). Timing steps/s while varying one budget at a time gives
the marginal cost of one momentum BiCGStab iteration (2 A-applies),
one Schur CG iteration (1 DGst apply + 1 MG V-cycle), and one outer
FGMRES iteration (1 coupled apply + 1 full ABF application) — measured
in situ, with XLA fusion exactly as in the real step.

Run:  python examples/profile3d.py
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()

import numpy as np


def time_config(N, outer, mom, schur, steps=30, repeats=3, fast=False):
    import jax.numpy as jnp

    from fluca_tpu.models.channel import setup_channel_3d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    ns = setup_channel_3d(
        N=(N, N, N), dt=2e-3, max_steps=100000, dtype=jnp.float32
    )
    preset = (
        CNLinearConfig.production_fast if fast
        else CNLinearConfig.production
    )
    ns.impl.cfg = preset(outer=outer, mom=mom, schur=schur)
    ns.step()
    ns.advance(steps)  # compile scan program
    np.asarray(ns.state["v"][0])
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        ns.advance(steps)
        np.asarray(ns.state["v"][0])
        best = min(best, time.perf_counter() - t0)
    ms = best / steps * 1e3
    tag = "fast " if fast else ""
    print(f"  {tag}o{outer}/m{mom}/s{schur}: {ms:8.2f} ms/step "
          f"({steps/best:.1f} steps/s)", flush=True)
    return ms


def time_pieces(N):
    """Standalone V-cycle / top-level SpMV timings (slope method)."""
    import jax
    import jax.numpy as jnp

    from bench import slope_time_per_iter
    from fluca_tpu.mesh.cart import CartMesh
    from fluca_tpu.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
    from fluca_tpu.solvers.mg import PoissonMG

    per = BoundaryCondition(BCType.PERIODIC)
    wall = zero_velocity_bc()
    mesh = CartMesh.create((N, N, N), (True, False, True))
    mesh.set_uniform_coordinates(0, 4, 0, 2, 0, 2)
    mg = PoissonMG(mesh, [per, per, wall, wall, per, per],
                   scale=2e-3, dtype=jnp.float32)
    x = jnp.ones((N, N, N), jnp.float32)
    t_spmv = slope_time_per_iter(mg.apply_op, x, iters_lo=20,
                                 iters_hi=150)
    t_v = slope_time_per_iter(
        jax.jit(mg.precondition), x, iters_lo=5, iters_hi=40
    )
    print(f"  top-level SpMV (Pallas): {t_spmv*1e3:8.3f} ms", flush=True)
    print(f"  MG V-cycle:              {t_v*1e3:8.3f} ms", flush=True)
    return t_spmv, t_v


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    if "--fast" in sys.argv:
        # fast-path marginal costs (production_fast presets)
        print(f"== fast-path configs at {N}^3 (channel) ==", flush=True)
        base = time_config(N, 3, 8, 6, fast=True)
        s2 = time_config(N, 3, 8, 2, fast=True)
        m2 = time_config(N, 3, 2, 6, fast=True)
        o1 = time_config(N, 1, 8, 6, fast=True)
        per_schur = (base - s2) / (3 * 4.0)
        per_mom = (base - m2) / (3 * 6.0)
        per_outer = (base - o1) / 2.0
        print("\n== fast-path marginal costs ==")
        print(f"  per Schur V-cycle:   {per_schur:7.2f} ms "
              f"(3x6 = {18*per_schur:.1f} ms)")
        print(f"  per Jacobi sweep:    {per_mom:7.2f} ms "
              f"(3x8 = {24*per_mom:.1f} ms)")
        print(f"  per outer iter:      {per_outer:7.2f} ms (fixed "
              f"part = {per_outer - 6*per_schur - 8*per_mom:.2f} ms)")
        print(f"  step fixed part:     {base - 3*per_outer:7.2f} ms")
        return
    print(f"== pieces at {N}^3 ==", flush=True)
    t_spmv, t_v = time_pieces(N)

    print(f"== step configs at {N}^3 (channel) ==", flush=True)
    base = time_config(N, 3, 8, 6)
    s2 = time_config(N, 3, 8, 2)
    m2 = time_config(N, 3, 2, 6)
    o1 = time_config(N, 1, 8, 6)

    # each outer FGMRES iteration runs one ABF apply (m momentum
    # BiCGStab iters + s Schur CG iters + fixed extras) and one
    # coupled apply, so varying s by ds changes 3*ds Schur iterations
    per_schur = (base - s2) / (3 * 4.0)
    per_mom = (base - m2) / (3 * 6.0)
    per_outer = (base - o1) / 2.0
    print("\n== marginal costs ==")
    print(f"  per Schur CG iter:   {per_schur:7.2f} ms  "
          f"(3 outer x 6 = {18*per_schur:.1f} ms of {base:.1f})")
    print(f"  per momentum iter:   {per_mom:7.2f} ms  "
          f"(3 outer x 8 = {24*per_mom:.1f} ms)")
    print(f"  per outer iter:      {per_outer:7.2f} ms "
          f"(incl. its own schur+mom: fixed part = "
          f"{per_outer - 6*per_schur - 8*per_mom:.2f} ms)")
    print(f"  step fixed part (rhs/coeffs/update): "
          f"{base - 3*per_outer:7.2f} ms")
    print(f"  V-cycle alone: {t_v*1e3:.2f} ms; SpMV alone: "
          f"{t_spmv*1e3:.3f} ms")


if __name__ == "__main__":
    main()
