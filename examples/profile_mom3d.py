"""Split the 3-D momentum BiCGStab iteration cost: A-apply vs vector
ops, at 128^3 on the GPU. Also measures the pure-traffic speed-of-light
for an A-apply (sum of the fields a minimal kernel must touch).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()

import numpy as np


def tree_slope_time(fn, x, iters_lo=20, iters_hi=150, repeats=3):
    """slope_time_per_iter over pytree-valued fn."""
    import time

    import jax
    import jax.numpy as jnp
    from jax import lax

    ts = {}
    for iters in (iters_lo, iters_hi):
        g = jax.jit(
            lambda x, it=iters: sum(
                jnp.sum(leaf)
                for leaf in jax.tree_util.tree_leaves(
                    lax.fori_loop(0, it, lambda i, a: fn(a), x)
                )
            )
        )
        float(g(x))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(g(x))
            best = min(best, time.perf_counter() - t0)
        ts[iters] = best
    return (ts[iters_hi] - ts[iters_lo]) / (iters_hi - iters_lo)


def main():
    import jax
    import jax.numpy as jnp
    from fluca_tpu.models.channel import setup_channel_3d
    from fluca_tpu.solvers.krylov import bicgstab

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    ns = setup_channel_3d(N=(N, N, N), dt=2e-3, max_steps=10,
                          dtype=jnp.float32)
    ops = ns.impl.ops
    state = ns.state
    U0 = state["U"]
    Bv0 = ops.apply_B(state["v"])
    bcB = ops.bc_B(0.0)
    v0f = tuple(
        tuple(Bv0[d][c] + bcB[d][c] for c in range(3)) for d in range(3)
    )

    # --- A-apply (XLA dict-coeff path), coeffs rebuilt inside jit ----
    def apply_once(v):
        coeffs = ops.build_momentum_coeffs(U0, v0f)
        return ops.apply_A_coeffs(v, coeffs)

    v = state["v"]
    t_apply = tree_slope_time(apply_once, v)
    print(f"A-apply (XLA, coeffs fused): {t_apply*1e3:8.3f} ms",
          flush=True)

    # --- speed-of-light: touch u,v,w + 12 factor fields once --------
    factors = []
    for d in range(3):
        lo, hi = ops._face_factors(U0[d], d)
        factors += [lo, hi]
        for c in range(3):
            lo, hi = ops._face_factors(v0f[d][c], d)
            factors += [lo]
    factors = tuple(factors)

    def sol(v):
        s = sum(f for f in factors)
        return tuple(v[c] + s for c in range(3))

    t_sol = tree_slope_time(sol, v)
    print(f"speed-of-light (18 fields in, 3 out): {t_sol*1e3:8.3f} ms",
          flush=True)

    # --- full momentum solve, 8 iters --------------------------------
    diagA = ops.diag_A(U0, v0f)

    def solve(v):
        coeffs = ops.build_momentum_coeffs(U0, v0f)
        inv_diag = tuple(1.0 / d for d in diagA)

        def A(x):
            return ops.apply_A_coeffs(x, coeffs)

        def M(r):
            return tuple(inv_diag[c] * r[c] for c in range(3))

        res = bicgstab(A, v, rtol=1e-30, maxiter=8, M=M)
        return res.x

    t_solve = tree_slope_time(solve, v, iters_lo=3, iters_hi=20)
    print(f"BiCGStab m8 solve: {t_solve*1e3:8.3f} ms "
          f"({t_solve/8*1e3:.3f} ms/iter; "
          f"vec-op share = {(t_solve/8 - 2*t_apply)*1e3:.3f} ms/iter)",
          flush=True)


if __name__ == "__main__":
    main()
