"""Benchmark: pressure-Poisson stencil SpMV against a plain copy, and
full-step throughput of the NS cells.

Primary metric (BASELINE.json north star: Poisson SpMV >= 80% of the
memory-bandwidth roofline per device): the Poisson apply's effective
bandwidth as a fraction of a plain XLA copy of a same-size buffer
measured in the same run (no stencil can move data faster than a
copy).

Timing uses iteration-count slopes with a forced scalar host fetch:
per-call fixed overheads (dispatch, host sync) cancel in the slope,
so the number is device throughput.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
and exits non-zero when any cell recorded an error.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()


def copy_op(x):
    """Plain XLA copy: the speed-of-light reference of a stencil
    sweep that reads and writes one buffer of the same size."""
    return x * 1.0000001


def slope_time_per_iter(fn, x, iters_lo=50, iters_hi=400, repeats=3):
    """Seconds per application of fn, fixed overheads removed.

    The iteration windows must be long enough that host-sync jitter
    is small against the device time, or the slope swings run to run
    — hence 50/400, not 10/60."""
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
        float(g(x))  # compile + warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(g(x))
            best = min(best, time.perf_counter() - t0)
        ts[iters] = best
    return (ts[iters_hi] - ts[iters_lo]) / (iters_hi - iters_lo)


def spmv_roofline(N=4096):
    import jax.numpy as jnp
    import numpy as np

    from fluca_tpu.mesh.cart import CartMesh
    from fluca_tpu.ns.bc import zero_velocity_bc
    from fluca_tpu.solvers.mg import PoissonMG
    dtype = jnp.float32
    mesh = CartMesh.create((N, N))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    bcs = [zero_velocity_bc()] * 4
    mg = PoissonMG(mesh, bcs, scale=1.0, dtype=dtype)

    x = jnp.ones((N, N), dtype)
    t_copy = slope_time_per_iter(copy_op, x)
    t_spmv = slope_time_per_iter(mg.apply_op, x)

    bytes_moved = 2 * N * N * np.dtype(np.float32).itemsize
    gbps_copy = bytes_moved / t_copy / 1e9
    gbps_spmv = bytes_moved / t_spmv / 1e9
    frac = gbps_spmv / gbps_copy
    return {
        "frac": frac,
        "gbps_copy": gbps_copy,
        "gbps_spmv": gbps_spmv,
        "us_per_apply": t_spmv * 1e6,
        "N": N,
    }


def main():
    r = spmv_roofline()
    frac = r["frac"]
    extra = {
        "cavity2d_256_steps_per_sec": None,
        "cavity3d_64_steps_per_sec": None,
        "channel3d_128_steps_per_sec": None,
    }
    if "--quick" not in sys.argv:
        # full-step throughputs (the perf surface where the real work
        # is; VERDICT r1 item 5): production preset, warm scan path
        try:
            extra["cavity2d_256_steps_per_sec"] = round(
                cavity_throughput(N=256, steps=50), 2
            )
            extra["cavity3d_64_steps_per_sec"] = round(
                cavity3d_throughput(N=(64, 64, 32), steps=30), 2
            )
            extra["channel3d_128_steps_per_sec"] = round(
                channel_throughput(N=128, steps=30), 2
            )
            extra["channel3d_128_bf16_steps_per_sec"] = round(
                channel_throughput(N=128, steps=30, bf16=True), 2
            )
            extra["channel3d_128_fast_steps_per_sec"] = round(
                channel_throughput(N=128, steps=30, fast=True), 2
            )
        except Exception as e:  # pragma: no cover
            extra["error"] = f"{type(e).__name__}: {e}"
        # BASELINE config #5 at stated size (own try: a memory
        # failure here must not discard the metrics above)
        try:
            r512 = channel512_bench()
            extra["channel512_steps_per_sec"] = r512["steps_per_sec"]
            extra["channel512_spmv_gbps"] = r512["spmv_gbps"]
            extra["channel512_copy_gbps"] = r512["copy_gbps"]
            extra["channel512_mcells_per_sec"] = r512["mcells_per_sec"]
            extra["channel512_solver"] = r512["solver"]
            extra["channel512_rnorm"] = r512["ksp_rnorm"]
        except Exception as e:  # pragma: no cover
            extra["channel512_error"] = f"{type(e).__name__}: {e}"

    print(
        json.dumps(
            {
                "metric": "poisson_spmv_roofline_fraction",
                "value": round(frac, 4),
                "unit": (
                    f"fraction of measured copy roofline "
                    f"({r['gbps_copy']:.0f} GB/s); spmv "
                    f"{r['gbps_spmv']:.0f} GB/s at "
                    f"{r['us_per_apply']:.0f} us/apply, "
                    f"{r['N']}x{r['N']} f32; extra: full-step "
                    f"steps/s at the fixed-budget production preset"
                ),
                "vs_baseline": round(frac / 0.80, 4),
                "device": device_info(),
                **extra,
            }
        )
    )
    if any(k.endswith("error") for k in extra):
        sys.exit(1)


def device_info():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card_line()}


def card_line():
    """'<name>, <power limit>' as nvidia-smi reports them (None off
    an NVIDIA machine)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0].strip()


def _advance_throughput(ns, steps):
    """Warm steps/s of the scan fast path with host-sync timing.

    The sync fetch is a SCALAR device reduction, not a field
    download: jnp.sum depends on the final state so float() blocks
    until every step finished, while np.asarray(v) would also copy a
    full field to the host inside the timed window."""
    import time

    import jax.numpy as jnp

    ns.step()
    ns.advance(steps)  # compile the scan program
    float(jnp.sum(ns.state["v"][0]))
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        ns.advance(steps)
        float(jnp.sum(ns.state["v"][0]))
        best = min(best, time.time() - t0)
    return steps / best


def cavity_throughput(N=256, steps=50, capped=True):
    """Cavity 2-D timesteps/sec.

    steps=50 so the one host sync per advance() amortizes below the
    per-step cost."""
    from fluca_tpu.models.cavity import setup_cavity_2d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    ns = setup_cavity_2d(
        N=N, Re=100.0, dt=0.01, max_steps=10 * steps + 1
    )
    if capped:
        ns.impl.cfg = CNLinearConfig.production()
    return _advance_throughput(ns, steps)


def cavity3d_throughput(N=(64, 64, 32), steps=30):
    """Cavity 3-D (reference cavity_flow_3d.c config) timesteps/sec."""
    import jax.numpy as jnp

    from fluca_tpu.models.cavity import setup_cavity_3d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    ns = setup_cavity_3d(N=N, Re=100.0, dt=0.01,
                         max_steps=10 * steps + 1, dtype=jnp.float32)
    ns.impl.cfg = CNLinearConfig.production()
    return _advance_throughput(ns, steps)


def channel_throughput(N=128, steps=30, fast=False, bf16=False):
    """Turbulent-channel config 128^3 timesteps/sec (the 3-D
    full-step bandwidth story).

    fast=True: the production_fast preset (GCR outer + Jacobi
    momentum + V-cycle Schur — the r4 GCR outer keeps it bounded at
    any CFL where the r3 Richardson outer diverged;
    tests/test_fastpath.py).
    bf16=True: production with the bf16 ABF preconditioner."""
    import jax.numpy as jnp

    from fluca_tpu.models.channel import setup_channel_3d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    ns = setup_channel_3d(N=(N, N, N), dt=2e-3, max_steps=10**9,
                          dtype=jnp.float32)
    cfg = (CNLinearConfig.production_fast() if fast
           else CNLinearConfig.production())
    if bf16:
        cfg.precond_dtype = "bfloat16"
    ns.impl.cfg = cfg
    return _advance_throughput(ns, steps)


# Channel 512x256x256 (BASELINE config #5). dt: at the r3 bench's
# dt=1e-3 the convective CFL on this grid is ~12 (laminar centerline
# u ~ 90, h_x = 4/512): the momentum block loses diagonal dominance,
# every fixed-budget combo under-resolves, and the driven flow
# silently decays. Throughput is dt-independent, so the benchmark
# uses a CFL ~ 0.6 step like any production run would.
CHANNEL512_DT = 5e-5
CHANNEL512_N = (512, 256, 256)
# Solver ladder, first that passes the retention gate wins: (label,
# outer, momentum solver, momentum budget, Schur budget, precond
# dtype, precond scope). GCR outer + CG Schur throughout: on the
# wall-clustered grid the anisotropic V-cycle used as a Richardson
# iteration diverges. bf16 scope "mom": momentum solves in bf16
# (diagonally dominant, robust), the Schur solve stays f32 (the bf16
# V-cycle on this anisotropic operator lets the flow collapse).
# Damped-Jacobi momentum sweeps are diagonally dominant at CFL 0.6
# and need no dot products. The o2 rnorm budget is set by the Schur
# count: s8 at o2 matches the solve quality of o3/s6.
CHANNEL512_ATTEMPTS = [
    ("o2+jac6s8+bf16mom", 2, "jacobi", 6, 8, "bfloat16", "mom"),
    ("o3+jac6s6+bf16mom", 3, "jacobi", 6, 6, "bfloat16", "mom"),
    ("o3+bf16mom", 3, "bicgstab", 8, 6, "bfloat16", "mom"),
    ("o2", 2, "bicgstab", 8, 6, None, "both"),
]


def setup_channel512(attempt=None):
    """The channel at the benchmark's shape, dt and stretching, with
    one rung of the solver ladder (the first by default)."""
    import jax.numpy as jnp

    from fluca_tpu.models.channel import setup_channel_3d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    _, outer, momsol, m, s, pdt, scope = (
        attempt or CHANNEL512_ATTEMPTS[0]
    )
    ns = setup_channel_3d(N=CHANNEL512_N, dt=CHANNEL512_DT,
                          max_steps=10**9,
                          stretch_y=2.0, dtype=jnp.float32)
    cfg = CNLinearConfig.production(outer, m, s)
    cfg.mom_solver = momsol
    cfg.precond_dtype = pdt
    cfg.precond_scope = scope
    ns.impl.cfg = cfg
    return ns


def mean_abs_u(ns):
    import jax.numpy as jnp

    return float(jnp.mean(jnp.abs(ns.state["v"][0])))


def retention_gate(u0, u1):
    """Solve-quality gate, not just finiteness: on the wall-clustered
    grid a too-weak preconditioner makes the fixed-budget solve
    return x ~ 0 and the driven mean flow silently decays. 10 steps
    must retain 90% of it."""
    import numpy as np

    if not np.isfinite(u1) or u1 < 0.9 * u0:
        raise RuntimeError(
            f"mean flow decayed {u0:.3g}->{u1:.3g} in 10 steps: "
            f"solver under-resolving"
        )
    return u1 / u0


def channel512_bench(steps=20):
    """BASELINE config #5 at its stated size: turbulent channel
    512x256x256 f32 on one device. Reports the full production-step
    throughput and the 7-point stencil-SpMV bandwidth at that shape
    beside a plain copy of the same size."""
    import jax.numpy as jnp
    import numpy as np

    ns = None
    for attempt in CHANNEL512_ATTEMPTS:
        label = attempt[0]
        try:
            ns = setup_channel512(attempt)
            u0 = mean_abs_u(ns)
            ns.step()  # compiles + runs one step (OOM shows here)
            ns.advance(10)
            retention_gate(u0, mean_abs_u(ns))
            solver_label = label
            break
        except Exception as e:
            print(f"channel512 {label} failed: {type(e).__name__}: "
                  f"{e}", file=sys.stderr)
            ns = None
    if ns is None:
        raise RuntimeError("channel512: every solver attempt failed")

    sps = _advance_throughput(ns, steps)
    rnorm = float(ns.last_diag["ksp_rnorm"])

    # stencil SpMV GB/s at this shape (2 field sweeps per apply)
    x = jnp.zeros(ns.mesh.cell_shape, jnp.float32)
    t_spmv = slope_time_per_iter(ns.impl.mg.apply_op, x, iters_lo=20,
                                 iters_hi=120)
    t_copy = slope_time_per_iter(copy_op, x, iters_lo=20, iters_hi=120)
    cells = int(np.prod(CHANNEL512_N))
    bytes_moved = 2 * cells * 4
    return {
        "steps_per_sec": round(sps, 3),
        "ms_per_step": round(1e3 / sps, 1),
        "mcells_per_sec": round(cells * sps / 1e6, 1),
        "spmv_gbps": round(bytes_moved / t_spmv / 1e9, 1),
        "copy_gbps": round(bytes_moved / t_copy / 1e9, 1),
        "solver": solver_label,
        "ksp_rnorm": round(rnorm, 2),
        "grid": list(CHANNEL512_N),
    }


def poisson3d_roofline(N=256):
    """3-D 7-point apply vs a same-size plain copy (run with
    --poisson3d)."""
    import jax.numpy as jnp
    import numpy as np

    from fluca_tpu.mesh.cart import CartMesh
    from fluca_tpu.ns.bc import zero_velocity_bc
    from fluca_tpu.solvers.mg import PoissonMG

    dtype = jnp.float32
    mesh = CartMesh.create((N, N, N))
    mesh.set_uniform_coordinates(0, 1, 0, 1, 0, 1)
    mg = PoissonMG(mesh, [zero_velocity_bc()] * 6, scale=1.0,
                   dtype=dtype)

    x = jnp.ones((N, N, N), dtype)
    t_copy = slope_time_per_iter(copy_op, x, iters_lo=20,
                                 iters_hi=150)
    t_spmv = slope_time_per_iter(mg.apply_op, x, iters_lo=20,
                                 iters_hi=150)

    bytes_moved = 2 * N**3 * np.dtype(np.float32).itemsize
    gbps_copy = bytes_moved / t_copy / 1e9
    gbps_spmv = bytes_moved / t_spmv / 1e9
    frac = gbps_spmv / gbps_copy
    print(
        json.dumps(
            {
                "metric": "poisson3d_spmv_roofline_fraction",
                "value": round(frac, 4),
                "unit": (
                    f"fraction of measured copy roofline "
                    f"({gbps_copy:.0f} GB/s); spmv {gbps_spmv:.0f} "
                    f"GB/s at {t_spmv*1e6:.0f} us/apply, {N}^3 f32"
                ),
                "vs_baseline": round(frac / 0.80, 4),
                "device": device_info(),
            }
        )
    )


if __name__ == "__main__":
    if "--cavity" in sys.argv:
        print(json.dumps({
            "metric": "cavity_timesteps_per_sec",
            "value": round(cavity_throughput(), 3),
            "unit": "steps/s (256x256 f32, Re=100, capped-3)",
            "vs_baseline": None,
        }))
    elif "--channel3d" in sys.argv:
        print(json.dumps({
            "metric": "channel3d_timesteps_per_sec",
            "value": round(channel_throughput(), 3),
            "unit": "steps/s (128^3 f32, production preset)",
            "vs_baseline": None,
        }))
    elif "--channel512" in sys.argv:
        r = channel512_bench()
        print(json.dumps({
            "metric": "channel512_timesteps_per_sec",
            "value": r["steps_per_sec"],
            "unit": (
                f"steps/s (512x256x256 f32, production preset, "
                f"{r['ms_per_step']} ms/step, "
                f"{r['mcells_per_sec']} Mcells/s; stencil SpMV "
                f"{r['spmv_gbps']} GB/s at this shape)"
            ),
            "vs_baseline": None,
            **r,
        }))
    elif "--poisson3d" in sys.argv:
        poisson3d_roofline()
    else:
        main()
