"""Smoke test of the NS time step on an NVIDIA GPU.

    python chip_smoke.py            # phases 1-5 on one GPU
    python chip_smoke.py --four     # the 4-GPU sharded channel only

All phases run in one process (a second JAX process on the same card
would find its memory taken). Each phase prints its result; the last
line is the JSON verdict, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases:
  device     jax.devices() and the card's name and power limit
  app        fluca_tpu.app on a 3-D lid-driven cavity
  channel    the turbulent channel at 512x256x256 f32 (BASELINE #5)
  reference  cavity 64^2 and Taylor-Green 64^2 on the GPU in f32
             against the same models on the CPU backend in f64
  layers     Poisson apply / residual / Jacobi sweep and the 3-D
             momentum A-apply at full width against a numpy f64
             implementation of the same banded sums, timed beside a
             plain XLA copy
  four       (--four) the channel sharded over 4 GPUs against the
             same steps on one

Exits non-zero without a verdict when JAX finds no GPU or any phase
fails.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np

PHASES = ("device", "app", "channel", "reference", "layers")
SEED = 0
APP_N = 128          # 3-D cavity edge of the app phase
LAYER_2D_N = 4096    # 2-D Poisson layer edge
# Poisson and momentum sums have at most 27 f32 terms per output and
# no cancellation against max|y|: f32 rounding stays well inside this
LAYER_RTOL = 1e-5
# cavity: f32 rounding at the reference's 1e-5 solver tolerance
CAVITY_RTOL = 1e-4
# Taylor-Green: the f32 run's error against the exact solution may
# differ from the f64 run's by this fraction
TGV_FRAC = 0.02
# 4 GPUs against 1: NCCL reduction order is not bitwise. Velocity
# must agree to 1e-4. Pressure carries the modes that the fixed-budget
# CG leaves unconverged, which amplify rounding: at 512x256x256 a 1-ulp
# change of the start moves it by 8.6e-4 and the f32 run sits 1.1e-2
# from f64 (one H100, measured when this gate was set), so the
# decomposition may move it by as much as f32 itself is off.
FOUR_RTOL = 1e-4
FOUR_P_RTOL = 1e-2
# the channel rung of the --four phase: the benchmark's first rung
# with an f32 preconditioner. A bf16 preconditioner turns the last-bit
# differences of the reduction order into bf16 rounding flips (3e-4
# pressure difference in a 4-virtual-device CPU run), which would
# measure rounding, not the decomposition.
FOUR_ATTEMPT = ("o2+jac6s8 f32", 2, "jacobi", 6, 8, None, "both")


# ----------------------------------------------------------------------
# comparators
# ----------------------------------------------------------------------

def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over matching arrays (or sequences of them)."""
    if isinstance(a, (tuple, list)):
        num = sum(float(np.sum((np.asarray(x, np.float64)
                                - np.asarray(y, np.float64)) ** 2))
                  for x, y in zip(a, b))
        den = sum(float(np.sum(np.asarray(y, np.float64) ** 2))
                  for y in b)
    else:
        num = float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2))
        den = float(np.sum(np.asarray(b, np.float64) ** 2))
    return float(np.sqrt(num / max(den, 1e-300)))


def max_rel(y, y_ref) -> float:
    """max|y - y_ref| / max|y_ref|."""
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    return float(np.max(np.abs(y - y_ref))
                 / max(float(np.max(np.abs(y_ref))), 1e-300))


def check(name, value, limit):
    """Print value beside its limit; raise when it is past it."""
    ok = bool(np.isfinite(value)) and value <= limit
    print(f"  {name}: {value:.3e} (limit {limit:.0e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} = {value} > {limit}")


# ----------------------------------------------------------------------
# numpy float64 layer references, built from the AxisStencil bands
# ----------------------------------------------------------------------

def _bcast(w, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return np.reshape(w, shape)


def band_sum_np(st, x, axis, rows):
    """sum_off w[i] x[i + off] along ``axis`` for the output planes
    ``rows`` of axis 0 (all of them along the other axes). ``st`` is
    an AxisStencil (cell -> cell)."""
    x = np.asarray(x)
    n = x.shape[axis]
    if axis == 0:
        out_idx, base = np.asarray(rows), x
    else:
        out_idx, base = np.arange(st.n_out), x[rows]
    y = np.zeros(base.shape[:axis] + (len(out_idx),)
                 + base.shape[axis + 1:])
    for off, w in st.bands:
        idx = out_idx + off
        if st.periodic:
            ok = np.ones(idx.shape, bool)
            idx = idx % n
        else:
            ok = (idx >= 0) & (idx < n)
            idx = np.clip(idx, 0, n - 1)
        coef = np.where(ok, w[out_idx], 0.0)
        y += _bcast(coef, x.ndim, axis) * np.take(
            base, idx, axis=axis).astype(np.float64)
    return y


def poisson_np(level, x, b, rows, omega):
    """(apply, residual, one damped-Jacobi sweep) of a PoissonMG level
    in float64 on the output planes ``rows``."""
    mesh = level.mesh
    vol = np.asarray(level.host_vol)[rows]
    acc = sum(band_sum_np(st, x, d, rows)
              for d, st in enumerate(level.host_dgst))
    ap = -vol * acc
    diag = 0.0
    for d, st in enumerate(level.host_dgst):
        w0 = st.as_dict().get(0, np.zeros(mesh.N[d]))
        diag = diag + _bcast(-(w0[rows] if d == 0 else w0), mesh.dim, d)
    inv_diag = 1.0 / np.where(diag == 0.0, 1.0, vol * diag)
    res = np.asarray(b, np.float64)[rows] - ap
    jac = np.asarray(x, np.float64)[rows] + omega * inv_diag * res
    return ap, res, jac


def _face_lohi_np(F, axis, periodic, rows):
    """Low/high face values of each cell along ``axis`` (rows of
    axis 0 only)."""
    F = np.asarray(F)
    if axis == 0:
        hi_idx = np.asarray(rows) + 1
        if periodic:
            hi_idx = hi_idx % F.shape[0]
        lo, hi = F[rows], F[hi_idx]
    else:
        F = F[rows]
        n = F.shape[axis] if periodic else F.shape[axis] - 1
        lo = np.take(F, np.arange(n), axis=axis)
        hi = np.take(F, (np.arange(n) + 1) % F.shape[axis], axis=axis)
    return lo.astype(np.float64), hi.astype(np.float64)


def momentum_np(mesh, axbcs, rho, mu, dt, v, U0, v0f, rows):
    """A v = v + dt C(U0, v0f) v - (mu dt / 2 rho) L v in float64 on
    the output planes ``rows`` (cnlinearcart3d.c momentum block)."""
    from fluca_tpu.ns import tables as T_
    from fluca_tpu.ops.banded import AxisStencil

    dim = mesh.dim
    b = 0.5 * mu * dt / rho
    out = []
    for c in range(dim):
        y = np.asarray(v[c], np.float64)[rows].copy()
        for d in range(dim):
            per = mesh.periodic[d]
            lap, _, _ = T_.lap_tables(mesh, d, axbcs[d], c)
            y -= b * band_sum_np(lap, v[c], d, rows)
            FlU, FrU = _face_lohi_np(U0[d], d, per, rows)
            Flv, Frv = _face_lohi_np(v0f[d][c], d, per, rows)
            for fac, wd, comp in zip(
                (FlU, FrU, Flv, Frv),
                T_.conv_tables(mesh, d, axbcs[d], c == d)
                + T_.conv_tables(mesh, d, axbcs[d], True),
                (c, c, d, d),
            ):
                st = AxisStencil.from_dict(d, mesh.N[d], per, wd)
                y += dt * fac * band_sum_np(st, v[comp], d, rows)
        out.append(y)
    return out


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

def slope_seconds(fn, x, args, lo=5, hi=25, repeats=3):
    """Device seconds per fn(x, args) application, from the slope
    between two fori_loop lengths synced on a scalar. ``args`` are
    passed as jit arguments, never baked in as constants."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    ts = {}
    for n in (lo, hi):
        g = jax.jit(lambda x, a, n=n: sum(
            jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(
                lax.fori_loop(0, n, lambda i, y: fn(y, a), x))))
        float(g(x, args))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(g(x, args))
            best = min(best, time.perf_counter() - t0)
        ts[n] = best
    return (ts[hi] - ts[lo]) / (hi - lo)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_device(ctx):
    import jax

    import bench

    print(f"  jax.devices(): {jax.devices()}")
    ctx["card"] = bench.card_line()
    if ctx["card"] is None:
        raise RuntimeError("nvidia-smi found no card")
    print(f"  card: {ctx['card']}")


def phase_app(ctx):
    import jax
    import jax.numpy as jnp

    from fluca_tpu import app
    from fluca_tpu.ns.ns import NSConvergedReason

    N = APP_N
    t0 = time.perf_counter()
    ns = app.run([
        "-cart_dim", "3", "-cart_grid_x", str(N), "-cart_grid_y",
        str(N), "-cart_grid_z", str(N), "-ns_max_steps", "5",
        "-ns_monitor",
    ])
    jax.block_until_ready(ns.state)
    wall = time.perf_counter() - t0
    assert ns.reason == NSConvergedReason.CONVERGED_ITS, ns.reason
    for leaf in jax.tree_util.tree_leaves(ns.state):
        assert leaf.dtype == jnp.float32, leaf.dtype
        # main() runs the phases only when this backend is the GPU
        assert {d.platform for d in leaf.devices()} == {
            jax.default_backend()}
        assert bool(jnp.all(jnp.isfinite(leaf)))
    print(f"  [{ctx['card']}] cavity {N}^3 f32, 5 steps through "
          f"app.run: {wall:.1f} s wall incl. compile; "
          f"{ns.reason.name}, fields finite, state f32 on the GPU")


def phase_channel(ctx):
    import jax
    import jax.numpy as jnp

    import bench

    card = ctx["card"]
    ns = bench.setup_channel512()
    impl = ns.impl
    u0 = bench.mean_abs_u(ns)
    t0 = time.perf_counter()
    ns.step()
    ns.advance(10)
    u1 = bench.mean_abs_u(ns)
    print(f"  [{card}] step + advance(10): "
          f"{time.perf_counter() - t0:.1f} s wall incl. compile")
    retention = bench.retention_gate(u0, u1)
    for leaf in jax.tree_util.tree_leaves(ns.state):
        assert bool(jnp.all(jnp.isfinite(leaf)))
        assert leaf.dtype == jnp.float32
    rnorm = float(ns.last_diag["ksp_rnorm"])
    print(f"  retention {retention:.4f} (gate 0.9), ksp_rnorm {rnorm}, "
          f"solver {bench.CHANNEL512_ATTEMPTS[0][0]}")
    float(jnp.sum(ns.state["v"][0]))
    t0 = time.perf_counter()
    ns.advance(10)
    float(jnp.sum(ns.state["v"][0]))
    ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"  [{card}] warm {ms:.2f} ms/step over advance(10) "
          f"(information, not a claim)")
    tabs = impl._big_tables() if impl._tables_as_params() else None
    compiled = impl._step_jit["scan"].lower(
        ns.state, jnp.asarray(ns.t, jnp.float32), tabs, 10
    ).compile()
    print(f"  scan(10) memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  [{card}] peak device bytes "
          f"{stats.get('peak_bytes_in_use')}")


def _cavity(dtype, steps):
    from fluca_tpu.models.cavity import setup_cavity_2d

    ns = setup_cavity_2d(N=64, Re=100.0, dt=0.01, max_steps=steps,
                         dtype=dtype)
    ns.solve()
    return [np.asarray(x) for x in ns.state["v"]], np.asarray(
        ns.state["p"])


def _tgv(dtype):
    from fluca_tpu.models.tgv import setup_taylor_green_2d, tgv_errors

    ns = setup_taylor_green_2d(N=64, nsteps=10, t_final=1.0,
                               dtype=dtype)
    ns.solve()
    return tgv_errors(ns), ns.state["p"].dtype


def cpu_f64(fn, *args):
    """fn(*args) on the CPU backend with x64 on for this call only."""
    import jax

    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        return fn(*args)


def phase_reference(ctx):
    import jax
    import jax.numpy as jnp

    steps = 20
    gv, gp = _cavity(jnp.float32, steps)
    assert gp.dtype == np.float32, gp.dtype
    cv, cp = cpu_f64(_cavity, jnp.float64, steps)
    assert cp.dtype == np.float64, cp.dtype
    assert not jax.config.jax_enable_x64, "x64 leaked into the GPU run"
    print(f"  cavity 64^2, {steps} steps: GPU f32 vs CPU f64")
    check("velocity rel L2", rel_l2(gv, cv), CAVITY_RTOL)
    check("pressure rel L2", rel_l2(gp, cp), CAVITY_RTOL)

    (gve, gpe), gdt = _tgv(jnp.float32)
    (cve, cpe), cdt = cpu_f64(_tgv, jnp.float64)
    assert gdt == jnp.float32 and cdt == jnp.float64, (gdt, cdt)
    print(f"  Taylor-Green 64^2 L2 errors vs exact: GPU f32 "
          f"v {gve:.6e} p {gpe:.6e}; CPU f64 v {cve:.6e} p {cpe:.6e}")
    check("velocity error drift", abs(gve - cve) / cve, TGV_FRAC)
    check("pressure error drift", abs(gpe - cpe) / cpe, TGV_FRAC)


def _rows(n):
    """Output planes checked against the host reference: both ends of
    axis 0 (boundary rows) and two in the middle."""
    return np.unique(np.r_[0:4, n // 2 - 1:n // 2 + 1, n - 4:n])


def _time_line(card, name, seconds, streams, nbytes, copy_gbps):
    gbps = streams * nbytes / seconds / 1e9
    print(f"  [{card}] {name}: {seconds * 1e3:.3f} ms, {gbps:.1f} GB/s "
          f"effective ({streams} streams) = {gbps / copy_gbps:.3f} "
          f"of copy")


def _poisson_layer(ctx, mesh, bcs, label):
    import jax
    import jax.numpy as jnp

    from fluca_tpu.solvers.mg import PoissonMG

    card = ctx["card"]
    mg = PoissonMG(mesh, bcs, scale=0.37, dtype=jnp.float32)
    lvl = mg.levels[0]
    rng = np.random.default_rng(SEED)
    xh = rng.standard_normal(mesh.cell_shape).astype(np.float32)
    bh = rng.standard_normal(mesh.cell_shape).astype(np.float32)
    x, b = jnp.asarray(xh), jnp.asarray(bh)
    rows = _rows(mesh.N[0])
    ap, res, jac = poisson_np(lvl, xh, bh, rows, mg.omega)

    def smooth(x, a):
        old = lvl.inv_diag
        lvl.inv_diag = a["inv_diag"]
        try:
            return mg._smooth(lvl, x, a["b"], 1)
        finally:
            lvl.inv_diag = old

    ops = {
        "apply": (lambda x, a: mg.apply_op(x), {}, 2, ap),
        "residual": (lambda x, a: mg._residual(lvl, x, a["b"]),
                     {"b": b}, 3, res),
        "jacobi": (smooth, {"b": b, "inv_diag": lvl.inv_diag}, 4, jac),
    }
    print(f"  Poisson {label}:")
    for name, (fn, args, _, ref) in ops.items():
        y = jax.jit(fn)(x, args)
        check(f"{name} max err / max|ref|",
              max_rel(np.asarray(y)[rows], ref), LAYER_RTOL)
    nbytes = x.size * 4
    t_copy = slope_seconds(lambda y, a: y * 1.0000001, x, {})
    copy_gbps = 2 * nbytes / t_copy / 1e9
    print(f"  [{card}] copy: {t_copy * 1e3:.3f} ms, {copy_gbps:.1f} GB/s")
    for name, (fn, args, streams, _) in ops.items():
        _time_line(card, name, slope_seconds(fn, x, args), streams,
                   nbytes, copy_gbps)


def _momentum_layer(ctx):
    import jax
    import jax.numpy as jnp

    import bench
    from fluca_tpu.models.channel import setup_channel_3d

    card = ctx["card"]
    ns = setup_channel_3d(N=bench.CHANNEL512_N, dt=bench.CHANNEL512_DT,
                          stretch_y=2.0, dtype=jnp.float32)
    ops = ns.impl.ops
    mesh = ops.mesh
    rng = np.random.default_rng(SEED)

    def rand(shape):
        return rng.standard_normal(shape).astype(np.float32)

    vh = [rand(mesh.cell_shape) for _ in range(3)]
    U0h = [rand(mesh.face_shape(d)) for d in range(3)]
    v0fh = [[rand(mesh.face_shape(d)) for _ in range(3)]
            for d in range(3)]
    v = tuple(jnp.asarray(a) for a in vh)
    U0 = tuple(jnp.asarray(a) for a in U0h)
    v0f = tuple(tuple(jnp.asarray(a) for a in r) for r in v0fh)
    del ns
    rows = _rows(mesh.N[0])
    ref = momentum_np(mesh, ops.axbcs, ops.rho, ops.mu, ops.dt, vh,
                      U0h, v0fh, rows)
    del vh, U0h, v0fh

    nbytes = v[0].size * 4
    t_copy = slope_seconds(lambda y, a: y * 1.0000001, v[0], {})
    copy_gbps = 2 * nbytes / t_copy / 1e9
    print(f"  momentum A-apply {mesh.N} (channel mesh):")
    print(f"  [{card}] copy: {t_copy * 1e3:.3f} ms, {copy_gbps:.1f} GB/s")
    coeffs = jax.jit(ops.build_momentum_coeffs)(U0, v0f)
    fn = ops.apply_A_coeffs
    y = jax.jit(fn)(v, coeffs)
    err = max(max_rel(np.asarray(y[c])[rows], ref[c]) for c in range(3))
    check("A-apply max err / max|ref|", err, LAYER_RTOL)
    # 18 streams: what the apply needs at least (3 v + 12 face
    # factors + 3 out); the XLA path reads dense coefficient planes
    _time_line(card, "A-apply", slope_seconds(fn, v, coeffs), 18,
               nbytes, copy_gbps)


def phase_layers(ctx):
    import bench  # noqa: F401  (compile cache, repo on the path)
    from fluca_tpu.mesh.cart import CartMesh
    from fluca_tpu.models.channel import setup_channel_3d
    from fluca_tpu.ns.bc import zero_velocity_bc

    ch = setup_channel_3d(N=bench.CHANNEL512_N, stretch_y=2.0,
                          dt=bench.CHANNEL512_DT)
    _poisson_layer(ctx, ch.mesh, ch.bcs,
                   f"{ch.mesh.N} (channel: periodic x/z, stretched y)")
    del ch
    n = LAYER_2D_N
    mesh = CartMesh.create((n, n))
    mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
    _poisson_layer(ctx, mesh, [zero_velocity_bc()] * 4,
                   f"{n}x{n} (walls)")
    _momentum_layer(ctx)


def bytes_in_use(devices):
    return [d.memory_stats()["bytes_in_use"] for d in devices]


def phase_four(ctx):
    import gc

    import jax
    import jax.numpy as jnp

    import bench
    from fluca_tpu.parallel.mesh import make_device_grid

    devices = jax.devices()
    assert len(devices) >= 4, f"--four needs 4 GPUs, found {devices}"
    card = ctx["card"]
    steps = 5

    def run(sharded):
        ns = bench.setup_channel512(FOUR_ATTEMPT)
        if sharded:
            ns.shard(make_device_grid(3, devices[:4]))
        t0 = time.perf_counter()
        ns.step()
        ns.advance(steps - 1)
        jax.block_until_ready(ns.state)
        wall = time.perf_counter() - t0
        return ns, wall

    par, wall4 = run(True)
    grid = par.device_grid
    print(f"  [{card}] solver {FOUR_ATTEMPT[0]}, grid "
          f"{dict(zip(grid.axis_names, grid.mesh.devices.shape))}, "
          f"{steps} steps: {wall4:.1f} s wall incl. compile")
    p = par.state["p"]
    assert len(p.sharding.device_set) == 4, p.sharding
    shard_shapes = {s.device.id: s.data.shape
                    for s in p.addressable_shards}
    print(f"  p shards: {shard_shapes}")
    assert all(np.prod(s) < p.size for s in shard_shapes.values())
    state_bytes = sum(x.size * x.dtype.itemsize
                      for x in jax.tree_util.tree_leaves(par.state))
    in_use = bytes_in_use(devices[:4])
    print(f"  [{card}] bytes in use per GPU: {in_use} "
          f"(state {state_bytes})")
    assert min(in_use) >= state_bytes / 4 / 2, "a GPU holds no share"
    got = jax.tree_util.tree_map(np.asarray, par.state)
    del par
    gc.collect()

    with jax.default_device(devices[0]):
        one, wall1 = run(False)
    print(f"  [{card}] one GPU, {steps} steps: {wall1:.1f} s wall "
          f"incl. compile")
    ref = jax.tree_util.tree_map(np.asarray, one.state)
    check("velocity rel L2, 4 GPUs vs 1", rel_l2(got["v"], ref["v"]),
          FOUR_RTOL)
    check("pressure rel L2, 4 GPUs vs 1", rel_l2(got["p"], ref["p"]),
          FOUR_P_RTOL)


# ----------------------------------------------------------------------

def select_phases(argv):
    """The phases an argument list asks for, in run order."""
    if "--four" in argv:
        return ["device", "four"]
    return list(PHASES)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    phases = select_phases(argv)
    if "jax" not in sys.modules:
        # keep the CPU backend beside the GPU for the f64 reference
        plats = os.environ.get("JAX_PLATFORMS")
        if plats and "cpu" not in plats.split(","):
            os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    try:
        backend = jax.default_backend()
    except RuntimeError as e:
        print(f"chip_smoke: JAX found no backend: {e}", file=sys.stderr)
        return 2
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU, JAX runs on {backend!r}",
              file=sys.stderr)
        return 2
    from fluca_tpu.utils import config

    config.use_compile_cache()
    fns = {name: globals()[f"phase_{name}"] for name in phases}
    ctx = {"card": "unknown card"}
    failed = []
    for name, fn in fns.items():
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAILED", flush=True)
            continue
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(f"card: {ctx['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
