"""Weak-scaling harness: sharded NS steps over growing device grids.

On a host with several GPUs this measures the >=85% weak-scaling
target (BASELINE.md): per-device problem size fixed, device count
grown, the step sharded via NS.shard (GSPMD emits halo
collective-permutes, which XLA hands to NCCL). ``--virtual N`` runs
the same code path on N virtual CPU devices — that validates the
sharded program structure and communication pattern, NOT link
bandwidth (virtual devices share one host's memory bus, so
"efficiency" there reflects host contention).

Usage:
  python bench_scaling.py [--base 128] [--steps 10] [--virtual 8]
                          [--out FILE.json]
Prints one JSON line per device count and optionally writes the
series to FILE.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    argv = sys.argv[1:]

    def arg(name, default, cast=int):
        return (
            cast(argv[argv.index(name) + 1]) if name in argv else default
        )

    virtual = arg("--virtual", 0)
    if virtual:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(virtual))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fluca_tpu.utils import config

    config.use_compile_cache()
    from fluca_tpu.mesh.cart import CartMesh
    from fluca_tpu.ns.bc import BCType, BoundaryCondition, \
        zero_velocity_bc
    from fluca_tpu.ns.cnlinear import CNLinearConfig
    from fluca_tpu.ns.ns import NS
    from fluca_tpu.parallel.mesh import make_device_grid

    base = arg("--base", 128)
    steps = arg("--steps", 10)
    out_path = arg("--out", None, str)

    devices = jax.devices()
    counts = []
    n = 1
    while n <= len(devices):
        counts.append(n)
        n *= 2

    results = []
    for n in counts:
        grid = make_device_grid(2, devices[:n])
        shape = tuple(grid.mesh.devices.shape)
        # weak scaling: grow the grid with the device mesh
        N = (base * shape[0], base * shape[1])
        mesh = CartMesh.create(N)
        mesh.set_uniform_coordinates(0.0, 1.0, 0.0, 1.0)
        wall = zero_velocity_bc()
        lid = BoundaryCondition(
            BCType.VELOCITY,
            velocity=lambda t, xs: (1.0 + 0.0 * xs[0], 0.0 * xs[0]),
        )
        ns = NS(mesh, rho=1.0, mu=0.01, dt=0.01, max_steps=10**9,
                bcs=[wall, wall, wall, lid], dtype=jnp.float32)
        ns.setup()
        ns.impl.cfg = CNLinearConfig.production()
        ns.shard(grid)  # first-class sharded solver path
        ns.step()
        ns.advance(steps)  # compile the scan program
        np.asarray(ns.state["v"][0])
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            ns.advance(steps)
            np.asarray(ns.state["v"][0])
            best = min(best, time.time() - t0)
        sps = steps / best
        eff = sps / results[0]["value"] if results else 1.0
        rec = {
            "metric": "weak_scaling_steps_per_sec",
            "devices": n,
            "grid": list(N),
            "value": round(sps, 3),
            "efficiency_vs_1dev": round(eff, 4),
            "platform": jax.devices()[0].platform,
            "virtual": bool(virtual),
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
