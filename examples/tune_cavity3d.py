"""Time the cavity3d step at 64x64x32 f32 under the outer
(fgmres / gcr) and inner (while-loop / unrolled fixed-trip) solver
forms, to isolate what each costs at the small size.

        python examples/tune_cavity3d.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from fluca_tpu.utils import config  # noqa: E402

config.use_compile_cache()


def main():
    import jax.numpy as jnp

    from bench import _advance_throughput
    from fluca_tpu.models.cavity import setup_cavity_3d
    from fluca_tpu.ns.cnlinear import CNLinearConfig

    out = {}

    def run(label, mutate):
        cfg = CNLinearConfig.production()
        mutate(cfg)
        ns = setup_cavity_3d(N=(64, 64, 32), Re=100.0, dt=0.01,
                             max_steps=10**9, dtype=jnp.float32)
        ns.impl.cfg = cfg
        sps = _advance_throughput(ns, 30)
        out[label] = round(sps, 2)
        print(f"{label:34s}: {sps:7.2f} steps/s", flush=True)

    run("gcr+fixed (r4 production)", lambda c: None)
    run("fgmres+fixed", lambda c: setattr(c, "outer_type", "fgmres"))

    def loops(c):
        # rtol > 1e-20 keeps the while_loop solver forms (still
        # effectively never converging early at 1e-19)
        c.mom_rtol = 1e-19
        c.schur_rtol = 1e-19

    run("gcr+while_loops", loops)

    def r3form(c):
        c.outer_type = "fgmres"
        loops(c)

    run("fgmres+while_loops (r3 form)", r3form)

    with open(os.path.join(ROOT, "TUNE_CAVITY3D.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
