"""Generate the committed CI sphere checkpoint
(tests/data/sphere_steady_t25): the coarse 48x32x32 analogue of the
128^3 run in examples/sphere_drag.py, run on CPU f64 (the test
environment's dtype) to steady state at Re=100.

The drag regression test (tests/test_sphere.py) restarts from this
checkpoint and asserts cd stays at the committed steady value —
the cylinder-Strouhal pattern (tests/test_shedding.py) applied to
the 3-D IBM path.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["FLUCA_TPU_DTYPE"] = "float64"  # the test env's dtype

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from fluca_tpu.io.checkpoint import save_checkpoint
from fluca_tpu.models.sphere import setup_sphere_3d
from fluca_tpu.ns.cnlinear import CNLinearConfig

D = 0.5

ns, ibm = setup_sphere_3d(
    N=(48, 32, 32), domain=(3.0, 2.0, 2.0), center=(1.0, 1.0, 1.0),
    diameter=D, Re=100.0, dt=0.02, max_steps=10**9,
)
ns.impl.cfg = CNLinearConfig.production(outer=3, mom=8, schur=8)
ns.step()
qA = 0.5 * np.pi * D**2 / 4.0
t0 = time.time()
while ns.t < 25.0:
    ns.advance(125)
    F = np.asarray(ibm.hydrodynamic_force(ns.state, ns.t, ns.rho))
    print(f"t={float(ns.t):6.2f} cd={float(F[0]/qA):.4f} "
          f"({time.time()-t0:.0f}s)", flush=True)
save_checkpoint(os.path.join(ROOT, "tests/data/sphere_steady_t25"), ns)
print("saved", flush=True)
