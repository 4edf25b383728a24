"""fluca_tpu — an incompressible-flow CFD framework in JAX.

A from-scratch re-design of the capabilities of thecasterian/fluca
(PETSc/MPI/C) for accelerators, using JAX/XLA; it runs on NVIDIA GPUs
and, for tests, on the CPU:

- ``fluca_tpu.mesh``    — distributed Cartesian staggered grids
  (reference: fluca/src/mesh/impl/cart/cart.c).
- ``fluca_tpu.ops``     — composable finite-difference stencil algebra
  (reference: fluca/src/fd/*), matrix-free, static-shape.
- ``fluca_tpu.ns``      — the incompressible Navier-Stokes solver with
  linearized Crank-Nicolson time stepping and the approximate block
  factorization (ABF) preconditioner (reference: fluca/src/ns/*).
- ``fluca_tpu.solvers`` — Krylov methods (CG/BiCGStab/FGMRES) and
  geometric multigrid, written in pure JAX over pytrees.
- ``fluca_tpu.parallel``— device-mesh sharding and halo exchange
  (the JAX equivalent of DMStag domain decomposition over MPI).
- ``fluca_tpu.io``      — checkpoint/restart and CGNS-compatible output
  (reference: fluca/src/viewer/impl/flucacgns/flucacgns.c).

Unlike the reference, operators are never assembled into sparse
matrices: every operator is a matrix-free closure over precomputed
per-axis stencil coefficient tables, applied as fused shifted-slice
arithmetic that XLA fuses into bandwidth-bound GPU kernels.
"""

__version__ = "0.1.0"

from fluca_tpu.utils.options import Options, set_global_options, global_options
from fluca_tpu.utils import config
from fluca_tpu.mesh.cart import CartMesh, BoundaryLoc

_initialized = False


def initialize(argv=None):
    """Initialize the library (reference: FlucaInitialize,
    fluca/src/sys/flucainit.c:7-26). Parses CLI options into the
    global options database and registers built-in types. An explicit
    ``argv`` always refreshes the options database (so successive
    in-process runs, e.g. tests, see their own flags)."""
    global _initialized
    if argv is not None:
        set_global_options(Options.from_argv(argv))
    _initialized = True


def finalize():
    """Reference: FlucaFinalize (fluca/src/sys/flucainit.c:44-71)."""
    global _initialized
    _initialized = False
