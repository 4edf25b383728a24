"""Device-mesh domain decomposition.

The JAX replacement for the reference's only parallelism
strategy: block-structured decomposition of the Cartesian grid over an
MPI rank grid with DMStag halo exchange (reference:
fluca/src/mesh/impl/cart/cart.c:88-104 ownership/halo setup; SURVEY.md
component #23). Here the grid axes are sharded over a logical device
mesh with ``jax.sharding.NamedSharding``; XLA/GSPMD inserts the halo
collectives (collective-permute between devices) for every shifted-slice
stencil access, and ``psum``-style allreduces for the Krylov dot
products — the structural equivalents of ``DMGlobalToLocal`` and
``VecDot``'s MPI_Allreduce.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_NAMES = ("gx", "gy", "gz")


@dataclass
class DeviceGrid:
    """A logical device mesh aligned with grid axes."""

    mesh: Mesh
    dim: int

    @property
    def axis_names(self):
        return AXIS_NAMES[: self.dim]

    def cell_spec(self) -> P:
        return P(*self.axis_names)

    def cell_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.cell_spec())


def _factor(n: int, dim: int) -> tuple[int, ...]:
    """Split n devices into a near-square dim-d grid."""
    shape = [1] * dim
    remaining = n
    # greedy: repeatedly divide by smallest prime factor, assign to the
    # axis with the smallest current extent
    def smallest_prime(m):
        for p in (2, 3, 5, 7, 11, 13):
            if m % p == 0:
                return p
        return m

    while remaining > 1:
        p = smallest_prime(remaining)
        i = int(np.argmin(shape))
        shape[i] *= p
        remaining //= p
    return tuple(shape)


def make_device_grid(
    dim: int, devices=None, shape: tuple[int, ...] | None = None
) -> DeviceGrid:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = _factor(n, dim)
    want = int(np.prod(shape))
    assert want <= n, f"grid {shape} needs {want} devices, have {n}"
    # a grid smaller than the host's device count uses the leading
    # devices (e.g. -parallel_grid 1x1 on an 8-device host runs
    # single-device; reference analogue: -cart_ranks_* with np=1)
    dev_array = np.array(devices[:want]).reshape(shape)
    mesh = Mesh(dev_array, AXIS_NAMES[:dim])
    return DeviceGrid(mesh=mesh, dim=dim)


def _divisible_sharding(grid: DeviceGrid, x) -> NamedSharding:
    """Shard each array axis that is divisible by the device-grid
    extent; leave the rest unsharded at placement time. Face arrays
    (N+1 points, the reference's 'extra face on the last rank'
    convention, fluca/src/fd/interface/fdapply.c:3-20) are therefore
    placed replicated along their face axis and re-sharded by GSPMD
    inside jit, which supports uneven (padded) partitions."""
    names = []
    for a in range(x.ndim):
        if a < grid.dim:
            ext = grid.mesh.shape[grid.axis_names[a]]
            names.append(
                grid.axis_names[a] if x.shape[a] % ext == 0 else None
            )
        else:
            names.append(None)
    return NamedSharding(grid.mesh, P(*names))


def state_shardings(grid: DeviceGrid, state) -> dict:
    return jax.tree_util.tree_map(
        lambda x: _divisible_sharding(grid, x), state
    )


def shard_state(grid: DeviceGrid, state):
    """Place a state pytree onto the device grid."""
    return jax.device_put(state, state_shardings(grid, state))


def constrain_state(grid: DeviceGrid, state):
    """Inside jit: pin every field (including uneven face arrays) to
    the grid-axis sharding; GSPMD pads the last shard."""
    sh = grid.cell_sharding()

    def con(x):
        spec = [
            grid.axis_names[a] if a < grid.dim else None
            for a in range(x.ndim)
        ]
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(grid.mesh, P(*spec))
        )

    return jax.tree_util.tree_map(con, state)
