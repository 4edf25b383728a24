"""Explicit halo exchange with shard_map + collective permutes.

The GSPMD path (parallel/mesh.py) lets XLA infer halo communication
from shifted-slice ops. This module is the explicit alternative — the
direct JAX analogue of the reference's DMGlobalToLocal ghost scatters
(fluca/src/mesh/impl/cart/cart.c:88-104, SURVEY.md §5): per-axis
``lax.ppermute`` neighbor exchanges of boundary slabs into ghost
layers, inside ``shard_map``. Used where communication scheduling must
be controlled (overlapping halo transfers with interior compute in
custom kernels) rather than left to GSPMD.

Conventions: fields are sharded block-wise along grid axes; ghost
layers of width w are appended on both sides of each sharded axis.
Non-periodic global boundaries receive zeros (boundary-folded stencil
coefficients are zero there by construction, matching ops/banded).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from fluca_tpu.parallel.mesh import DeviceGrid


def _axis_exchange(x, axis: int, axis_name: str, width: int,
                   periodic: bool):
    """Append ghost layers along ``axis`` filled from the neighbor
    shards over mesh axis ``axis_name``."""
    n_shards = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    lo_slab = lax.slice_in_dim(x, 0, width, axis=axis)
    hi_slab = lax.slice_in_dim(
        x, x.shape[axis] - width, x.shape[axis], axis=axis
    )

    # send my high slab to the right neighbor (their left ghost) and
    # my low slab to the left neighbor (their right ghost)
    right = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    left = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    from_left = lax.ppermute(hi_slab, axis_name, right)
    from_right = lax.ppermute(lo_slab, axis_name, left)

    if not periodic:
        zeros = jnp.zeros_like(lo_slab)
        from_left = jnp.where(idx == 0, zeros, from_left)
        from_right = jnp.where(idx == n_shards - 1, zeros, from_right)

    return jnp.concatenate([from_left, x, from_right], axis=axis)


def halo_exchange(grid: DeviceGrid, x, periodic, width: int = 1):
    """shard_map'd ghost-layer fill: returns per-shard arrays extended
    by ``width`` ghost cells on every sharded grid axis. ``periodic``
    is a per-axis tuple. Must be called under ``grid.mesh``."""

    spec = grid.cell_spec()

    def body(xs):
        for d in range(grid.dim):
            xs = _axis_exchange(
                xs, d, grid.axis_names[d], width, periodic[d]
            )
        return xs

    return jax.shard_map(
        body, mesh=grid.mesh, in_specs=spec, out_specs=spec
    )(x)


def stencil_apply_sharded(grid: DeviceGrid, bands_per_axis, x,
                          periodic):
    """Banded stencil apply with explicit halo exchange: each shard
    exchanges one ghost layer per axis, then applies the (tridiagonal)
    per-axis bands locally — the hand-scheduled equivalent of the
    GSPMD path, with communication and compute visible for overlap.

    ``bands_per_axis[d]`` is {offset in (-1,0,1): 1-D global
    coefficient array of length N_d}.
    """
    spec = grid.cell_spec()
    mesh = grid.mesh
    dim = grid.dim

    # shard the coefficient vectors along their axis
    import numpy as np

    band_arrays = []
    for d in range(dim):
        for off, w in sorted(bands_per_axis[d].items()):
            band_arrays.append((d, off, jnp.asarray(w, x.dtype)))

    def body(xs, *ws):
        out = None
        wi = 0
        for d in range(dim):
            xg = _axis_exchange(
                xs, d, grid.axis_names[d], 1, periodic[d]
            )
            n = xs.shape[d]
            for off in sorted(bands_per_axis[d]):
                w = ws[wi]
                wi += 1
                shp = [1] * dim
                shp[d] = -1
                seg = lax.slice_in_dim(xg, 1 + off, 1 + off + n, axis=d)
                t = w.reshape(shp) * seg
                out = t if out is None else out + t
        return out

    in_specs = [spec] + [
        P(grid.axis_names[d]) for d, _, _ in band_arrays
    ]
    return jax.shard_map(
        body, mesh=mesh, in_specs=tuple(in_specs), out_specs=spec
    )(x, *[w for _, _, w in band_arrays])


def stencil_apply_sharded_overlapped(grid: DeviceGrid, bands_per_axis,
                                     x, periodic):
    """Communication-overlapped banded stencil apply.

    Same result as :func:`stencil_apply_sharded`, scheduled for
    overlap: ALL ppermute halo sends are issued up front, the interior
    apply (pure local data, zero-filled at shard edges) runs with no
    dependency on them, and the received boundary slabs fold in last
    as one-line corrections. XLA's latency-hiding scheduler can then
    run the halo transfers concurrently with the interior compute — the
    double-buffered DMGlobalToLocal overlap of SURVEY §7 (build-plan
    item 7), expressed as dataflow instead of explicit buffers.

    Requires tridiagonal bands (offsets in {-1, 0, 1}), which is what
    every composed operator in the NS solver produces.
    """
    spec = grid.cell_spec()
    mesh = grid.mesh
    dim = grid.dim

    for d in range(dim):
        assert set(bands_per_axis[d]) <= {-1, 0, 1}, (
            "overlapped apply supports width-1 stencils only"
        )

    band_arrays = []
    for d in range(dim):
        for off, w in sorted(bands_per_axis[d].items()):
            band_arrays.append((d, off, jnp.asarray(w, x.dtype)))

    def _shift_local(xs, d, off):
        """shift by -off with zero fill (local block only)."""
        n = xs.shape[d]
        if off == 0:
            return xs
        pad = [(0, 0)] * xs.ndim
        if off < 0:
            seg = lax.slice_in_dim(xs, 0, n + off, axis=d)
            pad[d] = (-off, 0)
        else:
            seg = lax.slice_in_dim(xs, off, n, axis=d)
            pad[d] = (0, off)
        return jnp.pad(seg, pad)

    def body(xs, *ws):
        # 1. issue every halo send first (no compute dependency)
        received = []  # (d, from_left, from_right)
        for d in range(dim):
            axis_name = grid.axis_names[d]
            n_shards = lax.axis_size(axis_name)
            idx = lax.axis_index(axis_name)
            n = xs.shape[d]
            lo_slab = lax.slice_in_dim(xs, 0, 1, axis=d)
            hi_slab = lax.slice_in_dim(xs, n - 1, n, axis=d)
            right = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            left = [(i, (i - 1) % n_shards) for i in range(n_shards)]
            from_left = lax.ppermute(hi_slab, axis_name, right)
            from_right = lax.ppermute(lo_slab, axis_name, left)
            if not periodic[d]:
                zeros = jnp.zeros_like(lo_slab)
                from_left = jnp.where(idx == 0, zeros, from_left)
                from_right = jnp.where(
                    idx == n_shards - 1, zeros, from_right
                )
            received.append((from_left, from_right))

        # 2. interior apply on local data only
        wi = 0
        out = None
        corr_w = [[None, None] for _ in range(dim)]
        for d in range(dim):
            n = xs.shape[d]
            for off in sorted(bands_per_axis[d]):
                w = ws[wi]
                wi += 1
                shp = [1] * dim
                shp[d] = -1
                t = w.reshape(shp) * _shift_local(xs, d, off)
                out = t if out is None else out + t
                # remember the edge coefficients for step 3
                if off == -1:
                    corr_w[d][0] = w[0]
                elif off == 1:
                    corr_w[d][1] = w[n - 1]

        # 3. fold in the received ghost slabs at the edge lines
        for d in range(dim):
            n = xs.shape[d]
            from_left, from_right = received[d]
            pad_lo = [(0, 0)] * xs.ndim
            pad_lo[d] = (0, n - 1)
            pad_hi = [(0, 0)] * xs.ndim
            pad_hi[d] = (n - 1, 0)
            if corr_w[d][0] is not None:
                out = out + jnp.pad(corr_w[d][0] * from_left, pad_lo)
            if corr_w[d][1] is not None:
                out = out + jnp.pad(corr_w[d][1] * from_right, pad_hi)
        return out

    in_specs = [spec] + [
        P(grid.axis_names[d]) for d, _, _ in band_arrays
    ]
    return jax.shard_map(
        body, mesh=mesh, in_specs=tuple(in_specs), out_specs=spec
    )(x, *[w for _, _, w in band_arrays])
