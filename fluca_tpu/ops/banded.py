"""Matrix-free banded stencil application along one grid axis.

This is the JAX replacement for the reference's assembled DMStag
matrices and matrix-free FlucaFDApply sweep (fluca/src/fd/interface/
fdapply.c:47-121). An operator along axis ``d`` is a small dict
``{offset: coeffs}`` where ``coeffs`` is a 1-D array over the output
index; application is

    y[..., i, ...] = sum_off coeffs[off][i] * x[..., i + off, ...]

implemented with static slices + zero padding (or rolls for periodic
axes), which XLA fuses into a single bandwidth-bound elementwise kernel
— the idiomatic XLA form of a stencil sweep. Boundary-modified rows are
baked into the coefficient tables at setup time so shapes stay static
(no data-dependent control flow under jit).

Input and output may live on different staggered locations (cell
centers vs faces), so input length ``n_in`` and output length
``n_out`` may differ by one; out-of-range reads contribute zero (their
coefficients are zero by construction).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
from jax import lax


def _broadcast_1d(w, ndim: int, axis: int):
    """Reshape 1-D coefficient array for broadcasting along ``axis``."""
    shape = [1] * ndim
    shape[axis] = -1
    return jnp.reshape(w, shape)


def shifted(x, axis: int, off: int, n_out: int, periodic: bool):
    """Return y with y[i] = x[i + off] along ``axis`` for i in
    [0, n_out); entries reading outside x are zero (non-periodic) or
    wrap (periodic, which requires n_out == x.shape[axis])."""
    n_in = x.shape[axis]
    if periodic:
        assert n_out == n_in
        return jnp.roll(x, -off, axis) if off else x
    if off == 0 and n_out == n_in:
        return x
    start = max(0, -off)
    stop = min(n_out, n_in - off)
    if stop <= start:
        return jnp.zeros(x.shape[:axis] + (n_out,) + x.shape[axis + 1 :], x.dtype)
    xs = lax.slice_in_dim(x, start + off, stop + off, axis=axis)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (start, n_out - stop)
    return jnp.pad(xs, pad)


@dataclass(frozen=True)
class AxisStencil:
    """Banded operator along one axis: {offset: 1-D coeff array}.

    Constructed on host in float64 numpy, converted to device arrays of
    the compute dtype lazily. ``n_out`` is the output extent along
    ``axis``; ``periodic`` selects wrap-around reads.
    """

    axis: int
    n_out: int
    periodic: bool
    bands: tuple[tuple[int, np.ndarray], ...]  # sorted by offset

    @classmethod
    def from_dict(cls, axis, n_out, periodic, band_dict) -> "AxisStencil":
        bands = []
        for off in sorted(band_dict):
            w = np.asarray(band_dict[off], dtype=np.float64)
            assert w.shape == (n_out,), (off, w.shape, n_out)
            if np.any(w != 0.0):
                bands.append((off, w))
        return cls(axis, n_out, periodic, tuple(bands))

    def as_dict(self) -> dict[int, np.ndarray]:
        return {off: w for off, w in self.bands}

    def device_bands(self, ndim: int, dtype):
        return tuple(
            (off, _broadcast_1d(jnp.asarray(w, dtype), ndim, self.axis))
            for off, w in self.bands
        )

    def apply(self, x, dtype=None):
        """Apply to a device array (convenience path; NS hot paths use
        precomputed device bands via ``apply_axis_stencil``)."""
        dt = dtype or x.dtype
        return apply_axis_stencil(
            self.device_bands(x.ndim, dt), x, self.axis, self.n_out,
            self.periodic,
        )

    def to_dense(self, n_in: int) -> np.ndarray:
        """Dense matrix form, for tests on tiny grids."""
        A = np.zeros((self.n_out, n_in))
        for off, w in self.bands:
            for i in range(self.n_out):
                j = i + off
                if self.periodic:
                    j %= n_in
                elif not (0 <= j < n_in):
                    continue
                A[i, j] += w[i]
        return A


def compose_axis_stencils(outer: AxisStencil, inner: AxisStencil) -> AxisStencil:
    """Band product C = outer @ inner along one axis (host-side).

    ``inner`` maps length n_in -> n_mid, ``outer`` maps n_mid ->
    n_out. Used to fuse operator chains (e.g. the pressure-Poisson
    D∘Gst) into a single banded stencil so the apply is one fused
    sweep instead of materializing intermediate face arrays.
    """
    assert outer.axis == inner.axis
    assert outer.periodic == inner.periodic
    n_out = outer.n_out
    n_mid = inner.n_out
    out_bands: dict[int, np.ndarray] = {}
    for a_off, a_w in outer.bands:
        for b_off, b_w in inner.bands:
            off = a_off + b_off
            acc = out_bands.setdefault(off, np.zeros(n_out))
            for i in range(n_out):
                j = i + a_off  # intermediate (inner-output) index
                if outer.periodic:
                    j %= n_mid
                elif not (0 <= j < n_mid):
                    continue
                acc[i] += a_w[i] * b_w[j]
    return AxisStencil.from_dict(
        outer.axis, n_out, outer.periodic, out_bands
    )


def apply_axis_stencil(device_bands, x, axis, n_out, periodic):
    """y = sum_off w_off * shifted(x, off). ``device_bands`` comes from
    AxisStencil.device_bands."""
    y = None
    for off, w in device_bands:
        term = w * shifted(x, axis, off, n_out, periodic)
        y = term if y is None else y + term
    if y is None:
        shape = list(x.shape)
        shape[axis] = n_out
        y = jnp.zeros(shape, x.dtype)
    return y
