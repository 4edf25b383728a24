"""Lagrangian marker sets + interpolation/spreading operators.

Gather/scatter form (the BASELINE.json "IBM delta-function
interpolation/spreading as gather/scatter kernels over Lagrangian
markers"): each marker owns a static (support x support [x support])
window of cells; interpolation is a gather-weighted sum, spreading a
scatter-add — both fully vectorized over markers, static shapes. On
a GPU XLA lowers the scatter-add to atomics, so the summation order
(and the last bits of a spread field) can differ from run to run.

Requires locally uniform grid spacing around the body (standard IBM
restriction; the delta kernels assume it).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from fluca_tpu.ibm.delta import KERNELS
from fluca_tpu.mesh.cart import CartMesh


@dataclass
class MarkerSet:
    mesh: CartMesh
    X: jnp.ndarray  # (Nm, dim) marker positions
    ds: jnp.ndarray  # (Nm,) arc length / area weight per marker
    kernel: str = "roma3"

    def __post_init__(self):
        mesh = self.mesh
        dim = mesh.dim
        self.h = np.array([float(mesh.widths(d)[0]) for d in range(dim)])
        for d in range(dim):
            w = mesh.widths(d)
            assert np.allclose(w, w[0]), (
                "IBM requires uniform grid spacing (per axis)"
            )
        self.x0 = np.array([float(mesh.centers(d)[0]) for d in range(dim)])
        self.fn, self.support = KERNELS[self.kernel]
        # static support offsets
        offs = np.arange(self.support) - (self.support - 1) // 2
        self.offsets = offs

    # -- index/weight computation (per call; positions may move) -------
    def _windows(self, X):
        """Cell indices (Nm, support, dim) and weights
        (Nm, support, dim) per axis."""
        mesh = self.mesh
        dim = mesh.dim
        h = jnp.asarray(self.h, X.dtype)
        x0 = jnp.asarray(self.x0, X.dtype)
        # nearest cell index per axis
        base = jnp.round((X - x0) / h).astype(jnp.int32)  # (Nm, dim)
        offs = jnp.asarray(self.offsets, jnp.int32)  # (support,)
        idx = base[:, None, :] + offs[None, :, None]  # (Nm, S, dim)
        xc = x0 + idx.astype(X.dtype) * h  # cell-center coords
        r = (X[:, None, :] - xc) / h
        w = self.fn(r)  # (Nm, S, dim)
        # clamp/wrap indices
        for d in range(dim):
            n = mesh.N[d]
            if mesh.periodic[d]:
                idx = idx.at[:, :, d].set(idx[:, :, d] % n)
            else:
                idx = idx.at[:, :, d].set(
                    jnp.clip(idx[:, :, d], 0, n - 1)
                )
        return idx, w

    def interpolate(self, field, X=None):
        """E: cell field -> marker values (gather)."""
        X = self.X if X is None else X
        idx, w = self._windows(X)
        dim = self.mesh.dim
        if dim == 2:
            gi = idx[:, :, 0][:, :, None]
            gj = idx[:, :, 1][:, None, :]
            vals = field[gi, gj]  # (Nm, S, S)
            ww = w[:, :, 0][:, :, None] * w[:, :, 1][:, None, :]
            return jnp.sum(vals * ww, axis=(1, 2))
        else:
            gi = idx[:, :, 0][:, :, None, None]
            gj = idx[:, :, 1][:, None, :, None]
            gk = idx[:, :, 2][:, None, None, :]
            vals = field[gi, gj, gk]
            ww = (
                w[:, :, 0][:, :, None, None]
                * w[:, :, 1][:, None, :, None]
                * w[:, :, 2][:, None, None, :]
            )
            return jnp.sum(vals * ww, axis=(1, 2, 3))

    def spread(self, F, X=None):
        """S: marker values (Nm,) -> cell field (scatter-add), scaled
        by ds / cell volume so that S and E are adjoint up to the
        marker quadrature weights."""
        X = self.X if X is None else X
        idx, w = self._windows(X)
        mesh = self.mesh
        dim = mesh.dim
        cellvol = float(np.prod(self.h))
        scale = (self.ds / cellvol) * F  # (Nm,)
        out = jnp.zeros(mesh.cell_shape, F.dtype)
        if dim == 2:
            ww = w[:, :, 0][:, :, None] * w[:, :, 1][:, None, :]
            vals = scale[:, None, None] * ww
            gi = jnp.broadcast_to(idx[:, :, 0][:, :, None], vals.shape)
            gj = jnp.broadcast_to(idx[:, :, 1][:, None, :], vals.shape)
            out = out.at[gi.ravel(), gj.ravel()].add(vals.ravel())
        else:
            ww = (
                w[:, :, 0][:, :, None, None]
                * w[:, :, 1][:, None, :, None]
                * w[:, :, 2][:, None, None, :]
            )
            vals = scale[:, None, None, None] * ww
            gi = jnp.broadcast_to(
                idx[:, :, 0][:, :, None, None], vals.shape
            )
            gj = jnp.broadcast_to(
                idx[:, :, 1][:, None, :, None], vals.shape
            )
            gk = jnp.broadcast_to(
                idx[:, :, 2][:, None, None, :], vals.shape
            )
            out = out.at[gi.ravel(), gj.ravel(), gk.ravel()].add(
                vals.ravel()
            )
        return out


def sphere_markers(
    mesh: CartMesh, center, radius, n_markers=None, kernel="roma3",
    dtype=None, retract=0.0,
) -> MarkerSet:
    """Quasi-uniform markers on a sphere via the Fibonacci lattice,
    spaced ~ grid h, each owning surface area ~ (4 pi r^2 / Nm) * h
    (volumetric thickness ~h, as for circle_markers).

    ``retract`` (in cell widths): place markers at radius - retract*h.
    The regularized delta smears the no-slip surface outward by
    ~0.5h, so the effective hydrodynamic radius exceeds the marker
    radius and drag is over-predicted at moderate cells/diameter;
    inward retraction by 0.3-0.5h cancels the widening (Breugem,
    J. Comput. Phys. 231 (2012) 4469-4498, Sec. 3). Marker count and
    quadrature weights stay tied to the NOMINAL radius (the physics
    surface)."""
    h = float(mesh.widths(0)[0])
    if n_markers is None:
        n_markers = max(int(np.ceil(4 * np.pi * radius**2 / h**2)), 16)
    if not 0.0 <= retract * h < radius:
        raise ValueError(
            f"retract={retract} with h={h} yields marker radius "
            f"{radius - retract * h} (nominal {radius}); require "
            f"0 <= retract*h < radius"
        )
    r_mark = radius - retract * h
    i = np.arange(n_markers) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n_markers)
    golden = np.pi * (1.0 + 5.0**0.5)
    theta = golden * i
    X = np.stack(
        [
            center[0] + r_mark * np.sin(phi) * np.cos(theta),
            center[1] + r_mark * np.sin(phi) * np.sin(theta),
            center[2] + r_mark * np.cos(phi),
        ],
        axis=1,
    )
    ds = np.full(n_markers, 4 * np.pi * radius**2 / n_markers * h)
    from fluca_tpu.utils import config

    import jax.numpy as jnp

    dt = dtype or config.default_dtype()
    return MarkerSet(
        mesh, jnp.asarray(X, dt), jnp.asarray(ds, dt), kernel
    )


def circle_markers(
    mesh: CartMesh, center, radius, n_markers=None, kernel="roma3",
    dtype=None, retract=0.0,
) -> MarkerSet:
    """Markers on a circle with spacing ~ grid h (the standard ds ~= h
    rule).  ``retract``: see sphere_markers (Breugem 2012 effective-
    radius correction, in cell widths)."""
    import jax.numpy as jnp

    h = float(mesh.widths(0)[0])
    if n_markers is None:
        n_markers = max(int(np.ceil(2 * np.pi * radius / h)), 8)
    th = np.linspace(0.0, 2 * np.pi, n_markers, endpoint=False)
    if not 0.0 <= retract * h < radius:
        raise ValueError(
            f"retract={retract} with h={h} yields marker radius "
            f"{radius - retract * h} (nominal {radius}); require "
            f"0 <= retract*h < radius"
        )
    r_mark = radius - retract * h
    X = np.stack(
        [center[0] + r_mark * np.cos(th), center[1] + r_mark * np.sin(th)],
        axis=1,
    )
    ds = np.full(n_markers, 2 * np.pi * radius / n_markers * h)
    # ds here includes the surface-normal thickness ~h so the spread
    # force has units of a volumetric body force
    from fluca_tpu.utils import config

    dt = dtype or config.default_dtype()
    return MarkerSet(
        mesh, jnp.asarray(X, dt), jnp.asarray(ds, dt), kernel
    )
