"""Geometric multigrid for the pressure-Poisson operator.

The scalability limiter of the whole scheme is the Schur-complement
solve S p' = rhs with S = -D Gst (the fractional-step limit, reference
THEORY_GUIDE.md:330-341; the reference delegates this to whatever
``-..abf_schur_ksp/pc`` PETSc options provide). Here: cell-centered
geometric multigrid with volume-weighted 2:1 coarsening, damped-Jacobi
smoothing, and an exact (host-precomputed pseudo-inverse) coarse solve,
used as a CG preconditioner.

Symmetry: on non-uniform grids D*Gst is symmetric only in the
cell-volume inner product, so we solve the volume-scaled system
  Shat p = vol .* (-D Gst p),  rhs_hat = vol .* rhs
which is symmetric positive semidefinite in the Euclidean inner
product (pure-Neumann pressure problems keep the constant nullspace;
handled by mean projection in CG and pinv on the coarse level).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from fluca_tpu.mesh.cart import CartMesh
from fluca_tpu.ns import tables as T_
from fluca_tpu.ops.banded import (
    _broadcast_1d,
    apply_axis_stencil,
    compose_axis_stencils,
)


@dataclass
class _Level:
    mesh: CartMesh
    dgst_bands: list  # per-axis composed D@Gst (cell->cell) bands
    vol: jnp.ndarray  # scale * cell volumes (operator row weights)
    vol_axes: tuple  # per-axis 1-D factors whose product is vol
    cellvol: jnp.ndarray  # plain cell volumes (rhs symmetrization)
    inv_diag: jnp.ndarray  # 1 / diag(Shat)
    cheb_lmax: object = None  # Chebyshev smoothing upper bound
    host_dgst: tuple = ()  # per-axis host-f64 AxisStencils (coarse solve)
    host_vol: object = None  # scale * cell volumes, host f64


def _build_level(mesh: CartMesh, axbcs, scale: float, dtype) -> _Level:
    dim = mesh.dim
    dgst_bands = []
    host_dgst = []
    diag = np.zeros(mesh.cell_shape)
    for d in range(dim):
        gst, _, _ = T_.gst_tables(mesh, d, axbcs[d])
        div = T_.div_tables(mesh, d)
        # fuse D@Gst into one tridiagonal-per-axis stencil so each
        # Poisson apply is a single 5/7-point fused sweep (no face
        # intermediates): the SpMV hot path
        dgst = compose_axis_stencils(div, gst)
        dgst_bands.append(dgst.device_bands(dim, dtype))
        host_dgst.append(dgst)
        w0 = dgst.as_dict().get(0, np.zeros(mesh.N[d]))
        shape = [1] * dim
        shape[d] = -1
        diag = diag + (-w0).reshape(shape)

    vol = mesh.cell_volumes()
    inv_diag = 1.0 / np.where(diag == 0.0, 1.0, scale * vol * diag)
    # the cell volumes are an outer product of the widths: applying
    # them as broadcast 1-D factors keeps the dense volume array out
    # of every operator apply (one memory stream fewer)
    vol_axes = tuple(
        _broadcast_1d(
            jnp.asarray(mesh.widths(d) * (scale if d == 0 else 1.0),
                        dtype),
            dim, d,
        )
        for d in range(dim)
    )
    return _Level(
        mesh=mesh,
        dgst_bands=dgst_bands,
        vol=jnp.asarray(scale * vol, dtype),
        vol_axes=vol_axes,
        cellvol=jnp.asarray(vol, dtype),
        inv_diag=jnp.asarray(inv_diag, dtype),
        host_dgst=tuple(host_dgst),
        host_vol=scale * vol,
    )


def _coarsen_mesh(mesh: CartMesh) -> CartMesh | None:
    if any(n % 2 != 0 or n < 4 for n in mesh.N):
        return None
    cm = CartMesh(
        N=tuple(n // 2 for n in mesh.N),
        periodic=mesh.periodic,
    )
    cm.set_coordinates(*[f[::2] for f in mesh.faces])
    return cm


class PoissonMG:
    """V-cycle preconditioner for Shat = vol .* (-D Gst) * scale."""

    def __init__(
        self,
        mesh: CartMesh,
        bcs,
        *,
        scale: float,
        dtype,
        nu_pre: int = 2,
        nu_post: int = 2,
        omega: float = 0.8,
        max_levels: int = 16,
        coarse_size: int = 1024,
        smoother: str = "jacobi",  # jacobi | chebyshev (comparable
        # V-cycle quality at these settings; jacobi avoids the setup
        # power iteration)
    ):
        axbcs = T_.axis_bcs(mesh, bcs)
        self.nu_pre, self.nu_post, self.omega = nu_pre, nu_post, omega
        self.smoother = smoother
        self.levels: list[_Level] = []
        m = mesh
        while True:
            self.levels.append(_build_level(m, axbcs, scale, dtype))
            if len(self.levels) >= max_levels:
                break
            if int(np.prod(m.N)) <= coarse_size:
                break
            mc = _coarsen_mesh(m)
            if mc is None:
                break
            m = mc

        # Chebyshev smoothing bounds: lambda_max of the
        # Jacobi-preconditioned operator per level via power iteration
        # (host-driven, setup time); smooth on [lmax/4, 1.05*lmax]
        if smoother == "chebyshev":
            rng = np.random.default_rng(12345)
            for lvl in self.levels:
                x = jnp.asarray(
                    rng.standard_normal(lvl.mesh.cell_shape), dtype
                )
                lmax = 2.0
                for _ in range(12):
                    y = lvl.inv_diag * self._apply_level(lvl, x)
                    nrm = float(jnp.linalg.norm(y.ravel()))
                    if nrm == 0.0:
                        break
                    lmax = nrm / max(
                        float(jnp.linalg.norm(x.ravel())), 1e-300
                    )
                    x = y / nrm
                lvl.cheb_lmax = 1.05 * lmax
        else:
            for lvl in self.levels:
                lvl.cheb_lmax = None

        # coarse-level exact solve via dense pseudo-inverse, assembled
        # on HOST in float64 from the banded tables (Kronecker sums).
        # Assembling by probing the f32 device apply poisons the pinv:
        # the constant-nullspace singular value then sits at ~1e-7
        # instead of ~1e-16, survives pinv's rcond cutoff, and puts
        # O(1e7) entries in the inverse — CG+projection masks this,
        # but it silently weakens the preconditioner (and breaks any
        # projection-free use of the V-cycle).
        coarse = self.levels[-1]
        Nc = coarse.mesh.N
        n = int(np.prod(Nc))
        A = np.zeros((n, n))
        for d, st in enumerate(coarse.host_dgst):
            Dd = st.to_dense(Nc[d])
            left = int(np.prod(Nc[:d], initial=1))
            right = int(np.prod(Nc[d + 1:], initial=1))
            A += np.kron(np.kron(np.eye(left), Dd), np.eye(right))
        A = -np.asarray(coarse.host_vol).ravel()[:, None] * A
        self._coarse_pinv = jnp.asarray(np.linalg.pinv(A), dtype)

    # ------------------------------------------------------------------
    def _apply_level(self, lvl: _Level, p):
        """Shat p on one level: fused per-axis banded sweeps."""
        mesh = lvl.mesh
        acc = None
        for d in range(mesh.dim):
            t = apply_axis_stencil(
                lvl.dgst_bands[d], p, d, mesh.N[d], mesh.periodic[d]
            )
            acc = t if acc is None else acc + t
        vol = lvl.vol_axes[0]
        for w in lvl.vol_axes[1:]:
            vol = vol * w
        return -vol * acc

    def apply_op(self, p):
        """Top-level operator Shat (for CG)."""
        return self._apply_level(self.levels[0], p)

    def scale_rhs(self, r):
        """Symmetrize the rhs to match Shat: Shat p = cellvol * r
        solves (-scale * D Gst) p = r. (NOT vol = scale*cellvol — the
        scale factor must act on the operator side only, otherwise it
        cancels and the solve returns p off by 1/scale.)"""
        return self.levels[0].cellvol * r

    # ------------------------------------------------------------------
    def _smooth(self, lvl, x, b, n):
        if self.smoother == "chebyshev" and lvl.cheb_lmax is not None:
            return self._smooth_cheby(lvl, x, b, n)
        for _ in range(n):
            r = b - self._apply_level(lvl, x)
            x = x + self.omega * lvl.inv_diag * r
        return x

    def _residual(self, lvl, x, b):
        return b - self._apply_level(lvl, x)

    def _smooth_cheby(self, lvl, x, b, n):
        """Chebyshev(n) smoothing on [lmax/4, lmax] of the
        Jacobi-preconditioned operator (standard three-term
        recurrence); stronger high-frequency damping than damped
        Jacobi for the same sweep count."""
        lmax = lvl.cheb_lmax
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b - self._apply_level(lvl, x)
        z = lvl.inv_diag * r
        d = z / theta
        x = x + d
        for _ in range(1, n):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - self._apply_level(lvl, x)
            z = lvl.inv_diag * r
            d = rho_new * rho * d + 2.0 * rho_new / delta * z
            rho = rho_new
            x = x + d
        return x

    @staticmethod
    def _restrict(r, dim):
        """Sum 2x2(x2) fine cells into each coarse cell (adjoint of
        piecewise-constant prolongation; residuals are vol-weighted so
        plain summation is the conservative restriction)."""
        for d in range(dim):
            shape = r.shape
            n = shape[d]
            new = shape[:d] + (n // 2, 2) + shape[d + 1 :]
            r = r.reshape(new).sum(axis=d + 1)
        return r

    @staticmethod
    def _prolong(e, dim):
        for d in range(dim):
            e = jnp.repeat(e, 2, axis=d)
        return e

    def _vcycle(self, li, x, b):
        lvl = self.levels[li]
        if li == len(self.levels) - 1:
            # HIGHEST: a GPU may otherwise run an f32 product in TF32
            xf = jnp.matmul(
                self._coarse_pinv, b.ravel(),
                precision=jax.lax.Precision.HIGHEST,
            )
            return xf.reshape(lvl.mesh.cell_shape)
        x = self._smooth(lvl, x, b, self.nu_pre)
        r = self._residual(lvl, x, b)
        rc = self._restrict(r, lvl.mesh.dim)
        ec = self._vcycle(li + 1, jnp.zeros_like(rc), rc)
        x = x + self._prolong(ec, lvl.mesh.dim)
        x = self._smooth(lvl, x, b, self.nu_post)
        return x

    def precondition(self, r):
        """One V-cycle as preconditioner: approximately Shat^{-1} r."""
        return self._vcycle(0, jnp.zeros_like(r), r)
