"""Krylov solvers in pure JAX over pytrees.

The KSP-equivalent layer: CG, BiCGStab and flexible GMRES, written
with ``lax.while_loop``/``lax.fori_loop`` so an entire solve compiles
into one XLA program (no host round-trips per iteration — the
analogue of PETSc KSP where every MatMult/VecDot is a kernel+allreduce;
here XLA emits fused stencil kernels and cross-device psums).

All solvers accept:
  A       : pytree -> pytree linear operator
  b       : right-hand side pytree
  x0      : initial guess (zeros if None)
  M       : preconditioner, pytree -> pytree (right preconditioning for
            FGMRES, so the convergence norm is the UNPRECONDITIONED
            residual — matching the reference default
            KSP_NORM_UNPRECONDITIONED, fluca/src/ns/interface/
            nssol.c:24-25)
  project : optional nullspace projection applied to keep iterates in
            range(A) (mean subtraction for the singular pressure
            Poisson problem, reference nsbasic.c:215-244)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree


# f32 products stay f32: a GPU may otherwise run them in TF32
_HIGHEST = lax.Precision.HIGHEST


# ----------------------------------------------------------------------
# pytree vector algebra
# ----------------------------------------------------------------------

def tree_dot(a, b):
    """Tree inner product. Reduced-precision leaves (bf16 inner
    solves) accumulate in float32 — the products are rounded to the
    leaf dtype but the O(n) summation must not be; >=32-bit leaves
    keep the plain vdot lowering (its reduction order is what the
    sharded-vs-single-device equivalence tests were pinned on)."""
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    tot = None
    for x, y in zip(leaves_a, leaves_b):
        if jnp.dtype(x.dtype).itemsize < 4:
            d = jnp.sum((x * y).astype(jnp.float32))
        else:
            d = jnp.vdot(x, y, precision=_HIGHEST)
        tot = d if tot is None else tot + d
    return tot


def tree_norm(a):
    return jnp.sqrt(tree_dot(a, a))


def tree_axpy(alpha, x, y):
    """y + alpha * x. The scalar is cast to each leaf's dtype so
    that f32 scalars (tree_dot accumulates in f32) do not silently
    promote reduced-precision (bf16) vectors."""
    a = jnp.asarray(alpha)
    return jax.tree_util.tree_map(
        lambda xi, yi: yi + a.astype(xi.dtype) * xi, x, y
    )


def tree_scale(alpha, x):
    a = jnp.asarray(alpha)
    return jax.tree_util.tree_map(
        lambda xi: a.astype(xi.dtype) * xi, x
    )


def tree_sub(x, y):
    return jax.tree_util.tree_map(lambda a, b: a - b, x, y)


def tree_add(x, y):
    return jax.tree_util.tree_map(lambda a, b: a + b, x, y)


def tree_zeros_like(x):
    return jax.tree_util.tree_map(jnp.zeros_like, x)


@dataclass
class KrylovResult:
    x: Any
    iters: Any
    rnorm: Any
    converged: Any


def _identity(x):
    return x


# ----------------------------------------------------------------------
# Conjugate gradient (SPD; the pressure-Poisson workhorse)
# ----------------------------------------------------------------------

def cg(
    A: Callable,
    b,
    x0=None,
    *,
    rtol=1e-5,
    atol=0.0,
    maxiter=1000,
    M: Optional[Callable] = None,
    project: Optional[Callable] = None,
) -> KrylovResult:
    M = M or _identity
    P = project or _identity
    b = P(b)
    x0 = tree_zeros_like(b) if x0 is None else x0

    bnorm = tree_norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = P(tree_sub(b, A(x0)))
    z0 = P(M(r0))
    rz0 = tree_dot(r0, z0)

    def cond(st):
        x, r, z, p, rz, k, rnorm = st
        return jnp.logical_and(k < maxiter, rnorm > tol)

    def body(st):
        x, r, z, p, rz, k, _ = st
        Ap = P(A(p))
        pAp = tree_dot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = P(M(r))
        rz_new = tree_dot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = tree_axpy(beta, p, z)
        return (x, r, z, p, rz_new, k + 1, tree_norm(r))

    init = (x0, r0, z0, z0, rz0, jnp.array(0, jnp.int32), tree_norm(r0))
    x, r, z, p, rz, k, rnorm = lax.while_loop(cond, body, init)
    return KrylovResult(x=P(x), iters=k, rnorm=rnorm, converged=rnorm <= tol)


# ----------------------------------------------------------------------
# BiCGStab (nonsymmetric; momentum-block solves)
# ----------------------------------------------------------------------

def bicgstab(
    A: Callable,
    b,
    x0=None,
    *,
    rtol=1e-5,
    atol=0.0,
    maxiter=1000,
    M: Optional[Callable] = None,
) -> KrylovResult:
    M = M or _identity
    x0 = tree_zeros_like(b) if x0 is None else x0

    bnorm = tree_norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = tree_sub(b, A(x0))
    rhat = r0

    def cond(st):
        x, r, p, v, rho, alpha, omega, k, rnorm = st
        return jnp.logical_and(k < maxiter, rnorm > tol)

    def body(st):
        x, r, p, v, rho, alpha, omega, k, _ = st
        rho_new = tree_dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = tree_axpy(beta, tree_axpy(-omega, v, p), r)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _nz(tree_dot(rhat, v))
        s = tree_axpy(-alpha, v, r)
        shat = M(s)
        t = A(shat)
        tt = tree_dot(t, t)
        omega = tree_dot(t, s) / _nz(tt)
        x = tree_axpy(alpha, phat, tree_axpy(omega, shat, x))
        r = tree_axpy(-omega, t, s)
        return (x, r, p, v, rho_new, alpha, omega, k + 1, tree_norm(r))

    one = jnp.asarray(1.0, dtype=jnp.result_type(*jax.tree_util.tree_leaves(b)))
    init = (
        x0, r0, tree_zeros_like(b), tree_zeros_like(b),
        one, one, one, jnp.array(0, jnp.int32), tree_norm(r0),
    )
    x, r, *_, k, rnorm = lax.while_loop(cond, body, init)
    return KrylovResult(x=x, iters=k, rnorm=rnorm, converged=rnorm <= tol)


def _nz(x):
    return jnp.where(x == 0, jnp.ones_like(x), x)


# ----------------------------------------------------------------------
# Fixed-budget variants (production presets): identical update
# formulas, but a Python-unrolled loop with NO convergence test. With
# rtol=1e-30 the while_loop variants never exit early either, so the
# iterates are the same — what the fixed forms remove is the
# data-dependent scalar cond (a device-serializing sync point per
# iteration) and the per-iteration residual-norm reduction.
# ----------------------------------------------------------------------

def cg_fixed(A, b, iters: int, M=None, project=None) -> KrylovResult:
    """iters CG iterations, no convergence test, final-residual norm
    only (one reduction at the end)."""
    M = M or _identity
    P = project or _identity
    b = P(b)
    x = tree_zeros_like(b)
    r = b
    z = P(M(r))
    p = z
    rz = tree_dot(r, z)
    for _ in range(iters):
        Ap = P(A(p))
        pAp = tree_dot(p, Ap)
        alpha = rz / _nz(pAp)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = P(M(r))
        rz_new = tree_dot(r, z)
        beta = rz_new / _nz(rz)
        p = tree_axpy(beta, p, z)
        rz = rz_new
    rnorm = tree_norm(r)
    return KrylovResult(
        x=P(x), iters=jnp.array(iters, jnp.int32), rnorm=rnorm,
        converged=jnp.isfinite(rnorm),
    )


def bicgstab_fixed(A, b, iters: int, M=None) -> KrylovResult:
    """iters BiCGStab iterations, no convergence test."""
    M = M or _identity
    x = tree_zeros_like(b)
    r = b
    rhat = r
    p = tree_zeros_like(b)
    v = tree_zeros_like(b)
    one = jnp.asarray(
        1.0, dtype=jnp.result_type(*jax.tree_util.tree_leaves(b))
    )
    rho = alpha = omega = one
    for _ in range(iters):
        rho_new = tree_dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = tree_axpy(beta, tree_axpy(-omega, v, p), r)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _nz(tree_dot(rhat, v))
        s = tree_axpy(-alpha, v, r)
        shat = M(s)
        t = A(shat)
        omega = tree_dot(t, s) / _nz(tree_dot(t, t))
        x = tree_axpy(alpha, phat, tree_axpy(omega, shat, x))
        r = tree_axpy(-omega, t, s)
        rho = rho_new
    rnorm = tree_norm(r)
    return KrylovResult(
        x=x, iters=jnp.array(iters, jnp.int32), rnorm=rnorm,
        converged=jnp.isfinite(rnorm),
    )


# ----------------------------------------------------------------------
# Fixed-budget flexible GCR (generalized conjugate residual)
# ----------------------------------------------------------------------

def gcr(
    A: Callable,
    b,
    x0=None,
    *,
    maxiter: int,
    M: Optional[Callable] = None,
) -> KrylovResult:
    """Fully-unrolled flexible GCR: minimizes the residual over the
    same Krylov space as FGMRES (identical iterates in exact
    arithmetic) but tree-native — no state ravel, no (m+1, n) basis
    buffers, no Givens/Hessenberg machinery. The residual norm is
    non-increasing even under a rough/variable preconditioner, which
    makes it the robust replacement for plain Richardson in the
    fixed-budget production presets (Richardson x += M r diverges
    once the convective CFL pushes the ABF approximation error past
    ||I - MA|| = 1; GCR cannot).

    Work per iteration: 1 A-apply + 1 M-apply + 2(j+1) tree dots +
    ~2(j+1) tree axpys. Intended for small fixed budgets
    (maxiter <= ~6). Reference anchor: the outer coupled solve is
    -ns_ksp_type fgmres at rtol 1e-5 (nssol.c:22-25); this is the
    budgeted equivalent.
    """
    M = M or _identity
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = tree_sub(b, A(x0))
    zs, ws = [], []
    for _ in range(maxiter):
        z = M(r)
        w = A(z)
        # orthogonalize w against previous (normalized) directions
        for zi, wi in zip(zs, ws):
            beta = tree_dot(w, wi)
            w = tree_axpy(-beta, wi, w)
            z = tree_axpy(-beta, zi, z)
        inv = lax.rsqrt(_nz(tree_dot(w, w)))
        w = tree_scale(inv, w)
        z = tree_scale(inv, z)
        alpha = tree_dot(w, r)
        x = tree_axpy(alpha, z, x)
        r = tree_axpy(-alpha, w, r)
        zs.append(z)
        ws.append(w)
    rnorm = tree_norm(r)
    return KrylovResult(
        x=x,
        iters=jnp.array(maxiter, jnp.int32),
        rnorm=rnorm,
        converged=jnp.isfinite(rnorm),
    )


# ----------------------------------------------------------------------
# Flexible GMRES (right-preconditioned; the outer coupled solver,
# matching the reference's -ns_ksp_type fgmres with PCABF)
# ----------------------------------------------------------------------

def fgmres(
    A: Callable,
    b,
    x0=None,
    *,
    rtol=1e-5,
    atol=0.0,
    restart=30,
    maxiter=300,
    M: Optional[Callable] = None,
) -> KrylovResult:
    M = M or _identity

    bflat, unravel = ravel_pytree(b)
    n = bflat.shape[0]
    dtype = bflat.dtype
    # Hard memory guard: the V/Z bases are dense (restart+1, n) and
    # (restart, n) buffers (~(2*restart+1)*n words). At 512^3 f32 with
    # restart 30 that is ~16 GB — past HBM. Refuse loudly instead of
    # OOMing inside jit; production presets use restart <= 3 and the
    # Schur/momentum solves use CG/BiCGStab (O(n) memory).
    basis_bytes = (2 * restart + 1) * int(n) * jnp.dtype(dtype).itemsize
    if basis_bytes > 8 << 30:
        raise ValueError(
            f"fgmres basis would need {basis_bytes / 2**30:.1f} GiB "
            f"(restart={restart}, n={n}); lower the restart length "
            f"(e.g. CNLinearConfig.production()) or use cg/bicgstab"
        )
    x0 = tree_zeros_like(b) if x0 is None else x0
    x0flat, _ = ravel_pytree(x0)

    def Aflat(xf):
        return ravel_pytree(A(unravel(xf)))[0]

    def Mflat(xf):
        return ravel_pytree(M(unravel(xf)))[0]

    bnorm = jnp.linalg.norm(bflat)
    tol = jnp.maximum(rtol * bnorm, atol)
    m = restart
    max_cycles = (maxiter + m - 1) // m

    def arnoldi_cycle(xf):
        r = bflat - Aflat(xf)
        beta = jnp.linalg.norm(r)

        V = jnp.zeros((m + 1, n), dtype)
        Z = jnp.zeros((m, n), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        V = V.at[0].set(r / _nz(beta))

        def inner(j, carry):
            V, Z, H, cs, sn, g, done, nit = carry

            z = Mflat(V[j])
            w = Aflat(z)
            # modified Gram-Schmidt
            def mgs(i, wh):
                w, h = wh
                hij = jnp.where(
                    i <= j, jnp.vdot(V[i], w, precision=_HIGHEST), 0.0
                )
                w = w - hij * V[i]
                return (w, h.at[i].set(hij))

            w, hcol = lax.fori_loop(
                0, m + 1, mgs, (w, jnp.zeros((m + 1,), dtype))
            )
            hlast = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hlast)
            Vnext = w / _nz(hlast)

            # apply previous Givens rotations to the new column
            def giv(i, hc):
                hi = jnp.where(i < j, cs[i] * hc[i] + sn[i] * hc[i + 1], hc[i])
                hi1 = jnp.where(
                    i < j, -sn[i] * hc[i] + cs[i] * hc[i + 1], hc[i + 1]
                )
                return hc.at[i].set(hi).at[i + 1].set(hi1)

            hcol = lax.fori_loop(0, m, giv, hcol)

            # new rotation annihilating hcol[j+1]
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = hcol[j] / _nz(denom)
            s = hcol[j + 1] / _nz(denom)
            hj = c * hcol[j] + s * hcol[j + 1]
            hcol = hcol.at[j].set(hj).at[j + 1].set(0.0)

            gj = g[j]
            g = g.at[j].set(c * gj).at[j + 1].set(-s * gj)

            newly_done = jnp.abs(g[j + 1]) <= tol
            upd = jnp.logical_not(done)

            # select at the ROW level, not the whole buffer: a
            # full-buffer jnp.where(upd, V.at[...].set(...), V) forces
            # XLA to materialize a copy of the (m+1, n) basis every
            # inner iteration; row-level selects keep the update an
            # in-place dynamic-update-slice inside the while_loop
            V = V.at[j + 1].set(jnp.where(upd, Vnext, V[j + 1]))
            Z = Z.at[j].set(jnp.where(upd, z, Z[j]))
            H = jnp.where(upd, H.at[:, j].set(hcol), H)
            cs = jnp.where(upd, cs.at[j].set(c), cs)
            sn = jnp.where(upd, sn.at[j].set(s), sn)
            nit = jnp.where(upd, j + 1, nit)
            done = jnp.logical_or(done, newly_done)
            return (V, Z, H, cs, sn, g, done, nit)

        init = (V, Z, H, cs, sn, g, beta <= tol, jnp.array(0, jnp.int32))
        V, Z, H, cs, sn, g, done, nit = lax.while_loop(
            lambda c: jnp.logical_and(c[7] < m, jnp.logical_not(c[6])),
            lambda c: inner(c[7], c),
            init,
        )

        # back-substitution on the nit x nit triangular system
        y = jnp.zeros((m,), dtype)

        def backsub(jj, y):
            j = nit - 1 - jj
            valid = j >= 0
            hj = jnp.where(valid, H[j, j], 1.0)
            rowsum = jnp.dot(H[j, :], y, precision=_HIGHEST)
            yj = (g[j] - rowsum) / _nz(hj)
            return jnp.where(valid, y.at[j].set(yj), y)

        y = lax.fori_loop(0, m, backsub, y)
        xf = xf + jnp.dot(y, Z, precision=_HIGHEST)
        rnorm = jnp.abs(g[nit])
        return xf, rnorm, nit

    def cond(st):
        xf, rnorm, cyc, its = st
        return jnp.logical_and(cyc < max_cycles, rnorm > tol)

    def body(st):
        xf, _, cyc, its = st
        xf, rnorm, nit = arnoldi_cycle(xf)
        return (xf, rnorm, cyc + 1, its + nit)

    r0 = jnp.linalg.norm(bflat - Aflat(x0flat))
    xf, rnorm, cyc, its = lax.while_loop(
        cond, body, (x0flat, r0, jnp.array(0, jnp.int32),
                     jnp.array(0, jnp.int32))
    )
    return KrylovResult(
        x=unravel(xf), iters=its, rnorm=rnorm, converged=rnorm <= tol
    )
