"""The XLA stencil applies on the step's hot path against dense
operators assembled independently from the AxisStencil bands
(Kronecker sums of ``to_dense`` matrices), and their GSPMD-sharded
forms on the virtual 8-device mesh against one device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from fluca_tpu.mesh.cart import CartMesh
from fluca_tpu.ns import tables as T_
from fluca_tpu.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu.ns.operators import NSOperators
from fluca_tpu.ops.banded import AxisStencil
from fluca_tpu.parallel.mesh import make_device_grid
from fluca_tpu.solvers.mg import PoissonMG

SHAPES = {2: (8, 6), 3: (6, 4, 5)}
KINDS = ("walls", "periodic", "stretched")


def make_mesh(dim, kind, N=None):
    """walls: no-slip box; periodic: all periodic; stretched: periodic
    except wall-bounded axis 1 with clustered (non-uniform) spacing."""
    N = N or SHAPES[dim]
    per = {
        "walls": (False,) * dim,
        "periodic": (True,) * dim,
        "stretched": tuple(d != 1 for d in range(dim)),
    }[kind]
    mesh = CartMesh.create(N, per)
    faces = []
    for d, n in enumerate(N):
        f = np.linspace(0.0, 1.0 + 0.3 * d, n + 1)
        if kind == "stretched" and d == 1:
            xi = np.linspace(-1.0, 1.0, n + 1)
            f = 1.0 + np.tanh(2.0 * xi) / np.tanh(2.0)
        faces.append(f)
    mesh.set_coordinates(*faces)
    pbc = BoundaryCondition(BCType.PERIODIC)
    bcs = []
    for d in range(dim):
        bcs += [pbc, pbc] if per[d] else [zero_velocity_bc()] * 2
    return mesh, bcs


def kron_axis(M, N, d):
    """M acting along axis d of a C-ordered field of shape N."""
    left = int(np.prod(N[:d], initial=1))
    right = int(np.prod(N[d + 1:], initial=1))
    return np.kron(np.kron(np.eye(left), M), np.eye(right))


def dense_poisson(level, scale_vol):
    N = level.mesh.N
    A = sum(kron_axis(st.to_dense(N[d]), N, d)
            for d, st in enumerate(level.host_dgst))
    return -scale_vol.ravel()[:, None] * A


def face_lohi(F, d, periodic, n):
    F = np.asarray(F)
    if periodic:
        return F, np.roll(F, -1, axis=d)
    return (np.take(F, np.arange(n), axis=d),
            np.take(F, np.arange(1, n + 1), axis=d))


def dense_momentum(mesh, axbcs, rho, mu, dt, U0, v0f):
    """Block matrix of A = I + dt C(U0, v0f) - (mu dt / 2 rho) L over
    the stacked components."""
    dim, N = mesh.dim, mesh.N
    n = int(np.prod(N))
    b = 0.5 * mu * dt / rho
    A = np.zeros((dim * n, dim * n))

    def K(d, wd):
        st = AxisStencil.from_dict(d, N[d], mesh.periodic[d], wd)
        return kron_axis(st.to_dense(N[d]), N, d)

    for c in range(dim):
        A[c * n:(c + 1) * n, c * n:(c + 1) * n] += np.eye(n)
        for d in range(dim):
            lap, _, _ = T_.lap_tables(mesh, d, axbcs[d], c)
            A[c * n:(c + 1) * n, c * n:(c + 1) * n] -= b * kron_axis(
                lap.to_dense(N[d]), N, d)
            FlU, FrU = face_lohi(U0[d], d, mesh.periodic[d], N[d])
            Flv, Frv = face_lohi(v0f[d][c], d, mesh.periodic[d], N[d])
            wl1, wr1 = T_.conv_tables(mesh, d, axbcs[d], c == d)
            wl2, wr2 = T_.conv_tables(mesh, d, axbcs[d], True)
            A[c * n:(c + 1) * n, c * n:(c + 1) * n] += dt * (
                FlU.ravel()[:, None] * K(d, wl1)
                + FrU.ravel()[:, None] * K(d, wr1))
            A[c * n:(c + 1) * n, d * n:(d + 1) * n] += dt * (
                Flv.ravel()[:, None] * K(d, wl2)
                + Frv.ravel()[:, None] * K(d, wr2))
    return A


def random_factors(mesh, rng):
    dim = mesh.dim
    U0 = tuple(rng.standard_normal(mesh.face_shape(d))
               for d in range(dim))
    v0f = tuple(tuple(rng.standard_normal(mesh.face_shape(d))
                      for _ in range(dim)) for d in range(dim))
    return U0, v0f


def to_dev(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("op", ["apply", "residual", "jacobi"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dim", [2, 3])
def test_poisson_level_ops_match_dense(dim, kind, op):
    mesh, bcs = make_mesh(dim, kind)
    scale = 0.37
    mg = PoissonMG(mesh, bcs, scale=scale, dtype=jnp.float64)
    lvl = mg.levels[0]
    A = dense_poisson(lvl, scale * mesh.cell_volumes())
    rng = np.random.default_rng(dim)
    x = rng.standard_normal(mesh.cell_shape)
    b = rng.standard_normal(mesh.cell_shape)
    Ax = (A @ x.ravel()).reshape(mesh.cell_shape)
    if op == "apply":
        got, want = mg.apply_op(jnp.asarray(x)), Ax
    elif op == "residual":
        got = mg._residual(lvl, jnp.asarray(x), jnp.asarray(b))
        want = b - Ax
    else:
        got = mg._smooth(lvl, jnp.asarray(x), jnp.asarray(b), 1)
        d = np.diag(A).reshape(mesh.cell_shape)
        want = x + mg.omega * (b - Ax) / np.where(d == 0, 1.0, d)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dim", [2, 3])
def test_momentum_apply_matches_dense(dim, kind):
    mesh, bcs = make_mesh(dim, kind)
    rho, mu, dt = 1.0, 0.05, 0.01
    ops = NSOperators(mesh, bcs, rho, mu, dt, jnp.float64)
    rng = np.random.default_rng(10 + dim)
    U0, v0f = random_factors(mesh, rng)
    v = tuple(rng.standard_normal(mesh.cell_shape) for _ in range(dim))
    A = dense_momentum(mesh, ops.axbcs, rho, mu, dt, U0, v0f)
    want = A @ np.concatenate([x.ravel() for x in v])
    coeffs = ops.build_momentum_coeffs(to_dev(U0), to_dev(v0f))
    got = ops.apply_A_coeffs(to_dev(v), coeffs)
    got = np.concatenate([np.asarray(x).ravel() for x in got])
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # the unfused operator chain is the same matrix
    chain = ops.apply_A(to_dev(v), to_dev(U0), to_dev(v0f))
    chain = np.concatenate([np.asarray(x).ravel() for x in chain])
    np.testing.assert_allclose(chain, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


GRIDS = [(2, (2, 1)), (2, (2, 2)), (3, (2, 2, 2))]


def _sharded(grid, x):
    spec = P(*grid.axis_names[: x.ndim])
    return jax.device_put(x, NamedSharding(grid.mesh, spec))


@pytest.mark.parametrize("dim,shape", GRIDS)
def test_sharded_poisson_apply_matches_single(dim, shape):
    if len(jax.devices()) < int(np.prod(shape)):
        pytest.skip("needs the virtual 8-device mesh")
    N = (8, 8) if dim == 2 else (4, 8, 4)
    mesh, bcs = make_mesh(dim, "stretched", N)
    mg = PoissonMG(mesh, bcs, scale=0.5, dtype=jnp.float64)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(N))
    want = mg.apply_op(x)
    grid = make_device_grid(dim, jax.devices(), shape=shape)
    got = jax.jit(mg.apply_op)(_sharded(grid, x))
    assert len(got.sharding.device_set) == int(np.prod(shape))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dim,shape", GRIDS)
def test_sharded_momentum_apply_matches_single(dim, shape):
    if len(jax.devices()) < int(np.prod(shape)):
        pytest.skip("needs the virtual 8-device mesh")
    N = (8, 8) if dim == 2 else (4, 8, 4)
    mesh, bcs = make_mesh(dim, "stretched", N)
    ops = NSOperators(mesh, bcs, 1.0, 0.05, 0.01, jnp.float64)
    rng = np.random.default_rng(1)
    U0, v0f = to_dev(random_factors(mesh, rng))
    v = tuple(jnp.asarray(rng.standard_normal(N)) for _ in range(dim))

    def apply(v, U0, v0f):
        return ops.apply_A_coeffs(v, ops.build_momentum_coeffs(U0, v0f))

    want = apply(v, U0, v0f)
    grid = make_device_grid(dim, jax.devices(), shape=shape)
    got = jax.jit(apply)(
        tuple(_sharded(grid, x) for x in v), U0, v0f)
    for g, w in zip(got, want):
        assert len(g.sharding.device_set) == int(np.prod(shape))
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-13, atol=1e-13)
