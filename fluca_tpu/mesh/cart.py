"""Distributed Cartesian staggered grid.

JAX re-design of MESHCART (reference:
fluca/src/mesh/impl/cart/cart.c). The reference builds four compatible
DMStag objects (cell scalar ``sdm``, cell vector ``vdm``, face scalar
``Sdm``, face vector ``Vdm``) sharing one product coordinate DM
(cart.c:85-150) and distributes them over an MPI rank grid with
halo-exchange scatters. Here a mesh is a light host-side object holding
per-axis coordinate arrays (numpy, float64 at setup); fields are dense
JAX arrays whose distribution over a device mesh is expressed with
``jax.sharding`` (see fluca_tpu.parallel) — halo exchange is emitted by
XLA/GSPMD rather than hand-written scatters.

Field layouts (2-D; 3-D analogous; reference meshimpl.h:33-38):
  cell scalar   p      : (Nx, Ny)
  cell vector   v      : tuple of dim arrays, each (Nx, Ny)
  face scalar   U      : tuple per axis: (NFx, Ny), (Nx, NFy)
  face vector   vface  : nested tuple [face-axis][component]

``NF_d = N_d + 1`` for non-periodic axes and ``N_d`` for periodic axes
(DMStag's "nExtra on the last rank" convention, reference
fluca/src/fd/interface/fdapply.c:3-20, is global here since arrays are
globally shaped and sharding handles the split).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from fluca_tpu.utils import config


class BoundaryLoc(enum.IntEnum):
    """Boundary index mapping (reference: MeshCartGetBoundaryIndex,
    fluca/src/mesh/impl/cart/cart.c:564-591)."""

    LEFT = 0
    RIGHT = 1
    DOWN = 2
    UP = 3
    BACK = 4
    FRONT = 5

    @property
    def axis(self) -> int:
        return int(self) // 2

    @property
    def is_low(self) -> bool:
        return int(self) % 2 == 0


@dataclass
class CartMesh:
    """Cartesian grid: sizes, periodicity, per-axis coordinates.

    Coordinates are stored as per-axis face (vertex) arrays ``faces[d]``
    of length ``N_d + 1`` (for periodic axes ``faces[d][N] =
    faces[d][0] + L`` closes the circle); cell centers are midpoints.
    """

    N: tuple[int, ...]
    periodic: tuple[bool, ...]
    faces: list[np.ndarray] = field(default_factory=list)

    # -- constructors -------------------------------------------------
    @classmethod
    def create(cls, N, periodic=None, refine: int = 0) -> "CartMesh":
        """Reference: MeshCartCreate2d/3d (cart.c:290-314) +
        -cart_refine (cart.c:36-44)."""
        N = tuple(int(n) << refine for n in N)
        if periodic is None:
            periodic = (False,) * len(N)
        periodic = tuple(bool(b) for b in periodic)
        assert len(N) == len(periodic) and len(N) in (1, 2, 3)
        return cls(N=N, periodic=periodic)

    @classmethod
    def from_options(cls, opts, prefix: str = "cart_") -> "CartMesh":
        """Reference: MeshSetFromOptions_Cart (cart.c:13-54)."""
        o = opts.sub(prefix)
        dim = o.get_int("dim", 2)
        names = ["x", "y", "z"][:dim]
        N = tuple(o.get_int(f"grid_{c}", 8) for c in names)
        periodic = tuple(
            o.get_str(f"boundary_type_{c}", "none").lower() == "periodic"
            for c in names
        )
        refine = o.get_int("refine", 0)
        mesh = cls.create(N, periodic, refine)
        lo = tuple(o.get_real(f"{c}min", 0.0) for c in names)
        hi = tuple(o.get_real(f"{c}max", 1.0) for c in names)
        mesh.set_uniform_coordinates(*[b for ab in zip(lo, hi) for b in ab])
        return mesh

    # -- basic queries ------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.N)

    def nfaces(self, d: int) -> int:
        """Number of owned unique faces along axis d."""
        return self.N[d] if self.periodic[d] else self.N[d] + 1

    @property
    def cell_shape(self) -> tuple[int, ...]:
        return self.N

    def face_shape(self, d: int) -> tuple[int, ...]:
        return tuple(
            self.nfaces(a) if a == d else self.N[a] for a in range(self.dim)
        )

    @property
    def is_set_up(self) -> bool:
        return len(self.faces) == self.dim

    # -- coordinates --------------------------------------------------
    def set_uniform_coordinates(self, *bounds) -> None:
        """Reference: MeshCartSetUniformCoordinates. ``bounds`` is
        (xmin, xmax[, ymin, ymax[, zmin, zmax]])."""
        assert len(bounds) >= 2 * self.dim
        self.faces = []
        for d in range(self.dim):
            lo, hi = float(bounds[2 * d]), float(bounds[2 * d + 1])
            self.faces.append(np.linspace(lo, hi, self.N[d] + 1))

    def set_coordinates(self, *face_arrays) -> None:
        """Non-uniform grid from explicit per-axis face coordinates."""
        assert len(face_arrays) == self.dim
        self.faces = []
        for d, f in enumerate(face_arrays):
            f = np.asarray(f, dtype=np.float64)
            assert f.shape == (self.N[d] + 1,), (
                f"axis {d}: need {self.N[d] + 1} face coordinates"
            )
            assert np.all(np.diff(f) > 0)
            self.faces.append(f)

    def centers(self, d: int) -> np.ndarray:
        f = self.faces[d]
        return 0.5 * (f[:-1] + f[1:])

    def widths(self, d: int) -> np.ndarray:
        """Cell widths h_i = f[i+1] - f[i]."""
        return np.diff(self.faces[d])

    def face_coords(self, d: int) -> np.ndarray:
        """Coordinates of owned faces (length nfaces(d))."""
        f = self.faces[d]
        return f[: self.N[d]] if self.periodic[d] else f

    def length(self, d: int) -> float:
        return float(self.faces[d][-1] - self.faces[d][0])

    # -- extended (ghost) coordinates for stencil construction --------
    def centers_ext(self, d: int, width: int = 1) -> np.ndarray:
        """Cell centers with ``width`` ghost entries on each side.

        For periodic axes ghosts wrap with period L (matching DMStag
        ghosted product coordinates); for non-periodic axes ghosts are
        linearly extrapolated (only used by FD extrapolation rules —
        the NS tables never read non-periodic ghosts)."""
        c = self.centers(d)
        L = self.length(d)
        left, right = [], []
        for w in range(1, width + 1):
            if self.periodic[d]:
                left.append(c[-w] - L)
                right.append(c[w - 1] + L)
            else:
                left.append(2.0 * self.faces[d][0] - c[w - 1])
                right.append(2.0 * self.faces[d][-1] - c[-w])
        return np.concatenate([left[::-1], c, right])

    # -- field allocation helpers -------------------------------------
    def zeros_cell(self, dtype=None):
        import jax.numpy as jnp

        return jnp.zeros(self.cell_shape, dtype or config.default_dtype())

    def zeros_cell_vector(self, dtype=None):
        return tuple(self.zeros_cell(dtype) for _ in range(self.dim))

    def zeros_face(self, dtype=None):
        import jax.numpy as jnp

        dt = dtype or config.default_dtype()
        return tuple(
            jnp.zeros(self.face_shape(d), dt) for d in range(self.dim)
        )

    def zeros_face_vector(self, dtype=None):
        import jax.numpy as jnp

        dt = dtype or config.default_dtype()
        return tuple(
            tuple(
                jnp.zeros(self.face_shape(d), dt) for _ in range(self.dim)
            )
            for d in range(self.dim)
        )

    # -- misc ----------------------------------------------------------
    def cell_volumes(self) -> np.ndarray:
        """Dense array of cell volumes (outer product of widths)."""
        vol = self.widths(0)
        for d in range(1, self.dim):
            vol = np.multiply.outer(vol, self.widths(d))
        return vol

    def boundary_index(self, loc) -> int:
        return int(BoundaryLoc[loc.upper()] if isinstance(loc, str) else loc)

    def __repr__(self):
        per = ",".join("P" if p else "N" for p in self.periodic)
        return f"CartMesh(N={self.N}, periodic=({per}))"
