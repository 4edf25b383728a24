"""CNLinear: linearized Crank-Nicolson NS time stepping.

Re-design of NSCNLINEAR (reference: fluca/src/ns/impl/
linearcn/cnlinear.c + cnlinearcart2d.c:1933-2171 drivers) together
with the ABF preconditioner (fluca/src/ns/utils/abfpc/abfpc.c).

One time step solves the coupled 3x3 saddle system (THEORY_GUIDE
eq. 13)

    [ A   0   G  ] [ v  ]   [ momrhs    ]
    [ -T  I  -R  ] [ U  ] = [ interprhs ]
    [ 0   D   0  ] [ p' ]   [ 0         ]

with flexible GMRES to rtol 1e-5 on the unpreconditioned residual
(reference nssol.c:22-25), preconditioned by the (LD)U approximate
block factorization with Atilde = I (the fractional-step limit,
THEORY_GUIDE.md:318-349):

    v* = kspA^-1 momrhs            (BiCGStab + Jacobi)
    U* = interprhs + T v*
    p  = kspS^-1 (contrhs - D U*)  (CG + geometric multigrid on -D Gst)
    v  = v* - G p,   U = U* - Gst p     (abfpc.c:48-111)

then updates the pressure by extrapolation (cnlinearcart2d.c:1969-1980):
    step 0: p <- p0 + 2 dp,     phalf <- p0 + dp
    else  : p <- phalf + 1.5 dp, phalf <- phalf + dp

Because the scheme is linear for constant viscosity, the reference's
SNES-Picard wrapper converges in a single linear solve; the linear
solve IS the step.

The whole step compiles into one XLA program; the time loop runs on
host with donated state buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from fluca_tpu.mesh.cart import CartMesh
from fluca_tpu.ns.operators import NSOperators
from fluca_tpu.solvers.krylov import (
    bicgstab, bicgstab_fixed, cg, cg_fixed, fgmres, gcr, tree_add,
    tree_norm, tree_sub,
)
from fluca_tpu.solvers.mg import PoissonMG
from fluca_tpu.utils import config


@dataclass
class CNLinearConfig:
    rtol: float = 1e-5          # outer coupled FGMRES (nssol.c:22-25)
    restart: int = 30
    maxiter: int = 200
    mom_rtol: float = 1e-5      # kspA (abf_momentum_)
    mom_maxiter: int = 100
    schur_rtol: float = 1e-5    # kspS (abf_schur_)
    schur_maxiter: int = 200
    mg_levels: bool = True
    # Atilde approximations in the ABF factorization
    # (-pc_abf_schur_ainv_type / -pc_abf_upper_ainv_type,
    # abfpc.c:240-252); 'id' is the fractional-step limit
    schur_ainv: str = "id"      # id | diag | rowsum
    upper_ainv: str = "id"
    # warm-start the coupled solve from the old velocity state
    # (reference uses a zero initial guess, nsbasic.c:247-251; this
    # changes only the iteration count, not the converged solution)
    warm_start: bool = False
    # "coupled": iterate FGMRES+ABF to rtol on the full saddle system
    # (reference semantics). "fsm": one ABF pass with Atilde = I — the
    # classical fractional-step method (THEORY_GUIDE.md:318-349).
    # CAVEAT (measured, tests/test_fsm.py): with this linearized-CN
    # operator the single-pass splitting error is O(dt), NOT the
    # O(dt^2) of the textbook incremental form — kept for parity /
    # pedagogy only. The supported fast mode is
    # CNLinearConfig.production_fast(): same per-step cost class,
    # full production accuracy (tests/test_fastpath.py).
    solve_type: str = "coupled"  # coupled | fsm
    # fixed-budget mode (PETSc KSPConvergedSkip analogue): run the
    # outer iteration to maxiter and accept the result if finite
    converged_skip: bool = False
    # fixed-budget fast-path solver selections (production_fast):
    #   outer_type  "fgmres"    : flexible GMRES (reference semantics,
    #                             nssol.c:22-25) — optimal in the Krylov
    #                             sense but pays ravel/Gram-Schmidt/basis
    #                             traffic over the full coupled state
    #               "richardson": x += M(b - A x) — same
    #                             operator/preconditioner applications,
    #                             zero orthogonalization machinery;
    #                             with the ABF preconditioner this is
    #                             the classical iterated
    #                             pressure-correction scheme
    #   mom_solver  "bicgstab"  : Jacobi-preconditioned BiCGStab
    #               "jacobi"    : mom_maxiter damped-Jacobi sweeps
    #                             (1 A-apply per sweep, no dots)
    #   schur_solver "cg"       : MG-preconditioned CG
    #                "vcycle"   : mg Richardson (schur_maxiter V-cycles,
    #                             nullspace projection hoisted out of
    #                             the loop)
    outer_type: str = "fgmres"
    mom_solver: str = "bicgstab"
    schur_solver: str = "cg"
    mom_omega: float = 1.0
    # run the ABF preconditioner's inner solves (momentum + Schur) in
    # reduced precision ("bfloat16"): the outer Krylov iteration is
    # flexible (right-preconditioned GCR/FGMRES), so an inexact M only
    # changes the contraction rate, never the converged answer — the
    # coupled residual, outer dots and solution updates all stay in
    # the solver dtype. It halves the memory traffic of the dominant
    # inner-solve passes. Accuracy trade: at fixed budgets the
    # per-step residual is looser than with the f32 preconditioner
    # (tests/test_bf16_precond.py pins it) — use it where that is
    # acceptable (throughput studies, long statistical runs), not as
    # the default production path.
    # None = inner solves in the solver dtype (reference semantics).
    precond_dtype: str | None = None
    # which inner solves run reduced-precision: "both" or "mom"
    # (momentum only — the Schur/pressure solve stays in the solver
    # dtype, preserving most of M's contraction at ~60% of the
    # saving)
    precond_scope: str = "both"
    # report ||rhs|| in the step diagnostics so an achieved relative
    # tolerance (reference semantics: KSP rtol on the unpreconditioned
    # norm, nssol.c:24-25) can be formed as ksp_rnorm / rhs_norm.
    # Off by default: it adds one full-tree reduction per step.
    diag_rhs_norm: bool = False

    @classmethod
    def production(cls, outer=3, mom=8, schur=6):
        """Fixed-budget preset: reproduces the full rtol-1e-5 TGV
        accuracy (verified to the digit at 8^2/16^2) with completely
        deterministic per-step work — no tolerance checks, maximal
        XLA-friendliness. Increase budgets for impulsive starts or
        very stiff cases.

        Solver forms are the fully-unrolled fixed-trip ones (GCR
        outer = FGMRES's Krylov space without the ravel/basis
        machinery; bicgstab_fixed / cg_fixed inner): at rtol 1e-30
        the while_loop forms never exit early, so the iterates are
        identical — but the unrolled forms drop the per-iteration
        scalar cond."""
        return cls(
            rtol=1e-30, maxiter=outer, restart=outer,
            converged_skip=True,
            mom_rtol=1e-30, mom_maxiter=mom,
            schur_rtol=1e-30, schur_maxiter=schur,
            outer_type="gcr",
        )

    @classmethod
    def production_fast(cls, outer=3, mom=8, schur=6, mom_omega=1.0,
                        outer_type="gcr"):
        """Fixed-budget preset on the overhead-free solver path:
        GCR outer + damped-Jacobi momentum + MG-Richardson Schur.
        Identical operator/preconditioner structure to
        ``production()`` but with the per-iteration Krylov
        bookkeeping of the inner solves removed — each outer
        iteration is one coupled apply plus one ABF application plus
        the GCR line-search dots. Accuracy is validated against the
        production preset by tests/test_fastpath.py.

        The outer defaults to GCR, not Richardson: the damped-Jacobi
        momentum sweeps AMPLIFY instead of contract once the
        convective CFL u*dt/h passes ~1 (A = I + dt C - b L loses
        diagonal dominance), and the plain Richardson outer
        compounds that geometrically — reproduced at the 128^3
        channel config (CFL ~ 6): rnorm = inf within one step
        (regression:
        tests/test_fastpath.py::test_high_cfl_richardson_fenced).
        GCR's residual-minimizing line search keeps the same
        preconditioner stable at any CFL for a few dots per outer
        iteration. Pass outer_type="richardson" explicitly for
        CFL-<1 cases where the last 10% matters."""
        return cls(
            rtol=1e-30, maxiter=outer, restart=outer,
            converged_skip=True,
            mom_rtol=1e-30, mom_maxiter=mom,
            schur_rtol=1e-30, schur_maxiter=schur,
            outer_type=outer_type, mom_solver="jacobi",
            schur_solver="vcycle", mom_omega=mom_omega,
        )

    @classmethod
    def from_options(cls, opts, prefix="ns_"):
        o = opts.sub(prefix)
        return cls(
            rtol=o.get_real("ksp_rtol", 1e-5),
            restart=o.get_int("ksp_gmres_restart", 30),
            maxiter=o.get_int("ksp_max_it", 200),
            mom_rtol=o.get_real("abf_momentum_ksp_rtol", 1e-5),
            mom_maxiter=o.get_int("abf_momentum_ksp_max_it", 100),
            schur_rtol=o.get_real("abf_schur_ksp_rtol", 1e-5),
            schur_maxiter=o.get_int("abf_schur_ksp_max_it", 200),
            schur_ainv=o.get_str("pc_abf_schur_ainv_type", "id"),
            upper_ainv=o.get_str("pc_abf_upper_ainv_type", "id"),
            solve_type=o.get_str("solve_type", "coupled"),
            outer_type=o.get_str("ksp_type", "fgmres"),
            mom_solver=o.get_str("abf_momentum_ksp_type", "bicgstab"),
            schur_solver=o.get_str("abf_schur_ksp_type", "cg"),
            # PETSc -ksp_convergence_test skip analogue (required for
            # the fixed-budget richardson outer)
            converged_skip=o.get_bool("ksp_convergence_test_skip", False),
        )


class CNLinearSolver:
    def __init__(
        self,
        mesh: CartMesh,
        bcs,
        rho: float,
        mu: float,
        dt: float,
        cfg: CNLinearConfig | None = None,
        dtype=None,
    ):
        dtype = dtype or config.default_dtype()
        self.dtype = dtype
        self.cfg = cfg or CNLinearConfig()
        self.ops = NSOperators(mesh, bcs, rho, mu, dt, dtype)
        self.mesh = mesh
        self.dt = float(dt)
        self.rho = float(rho)
        self.mu = float(mu)
        # multigrid hierarchy for Shat = vol .* (-D Gst)
        self.mg = PoissonMG(mesh, bcs, scale=dt / rho, dtype=dtype)
        self.pin_pressure = not self.ops.has_pressure_outlet
        self._step_jit = {}
        # reduced-precision preconditioner resources (lazy; see
        # _pre_resources)
        self._pre16 = None
        # device grid for domain decomposition (None = single device);
        # set via set_device_grid / NS.shard
        self.grid = None
        # optional momentum body-force hook: f(state0, t) -> cell
        # vector; added to the momentum RHS as dt * f (used by the
        # direct-forcing IBM, fluca_tpu.ibm.forcing)
        self.body_force = None

    # -- domain decomposition -------------------------------------------
    def set_device_grid(self, grid) -> None:
        """Make the compiled step run sharded over a device grid (the
        reference's block-structured rank decomposition, cart.c:85-151,
        as GSPMD sharding): every step program constrains its state to
        the grid-axis sharding, and XLA inserts the halo
        collective-permutes / psum allreduces for the banded sweeps.
        ``grid=None`` returns to the single-device step."""
        self.grid = grid
        self._step_jit = {}
        self._pre16 = None

    def _constrain(self, state):
        if self.grid is None:
            return state
        from fluca_tpu.parallel.mesh import constrain_state

        return constrain_state(self.grid, state)

    # -- state ---------------------------------------------------------
    def zero_state(self) -> dict:
        return {
            "v": self.mesh.zeros_cell_vector(self.dtype),
            "U": self.mesh.zeros_face(self.dtype),
            "p": self.mesh.zeros_cell(self.dtype),
            "phalf": self.mesh.zeros_cell(self.dtype),
        }

    # -- coupled operator & preconditioner ----------------------------
    def _coupled_apply(self, x, Acoeffs):
        ops = self.ops
        v, U, p = x["v"], x["U"], x["p"]
        Av = ops.apply_A_coeffs(v, Acoeffs)
        Gp = ops.apply_G(p)
        Tv = ops.apply_T(v)
        Rp = ops.apply_R(p)
        return {
            "v": tuple(Av[c] + Gp[c] for c in range(ops.dim)),
            "U": tuple(
                U[d] - Tv[d] - Rp[d] for d in range(ops.dim)
            ),
            "p": ops.apply_D(U),
        }

    def _project_p(self, p):
        """Remove the constant-pressure nullspace component (vol
        weighted mean; reference attaches a constant nullspace to S,
        abfpc.c:170-179)."""
        if not self.pin_pressure:
            return p
        vol = self.mg.levels[0].vol
        mean = jnp.sum(vol * p) / jnp.sum(vol)
        return p - mean

    def _solve_momentum(self, rhs_v, Acoeffs, diagA, applyA=None):
        ops = self.ops
        inv_diag = tuple(1.0 / d for d in diagA)
        A = applyA or (lambda v: ops.apply_A_coeffs(v, Acoeffs))

        if self.cfg.mom_solver == "gcr":
            # fixed-budget Jacobi-preconditioned GCR: 1 A-apply per
            # iteration (vs BiCGStab's 2) with a residual-minimizing
            # line search, so it cannot diverge where plain Jacobi
            # does (convective CFL > ~1)
            return gcr(
                A,
                rhs_v,
                maxiter=self.cfg.mom_maxiter,
                M=lambda r: tuple(
                    inv_diag[c] * r[c] for c in range(ops.dim)
                ),
            ).x

        if self.cfg.mom_solver == "jacobi":
            # mom_maxiter damped-Jacobi sweeps, unrolled: one fused
            # A-apply plus an elementwise epilogue per sweep — no dot
            # products, no norm reductions. A = I + dt C - nu dt/2 L
            # is strongly diagonally dominant at CFL-limited dt, so
            # plain Jacobi contracts geometrically (validated against
            # BiCGStab by tests/test_fastpath.py).
            w = self.cfg.mom_omega
            x = tuple(
                w * inv_diag[c] * rhs_v[c] for c in range(ops.dim)
            )
            for _ in range(self.cfg.mom_maxiter - 1):
                Ax = A(x)
                x = tuple(
                    x[c] + w * inv_diag[c] * (rhs_v[c] - Ax[c])
                    for c in range(ops.dim)
                )
            return x

        def M(r):
            return tuple(inv_diag[c] * r[c] for c in range(ops.dim))

        # the reduced-precision path needs the unrolled form: the
        # while forms mix f32 scalars into the carry and fail to
        # trace in bf16. Elsewhere the while form keeps the HLO graph
        # small; at rtol 1e-30 both run the same iterations.
        use_fixed = (
            self.cfg.converged_skip
            and self.cfg.mom_rtol <= 1e-20
            and applyA is not None
        )
        if use_fixed:
            return bicgstab_fixed(
                A, rhs_v, self.cfg.mom_maxiter, M=M
            ).x
        res = bicgstab(
            A, rhs_v, rtol=self.cfg.mom_rtol,
            maxiter=self.cfg.mom_maxiter, M=M,
        )
        return res.x

    def _ainv_diag(self, kind: str, Acoeffs, diagA):
        """1/Atilde as a per-component diagonal field, or None for
        identity. 'diag' uses diag(A); 'rowsum' uses A @ 1 (the
        lumped row-sum), both matrix-free (abfpc.c Atilde options)."""
        if kind == "id":
            return None
        if kind == "diag":
            return tuple(1.0 / d for d in diagA)
        if kind == "rowsum":
            ones = tuple(
                jnp.ones(self.mesh.cell_shape, self.dtype)
                for _ in range(self.ops.dim)
            )
            rs = self.ops.apply_A_coeffs(ones, Acoeffs)
            return tuple(
                1.0 / jnp.where(r == 0, 1.0, r) for r in rs
            )
        raise ValueError(f"unknown ainv type {kind!r}")

    def _solve_schur(self, rhs_p, ainv1=None, mg=None):
        """Solve Stilde p = rhs with CG+MG (Atilde1 = I, symmetric) or
        FGMRES+MG (diag/rowsum, nonsymmetric Stilde =
        -D T Atilde1^-1 G + D R = D T (I - Atilde1^-1) G - D Gst).

        ``mg`` overrides the multigrid hierarchy (the bf16 twin for
        precond_dtype; the constant-nullspace projection then uses
        that hierarchy's volumes)."""
        mg = mg or self.mg
        if self.pin_pressure:
            vol = mg.levels[0].vol

            def proj(p):
                # accumulate the O(n) sums in at least f32 even when
                # the hierarchy is bf16 (a bf16 accumulator loses the
                # mean entirely at production sizes) — but never
                # DOWNcast an f64 solve's accumulation
                acc_dt = jnp.promote_types(p.dtype, jnp.float32)
                num = jnp.sum((vol * p).astype(acc_dt))
                den = jnp.sum(vol.astype(acc_dt))
                return p - (num / den).astype(p.dtype)
        else:
            proj = None
        if ainv1 is None and self.cfg.schur_solver == "vcycle":
            # MG as the solver: schur_maxiter V-cycle Richardson
            # iterations. Per iteration this is one V-cycle plus one
            # fused residual — CG's dots, per-iteration norm, and
            # per-iteration nullspace projections are all gone; the
            # constant mode is projected once at the end (G of a
            # constant is 0, so a bounded constant component never
            # feeds back into the velocity update).
            b = mg.scale_rhs(rhs_p)
            lvl0 = mg.levels[0]
            p = mg.precondition(b)
            for _ in range(self.cfg.schur_maxiter - 1):
                r = mg._residual(lvl0, p, b)
                p = p + mg.precondition(r)
            return proj(p) if proj else p
        if ainv1 is None:
            # unrolled form only on the reduced-precision hierarchy
            # (the while form cannot carry bf16 state; same gate as
            # _solve_momentum)
            use_fixed = (
                self.cfg.converged_skip
                and self.cfg.schur_rtol <= 1e-20
                and mg is not self.mg
            )
            if use_fixed:
                return cg_fixed(
                    mg.apply_op,
                    mg.scale_rhs(rhs_p),
                    self.cfg.schur_maxiter,
                    M=mg.precondition,
                    project=proj,
                ).x
            res = cg(
                mg.apply_op,
                mg.scale_rhs(rhs_p),
                rtol=self.cfg.schur_rtol,
                maxiter=self.cfg.schur_maxiter,
                M=mg.precondition,
                project=proj,
            )
            return res.x
        ops = self.ops

        def S(p):
            # Stilde p = D T (I - Atilde1^-1) G p - D Gst p,
            # vol-scaled to match the MG preconditioner
            Gp = ops.apply_G(p)
            corr = tuple(
                Gp[c] - ainv1[c] * Gp[c] for c in range(ops.dim)
            )
            out = ops.apply_D(ops.apply_T(corr)) - ops.apply_DGst(p)
            return self.mg.scale_rhs(out)

        res = fgmres(
            S,
            self.mg.scale_rhs(rhs_p),
            rtol=self.cfg.schur_rtol,
            maxiter=self.cfg.schur_maxiter,
            restart=30,
            M=self.mg.precondition,
        )
        p = res.x
        return proj(p) if proj else p

    # -- reduced-precision preconditioner ------------------------------
    def _pre_resources(self):
        """Build (once) the precond_dtype twin of the PoissonMG
        hierarchy."""
        if self.cfg.precond_dtype is None:
            return None
        cfg = self.cfg
        if not (
            cfg.converged_skip
            and cfg.mom_rtol <= 1e-20
            and (cfg.precond_scope == "mom" or cfg.schur_rtol <= 1e-20)
        ):
            # the tolerance-based (while_loop) inner forms mix f32
            # scalars into the carry and fail to trace on bf16 trees;
            # only the fixed-budget presets are supported
            raise ValueError(
                "precond_dtype requires a fixed-budget config "
                "(converged_skip=True with inner rtols <= 1e-20, "
                "e.g. CNLinearConfig.production()); tolerance-based "
                "inner solves cannot run in reduced precision"
            )
        pdt = jnp.dtype(self.cfg.precond_dtype)
        if (
            self._pre16 is not None
            and self._pre16["dtype"] == pdt
            and (self._pre16["mg"] is None)
            == (self.cfg.precond_scope == "mom")
        ):
            return self._pre16
        res = {"dtype": pdt, "mg": None}
        if self.cfg.precond_scope != "mom":
            res["mg"] = PoissonMG(
                self.mesh, self.ops.bcs, scale=self.dt / self.rho,
                dtype=pdt,
            )
        self._pre16 = res
        return res

    def _precond_ctx(self, Acoeffs, diagA):
        """Per-step reduced-precision context: the momentum
        coefficients and diag cast once (one pass), plus the A-apply
        closure in that dtype (the coefficient applies are
        dtype-generic). None when precond_dtype is off."""
        res = self._pre_resources()
        if res is None:
            return None
        pdt = res["dtype"]
        Ac = jax.tree_util.tree_map(lambda x: x.astype(pdt), Acoeffs)
        return {
            "dtype": pdt,
            "mg": res["mg"],
            "diagA": tuple(d.astype(pdt) for d in diagA),
            "Acoeffs": Ac,
            "applyA": lambda v: self.ops.apply_A_coeffs(
                tuple(x.astype(pdt) for x in v), Ac
            ),
        }

    def _abf_apply(self, r, Acoeffs, diagA, pre=None):
        """PCApply_ABF (abfpc.c:48-111).

        ``pre`` (from _precond_ctx): run the two inner solves in
        reduced precision. Valid because the ABF application is a
        preconditioner under a FLEXIBLE outer iteration: the
        T/D/G/Gst chains, the outer residual and the solution
        updates all stay in the solver dtype, so reduced precision
        only perturbs M, never the converged answer."""
        ops = self.ops
        ainv1 = self._ainv_diag(self.cfg.schur_ainv, Acoeffs, diagA)
        ainv2 = self._ainv_diag(self.cfg.upper_ainv, Acoeffs, diagA)
        if pre is not None and ainv1 is None and ainv2 is None:
            pdt = pre["dtype"]
            rv = tuple(x.astype(pdt) for x in r["v"])
            vstar16 = self._solve_momentum(
                rv, pre["Acoeffs"], pre["diagA"],
                applyA=pre["applyA"],
            )
            vstar = tuple(
                x.astype(self.dtype) for x in vstar16
            )
            Tv = ops.apply_T(vstar)
            Ustar = tuple(
                r["U"][d] + Tv[d] for d in range(ops.dim)
            )
            rp = r["p"] - ops.apply_D(Ustar)
            if self.cfg.precond_scope == "mom":
                p = self._solve_schur(rp, ainv1=None)
            else:
                p = self._solve_schur(
                    rp.astype(pdt), ainv1=None, mg=pre["mg"]
                ).astype(self.dtype)
            Gstp = ops.apply_Gst(p)
            Gp = ops.apply_G(p)
            v = tuple(vstar[c] - Gp[c] for c in range(ops.dim))
            U = tuple(
                Ustar[d] - Gstp[d] for d in range(ops.dim)
            )
            return {"v": v, "U": U, "p": p}
        vstar = self._solve_momentum(r["v"], Acoeffs, diagA)
        Tv = ops.apply_T(vstar)
        Ustar = tuple(r["U"][d] + Tv[d] for d in range(ops.dim))
        # rhs for Schur: contrhs - D U*
        rp = r["p"] - ops.apply_D(Ustar)
        p = self._solve_schur(rp, ainv1=ainv1)
        Gp = ops.apply_G(p)
        if ainv2 is None:
            # Atilde2 = I: -T G p + R p = -Gst p exactly (R = TG -
            # Gst), so the U back-substitution collapses to one
            # banded sweep instead of the T-G chain plus R
            Gstp = ops.apply_Gst(p)
            v = tuple(vstar[c] - Gp[c] for c in range(ops.dim))
            U = tuple(
                Ustar[d] - Gstp[d] for d in range(ops.dim)
            )
            return {"v": v, "U": U, "p": p}
        Gp2 = tuple(ainv2[c] * Gp[c] for c in range(ops.dim))
        # U update: U* - (T Atilde2^-1 G - R) p, with R = T G - Gst
        TGp2 = ops.apply_T(Gp2)
        Rp = ops.apply_R(p)
        v = tuple(vstar[c] - Gp2[c] for c in range(ops.dim))
        U = tuple(
            Ustar[d] - TGp2[d] + Rp[d] for d in range(ops.dim)
        )
        return {"v": v, "U": U, "p": p}

    # -- RHS (FormFunction; cnlinearcart2d.c:2071-2171) ----------------
    def _form_rhs(self, sol0, phalf, t, is_first_step: bool):
        ops = self.ops
        dim = ops.dim
        dt, rho, mu = self.dt, self.rho, self.mu
        v0 = sol0["v"]
        s_visc = 0.5 * mu * dt / rho
        s_g = dt / rho

        if is_first_step:
            q, t_q = sol0["p"], t
        else:
            q, t_q = phalf, t - 0.5 * dt

        Gq = ops.apply_G(q)
        bcGq = ops.bc_G(t_q)
        Lv0 = ops.apply_L(v0)
        bcLt = ops.bc_L(t)
        bcLt1 = ops.bc_L(t + dt)
        bcC = ops.bc_C(t, t + dt)

        momrhs = tuple(
            v0[c]
            + s_visc * (Lv0[c] + bcLt[c])
            - dt * bcC[c]
            - (Gq[c] + s_g * bcGq[c])
            + s_visc * bcLt1[c]
            for c in range(dim)
        )

        # interp rhs: bcT(t+dt) + (-T)[(dt/rho)(bcG(tq)-bcG(t+dt/2))]
        #             + (dt/rho)(bcGst(tq)-bcGst(t+dt/2))
        bcT1 = ops.bc_T(t + dt)
        bcGp = ops.bc_G(t + 0.5 * dt)
        bcGstp = ops.bc_Gst(t + 0.5 * dt)
        bcGstq = ops.bc_Gst(t_q)
        dG = tuple(s_g * (bcGq[c] - bcGp[c]) for c in range(dim))
        TdG = ops.apply_T(dG)
        interprhs = tuple(
            bcT1[d] - TdG[d] + s_g * (bcGstq[d] - bcGstp[d])
            for d in range(dim)
        )

        contrhs = jnp.zeros(self.mesh.cell_shape, self.dtype)
        return {"v": momrhs, "U": interprhs, "p": contrhs}

    # -- one time step -------------------------------------------------
    def _step_impl(self, state, t, is_first_step: bool):
        ops = self.ops
        dim = ops.dim
        state = self._constrain(state)
        sol0 = state
        U0 = sol0["U"]

        # v0interp = B v0 + bcB(t)   (cnlinearcart2d.c:1947-1957)
        Bv0 = ops.apply_B(sol0["v"])
        bcB = ops.bc_B(t)
        v0f = tuple(
            tuple(Bv0[d][c] + bcB[d][c] for c in range(dim))
            for d in range(dim)
        )

        rhs = self._form_rhs(sol0, state["phalf"], t, is_first_step)
        if self.body_force is not None:
            f = self.body_force(sol0, t)
            rhs["v"] = tuple(
                rhs["v"][c] + self.dt * f[c] for c in range(dim)
            )
        diagA = ops.diag_A(U0, v0f)
        Acoeffs = ops.build_momentum_coeffs(U0, v0f)
        pre = self._precond_ctx(Acoeffs, diagA)

        if self.cfg.solve_type == "fsm":
            # classical fractional-step: one ABF application IS the
            # solve (Atilde = I, THEORY_GUIDE.md:320-349); report the
            # coupled residual for diagnostics
            x = self._abf_apply(rhs, Acoeffs, diagA, pre)
            r = tree_sub(rhs, self._coupled_apply(x, Acoeffs))
            res = type("R", (), {})()
            res.x = x
            res.rnorm = tree_norm(r)
            res.iters = jnp.array(1, jnp.int32)
            res.converged = jnp.isfinite(res.rnorm)
        elif self.cfg.outer_type == "gcr":
            # fixed-budget flexible GCR: FGMRES-equivalent residual
            # minimization without the ravel/basis/Givens machinery
            # (see solvers.krylov.gcr). Robust at any CFL, unlike the
            # richardson outer.
            res = gcr(
                lambda x: self._coupled_apply(x, Acoeffs),
                rhs,
                maxiter=self.cfg.maxiter,
                M=lambda r: self._abf_apply(r, Acoeffs, diagA, pre),
            )
            res.converged = jnp.logical_and(
                res.converged, jnp.isfinite(jnp.sum(res.x["p"]))
            )
        elif (
            self.cfg.outer_type == "richardson"
            and self.cfg.converged_skip
        ):
            # fixed-budget Richardson outer: maxiter iterations of
            # x += M(rhs - A x) with the ABF preconditioner M — the
            # iterated pressure-correction scheme. Exactly one coupled
            # apply + one ABF application per iteration; no state
            # ravels, no Gram-Schmidt, no basis buffers.
            x = self._abf_apply(rhs, Acoeffs, diagA, pre)
            rlast = rhs
            for _ in range(self.cfg.maxiter - 1):
                rlast = tree_sub(
                    rhs, self._coupled_apply(x, Acoeffs)
                )
                x = tree_add(
                    x, self._abf_apply(rlast, Acoeffs, diagA, pre)
                )
            res = type("R", (), {})()
            res.x = x
            # rnorm: coupled residual BEFORE the last correction (one
            # reduction; avoids an extra coupled apply purely for
            # diagnostics). For maxiter == 1 this is |rhs|.
            res.rnorm = tree_norm(rlast)
            res.iters = jnp.array(self.cfg.maxiter, jnp.int32)
            # rlast pre-dates the final correction, so probe the final
            # iterate too (sum turns any NaN/inf into a non-finite
            # scalar) — divergence is flagged in the step it happens
            res.converged = jnp.logical_and(
                jnp.isfinite(res.rnorm),
                jnp.isfinite(jnp.sum(x["p"])),
            )
        else:
            x0 = None
            if self.cfg.warm_start:
                x0 = {
                    "v": sol0["v"],
                    "U": sol0["U"],
                    "p": jnp.zeros_like(sol0["p"]),
                }
            res = fgmres(
                lambda x: self._coupled_apply(x, Acoeffs),
                rhs,
                x0=x0,
                rtol=self.cfg.rtol,
                restart=self.cfg.restart,
                maxiter=self.cfg.maxiter,
                M=lambda r: self._abf_apply(r, Acoeffs, diagA, pre),
            )
        x = res.x
        dp = self._project_p(x["p"])

        if is_first_step:
            p_new = sol0["p"] + 2.0 * dp
            phalf_new = sol0["p"] + dp
        else:
            p_new = state["phalf"] + 1.5 * dp
            phalf_new = state["phalf"] + dp

        new_state = self._constrain({
            "v": x["v"],
            "U": x["U"],
            "p": p_new,
            "phalf": phalf_new,
        })
        converged = (
            jnp.isfinite(res.rnorm)
            if self.cfg.converged_skip
            else res.converged
        )
        diag = {
            "ksp_iters": res.iters,
            "ksp_rnorm": res.rnorm,
            "converged": converged,
        }
        if self.cfg.diag_rhs_norm:
            diag["rhs_norm"] = tree_norm(rhs)
        return new_state, diag

    # -- full-grid coefficient tables as runtime arguments ------------
    # The O(N^3) coefficient fields (Jacobi diagonals, MG volumes /
    # inverse diagonals, the dense coarse pinv) must reach the
    # compiled step as PARAMETERS, not as closure constants: embedded
    # as dense HLO constants they serialize ~50 MB at 128^3 and
    # >1.5 GB at 512x256x256 into every compiled program. The tables
    # are swapped to tracers for the duration of the trace, so every
    # attr read inside _step_impl consumes the jit argument.
    # Engage only when the tables are actually large (>= ~16 MB,
    # i.e. 3-D production grids): below that the embedded-constant
    # path is cheap, and the small-grid CPU test matrix keeps its
    # long-proven compiled artifacts bit-for-bit.
    _TABLE_PARAM_BYTES = 16 << 20

    def _big_tables(self):
        mg_tabs = [
            (lvl.vol, lvl.cellvol, lvl.inv_diag)
            for lvl in self.mg.levels
        ]
        out = {
            "diag_L": tuple(self.ops.diag_L),
            "mg": mg_tabs,
            "pinv": getattr(self.mg, "_coarse_pinv", None),
        }
        if self._pre16 is not None and self._pre16["mg"] is not None:
            mg16 = self._pre16["mg"]
            out["mg16"] = [
                (lvl.vol, lvl.cellvol, lvl.inv_diag)
                for lvl in mg16.levels
            ]
            out["pinv16"] = getattr(mg16, "_coarse_pinv", None)
        return out

    @staticmethod
    def _donate():
        """Donate the state into the step on every backend except the
        CPU. On the CPU backend, donation of the sharded state (8
        virtual devices) triggers latent heap corruption inside XLA
        (glibc MALLOC_CHECK_=3 flags 'corrupted size vs. prev_size'
        right after a donated cavity solve; downstream compiles then
        NaN or abort depending on heap layout — reproduced on jax
        0.9.0). CPU runs are the f64 test matrix where memory is
        ample, so donation buys nothing there anyway.
        """
        return () if jax.default_backend() == "cpu" else (0,)

    def _tables_as_params(self) -> bool:
        import jax.tree_util as jtu

        return sum(
            x.size * x.dtype.itemsize
            for x in jtu.tree_leaves(self._big_tables())
        ) >= self._TABLE_PARAM_BYTES

    def _set_big_tables(self, tabs):
        old = self._big_tables()
        self.ops.diag_L = tuple(tabs["diag_L"])
        for lvl, (v, cv, idg) in zip(self.mg.levels, tabs["mg"]):
            lvl.vol, lvl.cellvol, lvl.inv_diag = v, cv, idg
        if tabs["pinv"] is not None:
            self.mg._coarse_pinv = tabs["pinv"]
        if (
            self._pre16 is not None
            and self._pre16["mg"] is not None
            and "mg16" in tabs
        ):
            mg16 = self._pre16["mg"]
            for lvl, (v, cv, idg) in zip(mg16.levels, tabs["mg16"]):
                lvl.vol, lvl.cellvol, lvl.inv_diag = v, cv, idg
            if tabs.get("pinv16") is not None:
                mg16._coarse_pinv = tabs["pinv16"]
        return old

    def _traced_step(self, state, t, tabs, is_first):
        old = self._set_big_tables(tabs)
        try:
            return self._step_impl(state, t, is_first_step=is_first)
        finally:
            self._set_big_tables(old)

    def step(self, state, t, step_index: int):
        """Jitted single step; two compiled variants (first step uses
        q = p0, later steps q = phalf)."""
        is_first = step_index == 0
        # build reduced-precision twins EAGERLY (host side) so their
        # tables enter _big_tables before the trace
        self._pre_resources()
        t = jnp.asarray(t, self.dtype)
        if not self._tables_as_params():
            if is_first not in self._step_jit:
                self._step_jit[is_first] = jax.jit(
                    partial(self._step_impl, is_first_step=is_first),
                    donate_argnums=self._donate(),
                )
            return self._step_jit[is_first](state, t)
        if is_first not in self._step_jit:
            self._step_jit[is_first] = jax.jit(
                partial(self._traced_step, is_first=is_first),
                donate_argnums=self._donate(),
            )
        return self._step_jit[is_first](state, t, self._big_tables())

    def multi_step(self, state, t, n: int):
        """Production fast path: n non-first steps fused into one XLA
        program via lax.scan (no host round-trip per step). Returns
        (state, diag-of-last-step with worst-case rnorm/min
        convergence across the batch)."""
        self._pre_resources()  # before _big_tables (see step())
        if "scan" not in self._step_jit:
            as_params = self._tables_as_params()

            def run(state, t0, tabs, n):
                def body(carry, _):
                    st, tt = carry
                    if as_params:
                        new, diag = self._traced_step(
                            st, tt, tabs, is_first=False
                        )
                    else:
                        new, diag = self._step_impl(
                            st, tt, is_first_step=False
                        )
                    return (new, tt + self.dt), (
                        diag["ksp_iters"],
                        diag["ksp_rnorm"],
                        diag["converged"],
                    )

                (state, _), (its, rn, conv) = jax.lax.scan(
                    body, (state, t0), None, length=n
                )
                return state, {
                    "ksp_iters": its[-1],
                    "ksp_rnorm": jnp.max(rn),
                    "converged": jnp.all(conv),
                }

            self._step_jit["scan"] = jax.jit(
                run, static_argnums=(3,),
                donate_argnums=self._donate(),
            )
        t = jnp.asarray(t, self.dtype)
        tabs = (
            self._big_tables() if self._tables_as_params() else None
        )
        return self._step_jit["scan"](state, t, tabs, int(n))
