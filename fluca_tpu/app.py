"""Demo application: options-driven lid-driven cavity solver.

Reference: fluca/app/main.c — builds Mesh+NS from the options
database, optional mesh/solution restart from file, solves, writes
output. Run e.g.:

  python -m fluca_tpu.app -cart_grid_x 64 -cart_grid_y 64 \
      -ns_density 400 -ns_viscosity 1 -ns_time_step_size 0.002 \
      -ns_max_steps 1000 -ns_monitor \
      -ns_view_solution out.cgns -checkpoint ck_dir
"""

from __future__ import annotations

import sys

import fluca_tpu
from fluca_tpu.mesh.cart import CartMesh
from fluca_tpu.ns.bc import BCType, BoundaryCondition, zero_velocity_bc
from fluca_tpu.ns.monitor import monitor_default
from fluca_tpu.ns.ns import NS
from fluca_tpu.utils import config
from fluca_tpu.utils.options import global_options


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> NS:
    """Build, solve and write out the case the options describe;
    returns the solved NS object."""
    argv = sys.argv[1:] if argv is None else argv
    fluca_tpu.initialize(argv)
    config.use_compile_cache()
    opts = global_options()

    # mesh from options or from a CGNS file (main.c:36-48)
    if opts.has("mesh_cart_create_from_file"):
        from fluca_tpu.io.cgns import mesh_from_cgns

        mesh = mesh_from_cgns(
            opts.get_str("mesh_cart_create_from_file")
        )
    else:
        mesh = CartMesh.from_options(opts)

    wall = zero_velocity_bc()
    lid = BoundaryCondition(
        BCType.VELOCITY,
        velocity=lambda t, xs: tuple(
            (1.0 + 0.0 * xs[0]) if c == 0 else 0.0 * xs[0]
            for c in range(mesh.dim)
        ),
    )
    bcs = [wall] * (2 * mesh.dim)
    bcs[3] = lid  # moving top lid (main.c:52-66)

    ns = NS(
        mesh,
        rho=400.0,
        mu=1.0,
        dt=0.002,
        max_steps=1000,
        bcs=bcs,
        options=opts,
    )
    ns.set_from_options()
    ns.setup()

    # domain decomposition over the available devices (the reference's
    # mpiexec -n N x -cart_ranks_* path): -parallel_grid auto | 2x4
    if opts.has("parallel_grid"):
        spec = opts.get_str("parallel_grid")
        shape = (
            None if spec in ("", "auto", "true")
            else tuple(int(x) for x in spec.split("x"))
        )
        ns.shard(shape=shape)
        import jax

        print(
            f"parallel: {len(jax.devices())} devices, grid "
            f"{dict(zip(ns.device_grid.axis_names, ns.device_grid.mesh.devices.shape))}"
        )

    if opts.has("load_checkpoint"):
        from fluca_tpu.io.checkpoint import load_checkpoint

        load_checkpoint(opts.get_str("load_checkpoint"), ns)

    # solution restart from CGNS (main.c:84-88): restores all fields
    # incl. phalf plus step/time metadata
    if opts.has("ns_load_solution_from_file"):
        from fluca_tpu.io.cgns import load_solution_cgns

        load_solution_cgns(
            opts.get_str("ns_load_solution_from_file"), ns
        )

    from fluca_tpu.io.viewer import AsciiViewer, create_viewer_from_options
    from fluca_tpu.ns.monitor import set_monitors_from_options

    set_monitors_from_options(
        ns, opts,
        writer_factory=lambda: create_viewer_from_options(
            opts, "ns_monitor_solution_viewer", mesh=mesh
        ) or AsciiViewer(),
    )

    reason = ns.solve()
    print(f"done: {reason.name} at step {ns.step_index}, t={ns.t:g}")

    if opts.has("checkpoint"):
        from fluca_tpu.io.checkpoint import save_checkpoint

        save_checkpoint(opts.get_str("checkpoint"), ns)
    if opts.sub("ns_").has("view_solution"):
        from fluca_tpu.io.cgns import CGNSWriter

        with CGNSWriter(
            opts.sub("ns_").get_str("view_solution"), mesh
        ) as w:
            w.write_solution(ns)
    # -log_view: PETSc-style event summary at exit (reference wires
    # this through PetscLogView, fluca/src/ns/interface/nspkg.c:30-34)
    if opts.get_bool("log_view", False):
        from fluca_tpu.utils.profiling import global_log

        print(global_log.view())
    return ns


if __name__ == "__main__":
    sys.exit(main())
