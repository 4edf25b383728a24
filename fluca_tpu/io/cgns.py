"""CGNS-compatible output (HDF5 flavor) + reader.

JAX-side equivalent of the reference's ``flucacgns`` viewer
(fluca/src/viewer/impl/flucacgns/flucacgns.c) and the Cartesian mesh
CGNS write/load (fluca/src/mesh/impl/cart/cartcgns.c): structured
zone with vertex coordinates, cell-centered ``FlowSolution<step>``
nodes, time-series metadata (BaseIterativeData/TimeValues +
ZoneIterativeData/FlowSolutionPointers, flucacgns.c:29-60), and batch
rollover to ``%d``-templated filenames after ``batch_size`` steps
(flucacgns.c:104-115).

Files follow the CGNS/SIDS-to-HDF5 mapping so ParaView & friends can
read them: every CGNS node is an HDF5 group with 33-byte ``name`` /
``label`` attributes, a ``type`` attribute ('MT','I4','R4','R8','C1')
and a `` data`` dataset holding the node value (Fortran-ordered for
arrays). Face-centered fields (the reference's UserDefinedData
"IFaceCenteredSolution" etc., cartcgns.c:355-379) are stored as
UserDefinedData_t nodes the same way.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import h5py

    HAVE_H5PY = True
except Exception:  # pragma: no cover
    HAVE_H5PY = False


def _require_h5py():
    if not HAVE_H5PY:
        raise RuntimeError("h5py is required for CGNS output")


def _set_node_attrs(g, name: str, label: str, dtype_code: str):
    # fixed-size string attributes (33/3 bytes, null-padded) exactly
    # as the ADF-to-HDF5 mapping specifies; np.bytes_ alone strips
    # trailing NULs and would shrink the attribute type
    g.attrs.create("name", np.bytes_(name[:32]), dtype="S33")
    g.attrs.create("label", np.bytes_(label[:32]), dtype="S33")
    g.attrs.create("type", np.bytes_(dtype_code[:2]), dtype="S3")
    g.attrs.create("flags", np.array([1], dtype=np.int32))


def _node(parent, name, label, data=None, dtype_code=None):
    g = parent.create_group(name)
    if data is None:
        _set_node_attrs(g, name, label, "MT")
    else:
        data = np.asarray(data)
        if dtype_code is None:
            dtype_code = {
                np.dtype(np.int32): "I4",
                np.dtype(np.int64): "I8",
                np.dtype(np.float32): "R4",
                np.dtype(np.float64): "R8",
            }.get(data.dtype, "C1")
        _set_node_attrs(g, name, label, dtype_code)
        # CGNS/HDF5 stores Fortran order: transpose so the data reads
        # back with CGNS axis conventions
        g.create_dataset(" data", data=data.T if data.ndim > 1 else data)
    return g


def _string_node(parent, name, label, s: str):
    data = np.frombuffer(s.encode(), dtype=np.uint8).astype(np.int8)
    g = parent.create_group(name)
    _set_node_attrs(g, name, label, "C1")
    g.create_dataset(" data", data=data)
    return g


def _empty_field_node(parent, name, label, global_shape):
    """R8 DataArray node with a full-shape dataset and NO data — the
    collective-create step of the hyperslab write protocol (the
    reference's cgp_field_write, which creates the field metadata
    before any rank writes data, flucacgns.c:241)."""
    g = parent.create_group(name)
    _set_node_attrs(g, name, label, "R8")
    # Fortran (reversed-dims) order, matching _node's data.T layout
    g.create_dataset(
        " data", shape=tuple(reversed(global_shape)), dtype=np.float64
    )
    return g


class CGNSWriter:
    """Time-series CGNS writer with batch rollover.

    ``filename`` may contain ``%d`` — required when ``batch_size`` is
    set, in which case a new file is started every ``batch_size``
    output steps (reference PetscViewerFlucaCGNSOpen semantics,
    flucacgns.c:230-241)."""

    def __init__(self, filename: str, mesh, batch_size: int | None = None):
        _require_h5py()
        if batch_size is not None and "%d" not in filename:
            raise ValueError(
                "batch_size requires a %d-templated filename "
                "(flucacgns.c:142-152)"
            )
        self.filename = filename
        self.mesh = mesh
        self.batch_size = batch_size
        self._file = None
        self._batch_index = 0
        self._steps: list[int] = []
        self._times: list[float] = []
        self._n_in_batch = 0
        # multi-process hyperslab mode (see _write_solution_multiproc)
        self._mp_started = False

    # -- file lifecycle ------------------------------------------------
    def _current_name(self) -> str:
        if "%d" in self.filename:
            return self.filename % self._batch_index
        return self.filename

    def _open(self):
        f = h5py.File(self._current_name(), "w")
        # root metadata (CGNS-HDF5 required nodes)
        f.attrs.create("name", np.bytes_("HDF5 MotherNode"),
                       dtype="S33")
        f.attrs.create("label", np.bytes_("Root Node of HDF5 File"),
                       dtype="S33")
        f.attrs.create("type", np.bytes_("MT"), dtype="S3")
        f.create_dataset(
            " format", data=np.frombuffer(b"IEEE_LITTLE_32", dtype=np.uint8).astype(np.int8)
        )
        f.create_dataset(
            " hdf5version",
            data=np.frombuffer(b"HDF5 Version 1.10".ljust(33, b"\x00"), dtype=np.uint8).astype(np.int8),
        )
        _node(f, "CGNSLibraryVersion", "CGNSLibraryVersion_t",
              np.array([3.3], dtype=np.float32))
        mesh = self.mesh
        dim = mesh.dim
        base = _node(f, "Base", "CGNSBase_t",
                     np.array([dim, dim], dtype=np.int32))
        nverts = [mesh.N[d] + 1 for d in range(dim)]
        ncells = [mesh.N[d] for d in range(dim)]
        zsize = np.array(
            [nverts, ncells, [0] * dim], dtype=np.int32
        )
        zone = _node(base, "Zone", "Zone_t", zsize.T)
        _string_node(zone, "ZoneType", "ZoneType_t", "Structured")
        gc = _node(zone, "GridCoordinates", "GridCoordinates_t")
        names = ["CoordinateX", "CoordinateY", "CoordinateZ"]
        for d in range(dim):
            # vertex coordinates: outer product broadcast per axis
            shape = [mesh.N[a] + 1 for a in range(dim)]
            arr = np.ones(shape)
            idx = [None] * dim
            idx[d] = slice(None)
            arr = arr * mesh.faces[d][tuple(idx)]
            _node(gc, names[d], "DataArray_t", arr)
        self._file = f
        self._zone = zone
        self._base = base
        self._steps = []
        self._times = []
        self._n_in_batch = 0

    def _write_cellinfo(self, grid) -> None:
        """Per-cell owner-rank map, written once per file with the
        mesh (reference: MeshView_Cart_CGNS "CellInfo" solution node
        with an Integer "Rank" field, cartcgns.c:113-114). Rank is
        the linear index into the device grid (the GSPMD analogue of
        the MPI rank); 0 everywhere for unsharded runs."""
        if "CellInfo" in self._zone:
            return
        mesh = self.mesh
        shape = mesh.cell_shape
        if grid is None:
            rank = np.zeros(shape, np.int32)
        else:
            ext = [grid.mesh.shape[n] for n in grid.axis_names]
            dev_lin = np.arange(
                int(np.prod(ext)), dtype=np.int32
            ).reshape(ext)
            coords = []
            for a, n in enumerate(shape):
                e = ext[a] if a < grid.dim else 1
                blk = -(-n // e)  # ceil: GSPMD pads the last shard
                coords.append(
                    np.minimum(np.arange(n) // blk, e - 1)
                )
            rank = dev_lin[np.ix_(*coords[: grid.dim])]
        sol = _node(self._zone, "CellInfo", "FlowSolution_t")
        _string_node(sol, "GridLocation", "GridLocation_t",
                     "CellCenter")
        _node(sol, "Rank", "DataArray_t", rank.astype(np.int32))

    def _finalize_time_series(self):
        """BaseIterativeData + ZoneIterativeData (flucacgns.c:29-60)."""
        if self._file is None or not self._steps:
            return
        f = self._file
        bid = _node(
            self._base, "BaseIterativeData", "BaseIterativeData_t",
            np.array([len(self._steps)], dtype=np.int32),
        )
        _node(bid, "TimeValues", "DataArray_t",
              np.array(self._times, dtype=np.float64))
        zid = _node(self._zone, "ZoneIterativeData",
                    "ZoneIterativeData_t")
        ptrs = np.zeros((len(self._steps), 32), dtype=np.int8)
        for i, s in enumerate(self._steps):
            name = f"FlowSolution{s}".ljust(32)
            ptrs[i] = np.frombuffer(name.encode(), dtype=np.uint8).astype(np.int8)
        g = zid.create_group("FlowSolutionPointers")
        _set_node_attrs(g, "FlowSolutionPointers", "DataArray_t", "C1")
        g.create_dataset(" data", data=ptrs.T)

    def close(self):
        if self._mp_started:
            import jax
            from jax.experimental import multihost_utils

            if jax.process_index() == 0 and self._steps:
                with h5py.File(self._current_name(), "r+") as f:
                    self._file = f
                    self._base = f["Base"]
                    self._zone = f["Base"]["Zone"]
                    self._finalize_time_series()
                self._file = None
            if jax.process_count() > 1:
                multihost_utils.sync_global_devices("fluca_cgns_close")
            self._mp_started = False
            self._steps, self._times = [], []
            return
        if self._file is not None:
            self._finalize_time_series()
            self._file.close()
            self._file = None

    # -- solution write ------------------------------------------------
    def write_solution(self, ns) -> None:
        """One FlowSolution<step> with cell fields + face-centered
        face-normal velocity as UserDefinedData (cartcgns.c:293-401).

        In a multi-process run the write is distributed: each process
        writes only the hyperslabs its shards own (the distributed
        equivalent of the reference's collective cgp_field_write_data,
        flucacgns.c:241-242)."""
        import jax

        if jax.process_count() > 1:
            self._write_solution_multiproc(ns)
            return
        if self._file is None:
            self._open()
        elif (
            self.batch_size is not None
            and self._n_in_batch >= self.batch_size
        ):
            self.close()
            self._batch_index += 1
            self._open()

        step, t = ns.step_index, ns.t
        state = ns.state
        dim = self.mesh.dim
        self._write_cellinfo(
            getattr(getattr(ns, "impl", None), "grid", None)
        )
        sol = _node(self._zone, f"FlowSolution{step}", "FlowSolution_t")
        _string_node(sol, "GridLocation", "GridLocation_t", "CellCenter")
        comp = ["X", "Y", "Z"]
        for c in range(dim):
            _node(sol, f"Velocity{comp[c]}", "DataArray_t",
                  np.asarray(state["v"][c], dtype=np.float64))
        _node(sol, "Pressure", "DataArray_t",
              np.asarray(state["p"], dtype=np.float64))
        _node(sol, "PressureHalfStep", "DataArray_t",
              np.asarray(state["phalf"], dtype=np.float64))
        # face-normal velocity per face set (UserDefinedData_t like the
        # reference's IFaceCenteredSolution nodes)
        face_names = ["IFaceCenteredSolution", "JFaceCenteredSolution",
                      "KFaceCenteredSolution"]
        for d in range(dim):
            ud = _node(self._zone, f"{face_names[d]}{step}",
                       "UserDefinedData_t")
            _node(ud, "FaceNormalVelocity", "DataArray_t",
                  np.asarray(state["U"][d], dtype=np.float64))
        self._steps.append(step)
        self._times.append(t)
        self._n_in_batch += 1

    # -- multi-process hyperslab write ----------------------------------
    def _solution_fields(self, ns):
        """(h5 path under the zone, global array) for every solution
        field of one output step."""
        state = ns.state
        dim = self.mesh.dim
        step = ns.step_index
        comp = ["X", "Y", "Z"]
        face_names = ["IFaceCenteredSolution", "JFaceCenteredSolution",
                      "KFaceCenteredSolution"]
        fields = []
        for c in range(dim):
            fields.append(
                (f"FlowSolution{step}/Velocity{comp[c]}",
                 state["v"][c])
            )
        fields.append((f"FlowSolution{step}/Pressure", state["p"]))
        fields.append(
            (f"FlowSolution{step}/PressureHalfStep", state["phalf"])
        )
        for d in range(dim):
            fields.append(
                (f"{face_names[d]}{step}/FaceNormalVelocity",
                 state["U"][d])
            )
        return fields

    def _write_solution_multiproc(self, ns) -> None:
        """Distributed CGNS write without materializing any global
        field: process 0 creates the file structure and full-shape
        datasets (the collective-create phase), then each process in
        rank order opens the file and fills only the index ranges its
        replica-0 shards own. HDF5 access is serialized with barriers
        (plain h5py has no MPI-IO); the data movement per process is
        O(local), exactly like the reference's cgp_field_write_data
        (flucacgns.c:241-242)."""
        import jax
        from jax.experimental import multihost_utils

        pid = jax.process_index()
        step, t = ns.step_index, ns.t
        if (
            self._mp_started
            and self.batch_size is not None
            and self._n_in_batch >= self.batch_size
        ):
            self.close()
            self._batch_index += 1

        fields = self._solution_fields(ns)
        if pid == 0:
            if not self._mp_started:
                self._open()
            else:
                self._file = h5py.File(self._current_name(), "r+")
                self._zone = self._file["Base"]["Zone"]
                self._base = self._file["Base"]
            self._write_cellinfo(
                getattr(getattr(ns, "impl", None), "grid", None)
            )
            sol = _node(self._zone, f"FlowSolution{step}",
                        "FlowSolution_t")
            _string_node(sol, "GridLocation", "GridLocation_t",
                         "CellCenter")
            for d, fname in enumerate(
                ["IFaceCenteredSolution", "JFaceCenteredSolution",
                 "KFaceCenteredSolution"][: self.mesh.dim]
            ):
                _node(self._zone, f"{fname}{step}", "UserDefinedData_t")
            for path, arr in fields:
                parent_name, leaf = path.rsplit("/", 1)
                _empty_field_node(
                    self._zone[parent_name], leaf, "DataArray_t",
                    arr.shape,
                )
            self._file.close()
            self._file = None
        self._mp_started = True
        self._steps.append(step)
        self._times.append(t)
        self._n_in_batch += 1

        multihost_utils.sync_global_devices(f"fluca_cgns_create_{step}")
        for r in range(jax.process_count()):
            if r == pid:
                with h5py.File(self._current_name(), "r+") as f:
                    zone = f["Base"]["Zone"]
                    for path, arr in fields:
                        dset = zone[path][" data"]
                        for sh in arr.addressable_shards:
                            if sh.replica_id != 0:
                                continue
                            idx = tuple(
                                slice(
                                    int(s.start or 0),
                                    int(s.stop)
                                    if s.stop is not None
                                    else int(n),
                                )
                                for s, n in zip(sh.index, arr.shape)
                            )
                            data = np.asarray(sh.data).astype(
                                np.float64
                            )
                            dset[tuple(reversed(idx))] = data.T
            multihost_utils.sync_global_devices(
                f"fluca_cgns_write_{step}_{r}"
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------------
# reader (round-trip + restart; MeshLoad_Cart_CGNS / VecLoad_Cart_CGNS
# equivalents, cartcgns.c:120-158,644-758)
# ----------------------------------------------------------------------


def mesh_from_cgns(filename: str):
    """Reconstruct a CartMesh from a CGNS file's vertex coordinates
    (reference: MeshLoad_Cart_CGNS, cartcgns.c:120-158; app flag
    -mesh_cart_create_from_file, app/main.c:35-48). Periodicity is
    not stored in CGNS structured zones; defaults to non-periodic."""
    from fluca_tpu.mesh.cart import CartMesh

    data = read_cgns(filename)
    faces = data["faces"]
    N = tuple(len(f) - 1 for f in faces)
    mesh = CartMesh.create(N)
    mesh.set_coordinates(*faces)
    return mesh


def load_solution_cgns(filename: str, ns, step: int | None = None):
    """Restore solution fields + step/time from a CGNS file
    (reference: NSLoadSolution -> VecLoad_Cart_CGNS,
    nssol.c:174-204, cartcgns.c:644-758)."""
    import jax.numpy as jnp

    data = read_cgns(filename)
    steps = sorted(data["solutions"])
    assert steps, f"no FlowSolution nodes in {filename}"
    if step is None:
        step = steps[-1]
    sol = data["solutions"][step]
    dim = ns.mesh.dim
    comp = ["X", "Y", "Z"]
    for d in range(dim):
        assert sol[f"Velocity{comp[d]}"].shape == ns.mesh.cell_shape, (
            "grid size mismatch on CGNS load"
        )
    ns.setup()
    ns.set_solution(
        v=tuple(
            jnp.asarray(sol[f"Velocity{comp[d]}"], ns.dtype)
            for d in range(dim)
        ),
        U=tuple(
            jnp.asarray(data["U"][step][d], ns.dtype)
            for d in range(dim)
        ),
        p=jnp.asarray(sol["Pressure"], ns.dtype),
        phalf=jnp.asarray(sol["PressureHalfStep"], ns.dtype),
    )
    ns.step_index = int(step)
    if "times" in data:
        idx = steps.index(step)
        ns.t = float(data["times"][idx])
    return ns


def read_cgns(filename: str) -> dict:
    """Read mesh + all solutions from one CGNS-HDF5 file."""
    _require_h5py()
    out: dict = {"solutions": {}, "faces": [], "U": {}}
    with h5py.File(filename, "r") as f:
        base = f["Base"]
        celldim = int(base[" data"][0])
        zone = base["Zone"]
        gc = zone["GridCoordinates"]
        names = ["CoordinateX", "CoordinateY", "CoordinateZ"]
        for d in range(celldim):
            arr = np.asarray(gc[names[d]][" data"])
            arr = arr.T if arr.ndim > 1 else arr
            idx = [0] * celldim
            idx[d] = slice(None)
            out["faces"].append(np.asarray(arr[tuple(idx)]))
        for key in zone:
            if key.startswith("FlowSolution") and key != "FlowSolutionPointers":
                step = int(key[len("FlowSolution"):])
                sol = {}
                for fname in zone[key]:
                    if fname in ("GridLocation",):
                        continue
                    data = np.asarray(zone[key][fname][" data"])
                    sol[fname] = data.T if data.ndim > 1 else data
                out["solutions"][step] = sol
            for pfx, d in (("IFaceCenteredSolution", 0),
                           ("JFaceCenteredSolution", 1),
                           ("KFaceCenteredSolution", 2)):
                if key.startswith(pfx):
                    step = int(key[len(pfx):])
                    data = np.asarray(
                        zone[key]["FaceNormalVelocity"][" data"]
                    )
                    out["U"].setdefault(step, {})[d] = (
                        data.T if data.ndim > 1 else data
                    )
        if "BaseIterativeData" in base:
            out["times"] = np.asarray(
                base["BaseIterativeData"]["TimeValues"][" data"]
            )
    return out
