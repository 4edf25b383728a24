"""Checkpoint / restart.

The reference uses CGNS as both visualization and checkpoint format,
writing all solution fields plus the pressure-extrapolation state
``phalf`` ("PressureHalfStep") and step/time metadata, and restoring
them on restart (fluca/src/ns/interface/nssol.c:130-204,
fluca/src/ns/impl/linearcn/cnlinear.c:146-162). Here the fast
checkpoint path is a plain npz + JSON bundle with bit-exact
round-trip of every field (restart continuity: the pressure
extrapolation continues exactly, cnlinearcart2d.c:1969-1980);
CGNS export (fluca_tpu.io.cgns) covers tool compatibility.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _named_fields(state) -> dict:
    out = {"p": state["p"], "phalf": state["phalf"]}
    for c, a in enumerate(state["v"]):
        out[f"v{c}"] = a
    for d, a in enumerate(state["U"]):
        out[f"U{d}"] = a
    return out


def _grid_meta(ns) -> dict:
    return {
        "step": ns.step_index,
        "time": ns.t,
        "dt": ns.dt,
        "rho": ns.rho,
        "mu": ns.mu,
        "dim": ns.mesh.dim,
        "N": list(ns.mesh.N),
        "periodic": list(ns.mesh.periodic),
        "faces": [f.tolist() for f in ns.mesh.faces],
    }


def save_checkpoint(path: str, ns) -> None:
    """Write state + metadata. ``path`` is a directory. Large fields
    stream through the native fastio engine (fluca_tpu.native) when
    available, falling back to npz. In a multi-process run (or when
    the state is not fully addressable) each process writes only its
    own shards plus a per-process manifest — the JAX equivalent
    of the reference's collective MPI-IO writes (cgp_*_write_data,
    flucacgns.c:241-242); no process ever needs to address the whole
    array."""
    import jax

    multiproc = jax.process_count() > 1 or any(
        hasattr(leaf, "is_fully_addressable")
        and not leaf.is_fully_addressable
        for leaf in jax.tree_util.tree_leaves(ns.state)
    )
    if multiproc:
        _save_checkpoint_sharded(path, ns)
        return

    os.makedirs(path, exist_ok=True)
    state = ns.state
    arrays = {
        name: np.asarray(a) for name, a in _named_fields(state).items()
    }

    from fluca_tpu import native

    used_native = True
    array_meta = {}
    for name, a in arrays.items():
        array_meta[name] = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if not native.write_array(
            os.path.join(path, f"{name}.bin"), a
        ):
            used_native = False
            break
    if not used_native:
        np.savez(os.path.join(path, "fields.npz"), **arrays)
    meta = {
        "format": "native" if used_native else "npz",
        "arrays": array_meta,
        **_grid_meta(ns),
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def _save_checkpoint_sharded(path: str, ns) -> None:
    """Per-shard write + manifest: each process writes the shards it
    owns (replica 0 only) and a manifest.p<pid>.json recording their
    global index ranges; process 0 writes meta.json. A barrier at the
    end makes the checkpoint complete when any process returns."""
    import jax

    os.makedirs(path, exist_ok=True)
    pid = jax.process_index()
    records: dict = {}
    array_meta: dict = {}
    for name, arr in _named_fields(ns.state).items():
        arr = jax.numpy.asarray(arr)
        array_meta[name] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype)
        }
        for sh in arr.addressable_shards:
            if sh.replica_id != 0:
                continue
            start = [int(s.start or 0) for s in sh.index]
            stop = [
                int(s.stop) if s.stop is not None else int(dim)
                for s, dim in zip(sh.index, arr.shape)
            ]
            fname = (
                f"{name}.shard_" + "_".join(map(str, start)) + ".npy"
            )
            np.save(os.path.join(path, fname), np.asarray(sh.data))
            records.setdefault(name, []).append(
                {"file": fname, "start": start, "stop": stop}
            )
    with open(
        os.path.join(path, f"manifest.p{pid}.json"), "w"
    ) as fh:
        json.dump(records, fh)
    if pid == 0:
        meta = {
            "format": "sharded",
            "nprocs": jax.process_count(),
            "arrays": array_meta,
            **_grid_meta(ns),
        }
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("fluca_checkpoint_save")


class _ShardedReader:
    """Hyperslab reads from a sharded checkpoint: ``read(name, idx)``
    returns the global index range ``idx`` of field ``name``, touching
    only the overlapping shard files and only the overlapping byte
    ranges within them (numpy mmap partial reads). This is the
    per-rank-hyperslab read of the reference's collective CGNS load
    (cartcgns.c:644-758) — no process ever materializes a global
    field. ``nbytes_read`` counts the logical bytes copied (for the
    locality assertion in tests)."""

    def __init__(self, path: str, meta: dict):
        import glob

        self.path = path
        self.meta = meta
        self.records: dict = {}
        for mpath in sorted(
            glob.glob(os.path.join(path, "manifest.p*.json"))
        ):
            with open(mpath) as fh:
                for name, recs in json.load(fh).items():
                    self.records.setdefault(name, []).extend(recs)
        self.nbytes_read = 0

    def read(self, name: str, idx) -> np.ndarray:
        am = self.meta["arrays"][name]
        dtype = np.dtype(am["dtype"])
        shape = tuple(s.stop - s.start for s in idx)
        out = np.empty(shape, dtype)
        filled = 0
        for rec in self.records.get(name, ()):
            inter = []
            for s, a, b in zip(idx, rec["start"], rec["stop"]):
                lo, hi = max(s.start, a), min(s.stop, b)
                if lo >= hi:
                    break
                inter.append((lo, hi, a, s.start))
            else:
                src = np.load(
                    os.path.join(self.path, rec["file"]), mmap_mode="r"
                )
                src_sl = tuple(
                    slice(lo - a, hi - a) for lo, hi, a, _ in inter
                )
                dst_sl = tuple(
                    slice(lo - o, hi - o) for lo, hi, _, o in inter
                )
                out[dst_sl] = src[src_sl]
                n = int(np.prod([hi - lo for lo, hi, _, _ in inter]))
                filled += n
                self.nbytes_read += n * dtype.itemsize
        assert filled >= int(np.prod(shape)), (
            f"sharded checkpoint incomplete for {name!r} range {idx}"
        )
        return out

    def read_full(self, name: str) -> np.ndarray:
        shape = self.meta["arrays"][name]["shape"]
        return self.read(name, tuple(slice(0, n) for n in shape))


def _load_sharded_arrays(path: str, meta: dict) -> dict:
    reader = _ShardedReader(path, meta)
    return {name: reader.read_full(name) for name in meta["arrays"]}


def _load_sharded_distributed(path: str, meta: dict, ns):
    """Shard-local load: each device's block is read directly from the
    overlapping shard files via ``jax.make_array_from_callback`` — a
    process only reads (and only holds) the index ranges its devices
    own, matching the reference's per-rank hyperslab VecLoad
    (cartcgns.c:644-758). Returns ({name: jax.Array}, reader)."""
    import jax

    from fluca_tpu.parallel.mesh import _divisible_sharding

    grid = ns.device_grid
    reader = _ShardedReader(path, meta)

    def template(name):
        if name in ("p", "phalf"):
            return ns.state[name]
        if name.startswith("v"):
            return ns.state["v"][int(name[1:])]
        return ns.state["U"][int(name[1:])]

    out = {}
    for name, am in meta["arrays"].items():
        shape = tuple(am["shape"])
        sharding = _divisible_sharding(grid, template(name))
        dtype = template(name).dtype

        def cb(idx, name=name, shape=shape, dtype=dtype):
            full = tuple(
                slice(
                    int(s.start or 0),
                    int(s.stop) if s.stop is not None else int(n),
                )
                for s, n in zip(idx, shape)
            )
            return reader.read(name, full).astype(dtype)

        out[name] = jax.make_array_from_callback(shape, sharding, cb)
    return out, reader


def load_checkpoint(path: str, ns) -> None:
    """Restore state + step/time into an already set-up NS object,
    verifying grid compatibility (the reference checks sizes on load,
    cartcgns.c:644-758)."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    assert list(ns.mesh.N) == meta["N"], (
        f"grid size mismatch: {ns.mesh.N} vs {meta['N']}"
    )
    assert list(ns.mesh.periodic) == meta["periodic"]
    if meta.get("format") == "sharded":
        if ns.device_grid is not None:
            ns.setup()
            data, _ = _load_sharded_distributed(path, meta, ns)
        else:
            data = _load_sharded_arrays(path, meta)
    elif meta.get("format") == "native":
        from fluca_tpu import native

        data = {}
        for name, am in meta["arrays"].items():
            arr = native.read_array(
                os.path.join(path, f"{name}.bin"),
                tuple(am["shape"]), np.dtype(am["dtype"]),
            )
            if arr is None:  # toolchain missing at load time
                raise IOError("native checkpoint requires fastio")
            data[name] = arr
    else:
        data = np.load(os.path.join(path, "fields.npz"))
    import jax.numpy as jnp

    dim = ns.mesh.dim
    ns.setup()
    # cast to the solver dtype: a checkpoint written at one precision
    # restarts at another (bitwise round-trip is preserved when the
    # dtypes match — the cast is a no-op then)
    dt_ = ns.dtype
    ns.set_solution(
        v=tuple(jnp.asarray(data[f"v{c}"], dt_) for c in range(dim)),
        U=tuple(jnp.asarray(data[f"U{d}"], dt_) for d in range(dim)),
        p=jnp.asarray(data["p"], dt_),
        phalf=jnp.asarray(data["phalf"], dt_),
    )
    ns.step_index = int(meta["step"])
    ns.t = float(meta["time"])
