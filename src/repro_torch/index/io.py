"""Sharded on-disk index format + index-state flattening, byte-compatible
with the reference's ``repro.index.io``: the same array files (``.npy`` at
the reference's dtypes), the same ``manifest.json`` and the same CRCs, so a
directory written by either package restores in the other.

Two layers:

* **State flattening** — ``index_state`` / ``index_from_state`` turn an
  index object (``RNSGGraph`` / ``RNSGIndex`` incl. installed quantized
  corpora / ``StreamingRFANN`` incl. tombstone + delta segment state) into
  a flat ``{key: ndarray}`` tree of host numpy arrays plus a JSON-able
  manifest, and back onto an explicit ``device``.
* **Directory format** — ``save_index`` / ``load_index``: one ``.npy``
  file per array (row-sharded into ``shards`` pieces for the big
  row-dimension arrays), plus ``manifest.json``.  Restore mmaps
  single-file arrays (copy-on-write, so they reach the device with one
  copy) and fills sharded ones with parallel reads, so serving a prebuilt
  index starts in seconds instead of a rebuild.

Crash safety: every array file is written tmp→fsync→``os.replace``, and
``manifest.json`` is written **last** (same atomic idiom) — a reader sees
either the previous complete generation or the new one, never a torn mix.
Array files carry a generation counter in their names so an interrupted
save can never overwrite files the current manifest still references;
superseded generations are garbage-collected after the manifest commits.

bf16 quantized corpora are stored as their exact f32 upcast and
re-narrowed on restore — bf16→f32→bf16 round-trips bit-exactly.
"""
from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

MANIFEST = "manifest.json"
SCHEMA = 1


class IndexCorruptionError(RuntimeError):
    """A saved index file failed validation (truncated, checksum-mangled,
    or shape-mismatched).  Raised with the offending file and the manifest
    generation named, instead of propagating a raw numpy/mmap error."""


def fsync_dir(path) -> None:
    """fsync a *directory* so a rename/create just committed inside it
    survives power failure.  ``tmp → fsync(file) → os.replace`` makes the
    file contents durable, but the new *name* lives in the directory
    inode — on most filesystems it is only guaranteed on disk after the
    directory itself is fsynced.  Shared by every atomic-save site
    (``RNSGGraph.save``, ``QueryPlanner.save_calibration``, the
    ``save_index`` array/manifest commits, and the WAL's segment
    create/rotate).  No-op where the platform refuses directory opens or
    directory fsync."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(os.fspath(path), flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ----------------------------------------------------------------- state
#: numpy dtype names of the quantized corpora, as the reference's manifest
#: writes them
_QUANT_DTYPES = {torch.int8: "int8", torch.bfloat16: "bfloat16"}


def _np(t, dtype) -> np.ndarray:
    """A tensor or array as host numpy of ``dtype``."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.asarray(t, dtype)


def _quant_entries(sub) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
    """Flatten a substrate's installed quantized slots (nothing if the
    substrate was never forced)."""
    flat: Dict[str, np.ndarray] = {}
    man: Dict[str, dict] = {}
    for prec, slot in sub._quant.items():
        dtype = _QUANT_DTYPES[slot["data"].dtype]
        if dtype == "bfloat16":                 # exact upcast; see module doc
            data = _np(slot["data"].float(), np.float32)
        else:
            data = _np(slot["data"], np.int8)
        flat[f"quant/{prec}/data"] = data
        has_scale = slot["scale"] is not None
        if has_scale:
            flat[f"quant/{prec}/scale"] = _np(slot["scale"], np.float32)
        man[prec] = dict(dtype=dtype, has_scale=has_scale)
    return flat, man


def index_state(index) -> Tuple[Dict[str, np.ndarray], dict]:
    """(flat array tree, JSON-able manifest) for one index object.

    Accepts ``RNSGGraph``, ``RNSGIndex`` (quantized corpora installed on
    its substrate ride along), or ``StreamingRFANN`` (base graph arrays +
    external ids + tombstone mask + delta snapshot + id counter)."""
    from repro_torch.core.construction import RNSGGraph
    from repro_torch.core.rfann import RNSGIndex
    from repro_torch.streaming.streaming import StreamingRFANN

    if isinstance(index, StreamingRFANN):
        with index._lock:
            # view and WAL watermark must come from the same locked
            # instant: a mutation between the two reads would bump the
            # watermark past records the snapshot does not contain, and
            # recovery would then skip them (lost acknowledged writes)
            v = index._view
            wal_lsn = int(getattr(index, "applied_lsn", 0))
        sub = v.sub
        flat = {"graph/vecs": np.asarray(v.base_vecs, np.float32),
                "graph/attrs": np.asarray(v.base_attrs, np.float32),
                "graph/nbrs": _np(sub._nbrs, np.int32),
                "graph/rmq": _np(sub._rmq, np.int32),
                "graph/dist_c": _np(sub._dist_c, np.float32),
                "graph/order": np.asarray(v.base_ids, np.int32),
                "stream/base_live": np.asarray(v.base_live, bool),
                "stream/delta_vecs": np.asarray(v.delta.vecs, np.float32),
                "stream/delta_attrs": np.asarray(v.delta.attrs, np.float32),
                "stream/delta_ids": np.asarray(v.delta.ids, np.int32)}
        qflat, qman = _quant_entries(sub)
        flat.update(qflat)
        manifest = dict(
            kind="streaming", n=int(len(v.base_ids)),
            d=int(v.base_vecs.shape[1]), quant=qman,
            streaming=dict(next_id=int(index._next_id),
                           max_delta=int(index.max_delta),
                           compact_every=int(index.compact_every),
                           n_delta=int(v.delta.count),
                           n_tombstones=int(v.n_tombstones),
                           precisions=sorted(index._precisions),
                           build_kw=dict(index._build_kw),
                           # WAL replay watermark: every mutation with
                           # lsn <= wal_lsn is inside this snapshot
                           wal_lsn=wal_lsn))
        return flat, manifest

    if isinstance(index, RNSGIndex):
        g, sub = index.g, index._substrate
    elif isinstance(index, RNSGGraph):
        g, sub = index, None
    else:
        raise TypeError(f"index_state: cannot flatten {type(index).__name__}"
                        " (expected RNSGGraph, RNSGIndex or StreamingRFANN)")
    arrays = g.arrays()
    flat = {f"graph/{name}": arrays[name]
            for name in ("vecs", "attrs", "nbrs", "rmq", "dist_c", "order",
                         "centroid")}
    qman: Dict[str, dict] = {}
    if sub is not None:
        qflat, qman = _quant_entries(sub)
        flat.update(qflat)
    manifest = dict(kind="rnsg", n=int(g.n), d=int(g.vecs.shape[1]),
                    build_seconds=float(g.build_seconds),
                    meta=dict(g.meta), quant=qman)
    return flat, manifest


def index_from_state(flat: Dict[str, np.ndarray], manifest: dict, *,
                     device=None):
    """Inverse of :func:`index_state`, onto ``device`` (default the card).
    Returns an ``RNSGIndex`` for kind ``rnsg`` (``.g`` exposes the graph)
    or a ``StreamingRFANN`` for kind ``streaming``; saved quantized corpora
    are preloaded onto the substrate so the first quantized request pays
    no re-quantize."""
    dev = resolve_device(device)
    kind = manifest.get("kind")
    if kind == "rnsg":
        from repro_torch.core.construction import (ARRAY_FIELDS,
                                                   graph_from_arrays)
        from repro_torch.core.rfann import RNSGIndex
        arrays = {name: flat[f"graph/{name}"] for name in ARRAY_FIELDS}
        arrays.update(build_seconds=float(manifest.get("build_seconds", 0.0)),
                      meta=dict(manifest.get("meta", {})))
        idx = RNSGIndex(graph_from_arrays(arrays, dev))
        _preload_quant(idx.substrate, flat, manifest)
        return idx
    if kind == "streaming":
        from repro_torch.streaming.streaming import StreamingRFANN
        s = manifest["streaming"]
        stream = StreamingRFANN.from_state(
            base_vecs=flat["graph/vecs"], base_attrs=flat["graph/attrs"],
            base_ids=flat["graph/order"],
            base_live=flat["stream/base_live"],
            base_nbrs=flat["graph/nbrs"], base_rmq=flat["graph/rmq"],
            base_dist_c=flat["graph/dist_c"],
            delta_vecs=flat["stream/delta_vecs"],
            delta_attrs=flat["stream/delta_attrs"],
            delta_ids=flat["stream/delta_ids"],
            next_id=s["next_id"], max_delta=s.get("max_delta", 1024),
            compact_every=s.get("compact_every", 0),
            precisions=s.get("precisions", ()),
            build_kw=s.get("build_kw"),
            wal_lsn=s.get("wal_lsn", 0), device=dev)
        _preload_quant(stream._view.sub, flat, manifest)
        return stream
    raise ValueError(f"index_from_state: unknown index kind {kind!r}")


def _preload_quant(sub, flat, manifest) -> None:
    for prec in manifest.get("quant", {}):
        sub.preload_quantized(prec, flat[f"quant/{prec}/data"],
                              flat.get(f"quant/{prec}/scale"))


# --------------------------------------------------------------- on disk
class _CrcWriter:
    """File proxy that CRC32s everything written through it, so the
    manifest can record a checksum without re-reading the file."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, data):
        self.crc = zlib.crc32(data, self.crc)
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


def _atomic_write(path: Path, write_fn) -> int:
    """tmp → fsync(file) → rename → fsync(dir); returns the CRC32 of the
    written bytes.  The directory fsync is what makes the *rename* itself
    durable — without it a power failure can roll the directory entry
    back even though the file data reached disk."""
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            w = _CrcWriter(f)
            write_fn(w)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path.parent)
        return w.crc
    finally:
        if tmp.exists():
            tmp.unlink()


def is_index_dir(path) -> bool:
    return (Path(path) / MANIFEST).is_file()


def save_index(index, path, *, shards: int = 1) -> dict:
    """Write the sharded directory format; returns the manifest.

    Arrays whose leading axis is the corpus row dimension are split into
    ``shards`` contiguous row slabs (one file each) so restore can fill
    them with parallel reads; small/global arrays stay single-file and
    mmap on restore.  Safe to save over a live directory: the new
    generation's files never collide with the old, and the manifest swap
    is the atomic commit point."""
    flat, man = index_state(index)
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    gen = 0
    if is_index_dir(p):
        try:
            gen = int(json.loads((p / MANIFEST).read_text())
                      .get("gen", 0)) + 1
        except (ValueError, json.JSONDecodeError):
            gen = 1
    shards = max(int(shards), 1)
    n_rows = man["n"]
    arrays: Dict[str, dict] = {}
    for key, a in flat.items():
        base = key.replace("/", ".")
        row_sharded = (shards > 1 and a.ndim >= 1
                       and a.shape[0] == n_rows and n_rows >= shards)
        parts = np.array_split(a, shards) if row_sharded else [a]
        files, crcs = [], []
        for i, part in enumerate(parts):
            fn = f"{base}.g{gen}.{i:02d}.npy"
            crcs.append(_atomic_write(p / fn,
                                      lambda f, part=part: np.save(f, part)))
            files.append(fn)
        arrays[key] = dict(files=files, shape=list(a.shape),
                           dtype=str(a.dtype), crc32=crcs)
    manifest = dict(schema=SCHEMA, gen=gen, shards=shards,
                    index=man, arrays=arrays)
    blob = json.dumps(manifest, indent=1).encode()
    _atomic_write(p / MANIFEST, lambda f: f.write(blob))
    _gc_stale(p, manifest)
    return manifest


def _gc_stale(p: Path, manifest: dict) -> None:
    live = {f for am in manifest["arrays"].values() for f in am["files"]}
    for f in p.iterdir():
        name = f.name
        if name in live or name == MANIFEST:
            continue
        if ".g" in name and (name.endswith(".npy") or ".npy.tmp." in name):
            f.unlink(missing_ok=True)


def _corrupt(p: Path, fn: str, gen, why) -> IndexCorruptionError:
    return IndexCorruptionError(
        f"load_index: array file {fn} in {p} (manifest generation {gen}) "
        f"is truncated or corrupt: {why}")


def _load_checked(p: Path, fn: str, gen, *, mmap_mode=None,
                  expect_crc=None, verify=False) -> np.ndarray:
    """np.load with the raw mmap/parse errors rewritten into
    :class:`IndexCorruptionError` naming the file and generation.  When
    the manifest carries a CRC32 for the file it is verified on every
    full read, and on mmap reads too iff ``verify=True`` (a CRC pass
    forces reading all the bytes, which defeats lazy mmap)."""
    path = p / fn
    try:
        if expect_crc is not None and (verify or mmap_mode is None):
            crc = 0
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    crc = zlib.crc32(chunk, crc)
            if crc != expect_crc:
                raise _corrupt(p, fn, gen,
                               f"CRC32 mismatch (manifest {expect_crc:#010x}"
                               f", file {crc:#010x})")
        return np.load(path, mmap_mode=mmap_mode)
    except IndexCorruptionError:
        raise
    except FileNotFoundError as e:
        raise _corrupt(p, fn, gen, f"missing: {e}") from e
    except (ValueError, OSError, EOFError) as e:
        raise _corrupt(p, fn, gen, e) from e


def load_index(path, *, mmap: bool = True, parallel: bool = True,
               workers: int = 8, verify: bool = False, device=None):
    """Restore from the directory format onto ``device`` (default the
    card).  Single-file arrays mmap (copy-on-write: no copy until they are
    moved to the device, once); row-sharded arrays are filled by a thread
    pool reading all slabs concurrently.  Returns whatever
    :func:`index_from_state` builds for the saved kind.

    Robustness: a truncated or checksum-mangled array file raises
    :class:`IndexCorruptionError` naming the file and the manifest
    generation.  Sharded slabs (read in full anyway) are always CRC32-
    verified against the manifest; mmapped single files are shape/parse
    validated, and ``verify=True`` CRC-checks them too (full read)."""
    p = Path(path)
    manifest = json.loads((p / MANIFEST).read_text())
    if manifest.get("schema", 0) > SCHEMA:
        raise ValueError(f"index at {p} has schema "
                         f"{manifest['schema']} > supported {SCHEMA}")
    gen = manifest.get("gen", 0)
    arrays = manifest["arrays"]
    flat: Dict[str, np.ndarray] = {}
    jobs = []
    for key, am in arrays.items():
        files = am["files"]
        crcs = am.get("crc32") or [None] * len(files)
        if len(files) == 1:
            a = _load_checked(p, files[0], gen,
                              mmap_mode="c" if mmap else None,
                              expect_crc=crcs[0], verify=verify)
            if list(a.shape) != list(am["shape"]):
                raise _corrupt(p, files[0], gen,
                               f"shape {list(a.shape)} != manifest "
                               f"{am['shape']}")
            flat[key] = a
            continue
        out = np.empty(tuple(am["shape"]), dtype=np.dtype(am["dtype"]))
        flat[key] = out
        # slab offsets follow np.array_split's rule: the first n % k slabs
        # get one extra row
        n, k = am["shape"][0], len(files)
        sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
        row = 0
        for fn, sz, crc in zip(files, sizes, crcs):
            jobs.append((out, row, sz, fn, crc))
            row += sz
    def fill(job):
        out, row0, sz, fn, crc = job
        part = _load_checked(p, fn, gen, expect_crc=crc, verify=verify)
        if len(part) != sz:
            raise _corrupt(p, fn, gen,
                           f"slab has {len(part)} rows, manifest says {sz}")
        out[row0:row0 + len(part)] = part
    if jobs:
        if parallel and len(jobs) > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(fill, jobs))
        else:
            for j in jobs:
                fill(j)
    return index_from_state(flat, manifest["index"], device=device)
