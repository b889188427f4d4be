"""Shard placement, the logical-axis layer and the collectives: the
counterpart of the reference's ``repro.parallel.sharding``.

The reference's multi-device layer is single-controller: one process
drives a ``jax.Mesh`` through ``shard_map``, and the cross-shard steps are
in-body collectives.  Here one process holds a ``ShardMesh``, one
``torch.device`` per shard over named axes (``mesh.shape`` is the ordered
``{name: size}``, shards in row-major coordinate order); ``shard_map``
runs a per-shard body on its shard's device, and the collectives take one
tensor per shard.  The copies are ``Tensor.to``, so autograd runs back
through them.  Shards are placed round-robin over the devices, so S shards
may share one card (they then run back to back on its current stream) or
spread over several.

The logical-axis layer is the reference's, rule for rule: every tensor
carries a tuple of *logical* axis names (one per dim), and
``spec_for_logical`` maps them onto mesh axes, dropping or shrinking the
mapping whenever the dim is not divisible by the mesh-axis product or the
mesh axis was already consumed by an earlier dim of the same tensor.  A
spec is a tuple with one entry per dim: ``None``, one axis name, or a
tuple of names (the reference's ``PartitionSpec`` entries).

A mesh may run only some of its shards (``mesh.share(s)``: the dry-run's
one device's share of a program).  The collectives then stand in for the
absent shards with tensors of the present shard's shapes, so every shape,
operation and per-device byte of the share is the full program's.

``CollectiveCounter`` counts what the collectives move, per device, under
the kinds of the reference's HLO accounting (``launch.hlo_analysis``): each
collective adds its per-device operand bytes (an all-gather's operand is
the local shard, a reduce-scatter's the full local tensor)."""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

# logical axis -> mesh-axis alternatives.  Each value is a tuple of
# ALTERNATIVE tuples tried in order (first divisible wins); a plain tuple of
# strings is treated as a single alternative whose prefixes may shrink.
#
# DEFAULT_RULES = the TP strategy (serving, and huge-model training):
#   batch over (pod, data); weights FSDP(data) × TP(model).
DEFAULT_RULES: Dict[Optional[str], Tuple] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "fsdp+": ("pod", "data"),     # ZeRO-1-across-pods (optimizer state)
    "tp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "seq": ("data",),
    "sp": ("model",),             # Megatron-style sequence parallelism
    "layer": (),
    None: (),
}

# FSDP strategy (training of the ≤15B dense archs and MoE training): no
# tensor parallelism — batch is sharded over every mesh axis (falling back to
# (data, model) when the pod axis does not divide), weights are ZeRO-3 over
# (data, model); experts stay on 'model' (the MoE does EP inside).
FSDP_RULES: Dict[Optional[str], Tuple] = {
    "batch": (("pod", "data", "model"), ("data", "model"), ("pod", "data"),
              ("data",)),
    "fsdp": (("data", "model"), ("data",)),
    "fsdp+": (("pod", "data", "model"), ("pod", "data"), ("data", "model"),
              ("data",)),
    "tp": (),
    "vocab": ("model",),
    "expert": ("model",),
    "seq": ("data",),
    "sp": (),
    "layer": (),
    None: (),
}

# Replica strategy (serving of sub-chip-scale models, e.g. mamba2-780m):
# weights fully replicated, batch over (pod, data); the model axis holds
# independent serving replicas — zero collectives on the critical path.
REPLICA_RULES: Dict[Optional[str], Tuple] = {
    "batch": ("pod", "data"),
    "fsdp": (),
    "fsdp+": (),
    "tp": (),
    "vocab": (),
    "expert": (),
    "seq": ("data",),
    "sp": (),
    "layer": (),
    None: (),
}

STRATEGIES = {"tp": DEFAULT_RULES, "fsdp": FSDP_RULES, "replica": REPLICA_RULES}


# ---------------------------------------------------------------- the mesh
@dataclass(frozen=True)
class ShardMesh:
    """One device per shard over named axes.  ``axis_sizes`` defaults to one
    axis of every shard; ``present`` (default: every shard) is the shards a
    program runs (``share``)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    axis_sizes: Tuple[int, ...] = ()
    present: Tuple[int, ...] = field(default=())

    def __post_init__(self):
        if not self.axis_sizes:
            object.__setattr__(self, "axis_sizes", (len(self.devices),))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"ShardMesh: axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"ShardMesh: {len(self.devices)} devices for "
                             f"axes {dict(zip(self.axis_names, self.axis_sizes))}")
        if not self.present:
            object.__setattr__(self, "present", tuple(range(len(self.devices))))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        """The ordered ``{axis name: size}`` (jax's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def axis(self) -> str:
        """A one-axis mesh's axis name."""
        if len(self.axis_names) != 1:
            raise ValueError(f"ShardMesh.axis: the mesh has axes "
                             f"{self.axis_names}")
        return self.axis_names[0]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The present shards' devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices[s] for s in self.present))

    def coords(self, s: int) -> Dict[str, int]:
        """Shard ``s``'s coordinate on each axis (row-major order)."""
        out = {}
        for name, n in zip(reversed(self.axis_names),
                           reversed(self.axis_sizes)):
            out[name] = s % n
            s //= n
        return {a: out[a] for a in self.axis_names}

    def index_on(self, s: int, axes: Sequence[str]) -> int:
        """Shard ``s``'s row-major index over ``axes`` (in their order)."""
        c, i = self.coords(s), 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def axis_groups(self, axes) -> List[Tuple[int, ...]]:
        """The shard groups of a collective over ``axes`` (a name or a tuple
        of names): the shards that share every other coordinate, each group
        ordered row-major over ``axes`` in the given order."""
        axes = spec_axes(axes)
        rest = [a for a in self.axis_names if a not in axes]
        groups: Dict[Tuple, List] = {}
        for s in range(self.size):
            c = self.coords(s)
            groups.setdefault(tuple(c[a] for a in rest), []).append(s)
        return [tuple(sorted(g, key=lambda s: self.index_on(s, axes)))
                for g in groups.values()]

    def share(self, s: int = 0) -> "ShardMesh":
        """This mesh running shard ``s`` alone: one device's share."""
        return replace(self, present=(s,))


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` are one card: give every CUDA device
    its index, so per-device state (replicas, uploads, the select kernels'
    arrival counters) never keys one card twice."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_shards, devices: Sequence | None = None,
              axis: str = "data") -> ShardMesh:
    """Place shard ``s`` on ``devices[s % len(devices)]``.  ``n_shards`` is
    a shard count (one axis named ``axis``) or an ordered ``{name: size}``
    of axes.  ``devices`` defaults to every visible CUDA card and raises
    without one (as ``resolve_device`` does); pass ``["cpu"]`` for a mesh
    of CPU shards, ``["meta"]`` for a dry-run's."""
    if isinstance(n_shards, dict):
        names, sizes = tuple(n_shards), tuple(int(v) for v in n_shards.values())
    else:
        names, sizes = (axis,), (int(n_shards),)
    n = math.prod(sizes)
    if n < 1 or min(sizes) < 1:
        raise ValueError(f"make_mesh: n_shards={n_shards} must be >= 1")
    if devices is None:
        resolve_device(None)                 # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_canonical(resolve_device(d)) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices given")
    return ShardMesh(tuple(devs[s % len(devs)] for s in range(n)), names,
                     sizes)


def on_device(dev: torch.device):
    """Context that makes ``dev`` the current card (a kernel launches on
    the current card); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def shard_map(body: Callable, mesh: ShardMesh) -> List:
    """``body(s, device)`` for every present shard, each run with its
    device current; returns the per-shard results in shard order.  Shards
    on one card are enqueued one after another on its current stream."""
    out = []
    for s in mesh.present:
        dev = mesh.devices[s]
        with on_device(dev):
            out.append(body(s, dev))
    return out


# ---------------------------------------------------------------- counting
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COUNTERS: List["CollectiveCounter"] = []


class CollectiveCounter:
    """While active (``with CollectiveCounter() as c``), every collective
    adds its per-device operand bytes under its kind, and ``total``; a
    group of one shard moves nothing and adds nothing.  ``calls`` counts
    the collectives by kind."""

    def __init__(self):
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.calls = {k: 0 for k in COLLECTIVES}

    def __enter__(self):
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        _COUNTERS.remove(self)

    def as_dict(self) -> Dict[str, int]:
        """Bytes per kind and ``total`` (the reference's record layout)."""
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out


def count_collective(kind: str, operand: torch.Tensor) -> None:
    """Add one collective of ``kind`` with this per-device operand to every
    active counter."""
    nbytes = operand.numel() * operand.element_size()
    for c in _COUNTERS:
        c.bytes[kind] += nbytes
        c.calls[kind] += 1


# ------------------------------------------------------------- collectives
def _present_groups(mesh: ShardMesh, axes):
    """(group, {member: index into the present parts}) for every group of
    a collective over ``axes`` (``None``: the whole mesh) that holds a
    present shard."""
    pos = {s: i for i, s in enumerate(mesh.present)}
    groups = (mesh.axis_groups(axes) if axes is not None
              else [tuple(range(mesh.size))])
    return [(g, {m: pos[m] for m in g if m in pos})
            for g in groups if any(m in pos for m in g)]


def _count_once(kind: str, groups, parts) -> None:
    """One collective call, counted once: every device runs it once, on
    its own operand (the first present shard's stands for all)."""
    g, have = groups[0]
    if len(g) > 1:
        count_collective(kind, parts[next(iter(have.values()))])


def _check_parts(parts, mesh: ShardMesh, what: str):
    if len(parts) != len(mesh.present):
        raise ValueError(f"{what}: {len(parts)} parts for "
                         f"{len(mesh.present)} present shards")


def all_gather(parts: Sequence[torch.Tensor], mesh: ShardMesh, axis=None,
               dim: int = 0):
    """Without ``axis``: per-shard tensors of one shape -> one (S, ...)
    tensor on the first present shard's device (a copy only for shards on
    another device).  With ``axis`` (a name or a tuple of names): the tiled
    ``lax.all_gather`` — each shard receives the concatenation along
    ``dim`` of its group's parts in group order; returns one tensor per
    present shard (shards of a group on one device share it)."""
    _check_parts(parts, mesh, "all_gather")
    if axis is None:
        dev = mesh.devices[mesh.present[0]]
        if mesh.size > 1:
            count_collective("all-gather", parts[0])
        got = {s: p for s, p in zip(mesh.present, parts)}
        stand = parts[0]
        return torch.stack([got.get(s, stand).to(dev, non_blocking=True)
                            for s in range(mesh.size)])
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    groups = _present_groups(mesh, axis)
    _count_once("all-gather", groups, parts)
    for g, have in groups:
        made: Dict[torch.device, torch.Tensor] = {}
        for m, i in have.items():
            dev = mesh.devices[m]
            if dev in made:
                out[i] = made[dev]
                continue
            if len(have) == len(g):
                full = torch.cat([parts[have[r]].to(dev) for r in g], dim=dim)
            else:                   # a share: zeros stand in for the rest
                blk = parts[i]
                shp = list(blk.shape)
                shp[dim] *= len(g)
                full = blk.new_zeros(shp, device=dev)
                for j, r in enumerate(g):
                    if r in have:
                        full.narrow(dim, j * blk.shape[dim],
                                    blk.shape[dim]).copy_(parts[have[r]])
            made[dev] = out[i] = full
    return out


def reduce_scatter(parts: Sequence[torch.Tensor], mesh: ShardMesh, axis,
                   dim: int = 0, dtype: Optional[torch.dtype] = None):
    """The tiled ``psum_scatter``: each group's parts (one shape) are summed
    in f32 and member r of the group receives block r along ``dim``, in
    ``dtype`` (default: the parts' dtype), on its device.  In a share the
    absent shards add nothing."""
    _check_parts(parts, mesh, "reduce_scatter")
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    groups = _present_groups(mesh, axis)
    _count_once("reduce-scatter", groups, parts)
    for g, have in groups:
        first = parts[next(iter(have.values()))]
        dt = dtype or first.dtype
        if first.shape[dim] % len(g):
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(first.shape)} does not split into "
                             f"{len(g)} blocks")
        dev0 = mesh.devices[next(iter(have))]
        acc = None
        for m, i in have.items():
            p = parts[i].to(dev0, torch.float32)
            acc = p if acc is None else acc + p
        blocks = torch.chunk(acc, len(g), dim=dim)
        for r, m in enumerate(g):
            if m in have:
                out[have[m]] = blocks[r].to(mesh.devices[m], dt)
    return out


def all_reduce(parts: Sequence[torch.Tensor], mesh: ShardMesh, axis=None,
               dtype: Optional[torch.dtype] = None):
    """``psum`` over ``axis`` (default: every axis): each group's parts
    summed in f32, every member receiving the sum in ``dtype`` (default:
    the parts' dtype) on its device."""
    _check_parts(parts, mesh, "all_reduce")
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    groups = _present_groups(mesh, axis)
    _count_once("all-reduce", groups, parts)
    for g, have in groups:
        first = parts[next(iter(have.values()))]
        dev0 = mesh.devices[next(iter(have))]
        acc = None
        for i in have.values():
            p = parts[i].to(dev0, torch.float32)
            acc = p if acc is None else acc + p
        for m, i in have.items():
            out[i] = acc.to(mesh.devices[m], dtype or first.dtype)
    return out


def all_to_all(parts: Sequence[torch.Tensor], mesh: ShardMesh,
               split_dim: int, concat_dim: int, axis=None
               ) -> List[torch.Tensor]:
    """The tiled ``lax.all_to_all`` over ``axis`` (default: the whole mesh
    as one group): member s of a group of G splits its part into G equal
    slices along ``split_dim`` and sends slice r to member r, which
    concatenates what it receives along ``concat_dim`` in source order.
    Returns the received tensors, one per present shard, each on its
    shard's device.  In a share an absent source sends the present
    shard's slice in its place."""
    _check_parts(parts, mesh, "all_to_all")
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    groups = _present_groups(mesh, axis)
    _count_once("all-to-all", groups, parts)
    for g, have in groups:
        G = len(g)
        pieces = {m: torch.chunk(parts[i], G, dim=split_dim)
                  for m, i in have.items()}
        if any(len(ps) != G or ps[0].shape != ps[-1].shape
               for ps in pieces.values()):
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{[tuple(parts[i].shape) for i in have.values()]}"
                             f" does not split into {G} equal slices")
        stand = pieces[next(iter(have))]
        for r, m in enumerate(g):
            if m in have:
                dev = mesh.devices[m]
                out[have[m]] = torch.cat(
                    [pieces.get(s, stand)[r].to(dev) for s in g],
                    dim=concat_dim)
    return out


# ------------------------------------------------------- logical-axis layer
def _alternatives(entry) -> Tuple[Tuple[str, ...], ...]:
    if not entry:
        return ()
    if isinstance(entry[0], str):   # plain tuple -> its prefixes
        return tuple(tuple(entry[:k]) for k in range(len(entry), 0, -1))
    return tuple(tuple(alt) for alt in entry)   # explicit alternatives, as-is


def spec_for_logical(logical: Sequence[Optional[str]],
                     shape: Sequence[int],
                     mesh,
                     rules: Optional[Dict] = None) -> Tuple:
    """The reference's resolver: per dim ``None``, an axis name, or a tuple
    of names.  ``mesh`` is anything with a ``shape`` mapping of axis
    sizes."""
    rules = rules or DEFAULT_RULES
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        chosen: Tuple[str, ...] = ()
        for alt in _alternatives(rules.get(name, ())):
            sub = tuple(a for a in alt if a in mesh.shape and a not in used)
            if len(sub) != len(alt):
                continue
            size = math.prod(mesh.shape[a] for a in sub)
            if size > 1 and dim % size == 0:
                chosen = sub
                break
        if chosen:
            used.update(chosen)
            parts.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            parts.append(None)
    return tuple(parts)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(logical_tree, shape_tree, mesh, rules=None):
    """Matching trees of logical tuples and shaped values (tensors, meta
    tensors) -> the tree of specs."""
    if _is_logical(logical_tree):
        return spec_for_logical(logical_tree, tuple(shape_tree.shape), mesh,
                                rules)
    return {k: tree_shardings(v, shape_tree[k], mesh, rules)
            for k, v in logical_tree.items()}


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name, or a tuple of
    names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Tuple, mesh) -> Tuple[int, ...]:
    """The per-shard block shape of a tensor of ``shape`` under ``spec``."""
    return tuple(n // math.prod(mesh.shape[a] for a in spec_axes(e))
                 for n, e in zip(shape, spec))


def block_slices(shape: Sequence[int], spec: Tuple, mesh: ShardMesh,
                 s: int) -> Tuple[slice, ...]:
    """Shard ``s``'s block of a tensor of ``shape`` under ``spec``: per
    dim, its row-major index over the dim's axes times the block size."""
    out = []
    for n, e in zip(shape, spec):
        axes = spec_axes(e)
        b = n // math.prod(mesh.shape[a] for a in axes)
        i = mesh.index_on(s, axes)
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


class ActSharder:
    """The per-shard counterpart of ``with_sharding_constraint``: a call
    ``hook(x, logical)`` checks that the local tensor ``x`` has the block
    shape that ``spec_for_logical`` gives its global shape, and raises
    otherwise.  ``global_sizes`` maps logical names to their global extents
    (the sharded step sets ``{"batch": B}``); any other dim is whole."""

    def __init__(self, mesh: ShardMesh, rules=None):
        self.mesh, self.rules = mesh, rules
        self.global_sizes: Dict[str, int] = {}

    def __call__(self, x, logical):
        glob = tuple(self.global_sizes.get(name, n)
                     for n, name in zip(x.shape, logical))
        spec = spec_for_logical(logical, glob, self.mesh, self.rules)
        want = local_shape(glob, spec, self.mesh)
        if tuple(x.shape) != want:
            raise ValueError(
                f"act_shard: a local tensor of shape {tuple(x.shape)} for "
                f"logical axes {tuple(logical)} of global shape {glob}; the "
                f"spec {spec} gives blocks of {want}")
        return x


def make_act_sharder(mesh: Optional[ShardMesh], rules=None):
    """Returns hook(x, logical): the identity off-mesh, an ``ActSharder``
    on a mesh."""
    if mesh is None:
        return lambda x, logical: x
    return ActSharder(mesh, rules)


# ----------------------------------------------------------------------
def batch_logical(cfg, shape_kind: str, long_context: bool = False) -> Dict:
    """Logical axes for each input-batch leaf."""
    out = {}
    if shape_kind == "train":
        out["tokens"] = ("batch", None)
        out["labels"] = ("batch", None)
    elif shape_kind == "prefill":
        out["tokens"] = ("batch", None)
    elif shape_kind == "decode":
        out["token"] = ("batch",)
    if cfg.family == "encdec" and shape_kind in ("train", "prefill"):
        out["frames"] = ("batch", None, None)
    if cfg.family == "vlm" and shape_kind in ("train", "prefill"):
        out["patches"] = ("batch", None, None)
    return out


def cache_logical(cfg, long_context: bool = False) -> Dict:
    """Logical axes for the decode-cache leaves (KV seq-sharded in long mode)."""
    seq_ax = "seq" if long_context else None
    out = {}
    if cfg.family in ("dense", "moe", "encdec"):
        out["k"] = ("layer", "batch", seq_ax, "tp", None)
        out["v"] = ("layer", "batch", seq_ax, "tp", None)
    if cfg.family == "vlm":
        out["k"] = ("layer", None, "batch", seq_ax, "tp", None)
        out["v"] = ("layer", None, "batch", seq_ax, "tp", None)
    if cfg.family == "ssm":
        out["state"] = ("layer", "batch", "tp", None, None)
        out["conv"] = ("layer", "batch", None, "tp")
    if cfg.family == "hybrid":
        out["k"] = ("layer", "batch", seq_ax, "tp", None)
        out["v"] = ("layer", "batch", seq_ax, "tp", None)
        out["state"] = ("layer", None, "batch", "tp", None, None)
        out["conv"] = ("layer", None, "batch", None, "tp")
    if cfg.family == "encdec":
        out["ck"] = ("layer", "batch", None, "tp", None)
        out["cv"] = ("layer", "batch", None, "tp", None)
    if cfg.family == "vlm":
        out["ck"] = ("layer", "batch", None, "tp", None)
        out["cv"] = ("layer", "batch", None, "tp", None)
    return out
