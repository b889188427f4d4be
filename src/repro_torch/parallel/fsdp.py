"""The FSDP-strategy (ZeRO-3) sharded train step: the reference's
``build_train_step`` under ``jax.jit`` with ``in_shardings = (state_sh,
bsh)`` from ``tree_shardings`` (``launch/dryrun.py:129-148``), on the
port's single-controller ``ShardMesh``.

Placement.  Each parameter leaf is split by ``spec_for_logical`` under the
rules (``FSDP_RULES`` by default): shard s holds its block on
``mesh.devices[s]``; a dim that does not divide stays whole, so the leaf is
replicated over the axes its spec leaves out.  The moments take the ZeRO-1
rules (``"fsdp"`` → ``rules["fsdp+"]``), which place them with their
parameters on every mesh without a ``pod`` axis; the step refuses a layout
that would not.  A sharded state is a list of per-shard states, each
``{"params", "opt": {"m", "v", "step"}}`` of the shard's blocks
(``shard_state`` / ``unshard_state`` move between the two layouts, so a
checkpoint written from either restores into the other).

The step, for every present shard of the mesh:
* the batch is split by ``batch_logical`` over its spec;
* the forward is ``Model._train_parts``, the walk that ``Model.loss``
  runs, here group by group across all shards (the MoE's expert exchange
  couples the shards within a layer).  Its fetch all-gathers each group's
  weights from their owners inside the group's checkpointed region, so
  they are freed after use and gathered again in the recompute; an expert
  dim that the spec puts on the EP axis stays split (each shard runs its
  own experts, ``models.moe``);
* the loss is the token mean over the global batch: the shards' summed NLL
  and token counts are all-reduced before the ratio, so each shard's
  gradient is its share of the global mean; ``aux`` is the mean over the
  shards;
* the gradients reach their owners by ``reduce_scatter`` (summed in f32:
  the owners' gradient blocks are f32, as the micro-batch step's
  accumulator is), and a leaf replicated over some axes gets the
  ``all_reduce`` of those axes on top;
* the global clip norm is an ``all_reduce`` of per-shard squared sums, a
  replicated block counted on one of its holders only;
* AdamW runs on each owner's blocks; weight decay is decided by the whole
  leaf's ``ndim >= 2`` (a block keeps every dim).

On ``mesh.share(s)`` the same code runs one device's share of the step
(the dry-run): the collectives stand in for the absent shards."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.moe import moe_ffn_shards
from repro_torch.models.params import DTYPES, logical_axes
from repro_torch.parallel.sharding import (FSDP_RULES, ActSharder, ShardMesh,
                                           all_gather, all_reduce,
                                           batch_logical, block_slices,
                                           on_device, reduce_scatter,
                                           spec_axes, spec_for_logical)
from repro_torch.training.optim import adamw_update, cosine_schedule

Path = Tuple[str, ...]


def _get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _logical_leaves(tree, prefix: Path = ()):
    """(path, logical tuple) in sorted-key order (a logical tuple is a
    leaf, not a container)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _logical_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@dataclass(frozen=True)
class LeafPlace:
    """Where one leaf lives: its global shape, its spec, the dims a compute
    gathers (every split dim but an expert dim on the EP axis), and the
    mesh axes it is replicated over."""
    shape: Tuple[int, ...]
    spec: Tuple
    gather_dims: Tuple[int, ...]
    replicated: Tuple[str, ...]


def _place(logical, shape, mesh: ShardMesh, rules) -> LeafPlace:
    spec = spec_for_logical(logical, shape, mesh, rules)
    used = {a for e in spec for a in spec_axes(e)}
    gather = tuple(i for i, (e, name) in enumerate(zip(spec, logical))
                   if e is not None and name != "expert")
    return LeafPlace(tuple(shape), spec, gather,
                     tuple(a for a in mesh.axis_names if a not in used))


class StateLayout:
    """Every train-state leaf's placement on ``mesh`` under ``rules``."""

    def __init__(self, model, mesh: ShardMesh, rules=FSDP_RULES):
        self.mesh, self.rules = mesh, rules
        lax_tree = logical_axes(model.cfg, model.plan)
        shapes = model.param_shapes()
        zrules = dict(rules)              # ZeRO-1 across pods for opt state
        zrules["fsdp"] = rules["fsdp+"]
        self.params: Dict[Path, LeafPlace] = {}
        self.moments: Dict[Path, LeafPlace] = {}
        for path, lg in _logical_leaves(lax_tree):
            shp = tuple(_get(shapes, path).shape)
            self.params[path] = _place(lg, shp, mesh, rules)
            self.moments[path] = _place(lg, shp, mesh, zrules)
        self.opt_dtype = model.cfg.opt_dtype

    def check_step(self) -> None:
        """The sharded step updates each owner's blocks in place: every
        moment must lie with its parameter."""
        bad = [p for p in self.params
               if self.params[p].spec != self.moments[p].spec]
        if bad:
            raise NotImplementedError(
                f"build_sharded_train_step: the moments of {bad[:3]} are "
                f"sharded apart from their parameters (ZeRO-1 across a pod "
                f"axis); the sharded step needs them together")

    def block(self, place: LeafPlace, s: int) -> Tuple[slice, ...]:
        return block_slices(place.shape, place.spec, self.mesh, s)

    def holds_once(self, place: LeafPlace, s: int) -> bool:
        """Whether shard s is the first holder of its block (its index on
        the axes the leaf is replicated over is 0)."""
        return self.mesh.index_on(s, place.replicated) == 0

    def shard(self, state: Dict) -> List[Dict]:
        """A state -> one state of blocks per present shard, each block a
        copy on its shard's device."""
        out = []
        for s in self.mesh.present:
            dev = self.mesh.devices[s]
            st = {"params": {}, "opt": {"m": {}, "v": {},
                                        "step": state["opt"]["step"].to(
                                            dev, copy=True)}}
            for path, pl in self.params.items():
                _set(st["params"], path, _get(state["params"], path)[
                    self.block(pl, s)].to(dev, copy=True))
                mpl = self.moments[path]
                for k in ("m", "v"):
                    _set(st["opt"][k], path, _get(state["opt"][k], path)[
                        self.block(mpl, s)].to(dev, copy=True))
            out.append(st)
        return out

    def unshard(self, shards: Sequence[Dict], device=None) -> Dict:
        """Every shard's state (all shards present) -> the whole state on
        ``device`` (default: the first shard's device)."""
        dev = device or self.mesh.devices[0]
        return {"params": self.unshard_tree([sh["params"] for sh in shards],
                                            dev),
                "opt": {k: self.unshard_tree([sh["opt"][k] for sh in shards],
                                             dev, self.moments)
                        for k in ("m", "v")} | {
                    "step": shards[0]["opt"]["step"].to(dev, copy=True)}}

    def unshard_tree(self, trees: Sequence[Dict], device=None,
                     places: Optional[Dict[Path, LeafPlace]] = None) -> Dict:
        """Every shard's tree of blocks (parameters, or anything placed as
        they are: their gradients) -> the whole tree on ``device``."""
        if len(trees) != self.mesh.size:
            raise ValueError(f"unshard: {len(trees)} shard trees for a "
                             f"mesh of {self.mesh.size}")
        dev = device or self.mesh.devices[0]
        out: Dict = {}
        for path, place in (places or self.params).items():
            src = [_get(t, path) for t in trees]
            full = torch.empty(place.shape, dtype=src[0].dtype, device=dev)
            for s, blk in enumerate(src):
                full[self.block(place, s)] = blk.to(dev)
            _set(out, path, full)
        return out


def shard_state(state: Dict, model, mesh: ShardMesh,
                rules=FSDP_RULES) -> List[Dict]:
    """A whole train state -> the per-shard states of ``mesh`` (copies)."""
    return StateLayout(model, mesh, rules).shard(state)


def unshard_state(shards: Sequence[Dict], model, mesh: ShardMesh,
                  rules=FSDP_RULES, device=None) -> Dict:
    """Per-shard states -> the whole train state on one device."""
    return StateLayout(model, mesh, rules).unshard(shards, device)


def init_sharded_state(model, mesh: ShardMesh, generator: torch.Generator,
                       rules=FSDP_RULES) -> List[Dict]:
    """``init_train_state``'s parameters (drawn on ``model.device`` with
    ``generator``) split over the mesh, leaf by leaf so the whole tree and
    its blocks never coexist beyond one leaf; zero moments in
    ``cfg.opt_dtype`` and a zero step on every shard."""
    lay = StateLayout(model, mesh, rules)
    params = model.init(generator)
    out = [{"params": {}, "opt": {"m": {}, "v": {}, "step": torch.zeros(
        (), dtype=torch.int32, device=mesh.devices[s])}}
        for s in mesh.present]
    mdt = DTYPES[lay.opt_dtype]
    for path, pl in lay.params.items():
        leaf = _get(params, path)
        for i, s in enumerate(mesh.present):
            dev = mesh.devices[s]
            blk = leaf[lay.block(pl, s)].to(dev, copy=True)
            _set(out[i]["params"], path, blk)
            for k in ("m", "v"):
                _set(out[i]["opt"][k], path, torch.zeros(
                    tuple(blk.shape), dtype=mdt, device=dev))
        _set(params, path, None)            # free the whole leaf
        del leaf
    return out


def split_batch(batch: Dict, cfg, mesh: ShardMesh, rules=FSDP_RULES
                ) -> List[Dict]:
    """The global batch -> each present shard's block of every leaf (by
    ``batch_logical``'s spec), on the shard's device."""
    blog = batch_logical(cfg, "train")
    out = []
    for s in mesh.present:
        dev = mesh.devices[s]
        part = {}
        for k, v in batch.items():
            spec = spec_for_logical(blog[k], tuple(v.shape), mesh, rules)
            part[k] = v[block_slices(tuple(v.shape), spec, mesh, s)].to(dev)
        out.append(part)
    return out


# ------------------------------------------------------------ the gather
class _Gather(torch.autograd.Function):
    """All-gather of one leaf (or one group's slice of a stacked leaf) from
    its owners to every present shard; in backward, the shards' gradients
    reduce-scattered back to the owners (and all-reduced over the axes the
    leaf is replicated over) and added, in f32, into the owners' gradient
    blocks.  ``dummy`` requires grad so that backward runs; the blocks
    themselves get none."""

    @staticmethod
    def forward(ctx, gather, dummy, *blocks):
        ctx.gather = gather
        outs = gather.forward(blocks)
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.gather.backward(grads)
        return (None, None) + (None,) * len(grads)


class _LeafGather:
    """One leaf's gather on a mesh (``_Gather``'s forward and backward);
    ``sinks[i]`` is the present shard i's f32 gradient block (``index``:
    the group slice of a stacked leaf)."""

    def __init__(self, place: LeafPlace, mesh: ShardMesh, sinks, index):
        self.place, self.mesh, self.sinks, self.index = place, mesh, sinks, index
        off = 0 if index is None else 1       # a group slice drops dim 0
        self.steps = [(d - off, place.spec[d]) for d in place.gather_dims]

    def forward(self, blocks):
        parts = list(blocks)
        with torch.no_grad():
            for dim, axes in self.steps:
                parts = all_gather(parts, self.mesh, axis=axes, dim=dim)
        self.shapes = [(p.shape, p.dtype, p.device) for p in parts]
        return parts

    def backward(self, grads):
        # a missing gradient: that shard's copy of the leaf fed nothing
        parts = [g if g is not None else torch.zeros(shp, dtype=dt,
                                                     device=dev)
                 for g, (shp, dt, dev) in zip(grads, self.shapes)]
        with torch.no_grad():
            for dim, axes in reversed(self.steps):
                parts = reduce_scatter(parts, self.mesh, axes, dim=dim,
                                       dtype=torch.float32)
            if self.place.replicated:
                parts = all_reduce(parts, self.mesh, self.place.replicated,
                                   dtype=torch.float32)
            for sink, g in zip(self.sinks, parts):
                tgt = sink if self.index is None else sink[self.index]
                tgt.add_(g.to(tgt.device, torch.float32))


# ---------------------------------------------------------------- the step
def build_sharded_train_step(model, mesh: ShardMesh, rules=FSDP_RULES, *,
                             lr_schedule: Optional[Callable] = None,
                             max_grad_norm: float = 1.0,
                             keep_grads: bool = False):
    """Returns train_step(shards, batch) -> (shards, metrics): ``shards``
    the present shards' states (``shard_state``), ``batch`` the global
    batch (``tokens``, ``labels`` (B, S), and the frontend leaves), split
    here by its spec.  The shards' tensors are updated in place, as the
    unsharded step's; the metrics have its keys (``loss``, ``aux``,
    ``grad_norm``, ``lr``, ``step``), on the first present shard's
    device.  ``keep_grads``: the metrics also hold ``grads``, each
    shard's f32 gradient blocks before the clip (a copy)."""
    lr_schedule = lr_schedule or cosine_schedule
    lay = StateLayout(model, mesh, rules)
    lay.check_step()
    cfg, dm = model.cfg, model.dm
    present = mesh.present
    devs = [mesh.devices[s] for s in present]
    dev0 = devs[0]

    def on_shards(fn, *lists):
        out = []
        for i, dev in enumerate(devs):
            with on_device(dev):
                out.append(fn(i, *(lst[i] for lst in lists)))
        return out

    def train_step(shards: List[Dict], batch: Dict):
        if len(shards) != len(present):
            raise ValueError(f"train_step: {len(shards)} shard states for "
                             f"{len(present)} present shards")
        B = batch["tokens"].shape[0]
        bparts = split_batch(batch, cfg, mesh, rules)
        if isinstance(model._sa, ActSharder):
            model._sa.global_sizes = {"batch": B}
        sinks = {path: [torch.zeros(tuple(_get(sh["params"], path).shape),
                                    dtype=torch.float32, device=dev)
                        for sh, dev in zip(shards, devs)]
                 for path in lay.params}
        dummy = torch.zeros((), device=dev0, requires_grad=True)

        def gather(path: Path, index: Optional[int] = None):
            """The leaf at ``path`` (its ``index``-th group slice) on every
            present shard."""
            g = _LeafGather(lay.params[path], mesh, sinks[path], index)
            blocks = [_get(sh["params"], path) for sh in shards]
            if index is not None:
                blocks = [b[index] for b in blocks]
            return list(_Gather.apply(g, dummy, *blocks))

        def fetch(names, g: Optional[int] = None):
            """``Model._train_parts``' fetch: every leaf under the
            top-level ``names``, gathered, one tree per present shard."""
            trees = [{} for _ in present]
            for path in lay.params:
                if path[0] in names:
                    for t, w in zip(trees, gather(path, g)):
                        _set(t, path, w)
            return trees

        sums, aux = model._train_parts(
            fetch, bparts, on_shards,
            lambda xs, ps: moe_ffn_shards(xs, ps, cfg, dm, mesh))
        tot = all_reduce([t.reshape(1) for t, _ in sums], mesh)[0]
        cnt = all_reduce([c.reshape(1) for _, c in sums], mesh)[0]
        ce = (tot / torch.clamp_min(cnt, 1.0)).reshape(()).to(dev0)
        aux = aux.to(dev0)
        total = ce + 0.01 * aux
        total.backward()
        del sums, total

        # the global clip norm: every block's squared sum once
        sq = []
        for i, s in enumerate(present):
            acc = torch.zeros((), dtype=torch.float32, device=devs[i])
            for path, pl in lay.params.items():
                if lay.holds_once(pl, s):
                    acc = acc + torch.sum(torch.square(sinks[path][i]))
            sq.append(acc.reshape(1))
        gn = torch.sqrt(all_reduce(sq, mesh)[0].reshape(()))
        scale = torch.clamp_max(
            torch.tensor(max_grad_norm, dtype=torch.float32, device=gn.device)
            / torch.clamp_min(gn, 1e-9), 1.0)
        lr = lr_schedule(shards[0]["opt"]["step"])
        kept = None
        if keep_grads:
            kept = [{} for _ in present]
            for path in lay.params:
                for i in range(len(present)):
                    _set(kept[i], path, sinks[path][i].clone())
        new = []
        for i, sh in enumerate(shards):
            sc = scale.to(devs[i])
            grads = {}
            for path in lay.params:
                _set(grads, path, sinks[path][i].mul_(sc))
            params, opt = adamw_update(sh["params"], grads, sh["opt"],
                                       lr.to(devs[i]))
            new.append({"params": params, "opt": opt})
        metrics = dict(loss=ce.detach(), aux=aux.detach(), grad_norm=gn,
                       lr=lr, step=new[0]["opt"]["step"].float())
        if kept is not None:
            metrics["grads"] = kept
        return new, metrics

    return train_step

