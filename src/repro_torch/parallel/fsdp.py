"""The sharded train step: the reference's ``build_train_step`` under
``jax.jit`` with ``in_shardings = (state_sh, bsh)`` from ``tree_shardings``
(``launch/dryrun.py:129-148``), on the port's single-controller
``ShardMesh``.  Under the FSDP strategy's rules it is the ZeRO-3 step this
module describes; under rules that map ``"tp"`` (``DEFAULT_RULES``) the
same step runs the TP strategy's walk (``parallel.tp.TrainHooks``:
Megatron splits over ``model``, weights gathered over ``data`` only).

Placement.  Each parameter leaf is split by ``spec_for_logical`` under the
rules (``FSDP_RULES`` by default): shard s holds its block on
``mesh.devices[s]``; a dim that does not divide stays whole, so the leaf is
replicated over the axes its spec leaves out.  The moments take the ZeRO-1
rules (``"fsdp"`` → ``rules["fsdp+"]``), which place them with their
parameters on every mesh without a ``pod`` axis; across pods they split
further (ZeRO-1): such a leaf's gradient is reduce-scattered to the
moments' blocks, each owner updates that slice of the parameter (gathered
from the parameter's blocks), and the updated slices are all-gathered
back into the parameter's blocks.  A moment split apart from its
parameter on a dim the compute keeps split cannot be updated by its owner:
the step refuses that layout.  A sharded state is a list of per-shard
states, each
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
  ``all_reduce`` of those axes on top (the moments' blocks and axes for a
  ZeRO-1 leaf);
* the global clip norm is an ``all_reduce`` of per-shard squared sums, a
  replicated block counted on one of its holders only;
* AdamW runs on each owner's blocks; weight decay is decided by the whole
  leaf's ``ndim >= 2`` (a block keeps every dim).

On ``mesh.share(s)`` the same code runs one device's share of the step
(the dry-run): the collectives stand in for the absent shards."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.lm import PartHooks
from repro_torch.models.moe import moe_ffn_shards
from repro_torch.models.params import DTYPES, logical_axes
from repro_torch.parallel.sharding import (ADJOINT, FSDP_RULES, PLAIN,
                                           ActSharder, ShardMesh, all_gather,
                                           all_reduce, batch_logical,
                                           block_slices, on_device,
                                           reduce_scatter, spec_axes,
                                           spec_for_logical)
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
    gathers, and the mesh axes it is replicated over."""
    shape: Tuple[int, ...]
    spec: Tuple
    gather_dims: Tuple[int, ...]
    replicated: Tuple[str, ...]


def fsdp_gathered(path: Path, logical, spec) -> Tuple[int, ...]:
    """The FSDP strategy's compute gathers every split dim but an expert
    dim (each shard runs its own experts, ``models.moe``)."""
    return tuple(i for i, (e, name) in enumerate(zip(spec, logical))
                 if e is not None and name != "expert")


#: an SSM's leaves whose ``model`` blocks do not line up with its heads
_SSM_WHOLE = ("w_in", "conv_w", "conv_b")


def _ssm_whole(path: Path) -> bool:
    return len(path) > 1 and path[-2].startswith("ssm") and \
        path[-1] in _SSM_WHOLE


def tp_gathered(path: Path, logical, spec) -> Tuple[int, ...]:
    """The TP strategy's compute (``parallel.tp``): the dims it gathers.  A
    ``model`` dim stays split, except in an SSM's ``w_in`` / ``conv_w`` /
    ``conv_b`` (gathered whole, the shard takes its heads' columns) and in
    an expert leaf, which keeps only its expert dim split (EP; replicated
    experts otherwise, ``d_ff`` whole)."""
    split = [i for i, e in enumerate(spec) if e is not None]
    if "expert" in logical:
        return tuple(i for i in split if logical[i] != "expert")
    if _ssm_whole(path):
        return tuple(split)
    return tuple(i for i in split if "model" not in spec_axes(spec[i]))


def is_tp(rules) -> bool:
    """Whether ``rules`` are a TP strategy's (they split the ``"tp"``
    logical axis)."""
    return bool(rules.get("tp"))


def _place(path: Path, logical, shape, mesh: ShardMesh, rules,
           gathered: Callable = fsdp_gathered) -> LeafPlace:
    spec = spec_for_logical(logical, shape, mesh, rules)
    used = {a for e in spec for a in spec_axes(e)}
    return LeafPlace(tuple(shape), spec, tuple(gathered(path, logical, spec)),
                     tuple(a for a in mesh.axis_names if a not in used))


class TreeLayout:
    """Every leaf of a tree placed on ``mesh`` under ``rules``: the leaves
    of ``logical_tree`` (logical axis tuples) with the shapes of the
    matching leaves of ``shape_tree`` (tensors or meta tensors).  One code
    places either strategy's parameters, a train state's moments and a
    decode cache; ``gathered(path, logical, spec)`` names the dims a
    compute gathers (``fsdp_gathered``, or ``parallel.tp``'s rule)."""

    def __init__(self, logical_tree, shape_tree, mesh: ShardMesh, rules,
                 gathered: Callable = fsdp_gathered):
        self.mesh, self.rules = mesh, rules
        self.places: Dict[Path, LeafPlace] = {
            path: _place(path, lg, tuple(_get(shape_tree, path).shape), mesh,
                         rules, gathered)
            for path, lg in _logical_leaves(logical_tree)}

    def block(self, place: LeafPlace, s: int) -> Tuple[slice, ...]:
        return block_slices(place.shape, place.spec, self.mesh, s)

    def holds_once(self, place: LeafPlace, s: int) -> bool:
        """Whether shard s is the first holder of its block (its index on
        the axes the leaf is replicated over is 0)."""
        return self.mesh.index_on(s, place.replicated) == 0

    def shard_tree(self, tree: Dict,
                   places: Optional[Dict[Path, LeafPlace]] = None
                   ) -> List[Dict]:
        """A whole tree -> one tree of blocks per present shard, each block
        a copy on its shard's device."""
        out = []
        for s in self.mesh.present:
            dev = self.mesh.devices[s]
            t: Dict = {}
            for path, pl in (places or self.places).items():
                _set(t, path, _get(tree, path)[self.block(pl, s)].to(
                    dev, copy=True))
            out.append(t)
        return out

    def unshard_tree(self, trees: Sequence[Dict], device=None,
                     places: Optional[Dict[Path, LeafPlace]] = None) -> Dict:
        """Every shard's tree of blocks -> the whole tree on ``device``
        (default: the first shard's device)."""
        if len(trees) != self.mesh.size:
            raise ValueError(f"unshard: {len(trees)} shard trees for a "
                             f"mesh of {self.mesh.size}")
        dev = device or self.mesh.devices[0]
        out: Dict = {}
        for path, place in (places or self.places).items():
            src = [_get(t, path) for t in trees]
            full = torch.empty(place.shape, dtype=src[0].dtype, device=dev)
            for s, blk in enumerate(src):
                full[self.block(place, s)] = blk.to(dev)
            _set(out, path, full)
        return out


def _n_blocks(place: LeafPlace, mesh: ShardMesh) -> int:
    return math.prod(mesh.shape[a] for e in place.spec for a in spec_axes(e))


class StateLayout(TreeLayout):
    """Every train-state leaf's placement on ``mesh`` under ``rules``:
    ``params`` the parameters' places, ``moments`` the moments' (also
    where the step reduces each gradient to and updates it): the ZeRO-1
    rules' place (``"fsdp"`` → ``rules["fsdp+"]``) where it splits a leaf
    into more blocks than its parameter's, across pods (the ``zero1``
    leaves), else the parameter's, as the reference's own sharded-step
    test places them (``DEFAULT_RULES``' ``("pod", "data")`` resolves to
    no split without a pod axis).  The compute gathers by the strategy's
    rule (``tp_gathered`` under TP rules, else ``fsdp_gathered``)."""

    def __init__(self, model, mesh: ShardMesh, rules=FSDP_RULES):
        lax_tree = logical_axes(model.cfg, model.plan)
        shapes = model.param_shapes()
        gathered = tp_gathered if is_tp(rules) else fsdp_gathered
        super().__init__(lax_tree, shapes, mesh, rules, gathered)
        self.params = self.places
        zrules = dict(rules)              # ZeRO-1 across pods for opt state
        zrules["fsdp"] = rules["fsdp+"]
        zplaces = TreeLayout(lax_tree, shapes, mesh, zrules, gathered).places
        self.moments = {p: zplaces[p] if _n_blocks(zplaces[p], mesh)
                        > _n_blocks(pl, mesh) else pl
                        for p, pl in self.params.items()}
        self.zero1 = tuple(p for p in self.params
                           if self.params[p].spec != self.moments[p].spec)
        self.opt_dtype = model.cfg.opt_dtype

    def scatter_dims(self, path: Path) -> List[Tuple[int, Tuple]]:
        """(dim, mesh axes) of every dim that the compute holds whole and
        the gradient's place splits: a gradient is reduce-scattered over
        them, in reverse order, to its owners."""
        pl, tg = self.params[path], self.moments[path]
        return [(d, tg.spec[d]) for d in range(len(pl.shape))
                if tg.spec[d] is not None
                and (d in pl.gather_dims or pl.spec[d] is None)]

    def check_step(self) -> None:
        """Each moment's owner must be able to update it: on every dim the
        compute keeps split, the moment has its parameter's split."""
        bad = []
        for p in self.zero1:
            pl, ml = self.params[p], self.moments[p]
            if any(ml.spec[d] != e for d, e in enumerate(pl.spec)
                   if e is not None and d not in pl.gather_dims):
                bad.append(p)
        if bad:
            raise NotImplementedError(
                f"build_sharded_train_step: the moments of {bad[:3]} are "
                f"sharded apart from their parameters on a dim the step "
                f"keeps split ({[self.moments[p].spec for p in bad[:3]]} "
                f"against {[self.params[p].spec for p in bad[:3]]})")

    def sub_block(self, full: torch.Tensor, path: Path, s: int):
        """Shard ``s``'s block of the moments' place, from the compute's
        block ``full`` of the leaf (its parameter gathered)."""
        for d, axes in self.scatter_dims(path):
            axes = spec_axes(axes)
            n = full.shape[d] // math.prod(self.mesh.shape[a] for a in axes)
            full = full.narrow(d, self.mesh.index_on(s, axes) * n, n)
        return full

    def param_block(self, full: torch.Tensor, path: Path, s: int):
        """Shard ``s``'s parameter block, from the compute's block."""
        pl = self.params[path]
        for d in pl.gather_dims:
            axes = spec_axes(pl.spec[d])
            n = full.shape[d] // math.prod(self.mesh.shape[a] for a in axes)
            full = full.narrow(d, self.mesh.index_on(s, axes) * n, n)
        return full

    def shard(self, state: Dict) -> List[Dict]:
        """A state -> one state of blocks per present shard, each block a
        copy on its shard's device."""
        ps = self.shard_tree(state["params"])
        ms = {k: self.shard_tree(state["opt"][k], self.moments)
              for k in ("m", "v")}
        return [{"params": ps[i], "opt": {
            "m": ms["m"][i], "v": ms["v"][i],
            "step": state["opt"]["step"].to(self.mesh.devices[s], copy=True)}}
            for i, s in enumerate(self.mesh.present)]

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
    its blocks never coexist beyond one leaf; zero moments (of the
    moments' blocks) in ``cfg.opt_dtype`` and a zero step on every
    shard."""
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
            _set(out[i]["params"], path,
                 leaf[lay.block(pl, s)].to(dev, copy=True))
            mshape = tuple(b.stop - b.start for b in lay.block(
                lay.moments[path], s))
            for k in ("m", "v"):
                _set(out[i]["opt"][k], path, torch.zeros(
                    mshape, dtype=mdt, device=dev))
        _set(params, path, None)            # free the whole leaf
        del leaf
    return out


def split_batch(batch: Dict, cfg, mesh: ShardMesh, rules=FSDP_RULES,
                kind: str = "train") -> List[Dict]:
    """The global batch of a ``kind`` step -> each present shard's block of
    every leaf (by ``batch_logical``'s spec), on the shard's device."""
    blog = batch_logical(cfg, kind)
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


def gather_blocks(blocks, place: LeafPlace, mesh: ShardMesh,
                  index: Optional[int] = None) -> List[torch.Tensor]:
    """The present shards' blocks of one leaf (its ``index``-th group slice
    of a stacked leaf) all-gathered over each of ``place.gather_dims``' axes,
    one tensor per present shard."""
    off = 0 if index is None else 1       # a group slice drops dim 0
    parts = list(blocks)
    for d in place.gather_dims:
        parts = all_gather(parts, mesh, axis=place.spec[d], dim=d - off)
    return parts


class _LeafGather:
    """One leaf's gather on a mesh (``_Gather``'s forward and backward);
    ``sinks[i]`` is the present shard i's f32 gradient block (of
    ``lay.moments``' place; ``index``: the group slice of a stacked
    leaf)."""

    def __init__(self, lay: StateLayout, path: Path, sinks, index):
        self.place, self.mesh = lay.params[path], lay.mesh
        self.sinks, self.index = sinks, index
        off = 0 if index is None else 1       # a group slice drops dim 0
        self.steps = [(d - off, axes) for d, axes in lay.scatter_dims(path)]
        self.replicated = lay.moments[path].replicated

    def forward(self, blocks):
        with torch.no_grad():
            parts = gather_blocks(blocks, self.place, self.mesh, self.index)
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
            if self.replicated:
                parts = all_reduce(parts, self.mesh, self.replicated,
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
    shard's f32 gradient blocks (of ``StateLayout.moments``' places)
    before the clip (a copy).

    Under TP rules (``is_tp``) the walk is ``parallel.tp``'s and every
    collective of the forward, its backward included, is counted
    (``ADJOINT``); the model must be built on ``mesh`` (``TPServe``'s
    checks apply).  A layout the step cannot run raises."""
    lr_schedule = lr_schedule or cosine_schedule
    lay = StateLayout(model, mesh, rules)
    lay.check_step()
    cfg, dm = model.cfg, model.dm
    present = mesh.present
    devs = [mesh.devices[s] for s in present]
    dev0 = devs[0]
    tp = is_tp(rules)
    coll = ADJOINT if tp else PLAIN
    if tp:
        from repro_torch.parallel.tp import TPServe, TrainHooks
        if model.mesh != mesh:
            raise ValueError("build_sharded_train_step: a TP step runs on "
                             "the mesh its Model was built with")
        prog = TPServe(model, rules)

    def on_shards(fn, *lists):
        out = []
        for i, dev in enumerate(devs):
            with on_device(dev):
                out.append(fn(i, *(lst[i] for lst in lists)))
        return out

    def update_zero1(shards, path, grads, scale, lr):
        """A ZeRO-1 leaf: each owner's slice of the parameter (gathered
        from the parameter's blocks) updated with its moments and its
        gradient block ``grads[i]``, the slices all-gathered back into
        the parameter's blocks."""
        with torch.no_grad():
            full = gather_blocks([_get(sh["params"], path) for sh in shards],
                                 lay.params[path], mesh)
            sl = [lay.sub_block(f, path, s).clone()
                  for f, s in zip(full, present)]
            del full
            for i, sh in enumerate(shards):
                g = grads[i].mul_(scale.to(devs[i]))
                adamw_update({"p": sl[i]}, {"p": g},
                             {"m": {"p": _get(sh["opt"]["m"], path)},
                              "v": {"p": _get(sh["opt"]["v"], path)},
                              "step": sh["opt"]["step"]}, lr.to(devs[i]))
            for d, axes in lay.scatter_dims(path):
                sl = all_gather(sl, mesh, axis=axes, dim=d)
            for i, (sh, s) in enumerate(zip(shards, present)):
                _get(sh["params"], path).copy_(
                    lay.param_block(sl[i], path, s))

    def train_step(shards: List[Dict], batch: Dict):
        if len(shards) != len(present):
            raise ValueError(f"train_step: {len(shards)} shard states for "
                             f"{len(present)} present shards")
        B = batch["tokens"].shape[0]
        bparts = split_batch(batch, cfg, mesh, rules)
        if isinstance(model._sa, ActSharder):
            model._sa.global_sizes = {"batch": B}
        sinks = {path: [torch.zeros(
            tuple(b.stop - b.start for b in lay.block(lay.moments[path], s)),
            dtype=torch.float32, device=dev) for s, dev in zip(present, devs)]
            for path in lay.params}
        dummy = torch.zeros((), device=dev0, requires_grad=True)

        def gather(path: Path, index: Optional[int] = None):
            """The leaf at ``path`` (its ``index``-th group slice) on every
            present shard."""
            g = _LeafGather(lay, path, sinks[path], index)
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

        if tp:
            h = TrainHooks(prog, fetch, B)
        else:
            h = PartHooks(model, fetch, on_shards,
                          lambda xs, ps: moe_ffn_shards(xs, ps, cfg, dm, mesh))
        sums, aux = model._train_parts(h, bparts)
        tot = coll.all_reduce([t.reshape(1) for t, _ in sums], mesh)[0]
        cnt = coll.all_reduce([c.reshape(1) for _, c in sums], mesh)[0]
        ce = (tot / torch.clamp_min(cnt, 1.0)).reshape(()).to(dev0)
        aux = aux.to(dev0)
        total = ce + 0.01 * aux
        total.backward()
        del sums, total

        # the global clip norm: every block's squared sum once
        sq = []
        for i, s in enumerate(present):
            acc = torch.zeros((), dtype=torch.float32, device=devs[i])
            for path, pl in lay.moments.items():
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
            grads, params, m, v = {}, {}, {}, {}
            for path in lay.params:
                if path in lay.zero1:
                    continue
                _set(grads, path, sinks[path][i].mul_(sc))
                for tree, src in ((params, sh["params"]),
                                  (m, sh["opt"]["m"]), (v, sh["opt"]["v"])):
                    _set(tree, path, _get(src, path))
            _, opt = adamw_update(params, grads, {
                "m": m, "v": v, "step": sh["opt"]["step"]}, lr.to(devs[i]))
            new.append({"params": sh["params"], "opt": {
                "m": sh["opt"]["m"], "v": sh["opt"]["v"],
                "step": opt["step"]}})
        for path in lay.zero1:
            update_zero1(shards, path, sinks[path], scale, lr)
        metrics = dict(loss=ce.detach(), aux=aux.detach(), grad_norm=gn,
                       lr=lr, step=new[0]["opt"]["step"].float())
        if kept is not None:
            metrics["grads"] = kept
        return new, metrics

    return train_step
