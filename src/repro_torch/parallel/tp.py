"""The tensor-parallel (TP) strategy's serving program: prefill and decode
on the per-shard blocks of a ``ShardMesh`` under ``DEFAULT_RULES``, the
counterpart of what GSPMD derives for the reference from those rules
(``jax.jit(model.prefill)`` / ``model.decode`` with ``tree_shardings`` of
the parameters and ``cache_logical`` of the cache); and the same
sublayers as the hooks of its train step (``TrainHooks``, run by
``parallel.fsdp.build_sharded_train_step`` under TP rules).

Placement.  Every parameter and cache leaf is split by ``spec_for_logical``
(``parallel.fsdp.TreeLayout``, the layout code of the FSDP step): weights
FSDP over ``data`` × TP over ``model``, the batch over ``(pod, data)``;
a dim that does not divide stays whole.  The padded dims are the plan's
(``ShardPlan(tp=...)`` pads heads and vocab); padded heads are real heads.

The program is ``Model._serve``, the walk the unsharded ``prefill`` /
``decode`` run, with this module's hooks (``_Hooks``) on the mesh's
present shards:

* fetch: each group's leaves all-gathered over their ``data`` dims for use
  and freed after the group; a ``model`` dim stays split (Megatron), but
  for an SSM's ``w_in`` / ``conv_w`` / ``conv_b`` (see below) and the
  experts' ``d_ff`` when the experts do not divide ``model`` (they are
  replicated in the block, the reference's MoE fallback);
* attention and MLP: column-parallel ``wq`` / ``wk`` / ``wv`` (and biases),
  ``w_in`` / ``w_gate`` on each shard's heads or ``d_ff`` slice, then the
  row-parallel ``wo`` / ``w_out`` partial sums ``all_reduce``-d over
  ``model``.  Local query head j reads local KV head j // (h / kh): the
  padded plan keeps kh a multiple of the ``model`` size;
* the embedding is vocab-parallel (``(vocab@model, d@data)``): each shard
  looks up the ids in its rows, zeros the rest, and the ``all_reduce`` over
  ``model`` sums one nonzero row per id; the logits are vocab-parallel
  (``("batch", "tp")`` blocks of ``lm_head``, or of ``embed.T`` when tied)
  and all-gathered, then over the batch, into the caller's (B, vocab) f32;
* sequence parallelism (``opts["sp"]``): the residual stream is
  ``("batch", "sp", None)``, all-gathered over ``model`` before each
  sublayer and reduce-scattered after it; a sequence that does not divide
  (decode's one token) stays whole, as ``spec_for_logical`` drops it;
* an SSM sublayer splits its heads over ``model``.  ``w_in``'s output dim
  is ``[z | x | B | C | dt]`` and ``conv_dim`` is ``[x | B | C]``, whose
  contiguous ``model`` blocks do not line up with heads, so the fetch
  gathers those three leaves whole and each shard takes its heads'
  columns of z, x and dt plus all of B and C (``n_groups`` = 1: every head
  reads them).  The gated output RMSNorm over the whole ``d_inner`` takes
  the ``all_reduce`` of the shards' squared sums; the state cache is split
  by heads; the conv cache keeps its spec's contiguous block, so a decode
  step all-gathers the small conv tail over ``model`` and each shard
  writes back its own block (its block's new column is one more product
  of the token's normed input);
* the MoE splits tokens as the reference's ``shard_map`` does
  (``models.moe.token_axes``, ``model`` included when it divides): each
  shard routes its own slice of its data block with its own capacity
  (``moe_shards``: EP over ``model``, or replicated experts), and the
  outputs are all-gathered over ``model``;
* a long-context cache (``long_context=True``: ``cache_logical`` puts the
  KV sequence on ``data`` when the batch cannot take it) decodes by the
  flash-decoding merge: each ``data`` rank attends over its positions,
  the ranks' (weighted V, sum of exponentials, running max) are
  all-gathered and merged, and only the rank that owns ``cur_len`` writes
  the new K/V.

Every collective is one of ``parallel.sharding``'s, so a
``CollectiveCounter`` sees every byte.  A layout the program cannot run
raises; nothing falls back to the unsharded path.  On ``mesh.share(s)``
the same code runs one device's share (the dry-run)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_rope, mlp, norm
from repro_torch.models.moe import moe_shards, token_axes
from repro_torch.models.params import logical_axes
from repro_torch.parallel.fsdp import (TreeLayout, _get, _ssm_whole,
                                       gather_blocks, split_batch,
                                       tp_gathered)
from repro_torch.parallel.sharding import (ADJOINT, DEFAULT_RULES, PLAIN,
                                           ActSharder, cache_logical,
                                           on_device, spec_axes,
                                           spec_for_logical)

class TPServe:
    """The TP serving program of ``model`` (a ``Model`` built with its
    ``ShardMesh`` and ``make_act_sharder(mesh, DEFAULT_RULES)``, the
    reference's constructor).  ``shard_params`` / ``cache_layout`` place
    the trees; ``prefill(shards, batch, cache_len)`` and ``decode(shards,
    caches, cur_len, token)`` take the present shards' parameter blocks
    (and caches) and the global batch, and return what the unsharded
    ``Model`` returns: the caches (one tree of blocks per present shard,
    decode writes them in place) and the f32 logits over the padded vocab,
    gathered on the first present shard's device.  ``long_context``: the
    cache's KV sequence on ``data`` (``cache_logical(long_context=True)``).
    Raises on a layout it cannot run."""

    def __init__(self, model, rules=DEFAULT_RULES, long_context: bool = False):
        if model.mesh is None:
            raise ValueError("TPServe: the model has no mesh")
        self.model, self.mesh, self.rules = model, model.mesh, rules
        self.cfg, self.dm = model.cfg, model.dm
        self.long_context = long_context
        self.layout = TreeLayout(logical_axes(model.cfg, model.plan),
                                 model.param_shapes(), self.mesh, rules,
                                 gathered=tp_gathered)
        self.M = self.mesh.shape.get("model", 1)
        self._check()
        M, dm = self.M, self.dm
        self.dl = dataclasses.replace(dm, h=dm.h // M, kh=dm.kh // M)
        self.dsl = dataclasses.replace(
            dm, d_inner=dm.d_inner // M, ssm_h=dm.ssm_h // M,
            conv_dim=dm.d_inner // M + 2 * dm.ssm_n)

    def _check(self) -> None:
        """The layouts the program runs: ``model`` the mesh's last axis,
        heads (and SSM heads) in whole blocks per ``model`` rank, and every
        ``"tp"`` dim a shard consumes by its ``model`` slice split over
        ``model``."""
        M, dm, cfg = self.M, self.dm, self.cfg
        if "model" in self.mesh.axis_names and \
                self.mesh.axis_names[-1] != "model":
            raise NotImplementedError(
                f"TPServe: the model axis must be the mesh's last "
                f"(axes {self.mesh.axis_names})")
        if M == 1:
            return
        bad = []
        if cfg.family != "ssm" and (dm.h % M or dm.kh % M):
            bad.append(f"{dm.h} query / {dm.kh} KV heads")
        if dm.ssm_h % M:
            bad.append(f"{dm.ssm_h} SSM heads")
        lax_tree = logical_axes(cfg, self.model.plan)
        for path, pl in self.layout.places.items():
            lg = _get(lax_tree, path)
            if "expert" in lg or _ssm_whole(path):
                continue
            for d, name in enumerate(lg):
                if name == "tp" and d not in pl.gather_dims and \
                        pl.spec[d] != "model":
                    bad.append(f"{'/'.join(path)} dim {d} of "
                               f"{pl.shape[d]} not split over model")
        if bad:
            raise ValueError(f"TPServe: model axis {M} cannot split "
                             f"{'; '.join(bad)} (build the Model with "
                             f"ShardPlan(tp={M}))")

    # --------------------------------------------------------- placement
    def shard_params(self, params: Dict) -> List[Dict]:
        """The whole parameter tree -> the present shards' blocks."""
        return self.layout.shard_tree(params)

    def unshard_params(self, shards: Sequence[Dict], device=None) -> Dict:
        return self.layout.unshard_tree(shards, device)

    def kv_axes(self, batch_size: int,
                max_len: Optional[int] = None) -> Tuple[str, ...]:
        """The mesh axes a cache's KV sequence splits over: with
        ``long_context``, ``cache_logical``'s ``"seq"`` axes that the batch
        leaves free (none otherwise).  A cache of ``max_len`` positions
        must divide over them."""
        if not self.long_context:
            return ()
        whole = math.prod(self.mesh.axis_sizes)
        axes = spec_axes(spec_for_logical(("batch", "seq"),
                                          (batch_size, whole), self.mesh,
                                          self.rules)[1])
        n = math.prod(self.mesh.shape[a] for a in axes)
        if max_len is not None and max_len % n:
            raise ValueError(f"TPServe: a long-context cache of {max_len} "
                             f"positions does not split over {n} ranks")
        return axes

    def cache_layout(self, batch_size: int, max_len: int,
                     enc_len: Optional[int] = None) -> TreeLayout:
        """The decode cache's placement (``cache_logical``) at this batch
        and length (``enc_len``: an encdec memory's length)."""
        self.kv_axes(batch_size, max_len)
        return TreeLayout(cache_logical(self.cfg, self.long_context),
                          self.model.init_cache(batch_size, max_len, "meta",
                                                enc_len),
                          self.mesh, self.rules)

    # ------------------------------------------------------------ program
    def prefill(self, shards: Sequence[Dict], batch: Dict,
                cache_len: Optional[int] = None):
        """(caches, logits) of the global ``batch`` (``tokens`` and the
        frontend leaves), each part's cache of ``cache_len`` positions."""
        B, S = batch["tokens"].shape
        cache_len = cache_len or S
        self.kv_axes(B, cache_len)                # raises on a bad length
        parts = split_batch(batch, self.cfg, self.mesh, self.rules, "prefill")
        with torch.no_grad():
            return self.model._serve(_Hooks(self, shards, B), parts,
                                     cache_len=cache_len)

    def decode(self, shards: Sequence[Dict], caches: Sequence[Dict],
               cur_len: int, token: torch.Tensor):
        """(logits, caches) of one step: ``token`` (B,) written at
        ``cur_len`` (a Python int) into the caches, in place."""
        parts = split_batch({"token": token}, self.cfg, self.mesh, self.rules,
                            "decode")
        with torch.no_grad():
            _, logits = self.model._serve(_Hooks(self, shards, token.shape[0]),
                                          parts, caches=list(caches),
                                          cur_len=int(cur_len))
        return logits, caches


class _Hooks:
    """``Model._serve``'s hooks for one TP call on the present shards
    (``coll``: the collectives, ``PLAIN`` for serving)."""

    def __init__(self, prog: TPServe, shards: Sequence[Dict], B: int,
                 coll=PLAIN):
        self.p, self.B, self.c = prog, B, coll
        self.shards = list(shards or ())
        self.m, self.cfg, self.dm = prog.model, prog.cfg, prog.dm
        mesh = self.mesh = prog.mesh
        if shards is not None and len(self.shards) != len(mesh.present):
            raise ValueError(f"TPServe: {len(self.shards)} shard trees for "
                             f"{len(mesh.present)} present shards")
        self.devs = [mesh.devices[s] for s in mesh.present]
        self.rank = [mesh.coords(s).get("model", 0) for s in mesh.present]
        self.bax = spec_axes(spec_for_logical(("batch", None), (B, 1), mesh,
                                              prog.rules)[0])
        self.kv_axes = prog.kv_axes(B)
        conv = cache_logical(prog.cfg).get("conv")
        self.conv_axes = () if conv is None else spec_axes(spec_for_logical(
            conv, prog.model.init_cache(B, 1, "meta")["conv"].shape, mesh,
            prog.rules)[-1])
        self.seq, self.sp_axis = 1, None

    # ---------------------------------------------------------- plumbing
    def each(self, fn, *lists):
        out = []
        for i, dev in enumerate(self.devs):
            with on_device(dev):
                out.append(fn(i, *(lst[i] for lst in lists)))
        return out

    def fetch(self, names, g: Optional[int] = None):
        """Every leaf under the top-level ``names`` (its group-g slice),
        gathered for use, one tree per present shard."""
        trees: List[Dict] = [{} for _ in self.devs]
        for path, pl in self.p.layout.places.items():
            if path[0] not in names:
                continue
            blocks = [_get(sh, path) for sh in self.shards]
            if g is not None:
                blocks = [b[g] for b in blocks]
            for t, w in zip(trees, gather_blocks(blocks, pl, self.mesh, g)):
                node = t
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = w
        return trees

    def _stream(self, seq: int) -> None:
        """A residual stream of global length ``seq`` begins: is its
        sequence split (SP)?"""
        self.seq = seq
        spec = spec_for_logical(self.m._res_spec(), (self.B, seq, self.dm.d),
                                self.mesh, self.p.rules)
        self.sp_axis = spec[1]

    def enter(self, xs):
        """A whole-sequence stream (an encoder's input) into its layout."""
        self._stream(xs[0].shape[1])
        if self.sp_axis is None:
            return xs
        n = self.seq // self.mesh.shape[self.sp_axis]
        return [x.narrow(1, self.mesh.index_on(s, spec_axes(self.sp_axis)) * n,
                         n) for x, s in zip(xs, self.mesh.present)]

    def leave(self, xs):
        """A stream back to its whole sequence."""
        return self._full(xs)

    def _full(self, xs):
        """The stream's whole sequence (SP: all-gathered over its axis)."""
        if self.sp_axis is None:
            return xs
        return self.c.all_gather(xs, self.mesh, axis=self.sp_axis, dim=1)

    def _reduce(self, ys):
        """The row-parallel partial sums over ``model``: all-reduced, or
        under SP reduce-scattered over the sequence."""
        if self.p.M == 1:
            return ys
        if self.sp_axis is not None:
            return self.c.reduce_scatter(ys, self.mesh, self.sp_axis, dim=1)
        return self.c.all_reduce(ys, self.mesh, "model")

    def _add(self, xs, ys):
        return [x + y for x, y in zip(xs, self._reduce(ys))]

    def act(self, xs):
        sa = self.m._sa
        if isinstance(sa, ActSharder):
            sa.global_sizes = {"batch": self.B, "sp": self.seq}
        return [sa(x, self.m._res_spec()) for x in xs]

    # ----------------------------------------------------- embedding, head
    def embed(self, toks):
        self._stream(toks[0].shape[1])
        pl = self.p.layout.places[("embed",)]
        ws = self.fetch(("embed",))
        if "model" not in spec_axes(pl.spec[0]):
            return self.each(lambda i, t, w: w["embed"][t], toks, ws)
        nv = pl.shape[0] // self.p.M

        def lookup(i, t, w):
            loc = t.long() - self.rank[i] * nv
            ok = (loc >= 0) & (loc < nv)
            rows = w["embed"][torch.where(ok, loc, 0)]
            return torch.where(ok[..., None], rows, torch.zeros_like(rows))
        ys = self.each(lookup, toks, ws)
        if self.sp_axis is not None:
            return self.c.reduce_scatter(ys, self.mesh, self.sp_axis, dim=1)
        return self.c.all_reduce(ys, self.mesh, "model")

    def logits(self, xs):
        if self.sp_axis is not None:          # the last position's owner
            last = self.c.all_gather([x[:, -1:] for x in xs], self.mesh,
                                     axis=self.sp_axis, dim=1)
            xl = [x[:, -1] for x in last]
        else:
            xl = [x[:, -1] for x in xs]
        tie = self.cfg.tie_embeddings
        key = "embed" if tie else "lm_head"
        heads = self.fetch((key,))
        loc = self.each(lambda i, x, w: x.float() @ (
            w[key].T if tie else w[key]).to(x.dtype).float(), xl, heads)
        pl = self.p.layout.places[(key,)]
        sa = self.m._sa
        if isinstance(sa, ActSharder):
            sa.global_sizes = {"batch": self.B, "tp": pl.shape[0 if tie else 1]}
            loc = [sa(t, ("batch", "tp")) for t in loc]
        if "model" in spec_axes(pl.spec[0 if tie else 1]):
            loc = self.c.all_gather(loc, self.mesh, axis="model", dim=-1)
        if self.bax:
            loc = self.c.all_gather(loc, self.mesh, axis=self.bax, dim=0)
        return loc[0]

    # ---------------------------------------------------------- attention
    def attn(self, xs, ps, positions, causal=True, cache_len=None):
        cfg, dl, ao = self.cfg, self.p.dl, self.m._attn_opts
        xg = self._full(xs)
        if cache_len is None:                 # the encoder's
            outs = self.each(lambda i, x, p, pos: attn.self_attn_train(
                x, p, cfg, dl, pos, causal=causal, opts=ao), xg, ps, positions)
            return self._add(xs, outs), None
        res = self.each(lambda i, x, p, pos: attn.self_attn_prefill(
            x, p, cfg, dl, pos, opts=ao), xg, ps, positions)
        pad = cache_len - xg[0].shape[1]
        kvs = []
        for s, (_, (k, v)) in zip(self.mesh.present, res):
            if pad:
                k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
            if self.kv_axes:                  # this rank's positions
                n = cache_len // math.prod(self.mesh.shape[a]
                                           for a in self.kv_axes)
                j = self.mesh.index_on(s, self.kv_axes)
                k, v = k.narrow(1, j * n, n), v.narrow(1, j * n, n)
            kvs.append((k, v))
        return self._add(xs, [o for o, _ in res]), kvs

    def attn_decode(self, xs, ps, ks, vs, cur_len: int):
        cfg, dl = self.cfg, self.p.dl
        if not self.kv_axes:
            outs = self.each(lambda i, x, p, k, v: attn.self_attn_decode(
                x, p, cfg, dl, k, v, cur_len)[0], xs, ps, ks, vs)
            return self._add(xs, outs)
        # the sequence-sharded cache: each rank's partial softmax, merged
        n = ks[0].shape[1]
        offs = [self.mesh.index_on(s, self.kv_axes) * n
                for s in self.mesh.present]
        parts = self.each(lambda i, x, p, k, v: _decode_partial(
            x, p, cfg, dl, k, v, cur_len, offs[i]), xs, ps, ks, vs)
        stats = self.c.all_gather([st[None] for st in parts], self.mesh,
                                  axis=self.kv_axes, dim=0)
        hd = dl.hd

        def merge(i, st, x, p):
            acc, l, m = st[..., :hd], st[..., hd], st[..., hd + 1]
            w = torch.exp(m - m.amax(dim=0))              # (n, B, Kh, G)
            o = (acc * w[..., None]).sum(dim=0) / torch.clamp_min(
                (l * w).sum(dim=0), 1e-30)[..., None]
            b = x.shape[0]
            o = o.reshape(b, 1, dl.h * hd).to(x.dtype)
            return o @ p["wo"]
        outs = self.each(merge, stats, xs, ps)
        return self._add(xs, outs)

    def cross(self, xs, ps, memories):
        cfg, dl, ao = self.cfg, self.p.dl, self.m._attn_opts
        xg = self._full(xs)
        ckv = self.each(lambda i, mem, p: attn.cross_kv(mem, p, cfg, dl),
                        memories, ps)
        outs = self.each(lambda i, x, kv, p: attn.cross_attn(
            x, kv, p, cfg, dl, opts=ao), xg, ckv, ps)
        return self._add(xs, outs), ckv

    def cross_decode(self, xs, ps, cks, cvs):
        cfg, dl = self.cfg, self.p.dl
        outs = self.each(lambda i, x, p, k, v: attn.cross_decode(
            x, p, cfg, dl, k, v), xs, ps, cks, cvs)
        return self._add(xs, outs)

    # --------------------------------------------------------- MLP, MoE
    def mlp(self, xs, ps):
        cfg = self.cfg
        outs = self.each(lambda i, x, p: mlp(norm(x, p, cfg.norm), p,
                                             cfg.mlp_act),
                         self._full(xs), ps)
        return self._add(xs, outs)

    def moe(self, xs, ps):
        cfg, dm, mesh = self.cfg, self.dm, self.mesh
        xg = self._full(xs)
        b, s, d = xg[0].shape
        hs = self.each(lambda i, x, p: norm(x, p, cfg.norm).reshape(-1, d),
                       xg, ps)
        tax = token_axes(mesh, self.B * s)
        if tuple(tax[:len(self.bax)]) != tuple(self.bax):
            raise NotImplementedError(
                f"TPServe: the MoE's token axes {tax} do not refine the "
                f"batch axes {self.bax}")
        rest = tuple(tax[len(self.bax):])
        n = math.prod(mesh.shape[a] for a in rest)
        toks = [torch.chunk(h, n)[mesh.index_on(sh, rest)] if rest else h
                for h, sh in zip(hs, mesh.present)]
        ys, aux = moe_shards(toks, ps, cfg.moe_top_k, cfg.capacity_factor,
                             dm.e, mesh, self.c)
        if rest:
            ys = self.c.all_gather(ys, mesh, axis=rest, dim=0)
        ys = [y.reshape(b, s, d) for y in ys]
        if self.sp_axis is not None:          # back to this rank's slice
            k = s // mesh.shape[self.sp_axis]
            ys = [y.narrow(1, mesh.index_on(sh, spec_axes(self.sp_axis)) * k, k)
                  for y, sh in zip(ys, mesh.present)]
        return [x + y for x, y in zip(xs, ys)], aux

    # --------------------------------------------------------------- SSM
    def _ssm_cols(self, i: int, p: Dict) -> Dict:
        """Shard i's heads of an SSM sublayer: its columns of z, x and dt
        and all of B and C from the whole ``w_in``, its x columns and B, C
        of the conv; the rest is its fetched block."""
        if self.p.M == 1:
            return p
        dm, r = self.dm, self.rank[i]
        di, n, H = dm.d_inner, dm.ssm_n, dm.ssm_h
        dil, hl = di // self.p.M, H // self.p.M
        w = p["w_in"]
        q = dict(p)
        q["w_in"] = torch.cat([
            w[:, r * dil:(r + 1) * dil],                      # z
            w[:, di + r * dil:di + (r + 1) * dil],            # x
            w[:, 2 * di:2 * di + 2 * n],                      # B, C
            w[:, 2 * di + 2 * n + r * hl:2 * di + 2 * n + (r + 1) * hl]],  # dt
            dim=1)
        for k in ("conv_w", "conv_b"):
            c = p[k]
            q[k] = torch.cat([c[..., r * dil:(r + 1) * dil],
                              c[..., di:di + 2 * n]], dim=-1)
        return q

    def _conv_cols(self, i: int) -> slice:
        """Shard i's block of ``conv_dim`` in the conv cache."""
        cd = self.dm.conv_dim
        if not self.conv_axes:
            return slice(0, cd)
        n = cd // math.prod(self.mesh.shape[a] for a in self.conv_axes)
        j = self.mesh.index_on(self.mesh.present[i], self.conv_axes)
        return slice(j * n, (j + 1) * n)

    def _conv_new(self, i: int, x, p):
        """The pre-conv xBC columns of shard i's conv-cache block for the
        positions of ``x`` (the block's own product of the normed input)."""
        c = self._conv_cols(i)
        di = self.dm.d_inner
        return norm(x, p, self.cfg.norm) @ p["w_in"][:, di + c.start:
                                                       di + c.stop]

    def _out(self, gs, ps):
        """The gated RMSNorm over the whole ``d_inner`` (the shards' squared
        sums all-reduced over ``model``), then the row-parallel
        ``w_out``."""
        if self.p.M == 1:
            ys = self.each(lambda i, g, p: ssm_mod.rmsnorm(g, p["out_norm"]),
                           gs, ps)
        else:
            sq = self.c.all_reduce(self.each(lambda i, g: torch.sum(
                torch.square(g.float()), dim=-1, keepdim=True), gs),
                self.mesh, "model")
            di = float(self.dm.d_inner)
            ys = self.each(lambda i, g, q, p: (
                g.float() * torch.rsqrt(q / di + 1e-5)
                * p["out_norm"].float()).to(g.dtype), gs, sq, ps)
        return self.each(lambda i, y, p: y @ p["w_out"], ys, ps)

    def ssm_train(self, xs, ps):
        """The SSM sublayer over the shards' heads, no decode state."""
        cfg, so = self.cfg, self.m._ssm_opts
        gs = self.each(lambda i, x, p: ssm_mod.mamba_gated(
            x, self._ssm_cols(i, p), cfg, self.p.dsl, opts=so)[0],
            self._full(xs), ps)
        return self._add(xs, self._out(gs, ps))

    def ssm(self, xs, ps):
        cfg, so = self.cfg, self.m._ssm_opts
        xg = self._full(xs)
        res = self.each(lambda i, x, p: ssm_mod.mamba_gated(
            x, self._ssm_cols(i, p), cfg, self.p.dsl, opts=so), xg, ps)
        w = self.dm.conv_w - 1
        tails = self.each(lambda i, x, p: self._conv_new(i, x[:, -w:], p),
                          xg, ps)
        outs = self._out([g for g, _ in res], ps)
        return self._add(xs, outs), [(st, t) for (_, st), t in zip(res, tails)]

    def ssm_decode(self, xs, ps, sts, convs):
        cfg = self.cfg
        full = (self.c.all_gather(convs, self.mesh, axis=self.conv_axes,
                                  dim=-1)
                if self.conv_axes else convs)
        di, n = self.dm.d_inner, self.dm.ssm_n
        dil = di // self.p.M

        def step(i, x, p, st, cf):
            r = self.rank[i]
            mine = cf if self.p.M == 1 else torch.cat(
                [cf[..., r * dil:(r + 1) * dil], cf[..., di:di + 2 * n]], -1)
            g, new_st, _ = ssm_mod.mamba_decode_gated(
                x, self._ssm_cols(i, p), cfg, self.p.dsl, st, mine)
            blk = torch.cat([cf[:, 1:, self._conv_cols(i)],
                             self._conv_new(i, x, p)], dim=1)
            st.copy_(new_st)
            return g, blk
        res = self.each(step, xs, ps, sts, full)
        for c, (_, blk) in zip(convs, res):
            c.copy_(blk)
        return self._add(xs, self._out([g for g, _ in res], ps))


class TrainHooks(_Hooks):
    """``Model._train_parts``' hooks for the TP train step
    (``parallel.fsdp.build_sharded_train_step`` under TP rules): the
    serving program's sublayers with ``ADJOINT`` collectives, so every
    forward collective's adjoint runs, counted, in backward.  ``fetch`` is
    the step's (the weights gathered over ``data`` inside the checkpointed
    region, their gradients reduce-scattered back to the owners).

    Each shard's copy of a replicated activation is its own tensor, so a
    collective's backward is its adjoint: a row-parallel ``all_reduce``'s
    is an ``all_reduce`` of the shards' partial gradients (what the
    Megatron pair, identity here and an ``all_reduce`` at the next
    column-parallel input, moves too), and a leaf replicated over
    ``model`` (the norms, the router) collects a partial gradient on each
    rank, all-reduced over ``model`` by the step.  The loss sums are
    all-reduced over the whole mesh, each ``model`` rank's copy of its
    tokens' NLL included: the rank count cancels in the ratio."""

    def __init__(self, prog: TPServe, fetch, B: int):
        super().__init__(prog, None, B, ADJOINT)
        self.fetch = fetch

    def ce(self, xs, batches):
        """Each shard's (summed token NLL, scored-token count) of its batch
        block: the whole sequence (SP left), then the vocab-parallel cross
        entropy in slices of ``ce_chunk`` positions, each checkpointed
        across the shards so its f32 logits are recomputed in backward.
        Each ``model`` rank scores its vocab block; per token the ranks'
        (max, sum of exponentials) are all-gathered and merged and the
        label's logit comes from the rank that owns its row by an
        ``all_reduce``; padded columns (>= ``cfg.vocab_size``) are masked.
        A head whose vocab is not split runs the unsharded ``_ce_sums``."""
        cfg, m = self.cfg, self.m
        xs = self.leave(xs)
        tie = cfg.tie_embeddings
        key = "embed" if tie else "lm_head"
        heads = [m._head_matrix(h) for h in self.fetch((key,))]
        pl = self.p.layout.places[(key,)]
        if "model" not in spec_axes(pl.spec[0 if tie else 1]):
            return self.each(lambda i, x, h, b: m._ce_sums(h, x, b["labels"]),
                             xs, heads, batches)
        n = len(xs)
        s = xs[0].shape[1]
        c = min(int(m.opts.get("ce_chunk", 1024)), s)
        pad = (-s) % c
        labels = [b["labels"] for b in batches]
        if pad:
            xs = [F.pad(x, (0, 0, 0, pad)) for x in xs]
            labels = [F.pad(lb, (0, pad), value=-1) for lb in labels]
        nv = heads[0].shape[1]

        def chunk(*args):
            xc, lc, hd = args[:n], args[n:2 * n], args[2 * n:]

            def local(i, x, h, lb):
                lg = x.float() @ h.to(x.dtype).float()          # (b, c, nv)
                col = self.rank[i] * nv + torch.arange(nv, device=x.device)
                lg = torch.where(col >= cfg.vocab_size, -1e30, lg)
                mx = lg.amax(dim=-1).detach()
                se = torch.exp(lg - mx[..., None]).sum(dim=-1)
                loc = lb.long() - self.rank[i] * nv
                own = (loc >= 0) & (loc < nv)
                gold = torch.gather(lg, -1,
                                    torch.where(own, loc, 0)[..., None])[..., 0]
                return (torch.stack([mx, se])[None],
                        torch.where(own, gold, 0.0))
            loc = self.each(local, xc, hd, lc)
            st = self.c.all_gather([t for t, _ in loc], self.mesh,
                                   axis="model", dim=0)
            gold = self.c.all_reduce([g for _, g in loc], self.mesh, "model")

            def merge(i, st, gold, lb):
                mx = st[:, 0].detach()                          # (M, b, c)
                top = mx.amax(dim=0)
                lse = top + torch.log(torch.sum(
                    st[:, 1] * torch.exp(mx - top), dim=0))
                valid = (lb >= 0).float()
                return (torch.sum((lse - gold) * valid).reshape(()),
                        torch.sum(valid))
            out = self.each(merge, st, gold, lc)
            return tuple(t for pair in out for t in pair)

        sums = [(torch.zeros((), dtype=torch.float32, device=x.device),
                 torch.zeros((), dtype=torch.float32, device=x.device))
                for x in xs]
        for j in range(xs[0].shape[1] // c):
            args = ([x[:, j * c:(j + 1) * c] for x in xs]
                    + [lb[:, j * c:(j + 1) * c] for lb in labels] + heads)
            got = checkpoint(chunk, *args, use_reentrant=False,
                             preserve_rng_state=False)
            sums = [(t + got[2 * i], k + got[2 * i + 1])
                    for i, (t, k) in enumerate(sums)]
        return sums


def _decode_partial(x1, p, cfg, dm, ck, cv, cur_len: int, off: int):
    """One rank's share of a decode step over a sequence-sharded KV block
    holding positions [off, off + len): the new K/V written if this rank
    owns ``cur_len``; returns the (B, Kh, G, hd + 2) f32 of its weighted V
    sum, sum of exponentials and running max over its valid positions."""
    h = norm(x1, p, cfg.norm)
    q, k, v = attn._qkv(h, p, cfg, dm)
    if cfg.rope_theta:
        pos = torch.full((1, 1), cur_len, dtype=torch.int32, device=x1.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    n = ck.shape[1]
    if off <= cur_len < off + n:
        ck[:, cur_len - off] = k[:, 0].to(ck.dtype)
        cv[:, cur_len - off] = v[:, 0].to(cv.dtype)
    B, _, H, hd = q.shape
    Kh = ck.shape[2]
    qg = q.reshape(B, Kh, H // Kh, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, ck.float()) * (hd ** -0.5)
    pos = off + torch.arange(n, device=x1.device)
    mask = pos < cur_len + 1
    if cfg.sliding_window:
        mask = mask & (pos > cur_len + 1 - cfg.sliding_window)
    s = torch.where(mask, s, attn.NEG)
    m = s.amax(dim=-1)
    pr = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgs,bskh->bkgh", pr.to(cv.dtype).float(), cv.float())
    return torch.cat([acc, pr.sum(dim=-1)[..., None], m[..., None]], -1)
