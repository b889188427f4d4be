"""Unified model: dense / MoE / SSM / hybrid / enc-dec / VLM families (the
reference's ``repro.models.lm``).

One ``Model`` per ``ArchConfig``.  Parameters are the reference's tree of
group-stacked tensors (``params["blocks"][...]`` has a leading ``(G, ...)``
axis; a group is 1 layer for uniform stacks, ``attn_every`` layers for
hybrids, ``cross_attn_every`` for VLMs), and the layer stack is a Python
loop over the groups where the reference scans.  ``loss`` is the training
forward, differentiated by ``torch.autograd``; ``prefill`` builds the
decode cache in the reference's stacked layout, leaf for leaf; ``decode``
writes it in place (the reference donates it) and returns it.  Both run
``_serve``, the serving walk that ``parallel.tp`` runs on a mesh's shards;
``loss`` runs ``_train_parts``, the training walk that both sharded steps
(``parallel.fsdp``, ``parallel.tp``) run, each through its own hooks.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import cross_entropy, embed_tokens, mlp, norm
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import (DTYPES, ModelDims, ShardPlan,
                                       init_params, param_shapes,
                                       resolve_dims)

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the 2-D weight products
    (``mm`` / ``addmm``; a batched ``bmm`` is recomputed with the rest)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` checkpointed per the config's remat mode: ``full`` recomputes
    everything in backward, ``dots`` saves the weight products and
    recomputes the rest, ``none`` keeps everything.  The recompute gives
    the same numbers, so the gradients are the same bit for bit."""
    if mode not in ("full", "dots"):
        return fn
    kw = {} if mode == "full" else dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_dots))

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run


def _mlp_block(x, p, cfg):
    return x + mlp(norm(x, p, cfg.norm), p, cfg.mlp_act)


def _group(tree, g: int):
    """The g-th group's slice of a stacked tree (views)."""
    return {k: _group_slice(v, g) for k, v in tree.items()}


def _group_slice(v, g: int):
    """The g-th group's slice of a stacked leaf or tree (views)."""
    return _group(v, g) if isinstance(v, dict) else v[g]


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, plan: ShardPlan = ShardPlan(),
                 mesh=None, act_shard=None, opts: Optional[Dict] = None,
                 device=None):
        """``device``: where the parameters, inputs and caches live
        (``None``: the card, raising without one; ``"meta"`` for the
        dry-run's stand-ins).  opts: ``q_chunk`` / ``kv_chunk``
        (flash-attention tile sizes), ``ssm_chunk`` (SSD chunk length),
        ``ssd_dtype`` (``"bfloat16"`` keeps the SSD's intra-chunk decay
        and weight tensors in bf16), ``ce_chunk`` (the loss's sequence
        slice), ``remat_group`` (layers per checkpointed super-group,
        default the config's) and ``sp`` (the residual stream's logical
        seq axis, which only the TP rules map); the reference's dry-run
        options (``unroll``, ``block_skip``) are accepted and ignored.
        ``mesh``: a ``parallel.sharding.ShardMesh`` over which ``moe_ffn``
        splits its tokens and experts.  ``act_shard(x, logical) -> x``:
        the activation-sharding hook (``parallel.sharding.
        make_act_sharder``), called on each group's output."""
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.dm: ModelDims = resolve_dims(cfg, plan)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.opts = dict(opts or {})
        self.sp = bool(self.opts.get("sp", False))
        self._attn_opts = {k: self.opts[k] for k in
                           ("q_chunk", "kv_chunk", "unroll", "block_skip")
                           if k in self.opts}
        self._ssm_opts = {k: self.opts[k] for k in ("ssm_chunk", "ssd_dtype")
                          if k in self.opts}
        # act_shard(x, logical_tuple) -> x  (sharding constraint hook)
        self._sa = act_shard or (lambda x, spec: x)

    def _res_spec(self):
        """Residual-stream activation sharding (SP shards seq over 'model')."""
        return ("batch", "sp", None) if self.sp else ("batch", None, None)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Dict:
        """Parameters drawn with ``generator`` (on ``self.device``)."""
        return init_params(self.cfg, self.plan, generator, self.device)

    def param_shapes(self) -> Dict:
        """The parameter tree as meta tensors (no allocation)."""
        return param_shapes(self.cfg, self.plan)

    # ------------------------------------------------------------- head
    def _head_matrix(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _logits(self, params, x):
        """f32 logits over the padded vocab: products in x's dtype, summed
        in f32."""
        return x.float() @ self._head_matrix(params).to(x.dtype).float()

    # ------------------------------------------------------------- stacks
    def _group_layers(self):
        """One group's sublayers in order, as (kind, parameter key): kind
        ``attn`` (self-attention), ``cross`` (cross-attention over the
        frontend memory), ``ssm``, ``mlp`` or ``moe``."""
        cfg, dm = self.cfg, self.dm
        fam = cfg.family
        if fam in ("dense", "moe"):
            return [("attn", "attn"),
                    ("moe", "moe") if fam == "moe" else ("mlp", "mlp")]
        if fam == "ssm":
            return [("ssm", "ssm")]
        if fam == "hybrid":
            out = []
            for j in range(dm.group_layers):
                out.append(("attn", "attn") if j == 0 else ("ssm", f"ssm{j}"))
                out.append(("moe", f"ffn{j}_moe")
                           if cfg.n_experts and (j % cfg.moe_every
                                                 == cfg.moe_every - 1)
                           else ("mlp", f"ffn{j}"))
            return out
        out = [("attn", "attn"), ("cross", "cross"), ("mlp", "mlp")]
        for j in range(1, dm.group_layers if fam == "vlm" else 1):
            out += [("attn", f"attn{j}"), ("mlp", f"mlp{j}")]
        return out

    def _train_parts(self, h, batches):
        """The training forward of one or more batch parts (one for
        ``loss``; one per present shard for the sharded steps, which run
        this same walk group by group across their shards).  ``h`` holds
        the hooks (``PartHooks`` for parts that each run whole sublayers,
        ``parallel.tp``'s for the TP step): ``fetch(names, g=None)`` (for
        each part, a dict of the top-level parameter ``names`` that exist;
        with ``g``, every leaf's g-th group slice), ``each(fn, *lists)``
        (``[fn(i, *items_i)]`` over the parts), ``embed``, one per sublayer
        kind (``attn``, ``cross``, ``ssm_train``, ``mlp``, ``moe``: each
        returns the parts' residual streams after it, ``moe`` also the
        aux loss), ``enter`` / ``leave`` / ``act`` (a residual stream's
        layout) and ``ce`` (each part's ``_ce_sums``).  Returns (each
        part's ``_ce_sums``, aux).

        The groups run in order, each super-group of ``remat_group`` groups
        checkpointed as one (the reference scans over super-groups: the
        saved carry shrinks by r at the price of r groups recomputed
        together); r falls back to 1 when it does not divide the groups.
        Weights are fetched inside the checkpointed region, so a sharded
        fetch gathers them again in the recompute."""
        cfg = self.cfg
        G = self.dm.groups
        r = max(1, int(self.opts.get("remat_group", cfg.remat_group)))
        if G % r:
            r = 1
        positions = h.each(lambda i, b: torch.arange(
            b["tokens"].shape[1], device=b["tokens"].device)[None, :], batches)
        memories = self._memories(h, batches, remat=True)

        def body(aux, g0: int, *xs):
            xs = list(xs)
            for g in range(g0, g0 + r):
                pls = [p["blocks"] for p in h.fetch(("blocks",), g)]
                ga = torch.zeros((), dtype=torch.float32, device=aux.device)
                for kind, key in self._group_layers():
                    ps = [p[key] for p in pls]
                    if kind == "moe":
                        xs, a = h.moe(xs, ps)
                        ga = ga + a
                    elif kind == "attn":
                        xs, _ = h.attn(xs, ps, positions)
                    elif kind == "cross":
                        xs, _ = h.cross(xs, ps, memories)
                    elif kind == "ssm":
                        xs = h.ssm_train(xs, ps)
                    else:
                        xs = h.mlp(xs, ps)
                xs = h.act(xs)
                aux = aux + ga
            return (aux, *xs)

        body = _remat(body, cfg.remat)
        xs = h.embed([b["tokens"] for b in batches])
        aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for g0 in range(0, G, r):
            aux, *xs = body(aux, g0, *xs)
        xs = h.each(lambda i, x, p: norm(x, p, cfg.norm, "final_norm"),
                    xs, h.fetch(("final_norm", "final_norm_b")))
        return h.ce(xs, batches), aux

    # ------------------------------------------------------------- encoder
    def _memories(self, h, parts, remat: bool = False):
        """Each part's frontend memory: the encoder over its audio frames
        (encdec, through ``h``'s sublayers; ``remat``: each layer
        checkpointed, the training walk's) or its projected image patches
        (vlm); None otherwise."""
        cfg, dm = self.cfg, self.dm
        if cfg.family not in ("encdec", "vlm"):
            return [None] * len(parts)
        key = "frames" if cfg.family == "encdec" else "patches"
        xs = h.each(lambda i, b, p: (b[key] @ p["frontend_proj"]
                                     if "frontend_proj" in p else b[key]
                                     ).to(DTYPES[cfg.dtype]),
                    parts, h.fetch(("frontend_proj",)))
        if cfg.family == "vlm":
            return xs
        positions = h.each(lambda i, x: torch.arange(
            x.shape[1], device=x.device)[None, :], xs)

        def layer(g: int, *xs):
            pls = [p["enc_blocks"] for p in h.fetch(("enc_blocks",), g)]
            xs, _ = h.attn(list(xs), [p["attn"] for p in pls], positions,
                           causal=False)
            return tuple(h.act(h.mlp(xs, [p["mlp"] for p in pls])))

        body = _remat(layer, cfg.remat) if remat else layer
        xs = h.enter(xs)
        for g in range(dm.enc_layers):
            xs = list(body(g, *xs))
        xs = h.leave(xs)
        return h.each(lambda i, x, p: norm(x, p, cfg.norm, "enc_final_norm"),
                      xs, h.fetch(("enc_final_norm", "enc_final_norm_b")))

    def _local(self, params):
        """``PartHooks``' fetch, each and moe for one part holding the
        whole tree ``params``."""
        def fetch(names, g=None):
            return [{n: params[n] if g is None else _group_slice(params[n], g)
                     for n in names if n in params}]

        def each(fn, *lists):
            return [fn(0, *(lst[0] for lst in lists))]

        def moe(xs, ps):
            y, a = moe_ffn(xs[0], ps[0], self.cfg, self.dm, self.mesh)
            return [y], a
        return fetch, each, moe

    # ------------------------------------------------------------- train
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(ce + 0.01·aux, {"loss": ce, "aux": aux}) of a batch of
        ``tokens`` and ``labels`` (B, S); labels < 0 are not scored."""
        h = PartHooks(self, *self._local(params))
        [(tot, cnt)], aux = self._train_parts(h, [batch])
        ce = tot / torch.clamp_min(cnt, 1.0)
        total = ce + 0.01 * aux
        return total, {"loss": ce, "aux": aux}

    def _ce_sums(self, head, x, labels):
        """Sequence-chunked CE so (tokens × vocab) logits are never live at
        once: a loop over slices of ``ce_chunk`` positions (the last padded
        with label -1), each checkpointed so its f32 logits are recomputed
        in backward.  Returns (summed token NLL, scored-token count); a
        sharded step adds both over its shards before the ratio."""
        cfg = self.cfg
        s = x.shape[1]
        c = min(int(self.opts.get("ce_chunk", 1024)), s)
        pad = (-s) % c
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        nch = x.shape[1] // c

        def chunk_loss(xc, lc, head):
            logits = xc.float() @ head.to(xc.dtype).float()
            valid = (lc >= 0).float()
            nll = cross_entropy(logits, torch.clamp_min(lc, 0), cfg.vocab_size,
                                mask=valid) * torch.sum(valid)
            return nll, torch.sum(valid)

        grad = torch.is_grad_enabled()
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(nch):
            args = (x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c], head)
            nll, nv = (checkpoint(chunk_loss, *args, use_reentrant=False,
                                  preserve_rng_state=False)
                       if grad else chunk_loss(*args))
            tot = tot + nll
            cnt = cnt + nv
        return tot, cnt

    # ------------------------------------------------------------- serve
    def init_cache(self, batch_size: int, max_len: int, device=None,
                   enc_len: Optional[int] = None) -> Dict:
        """The empty decode cache (zeros) on ``device`` (default the
        model's; ``"meta"`` for shapes alone).  ``enc_len``: an encdec
        cache's memory length (default ``max_len // 4``, the reference's)."""
        cfg, dm = self.cfg, self.dm
        G = dm.groups
        bf = DTYPES[cfg.dtype]
        dev = self.device if device is None else device
        mk = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        cache: Dict = {}
        if cfg.family in ("dense", "moe", "encdec"):
            cache["k"] = mk((G, batch_size, max_len, dm.kh, dm.hd), bf)
            cache["v"] = mk((G, batch_size, max_len, dm.kh, dm.hd), bf)
        if cfg.family == "vlm":   # one KV slot per in-group self-attn layer
            gl = dm.group_layers
            cache["k"] = mk((G, gl, batch_size, max_len, dm.kh, dm.hd), bf)
            cache["v"] = mk((G, gl, batch_size, max_len, dm.kh, dm.hd), bf)
        if cfg.family == "ssm":
            cache["state"] = mk((G, batch_size, dm.ssm_h, dm.ssm_p, dm.ssm_n),
                                torch.float32)
            cache["conv"] = mk((G, batch_size, dm.conv_w - 1, dm.conv_dim), bf)
        if cfg.family == "hybrid":
            gl = dm.group_layers
            cache["k"] = mk((G, batch_size, max_len, dm.kh, dm.hd), bf)
            cache["v"] = mk((G, batch_size, max_len, dm.kh, dm.hd), bf)
            cache["state"] = mk((G, gl - 1, batch_size, dm.ssm_h, dm.ssm_p, dm.ssm_n),
                                torch.float32)
            cache["conv"] = mk((G, gl - 1, batch_size, dm.conv_w - 1, dm.conv_dim), bf)
        if cfg.family == "encdec":
            enc_len = max_len // 4 if enc_len is None else enc_len
            cache["ck"] = mk((G, batch_size, enc_len, dm.kh, dm.hd), bf)
            cache["cv"] = mk((G, batch_size, enc_len, dm.kh, dm.hd), bf)
        if cfg.family == "vlm":
            cache["ck"] = mk((G, batch_size, cfg.n_frontend_tokens, dm.kh, dm.hd), bf)
            cache["cv"] = mk((G, batch_size, cfg.n_frontend_tokens, dm.kh, dm.hd), bf)
        return cache

    def _slots(self, name: str) -> int:
        """How many in-group sublayers share the cache leaf ``name`` as a
        stacked axis after the group axis (0: one, not stacked): a VLM
        group's self-attention layers, a hybrid group's SSM layers."""
        fam, gl = self.cfg.family, self.dm.group_layers
        if fam == "vlm" and name in ("k", "v"):
            return gl
        if fam == "hybrid" and name in ("state", "conv"):
            return gl - 1
        return 0

    def _slot(self, cl: Dict, name: str, j: int):
        """A group's view ``cl`` of leaf ``name``: the j-th sublayer's."""
        return cl[name][j] if self._slots(name) else cl[name]

    def _put(self, cache: Dict, name: str, g: int, j: int, v) -> None:
        """Writes group g's j-th sublayer's leaf ``v`` into ``cache``,
        allocating the stacked leaf at its first write."""
        if name not in cache:
            n = self._slots(name)
            lead = (self.dm.groups,) + ((n,) if n else ())
            cache[name] = v.new_empty(lead + tuple(v.shape))
        self._slot(_group(cache, g), name, j).copy_(v)

    def _serve(self, h, parts, cache_len: Optional[int] = None,
               caches=None, cur_len: Optional[int] = None):
        """The serving walk over one or more batch parts: a prefill (with
        ``cache_len``) that builds each part's cache in the reference's
        stacked layout, or, given ``caches``, one decode step at position
        ``cur_len`` that writes them in place.  ``h`` holds the hooks:
        ``fetch`` / ``each`` (as ``_train_parts``'), ``enter`` / ``leave``
        / ``act`` (a residual stream's layout), ``embed``, one per sublayer
        kind (``attn``, ``attn_decode``, ``ssm``, ``ssm_decode``,
        ``cross``, ``cross_decode``, ``mlp``, ``moe``: each returns the
        parts' residual streams after it, ``moe`` with its aux loss) and
        ``logits``.  ``_Whole`` runs
        the whole tree on its device (``prefill`` / ``decode``);
        ``parallel.tp`` runs the per-shard blocks of a mesh.  Returns (the
        parts' caches, ``h.logits``)."""
        cfg = self.cfg
        decode = caches is not None
        if decode:
            xs = h.embed([b["token"][:, None] for b in parts])
        else:
            memories = self._memories(h, parts)
            xs = h.embed([b["tokens"] for b in parts])
            positions = h.each(lambda i, b: torch.arange(
                b["tokens"].shape[1], device=b["tokens"].device)[None, :],
                parts)
            caches = [{} for _ in parts]
        for g in range(self.dm.groups):
            pls = [p["blocks"] for p in h.fetch(("blocks",), g)]
            cls = [_group(c, g) for c in caches]
            seen = {"attn": 0, "ssm": 0}
            for kind, key in self._group_layers():
                ps = [p[key] for p in pls]
                j = seen.get(kind, 0)
                seen[kind] = j + 1
                if kind == "attn" and decode:
                    xs = h.attn_decode(xs, ps, [self._slot(c, "k", j) for c in cls],
                                       [self._slot(c, "v", j) for c in cls],
                                       cur_len)
                elif kind == "attn":
                    xs, kvs = h.attn(xs, ps, positions, cache_len=cache_len)
                    for c, (k, v) in zip(caches, kvs):
                        self._put(c, "k", g, j, k)
                        self._put(c, "v", g, j, v)
                elif kind == "ssm" and decode:
                    xs = h.ssm_decode(xs, ps,
                                      [self._slot(c, "state", j) for c in cls],
                                      [self._slot(c, "conv", j) for c in cls])
                elif kind == "ssm":
                    xs, sts = h.ssm(xs, ps)
                    for c, (st, conv) in zip(caches, sts):
                        self._put(c, "state", g, j, st)
                        self._put(c, "conv", g, j, conv)
                elif kind == "cross" and decode:
                    xs = h.cross_decode(xs, ps, [c["ck"] for c in cls],
                                        [c["cv"] for c in cls])
                elif kind == "cross":
                    xs, kvs = h.cross(xs, ps, memories)
                    for c, (k, v) in zip(caches, kvs):
                        self._put(c, "ck", g, 0, k)
                        self._put(c, "cv", g, 0, v)
                elif kind == "mlp":
                    xs = h.mlp(xs, ps)
                else:
                    xs, _ = h.moe(xs, ps)
            xs = h.act(xs)
        xs = h.each(lambda i, x, p: norm(x, p, cfg.norm, "final_norm"),
                    xs, h.fetch(("final_norm", "final_norm_b")))
        return caches, h.logits(xs)

    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Full-sequence forward that also builds the decode cache.
        Returns (cache, logits_last:(B,vocab) f32 over the padded vocab)."""
        cache_len = cache_len or batch["tokens"].shape[1]
        caches, logits = self._serve(_Whole(self, params), [batch],
                                     cache_len=cache_len)
        return caches[0], logits

    def forward(self, params, batch, cache_len: Optional[int] = None):
        """``prefill``."""
        return self.prefill(params, batch, cache_len)

    def decode(self, params, cache, cur_len: int, token):
        """token:(B,) int; cur_len: the position written (a Python int).
        Returns (logits, cache), the cache updated in place."""
        _, logits = self._serve(_Whole(self, params), [{"token": token}],
                                caches=[cache], cur_len=int(cur_len))
        return logits, cache


class PartHooks:
    """``Model._train_parts``' hooks for parts that each run whole
    sublayers: ``Model.loss``'s one part with the whole tree, or the FSDP
    step's shards with their gathered weights.  ``fetch`` / ``each`` as
    ``_train_parts`` takes them; ``moe(xs, ps)`` -> (the parts' MoE
    outputs, aux).  Each sublayer is the reference's, residual added."""

    def __init__(self, model: Model, fetch, each, moe):
        self.m, self.cfg, self.dm = model, model.cfg, model.dm
        self.fetch, self.each, self._moe = fetch, each, moe

    def enter(self, xs):
        return xs

    leave = enter

    def act(self, xs):
        return [self.m._sa(x, self.m._res_spec()) for x in xs]

    def embed(self, toks):
        return self.each(lambda i, t, p: embed_tokens(t, p["embed"]), toks,
                         self.fetch(("embed",)))

    def attn(self, xs, ps, positions, causal=True, cache_len=None):
        """Full-sequence self-attention (the encoder's with ``causal``
        False); (streams, None)."""
        cfg, dm, ao = self.cfg, self.dm, self.m._attn_opts
        return self.each(lambda i, x, p, pos: x + attn.self_attn_train(
            x, p, cfg, dm, pos, causal=causal, opts=ao),
            xs, ps, positions), None

    def cross(self, xs, ps, memories):
        cfg, dm, ao = self.cfg, self.dm, self.m._attn_opts
        ckv = self.each(lambda i, mem, p: attn.cross_kv(mem, p, cfg, dm),
                        memories, ps)
        return self.each(lambda i, x, kv, p: x + attn.cross_attn(
            x, kv, p, cfg, dm, opts=ao), xs, ckv, ps), ckv

    def ssm_train(self, xs, ps):
        return self.each(lambda i, x, p: x + ssm_mod.mamba_train(
            x, p, self.cfg, self.dm, opts=self.m._ssm_opts), xs, ps)

    def mlp(self, xs, ps):
        return self.each(lambda i, x, p: _mlp_block(x, p, self.cfg), xs, ps)

    def moe(self, xs, ps):
        ys, a = self._moe(xs, ps)
        return [x + y for x, y in zip(xs, ys)], a

    def ce(self, xs, batches):
        key = "embed" if self.cfg.tie_embeddings else "lm_head"
        return self.each(lambda i, x, h, b: self.m._ce_sums(
            self.m._head_matrix(h), x, b["labels"]),
            xs, self.fetch((key,)), batches)


class _Whole(PartHooks):
    """``Model._serve``'s hooks for one part holding the whole parameter
    tree on its device: each sublayer is the reference's, residual added."""

    def __init__(self, model: Model, params):
        super().__init__(model, *model._local(params))
        self.params = params

    def act(self, xs):
        return xs

    def attn(self, xs, ps, positions, causal=True, cache_len=None):
        if cache_len is None:                 # the encoder's
            return super().attn(xs, ps, positions, causal)
        cfg, dm, ao = self.cfg, self.dm, self.m._attn_opts
        x, p, pos = xs[0], ps[0], positions[0]
        o, (k, v) = attn.self_attn_prefill(x, p, cfg, dm, pos, opts=ao)
        pad = cache_len - x.shape[1]
        if pad:
            k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                    for t in (k, v))
        return [x + o], [(k, v)]

    def attn_decode(self, xs, ps, ks, vs, cur_len):
        o, _, _ = attn.self_attn_decode(xs[0], ps[0], self.cfg, self.dm,
                                        ks[0], vs[0], cur_len)
        return [xs[0] + o]

    def ssm(self, xs, ps):
        o, (st, conv) = ssm_mod.mamba_train(xs[0], ps[0], self.cfg, self.dm,
                                            return_state=True,
                                            opts=self.m._ssm_opts)
        return [xs[0] + o], [(st, conv)]

    def ssm_decode(self, xs, ps, sts, convs):
        o, st, conv = ssm_mod.mamba_decode(xs[0], ps[0], self.cfg, self.dm,
                                           sts[0], convs[0])
        sts[0].copy_(st)
        convs[0].copy_(conv)
        return [xs[0] + o]

    def cross_decode(self, xs, ps, cks, cvs):
        return [xs[0] + attn.cross_decode(xs[0], ps[0], self.cfg, self.dm,
                                          cks[0], cvs[0])]

    def logits(self, xs):
        return self.m._logits(self.params, xs[0][:, -1])
