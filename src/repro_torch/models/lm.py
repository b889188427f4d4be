"""Unified model: dense / MoE / SSM / hybrid / enc-dec / VLM families (the
reference's ``repro.models.lm``).

One ``Model`` per ``ArchConfig``.  Parameters are the reference's tree of
group-stacked tensors (``params["blocks"][...]`` has a leading ``(G, ...)``
axis; a group is 1 layer for uniform stacks, ``attn_every`` layers for
hybrids, ``cross_attn_every`` for VLMs), and the layer stack is a Python
loop over the groups where the reference scans.  ``loss`` is the training
forward, differentiated by ``torch.autograd``; ``prefill`` builds the
decode cache in the reference's stacked layout, leaf for leaf; ``decode``
writes it in place (the reference donates it) and returns it.
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

    # ------------------------------------------------------------- embedding
    def _embed(self, params, tokens):
        return embed_tokens(tokens, params["embed"])

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

    def _sublayer(self, kind: str, x, p, positions, memory_kv=None):
        """x after one sublayer of ``kind`` other than ``moe``, residual
        included."""
        cfg, dm = self.cfg, self.dm
        ao = self._attn_opts
        if kind == "attn":
            return x + attn.self_attn_train(x, p, cfg, dm, positions, opts=ao)
        if kind == "ssm":
            return x + ssm_mod.mamba_train(x, p, cfg, dm,
                                           opts=self._ssm_opts)
        if kind == "mlp":
            return _mlp_block(x, p, cfg)
        if kind == "cross":
            ckv = attn.cross_kv(memory_kv, p, cfg, dm)
            return x + attn.cross_attn(x, ckv, p, cfg, dm, opts=ao)
        raise ValueError(kind)

    def _train_parts(self, fetch, batches, each, moe):
        """The training forward of one or more batch parts (one for
        ``loss``; one per present shard for the sharded step, which runs
        this same walk group by group across its shards).  ``fetch(names,
        g=None)``: for each part, a dict of the top-level parameter
        ``names`` that exist (with ``g``, every leaf's g-th group slice);
        ``each(fn, *lists)``: ``[fn(i, *items_i)]`` over the parts;
        ``moe(xs, ps)``: (the parts' MoE outputs, aux).  Returns (each
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
        positions = each(lambda i, b: torch.arange(
            b["tokens"].shape[1], device=b["tokens"].device)[None, :], batches)
        memories = self._memories(fetch, batches, each)

        def body(aux, g0: int, *xs):
            xs = list(xs)
            for g in range(g0, g0 + r):
                pls = [p["blocks"] for p in fetch(("blocks",), g)]
                ga = torch.zeros((), dtype=torch.float32, device=aux.device)
                for kind, key in self._group_layers():
                    if kind == "moe":
                        ys, a = moe(xs, [p[key] for p in pls])
                        xs = [x + y for x, y in zip(xs, ys)]
                        ga = ga + a
                    else:
                        xs = each(lambda i, x, p, pos, mem: self._sublayer(
                            kind, x, p[key], pos, mem),
                            xs, pls, positions, memories)
                xs = [self._sa(x, self._res_spec()) for x in xs]
                aux = aux + ga
            return (aux, *xs)

        body = _remat(body, cfg.remat)
        xs = each(lambda i, b, p: embed_tokens(b["tokens"], p["embed"]),
                  batches, fetch(("embed",)))
        aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for g0 in range(0, G, r):
            aux, *xs = body(aux, g0, *xs)
        xs = each(lambda i, x, p: norm(x, p, cfg.norm, "final_norm"),
                  xs, fetch(("final_norm", "final_norm_b")))
        heads = (fetch(("embed",)) if cfg.tie_embeddings
                 else fetch(("lm_head",)))
        return each(lambda i, x, h, b: self._ce_sums(self._head_matrix(h), x,
                                                     b["labels"]),
                    xs, heads, batches), aux

    # ------------------------------------------------------------- encoder
    def _memories(self, fetch, batches, each):
        """Each part's frontend memory (``_train_parts``' arguments): the
        encoder over its audio frames (encdec) or its projected image
        patches (vlm); None otherwise."""
        cfg, dm = self.cfg, self.dm
        if cfg.family not in ("encdec", "vlm"):
            return [None] * len(batches)
        key = "frames" if cfg.family == "encdec" else "patches"
        xs = each(lambda i, b, p: (b[key] @ p["frontend_proj"]
                                   if "frontend_proj" in p else b[key]
                                   ).to(DTYPES[cfg.dtype]),
                  batches, fetch(("frontend_proj",)))
        if cfg.family == "vlm":
            return xs
        positions = each(lambda i, x: torch.arange(
            x.shape[1], device=x.device)[None, :], xs)

        def enc_layer(g: int, *xs):
            pls = [p["enc_blocks"] for p in fetch(("enc_blocks",), g)]
            return tuple(each(lambda i, h, p, pos: self._enc_group(h, p, pos),
                              list(xs), pls, positions))

        body = _remat(enc_layer, cfg.remat)
        for g in range(dm.enc_layers):
            xs = list(body(g, *xs))
        return each(lambda i, x, p: norm(x, p, cfg.norm, "enc_final_norm"),
                    xs, fetch(("enc_final_norm", "enc_final_norm_b")))

    def _enc_group(self, h, pl, positions):
        """One encoder layer (bidirectional self-attention, then the MLP)."""
        cfg, dm = self.cfg, self.dm
        h = h + attn.self_attn_train(h, pl["attn"], cfg, dm, positions,
                                     causal=False, opts=self._attn_opts)
        return self._sa(_mlp_block(h, pl["mlp"], cfg), self._res_spec())

    def _local(self, params):
        """``_train_parts``' fetch, each and moe for one part holding the
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

    def _memory(self, params, batch):
        """Frontend memory for encdec (audio frames) / vlm (image patches)."""
        fetch, each, _ = self._local(params)
        return self._memories(fetch, [batch], each)[0]

    # ------------------------------------------------------------- train
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(ce + 0.01·aux, {"loss": ce, "aux": aux}) of a batch of
        ``tokens`` and ``labels`` (B, S); labels < 0 are not scored."""
        fetch, each, moe = self._local(params)
        [(tot, cnt)], aux = self._train_parts(fetch, [batch], each, moe)
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
    def init_cache(self, batch_size: int, max_len: int) -> Dict:
        cfg, dm = self.cfg, self.dm
        G = dm.groups
        bf = DTYPES[cfg.dtype]
        mk = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
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
            enc_len = max_len // 4
            cache["ck"] = mk((G, batch_size, enc_len, dm.kh, dm.hd), bf)
            cache["cv"] = mk((G, batch_size, enc_len, dm.kh, dm.hd), bf)
        if cfg.family == "vlm":
            cache["ck"] = mk((G, batch_size, cfg.n_frontend_tokens, dm.kh, dm.hd), bf)
            cache["cv"] = mk((G, batch_size, cfg.n_frontend_tokens, dm.kh, dm.hd), bf)
        return cache

    def _prefill_group(self, x, pl, positions, memory, pad_kv):
        """One group, full sequence: (x, this group's cache leaves)."""
        cfg, dm = self.cfg, self.dm
        ao = self._attn_opts
        ys = {}
        if cfg.family in ("dense", "moe"):
            o, (k, v) = attn.self_attn_prefill(x, pl["attn"], cfg, dm, positions, opts=ao)
            x = x + o
            ys["k"], ys["v"] = pad_kv(k), pad_kv(v)
            if cfg.family == "moe":
                x = x + moe_ffn(x, pl["moe"], cfg, dm, self.mesh)[0]
            else:
                x = _mlp_block(x, pl["mlp"], cfg)
        elif cfg.family == "ssm":
            o, (st, conv) = ssm_mod.mamba_train(x, pl["ssm"], cfg, dm,
                                                return_state=True,
                                                opts=self._ssm_opts)
            x = x + o
            ys["state"], ys["conv"] = st, conv
        elif cfg.family == "hybrid":
            sts, convs = [], []
            for j in range(dm.group_layers):
                if j == 0:
                    o, (k, v) = attn.self_attn_prefill(x, pl["attn"], cfg, dm,
                                                       positions, opts=ao)
                    x = x + o
                    ys["k"], ys["v"] = pad_kv(k), pad_kv(v)
                else:
                    o, (st, conv) = ssm_mod.mamba_train(
                        x, pl[f"ssm{j}"], cfg, dm, return_state=True,
                        opts=self._ssm_opts)
                    x = x + o
                    sts.append(st)
                    convs.append(conv)
                if cfg.n_experts and (j % cfg.moe_every == cfg.moe_every - 1):
                    x = x + moe_ffn(x, pl[f"ffn{j}_moe"], cfg, dm, self.mesh)[0]
                else:
                    x = _mlp_block(x, pl[f"ffn{j}"], cfg)
            ys["state"] = torch.stack(sts)
            ys["conv"] = torch.stack(convs)
        elif cfg.family == "encdec":
            o, (k, v) = attn.self_attn_prefill(x, pl["attn"], cfg, dm, positions, opts=ao)
            x = x + o
            ys["k"], ys["v"] = pad_kv(k), pad_kv(v)
            ck, cv = attn.cross_kv(memory, pl["cross"], cfg, dm)
            x = x + attn.cross_attn(x, (ck, cv), pl["cross"], cfg, dm, opts=ao)
            ys["ck"], ys["cv"] = ck, cv
            x = _mlp_block(x, pl["mlp"], cfg)
        elif cfg.family == "vlm":
            ks, vs = [], []
            o, (k, v) = attn.self_attn_prefill(x, pl["attn"], cfg, dm, positions, opts=ao)
            x = x + o
            ks.append(pad_kv(k))
            vs.append(pad_kv(v))
            ck, cv = attn.cross_kv(memory, pl["cross"], cfg, dm)
            x = x + attn.cross_attn(x, (ck, cv), pl["cross"], cfg, dm, opts=ao)
            ys["ck"], ys["cv"] = ck, cv
            x = _mlp_block(x, pl["mlp"], cfg)
            for j in range(1, dm.group_layers):
                o, (k, v) = attn.self_attn_prefill(x, pl[f"attn{j}"], cfg, dm,
                                                   positions, opts=ao)
                x = x + o
                ks.append(pad_kv(k))
                vs.append(pad_kv(v))
                x = _mlp_block(x, pl[f"mlp{j}"], cfg)
            ys["k"], ys["v"] = torch.stack(ks), torch.stack(vs)
        return x, ys

    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Full-sequence forward that also builds the decode cache.
        Returns (cache, logits_last:(B,vocab) f32 over the padded vocab)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache_len = cache_len or s
        positions = torch.arange(s, device=tokens.device)[None, :]
        memory = self._memory(params, batch)
        x = self._embed(params, tokens)

        def pad_kv(k):
            if cache_len == s:
                return k
            return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, cache_len - s))

        G = self.dm.groups
        cache = None
        for g in range(G):
            x, ys = self._prefill_group(x, _group(params["blocks"], g),
                                        positions, memory, pad_kv)
            if cache is None:           # the stacked (G, ...) leaves
                cache = {k: v.new_empty((G, *v.shape)) for k, v in ys.items()}
            for k, v in ys.items():
                cache[k][g] = v
        x = norm(x, params, cfg.norm, "final_norm")
        return cache, self._logits(params, x[:, -1])

    def forward(self, params, batch, cache_len: Optional[int] = None):
        """``prefill``."""
        return self.prefill(params, batch, cache_len)

    def _cross_dec(self, x, pc, ck, cv):
        cfg, dm = self.cfg, self.dm
        h = norm(x, pc, cfg.norm)
        b = x.shape[0]
        q = (h @ pc["wq"]).reshape(b, 1, dm.h, dm.hd)
        if cfg.qkv_bias:
            q = q + pc["bq"].reshape(dm.h, dm.hd)
        o = attn.decode_attention(q, ck, cv, cur_len=ck.shape[1])
        return x + o.reshape(b, 1, dm.h * dm.hd) @ pc["wo"]

    def _decode_group(self, x, pl, cl, cur_len: int):
        """One group, one token; writes the group's cache views ``cl``."""
        cfg, dm = self.cfg, self.dm
        fam = cfg.family
        if fam in ("dense", "moe", "encdec"):
            o, _, _ = attn.self_attn_decode(x, pl["attn"], cfg, dm,
                                            cl["k"], cl["v"], cur_len)
            x = x + o
        if fam == "moe":
            x = x + moe_ffn(x, pl["moe"], cfg, dm, self.mesh)[0]
        elif fam == "dense":
            x = _mlp_block(x, pl["mlp"], cfg)
        elif fam == "ssm":
            o, st, conv = ssm_mod.mamba_decode(x, pl["ssm"], cfg, dm,
                                               cl["state"], cl["conv"])
            x = x + o
            cl["state"].copy_(st)
            cl["conv"].copy_(conv)
        elif fam == "hybrid":
            for j in range(dm.group_layers):
                if j == 0:
                    o, _, _ = attn.self_attn_decode(
                        x, pl["attn"], cfg, dm, cl["k"], cl["v"], cur_len)
                    x = x + o
                else:
                    o, st, conv = ssm_mod.mamba_decode(
                        x, pl[f"ssm{j}"], cfg, dm,
                        cl["state"][j - 1], cl["conv"][j - 1])
                    x = x + o
                    cl["state"][j - 1].copy_(st)
                    cl["conv"][j - 1].copy_(conv)
                if cfg.n_experts and (j % cfg.moe_every == cfg.moe_every - 1):
                    x = x + moe_ffn(x, pl[f"ffn{j}_moe"], cfg, dm, self.mesh)[0]
                else:
                    x = _mlp_block(x, pl[f"ffn{j}"], cfg)
        elif fam == "encdec":
            x = self._cross_dec(x, pl["cross"], cl["ck"], cl["cv"])
            x = _mlp_block(x, pl["mlp"], cfg)
        elif fam == "vlm":   # per-in-group-layer self-attn caches
            o, _, _ = attn.self_attn_decode(
                x, pl["attn"], cfg, dm, cl["k"][0], cl["v"][0], cur_len)
            x = x + o
            x = self._cross_dec(x, pl["cross"], cl["ck"], cl["cv"])
            x = _mlp_block(x, pl["mlp"], cfg)
            for j in range(1, dm.group_layers):
                o, _, _ = attn.self_attn_decode(
                    x, pl[f"attn{j}"], cfg, dm, cl["k"][j], cl["v"][j],
                    cur_len)
                x = x + o
                x = _mlp_block(x, pl[f"mlp{j}"], cfg)
        return x

    def decode(self, params, cache, cur_len: int, token):
        """token:(B,) int; cur_len: the position written (a Python int).
        Returns (logits, cache), the cache updated in place."""
        cfg = self.cfg
        x = self._embed(params, token[:, None])
        for g in range(self.dm.groups):
            x = self._decode_group(x, _group(params["blocks"], g),
                                   _group(cache, g), int(cur_len))
        x = norm(x, params, cfg.norm, "final_norm")
        return self._logits(params, x[:, -1]), cache
