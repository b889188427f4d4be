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
                                       init_params, resolve_dims)

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
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, plan: ShardPlan = ShardPlan(),
                 mesh=None, opts: Optional[Dict] = None, device=None):
        """``device``: where the parameters, inputs and caches live
        (``None``: the card, raising without one).  opts: ``q_chunk`` /
        ``kv_chunk`` (flash-attention tile sizes), ``ssm_chunk`` (SSD
        chunk length), ``ce_chunk`` (the loss's sequence slice) and
        ``remat_group`` (layers per checkpointed super-group, default the
        config's); the reference's dry-run options (``unroll``,
        ``block_skip``) are accepted and ignored.  ``mesh``: a
        ``parallel.sharding.ShardMesh`` over which ``moe_ffn`` splits its
        tokens and experts."""
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.dm: ModelDims = resolve_dims(cfg, plan)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.opts = dict(opts or {})
        self._attn_opts = {k: self.opts[k] for k in
                           ("q_chunk", "kv_chunk", "unroll", "block_skip")
                           if k in self.opts}
        self._ssm_opts = {k: self.opts[k] for k in ("ssm_chunk",)
                          if k in self.opts}

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Dict:
        """Parameters drawn with ``generator`` (on ``self.device``)."""
        return init_params(self.cfg, self.plan, generator, self.device)

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
    def _group_train(self, x, pl, positions, memory_kv=None):
        """One group, full sequence. Returns (x, aux)."""
        cfg, dm = self.cfg, self.dm
        ao, so = self._attn_opts, self._ssm_opts
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        fam = cfg.family
        if fam in ("dense", "moe"):
            x = x + attn.self_attn_train(x, pl["attn"], cfg, dm, positions, opts=ao)
            if fam == "moe":
                f, a = moe_ffn(x, pl["moe"], cfg, dm, self.mesh)
                x, aux = x + f, aux + a
            else:
                x = _mlp_block(x, pl["mlp"], cfg)
        elif fam == "ssm":
            x = x + ssm_mod.mamba_train(x, pl["ssm"], cfg, dm, opts=so)
        elif fam == "hybrid":
            for j in range(dm.group_layers):
                if j == 0:
                    x = x + attn.self_attn_train(x, pl["attn"], cfg, dm, positions, opts=ao)
                else:
                    x = x + ssm_mod.mamba_train(x, pl[f"ssm{j}"], cfg, dm, opts=so)
                if cfg.n_experts and (j % cfg.moe_every == cfg.moe_every - 1):
                    f, a = moe_ffn(x, pl[f"ffn{j}_moe"], cfg, dm, self.mesh)
                    x, aux = x + f, aux + a
                else:
                    x = _mlp_block(x, pl[f"ffn{j}"], cfg)
        elif fam in ("encdec", "vlm"):
            x = x + attn.self_attn_train(x, pl["attn"], cfg, dm, positions, opts=ao)
            ckv = attn.cross_kv(memory_kv, pl["cross"], cfg, dm)
            x = x + attn.cross_attn(x, ckv, pl["cross"], cfg, dm, opts=ao)
            x = _mlp_block(x, pl["mlp"], cfg)
            for j in range(1, dm.group_layers if fam == "vlm" else 1):
                x = x + attn.self_attn_train(x, pl[f"attn{j}"], cfg, dm, positions, opts=ao)
                x = _mlp_block(x, pl[f"mlp{j}"], cfg)
        return x, aux

    def _stack_train(self, params, x, positions, memory=None):
        """The groups in order, each super-group of ``remat_group`` groups
        checkpointed as one (the reference scans over super-groups: the
        saved carry shrinks by r at the price of r groups recomputed
        together); r falls back to 1 when it does not divide the groups."""
        G = self.dm.groups
        r = max(1, int(self.opts.get("remat_group", self.cfg.remat_group)))
        if G % r:
            r = 1
        blocks = params["blocks"]

        def body(x, aux, g0: int):
            for g in range(g0, g0 + r):
                x, a = self._group_train(x, _group(blocks, g), positions,
                                         memory)
                aux = aux + a
            return x, aux

        body = _remat(body, self.cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g0 in range(0, G, r):
            x, aux = body(x, aux, g0)
        return x, aux

    # ------------------------------------------------------------- encoder
    def _encode(self, params, frames):
        cfg, dm = self.cfg, self.dm
        x = frames
        if "frontend_proj" in params:
            x = x @ params["frontend_proj"]
        x = x.to(DTYPES[cfg.dtype])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def enc_group(h, g):
            pl = _group(params["enc_blocks"], g)
            h = h + attn.self_attn_train(h, pl["attn"], cfg, dm, positions,
                                         causal=False, opts=self._attn_opts)
            return _mlp_block(h, pl["mlp"], cfg)

        body = _remat(enc_group, cfg.remat)
        for g in range(dm.enc_layers):
            x = body(x, g)
        return norm(x, params, cfg.norm, "enc_final_norm")

    def _memory(self, params, batch):
        """Frontend memory for encdec (audio frames) / vlm (image patches)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return self._encode(params, batch["frames"])
        if cfg.family == "vlm":
            x = batch["patches"]
            if "frontend_proj" in params:
                x = x @ params["frontend_proj"]
            return x.to(DTYPES[cfg.dtype])
        return None

    # ------------------------------------------------------------- train
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(ce + 0.01·aux, {"loss": ce, "aux": aux}) of a batch of
        ``tokens`` and ``labels`` (B, S); labels < 0 are not scored."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        memory = self._memory(params, batch)
        x = self._embed(params, tokens)
        x, aux = self._stack_train(params, x, positions, memory)
        x = norm(x, params, cfg.norm, "final_norm")
        ce = self._chunked_ce(params, x, labels)
        total = ce + 0.01 * aux
        return total, {"loss": ce, "aux": aux}

    def _chunked_ce(self, params, x, labels):
        """Sequence-chunked CE so (tokens × vocab) logits are never live at
        once: a loop over slices of ``ce_chunk`` positions (the last padded
        with label -1), each checkpointed so its f32 logits are recomputed
        in backward."""
        cfg = self.cfg
        s = x.shape[1]
        head = self._head_matrix(params)
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
        return tot / torch.clamp_min(cnt, 1.0)

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
