"""Fused neighbor gather + squared L2 (+ top-k): the CUDA launchers.

The beam search's expansion hot path: gather M arbitrary rows of the
corpus and score them against a query.  ``csrc/gather_dist.cu`` replaces the
reference's Pallas ``gather_dist_pallas`` and ``gather_topk_pallas`` (an f32,
int8 or bf16 corpus with an optional per-dimension f32 ``scale``), batched
over the queries the beam steps in lockstep: ids (Q, M), queries (Q, d);
and ``gather_rerank_pallas``, the f32 rescore of the quantized path's
survivors.  Their plain PyTorch versions are in ``repro_torch.kernels.ref``;
callers go through ``repro_torch.kernels.ops``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

#: keys one block sorts at once in shared memory (32 KB)
TILE_MAX = 4096
#: largest next_pow2(k) a block keeps as its running best; a larger k (the
#: rerank only) is merged in global memory
SMEM_K = 2048


def _next_pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def topk_plan(m: int, k: int) -> Tuple[int, int, int, int]:
    """(P, SZ, R, S) of the top-k kernels for M positions and k survivors
    (``gather_rerank_launch`` in ``csrc/gather_dist.cu``):

    * next_pow2(max(M, k)) <= TILE_MAX: one block per query sorts all of
      them, (0, next_pow2(max(M, k)), 0, 0);
    * else next_pow2(k) <= SMEM_K: one block per query folds M in tiles into
      a running best P = next_pow2(k), (P, TILE_MAX, 0, 0);
    * else: S = next_pow2(ceil(M / R)) blocks per query sort runs of R =
      TILE_MAX keys, merged in global memory, (0, 0, TILE_MAX, S)."""
    pm = _next_pow2(max(m, k))
    if pm <= TILE_MAX:
        return 0, pm, 0, 0
    pk = _next_pow2(k)
    if pk <= SMEM_K:
        return pk, TILE_MAX, 0, 0
    return 0, 0, TILE_MAX, _next_pow2(-(-m // TILE_MAX))


def _check(x, ids, q, what):
    if q.dtype != torch.float32:
        raise ValueError(f"{what}: q must be float32")
    if x.dim() != 2 or ids.dim() != 2 or q.dim() != 2 \
            or q.shape != (ids.shape[0], x.shape[1]):
        raise ValueError(f"{what}: expected x (N,d), ids (Q,M), q (Q,d); got "
                         f"{tuple(x.shape)}, {tuple(ids.shape)}, "
                         f"{tuple(q.shape)}")
    if ids.device != x.device or q.device != x.device:
        raise ValueError(f"{what}: x, ids and q must share one device")
    return ids.to(torch.int32).contiguous(), q.contiguous()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def gather_dist_cuda(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, M) Σ(x[clip(id)]·scale − q)² on CUDA tensors; x f32, int8 or
    bf16."""
    ids, q = _check(x, ids, q, "gather_dist")
    x, code, scale = _build.corpus_operands(x, scale, "gather_dist")
    nq, m = ids.shape
    out = torch.empty((nq, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rc = _build.library("gather_dist").gather_dist_launch(
        x.data_ptr(), code, None if scale is None else scale.data_ptr(),
        ids.data_ptr(), q.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], nq, m, _stream(x))
    _build.check(rc, "gather_dist")
    return out


def _outputs(nq, k, dev):
    if k < 1:
        raise ValueError(f"top-k: k={k} must be at least 1")
    return (torch.empty((nq, k), dtype=torch.int32, device=dev),
            torch.empty((nq, k), dtype=torch.float32, device=dev))


def gather_topk_cuda(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                     k: int, scale: torch.Tensor | None = None):
    """Per-query top-k of the gathered distances (negative ids masked) on
    CUDA tensors -> (ids:(Q,k) i32, dists:(Q,k) f32); x f32, int8 or bf16.
    The caller has checked the reference's k bound (k <= 128)."""
    ids, q = _check(x, ids, q, "gather_topk")
    x, code, scale = _build.corpus_operands(x, scale, "gather_topk")
    nq, m = ids.shape
    out_i, out_d = _outputs(nq, k, x.device)
    if nq == 0:
        return out_i, out_d
    p, sz, _, _ = topk_plan(m, k)     # k <= 128: always a block plan
    rc = _build.library("gather_dist").gather_topk_launch(
        x.data_ptr(), code, None if scale is None else scale.data_ptr(),
        ids.data_ptr(), q.data_ptr(), out_i.data_ptr(), out_d.data_ptr(),
        x.shape[0], x.shape[1], nq, m, k, p, sz, _stream(x))
    _build.check(rc, "gather_topk")
    return out_i, out_d


def gather_rerank_cuda(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                       *, k: int):
    """The quantized path's f32 rescore on CUDA tensors: per query the k
    nearest of its (ascending, -1 masked) survivor ids -> (ids:(Q,k) i32,
    dists:(Q,k) f32), for every M and every k."""
    if x.dtype != torch.float32:
        raise ValueError("gather_rerank: x must be float32")
    ids, q = _check(x, ids, q, "gather_rerank")
    x = x.contiguous()
    nq, m = ids.shape
    out_i, out_d = _outputs(nq, k, x.device)
    if nq == 0:
        return out_i, out_d
    p, sz, r, s = topk_plan(m, k)
    scratch = (torch.empty((nq, s * r), dtype=torch.int64, device=x.device)
               if s else None)
    rc = _build.library("gather_dist").gather_rerank_launch(
        x.data_ptr(), ids.data_ptr(), q.data_ptr(), out_i.data_ptr(),
        out_d.data_ptr(), None if scratch is None else scratch.data_ptr(),
        x.shape[0], x.shape[1], nq, m, k, p, sz, r, s, _stream(x))
    _build.check(rc, "gather_rerank")
    return out_i, out_d
