"""Fused neighbor gather + squared L2 (+ top-k): the CUDA launchers.

The beam search's expansion hot path: gather M arbitrary rows of the
corpus and score them against a query.  ``csrc/gather_dist.cu`` replaces the
reference's Pallas ``gather_dist_pallas`` and ``gather_topk_pallas``,
batched over the queries the beam steps in lockstep: ids (Q, M), queries
(Q, d).  Their plain PyTorch versions are in ``repro_torch.kernels.ref``;
callers go through ``repro_torch.kernels.ops``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(x, ids, q, what):
    if x.dtype != torch.float32 or q.dtype != torch.float32:
        raise ValueError(f"{what}: x and q must be float32")
    if x.dim() != 2 or ids.dim() != 2 or q.dim() != 2 \
            or q.shape != (ids.shape[0], x.shape[1]):
        raise ValueError(f"{what}: expected x (N,d), ids (Q,M), q (Q,d); got "
                         f"{tuple(x.shape)}, {tuple(ids.shape)}, "
                         f"{tuple(q.shape)}")
    if ids.device != x.device or q.device != x.device:
        raise ValueError(f"{what}: x, ids and q must share one device")
    return (x.contiguous(), ids.to(torch.int32).contiguous(), q.contiguous())


def gather_dist_cuda(x: torch.Tensor, ids: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """(Q, M) Σ(x[clip(id)] − q)² on CUDA tensors."""
    x, ids, q = _check(x, ids, q, "gather_dist")
    nq, m = ids.shape
    out = torch.empty((nq, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rc = _build.library("gather_dist").gather_dist_launch(
        x.data_ptr(), ids.data_ptr(), q.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], nq, m,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "gather_dist")
    return out


def gather_topk_cuda(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                     k: int):
    """Per-query top-k of the gathered distances (negative ids masked) on
    CUDA tensors -> (ids:(Q,k) i32, dists:(Q,k) f32).  The caller has
    checked the k bound."""
    x, ids, q = _check(x, ids, q, "gather_topk")
    nq, m = ids.shape
    out_i = torch.empty((nq, k), dtype=torch.int32, device=x.device)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=x.device)
    if nq == 0:
        return out_i, out_d
    rc = _build.library("gather_dist").gather_topk_launch(
        x.data_ptr(), ids.data_ptr(), q.data_ptr(), out_i.data_ptr(),
        out_d.data_ptr(), x.shape[0], x.shape[1], nq, m, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "gather_topk")
    return out_i, out_d
