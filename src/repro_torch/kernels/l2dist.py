"""Tiled batched squared-L2 distance matrix: the CUDA launcher.

``csrc/l2dist.cu`` replaces the reference's Pallas ``l2dist_pallas``:
(Q, d) × (N, d) -> (Q, N) squared L2 in the expansion form
``max(‖q‖² − 2 q·x + ‖x‖², 0)``, f32 products and sums, for f32 or bf16
inputs.  Its plain PyTorch version is ``repro_torch.kernels.ref.l2dist_ref``;
callers go through ``repro_torch.kernels.ops.l2dist``, which picks between
the two by the device of the tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def l2dist_cuda(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q (Q, d) and x (N, d), both float32
    or both bfloat16 -> (Q, N) float32.  Raises on inputs the kernel does
    not take and on a failed launch."""
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"l2dist: expected q (Q,d) and x (N,d); got "
                         f"{tuple(q.shape)}, {tuple(x.shape)}")
    if q.dtype != x.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"l2dist: q and x must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {x.dtype}")
    if q.device != x.device:
        raise ValueError("l2dist: q and x must share one device")
    nq, d = q.shape
    n = x.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    q, x = q.contiguous(), x.contiguous()
    rc = _build.library("l2dist").l2dist_launch(
        q.data_ptr(), x.data_ptr(), _build.DTYPE_CODES[q.dtype],
        out.data_ptr(), nq, n, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "l2dist")
    return out
