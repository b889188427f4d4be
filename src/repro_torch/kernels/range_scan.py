"""Fused brute-force scan over a contiguous rank slice: the CUDA launcher.

The planner's exact strategy for selective ranges: ids are attribute ranks,
so a range query's candidates are the contiguous slice ``x[L : R+1]`` and a
masked L2 scan + top-k beats graph traversal when the slice is small.  The
kernel (``csrc/range_scan.cu``) replaces the reference's Pallas
``range_scan_pallas``, for an f32, int8 or bf16 corpus with an optional
per-dimension f32 ``scale``; its plain PyTorch version is
``repro_torch.kernels.ref.range_scan_ref``.  Callers go through
``repro_torch.kernels.ops.range_scan``, which picks between the two by the
device of the tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: rows one block of the scan's first pass owns (it sorts R keys in shared
#: memory); raised to next_pow2(k) when k is larger
ROWS_PER_BLOCK = 1024
#: largest next_pow2(k) merged in shared memory (2·next_pow2(k) keys);
#: a larger k is merged in global memory (``SMEM_K`` in the kernel source)
SMEM_K = 2048


def window_rows(bucket: int, tb: int = 128) -> int:
    """Rows actually scanned for a bucket: ceil(bucket/tb) blocks plus one
    extra block so any start alignment is covered (single source of truth —
    the kernel, its jnp oracle, and the planner cost model all use this)."""
    return (-(-bucket // tb) + 1) * tb


def range_scan_cuda(x: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, q: torch.Tensor, *, bucket: int,
                    k: int, n_valid: int = 0,
                    live: torch.Tensor | None = None,
                    scale: torch.Tensor | None = None):
    """Launch the scan on CUDA tensors.  x:(n_pad, d_pad) f32, int8 or bf16
    with n_pad % 128 == 0 and d_pad % 128 == 0; ``scale``: (d_pad,) f32 or
    None; starts/lens:(Q,); q:(Q, d_pad) f32; ``live``: (1, n_pad) or
    (n_pad,), 0 = masked.  Returns (ids:(Q,k) i32 ranks (-1 pad),
    dists:(Q,k) f32 (+inf pad)).  Raises on inputs the kernel does not take
    and on a failed launch."""
    n_pad, d_pad = x.shape
    nq = q.shape[0]
    if q.dtype != torch.float32:
        raise ValueError("range_scan: q must be float32")
    if n_pad % 128 or d_pad % 128 or q.shape[1] != d_pad:
        raise ValueError(f"range_scan: x {tuple(x.shape)} must be padded to "
                         f"multiples of 128 and q {tuple(q.shape)} to d_pad")
    if k < 1:
        raise ValueError(f"range_scan: k={k} must be at least 1")
    dev = x.device
    if q.device != dev:
        raise ValueError("range_scan: x and q must share one device")
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    dists = torch.empty((nq, k), dtype=torch.float32, device=dev)
    if nq == 0:
        return ids, dists
    w = window_rows(bucket)
    p = 1 << (k - 1).bit_length()
    if p <= SMEM_K:
        r = max(ROWS_PER_BLOCK, p)
        s = -(-w // r)
    else:       # whole sorted chunks, a pow2 number of them, merged in place
        r = SMEM_K
        s = 1 << (-(-w // r) - 1).bit_length()
    partial = torch.empty((nq, s, min(k, r)), dtype=torch.int64, device=dev)
    x, code, scale = _build.corpus_operands(x, scale, "range_scan")
    if x.data_ptr() % 16:
        raise ValueError("range_scan: x must start on a 16-byte boundary "
                         "(rows are read with vector loads)")
    q = q.contiguous()
    starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    if live is not None:
        live = live.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
        if live.numel() != n_pad:
            raise ValueError(f"range_scan: live has {live.numel()} entries, "
                             f"x has {n_pad} rows")
    lib = _build.library("range_scan")
    rc = lib.range_scan_launch(
        x.data_ptr(), code, None if scale is None else scale.data_ptr(),
        starts.data_ptr(), lens.data_ptr(), q.data_ptr(),
        None if live is None else live.data_ptr(), partial.data_ptr(),
        ids.data_ptr(), dists.data_ptr(), n_pad, d_pad, nq, w, k,
        int(n_valid) or n_pad, r, s,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "range_scan")
    return ids, dists
