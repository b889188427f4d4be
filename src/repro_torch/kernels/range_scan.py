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

#: the launcher's paths (``PATH_*`` in the kernel source), chosen here only:
#: one launch with per-warp threshold lists whose last block per query
#: merges the chunks; two passes with the merge in shared memory; two
#: passes with whole sorted runs merged in global memory
PATH_SELECT, PATH_SMEM_MERGE, PATH_RUN_MERGE = 0, 1, 2
#: largest k of the select path
SELECT_K = 256
#: bytes of rows one block of the select path reads (512 f32 rows at
#: d_pad = 128, 1024 bf16, 2048 int8: each block's fixed cost, its merges,
#: stays small beside its loads), until a window would need more than
#: SELECT_CHUNKS blocks
SELECT_BYTES = 256 * 1024
SELECT_CHUNKS = 32
#: rows one block of the two-pass path owns (it sorts R keys in shared
#: memory); raised to next_pow2(k) when k is larger
ROWS_PER_BLOCK = 1024
#: largest next_pow2(k) merged in shared memory (2·next_pow2(k) keys);
#: a larger k is merged in global memory
SMEM_K = 2048

#: per-(device, stream) arrival counters of the one-launch selects (this
#: scan's and ``gather_rerank``'s): zero before each launch, and a kernel's
#: last block of each query sets its counter back to zero.  Keyed by a
#: tensor's device, which always carries its index, so one card is one key
#: however many mesh shards it holds
_ARRIVALS: dict = {}


def window_rows(bucket: int, tb: int = 128) -> int:
    """Rows actually scanned for a bucket: ceil(bucket/tb) blocks plus one
    extra block so any start alignment is covered (single source of truth —
    the kernel, its jnp oracle, and the planner cost model all use this)."""
    return (-(-bucket // tb) + 1) * tb


def scan_plan(w: int, k: int, row_bytes: int):
    """(path, R, S, kc): the launcher's path, window rows per block, blocks
    per query and keys each block leaves in the (Q, S, kc) scratch, for a
    window of w rows of ``row_bytes`` bytes each.

    k <= SELECT_K, PATH_SELECT: as many chunks as SELECT_BYTES of rows each needs, at
    most SELECT_CHUNKS, evened out to ceil(w / S) rows rounded up to 128;
    one chunk needs no scratch (kc = 0).  Else two passes: R = max(1024,
    next_pow2(k)) rows over ceil(w / R) blocks while next_pow2(k) <= SMEM_K
    (PATH_SMEM_MERGE); past it whole sorted chunks of SMEM_K rows, a pow2
    number of them, merged in place (PATH_RUN_MERGE)."""
    p = 1 << (k - 1).bit_length()
    if k <= SELECT_K:
        rows = max(128, SELECT_BYTES // row_bytes // 128 * 128)
        s = min(-(-w // rows), SELECT_CHUNKS)
        r = -(-(-(-w // s)) // 128) * 128
        s = -(-w // r)
        return PATH_SELECT, r, s, (k if s > 1 else 0)
    if p <= SMEM_K:
        r = max(ROWS_PER_BLOCK, p)
        return PATH_SMEM_MERGE, r, -(-w // r), min(k, r)
    r = SMEM_K
    return PATH_RUN_MERGE, r, 1 << (-(-w // r) - 1).bit_length(), r


def arrival_counters(dev: torch.device, stream: int,
                     nq: int) -> torch.Tensor:
    """At least nq zeroed int32 counters on ``dev`` for launches on
    ``stream`` (kernels on one stream run one after another, so they share
    them)."""
    buf = _ARRIVALS.get((dev, stream))
    if buf is None or buf.numel() < nq:
        buf = torch.zeros(max(nq, 256), dtype=torch.int32, device=dev)
        _ARRIVALS[(dev, stream)] = buf
    return buf


def range_scan_cuda(x: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, q: torch.Tensor, *, bucket: int,
                    k: int, n_valid: int = 0,
                    live: torch.Tensor | None = None,
                    scale: torch.Tensor | None = None):
    """Launch the scan on CUDA tensors.  x:(n_pad, d_pad) f32, int8 or bf16
    with n_pad % 128 == 0 and d_pad % 128 == 0; ``scale``: (d_pad,) f32 or
    None; starts/lens:(Q,) (int32 costs no conversion); q:(Q, d_pad) f32;
    ``live``: (1, n_pad) or (n_pad,), 0 = masked.  Returns (ids:(Q,k) i32
    ranks (-1 pad), dists:(Q,k) f32 (+inf pad)).  Raises on inputs the
    kernel does not take and on a failed launch.  For k <= SELECT_K it is
    one kernel launch."""
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
    path, r, s, kc = scan_plan(w, k, d_pad * x.element_size())
    partial = (torch.empty((nq, s, kc), dtype=torch.int64, device=dev)
               if kc else None)
    x, code, scale = _build.corpus_operands(x, scale, "range_scan")
    q = q.contiguous()
    if (x.data_ptr() | q.data_ptr()
            | (0 if scale is None else scale.data_ptr())) % 16:
        raise ValueError("range_scan: x, q and scale must start on a "
                         "16-byte boundary (they are read with vector "
                         "loads)")
    starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    if live is not None:
        live = live.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
        if live.numel() != n_pad:
            raise ValueError(f"range_scan: live has {live.numel()} entries, "
                             f"x has {n_pad} rows")
    stream = torch.cuda.current_stream(dev).cuda_stream
    arrivals = (arrival_counters(dev, stream, nq) if path == PATH_SELECT
                else None)
    rc = _build.library("range_scan").range_scan_launch(
        path, x.data_ptr(), code, None if scale is None else scale.data_ptr(),
        starts.data_ptr(), lens.data_ptr(), q.data_ptr(),
        None if live is None else live.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        ids.data_ptr(), dists.data_ptr(), n_pad, d_pad, nq, w, k,
        int(n_valid) or n_pad, r, s, stream)
    _build.check(rc, "range_scan")
    return ids, dists
