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

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.range_scan import arrival_counters

#: keys one block sorts at once in shared memory (32 KB)
TILE_MAX = 4096
#: largest next_pow2(k) a block keeps as its running best; a larger k (the
#: rerank only) is merged in global memory
SMEM_K = 2048

#: ``gather_rerank_launch``'s paths (``PATH_*`` in the kernel source),
#: chosen by ``rerank_plan`` only: one launch of per-warp threshold lists
#: whose last block per query merges the chunks; one block per query
#: sorting in shared memory; sorted runs merged in global memory
PATH_SELECT, PATH_BLOCK, PATH_RUNS = 0, 1, 2
#: largest k of the select path
SELECT_K = 256
#: positions one step of a select block scores: 8 warps of four 8-lane
#: groups with RERANK_U = 4 rows each (``csrc/gather_dist.cu``)
SELECT_STEP = 128
#: bytes of rows one select block reads (512 rows at d = 128, four steps:
#: a block's fixed cost, its id load, merges and ticket, stays small beside
#: its row loads; 64 and 128 KB blocks were slower at every M past 128),
#: until a query would need more than SELECT_CHUNKS blocks
SELECT_BYTES = 256 * 1024
SELECT_CHUNKS = 64
#: most ids one select block stages in shared memory (a larger M takes
#: more blocks)
SELECT_MAX_R = 4096


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


@functools.lru_cache(maxsize=256)
def rerank_plan(m: int, k: int, d: int) -> Tuple[int, int, int, int, int]:
    """(path, R, S, P, SZ) of ``gather_rerank_launch`` for M positions per
    query, k survivors and f32 rows of d elements.

    * k <= SELECT_K, PATH_SELECT: S blocks per query of R positions each
      (a multiple of SELECT_STEP), as many as SELECT_BYTES of rows each
      needs, at most SELECT_CHUNKS (more only where R would pass
      SELECT_MAX_R), evened out to ceil(M / S) rounded up; one block emits
      its query's top-k itself;
    * else ``topk_plan``'s: PATH_BLOCK with its (P, SZ), one block per
      query, or PATH_RUNS with R = TILE_MAX and S a power of two."""
    if k <= SELECT_K:
        rows = max(SELECT_STEP,
                   SELECT_BYTES // (4 * max(d, 1)) // SELECT_STEP
                   * SELECT_STEP)
        s = max(1, min(-(-m // rows), SELECT_CHUNKS), -(-m // SELECT_MAX_R))
        r = -(-max(1, -(-m // s)) // SELECT_STEP) * SELECT_STEP
        return PATH_SELECT, r, max(1, -(-m // r)), 0, 0
    p, sz, r, s = topk_plan(m, k)
    if s:
        return PATH_RUNS, r, s, 0, 0
    return PATH_BLOCK, 0, 0, p, sz


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
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    return ids.contiguous(), q.contiguous()


def _stream(x):
    """The raw handle of the current stream of x's device (what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without building
    a Stream object: a few microseconds less per call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


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


def _outputs(ids, q, k):
    """(Q, k) int32 ids and f32 distances on the device of ids (int32) and
    q (f32), left unwritten."""
    if k < 1:
        raise ValueError(f"top-k: k={k} must be at least 1")
    return ids.new_empty((ids.shape[0], k)), q.new_empty((ids.shape[0], k))


def gather_topk_cuda(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                     k: int, scale: torch.Tensor | None = None):
    """Per-query top-k of the gathered distances (negative ids masked) on
    CUDA tensors -> (ids:(Q,k) i32, dists:(Q,k) f32); x f32, int8 or bf16.
    The caller has checked the reference's k bound (k <= 128)."""
    ids, q = _check(x, ids, q, "gather_topk")
    x, code, scale = _build.corpus_operands(x, scale, "gather_topk")
    nq, m = ids.shape
    out_i, out_d = _outputs(ids, q, k)
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
    nearest of its survivor ids (any order, -1 masked, an id >= N scored as
    row N-1), ties toward the lower id -> (ids:(Q,k) i32, dists:(Q,k) f32),
    for every M and every k.  int32 contiguous ids and a contiguous query
    are used as they are (no copy); for k <= SELECT_K it is one launch."""
    if x.dtype != torch.float32:
        raise ValueError("gather_rerank: x must be float32")
    ids, q = _check(x, ids, q, "gather_rerank")
    x = x.contiguous()
    n, d = x.shape
    nq, m = ids.shape
    out_i, out_d = _outputs(ids, q, k)
    if nq == 0:
        return out_i, out_d
    if n == 0:
        raise ValueError("gather_rerank: x has no rows")
    path, r, s, p, sz = rerank_plan(m, k, d)
    stream = _stream(x)
    scratch = arrivals = None
    if path == PATH_RUNS:
        scratch = torch.empty((nq, s * r), dtype=torch.int64, device=x.device)
    elif s > 1:
        scratch = torch.empty((nq, s, k), dtype=torch.int64, device=x.device)
        arrivals = arrival_counters(x.device, stream, nq)
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0
    rc = _build.library("gather_dist").gather_rerank_launch(
        path, int(vec), x.data_ptr(), ids.data_ptr(), q.data_ptr(),
        out_i.data_ptr(), out_d.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        n, d, nq, m, k, r, s, p, sz, stream)
    _build.check(rc, "gather_rerank")
    return out_i, out_d
