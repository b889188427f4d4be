"""Public kernel wrappers: dispatch by device, and count launches.

Dispatch follows the device of the tensor a wrapper is given, never what
happens to be installed:

* a CPU tensor runs the kernel's plain PyTorch version
  (``repro_torch.kernels.ref``);
* a CUDA tensor launches the hand-written Hopper kernel
  (``repro_torch/csrc``), built on first use; a failed build or launch
  raises.  There is no fallback.

The scoring kernels take an f32 corpus or a quantized copy (int8 with its
per-dimension ``scale``, or bf16; ``repro_torch.kernels.quantize``).

``LAUNCHES`` counts the wrapper calls that launched a CUDA kernel (a CPU
call counts nothing): the scoring kernels per corpus dtype, under
``"<kernel>.<f32|int8|bf16>"`` (``range_scan``, ``gather_dist``,
``gather_topk`` and the fused beams ``beam_single`` and ``beam_batched``),
``"gather_rerank"``, and ``l2dist`` per input dtype (``"l2dist.f32"``,
``"l2dist.bf16"``), so a run can show that its path went through the
kernels, and through which variant: zero the counts with
``reset_launches`` just before the run and read them just after."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

DTYPE_NAMES = {torch.float32: "f32", torch.int8: "int8",
               torch.bfloat16: "bf16"}

LAUNCHES: Dict[str, int] = dict.fromkeys(
    [f"{kernel}.{dt}"
     for kernel in ("range_scan", "gather_dist", "gather_topk",
                    "beam_single", "beam_batched")
     for dt in DTYPE_NAMES.values()] + ["gather_rerank", "l2dist.f32",
                                        "l2dist.bf16"], 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name: str, x: torch.Tensor | None = None) -> None:
    LAUNCHES[name if x is None else f"{name}.{DTYPE_NAMES[x.dtype]}"] += 1


def _tile(m: int, cap: int = 128) -> int:
    """The reference's lane-row size for an id vector of length m."""
    return int(min(cap, 1 << max(int(m) - 1, 0).bit_length() if m > 1 else 1))


def l2dist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q,d) × (N,d) -> (Q,N) squared L2 in the expansion form, f32 sums,
    clamped at 0; q and x f32 or bf16 (both of one dtype on the card);
    any Q, N and d."""
    if q.device.type == "cpu":
        return ref.l2dist_ref(q, x)
    from repro_torch.kernels.l2dist import l2dist_cuda
    out = l2dist_cuda(q, x)
    _count("l2dist", q)
    return out


def gather_dist(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """Fused gather + score: x (N,d), ids (Q,M) (clipped to [0, N-1]),
    q (Q,d) -> (Q,M) Σ(x·scale−q)².  Callers mask."""
    if x.device.type == "cpu":
        return ref.gather_dist_ref(x, ids, q, scale)
    from repro_torch.kernels.gather_dist import gather_dist_cuda
    out = gather_dist_cuda(x, ids, q, scale)
    _count("gather_dist", x)
    return out


def gather_topk(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                k: int, scale: torch.Tensor | None = None):
    """Fused gather + score + top-k: the reference's batched-beam frontier
    feed (on the card the fused ``beam_batched`` does it inside its loop).
    ids (Q,M), negative = masked -> (ids:(Q,k) i32 ascending distance (-1
    pad), dists:(Q,k) f32 (+inf pad)), ties toward the lower input position.
    Raises ``ValueError`` for a k beyond the reference kernel's running
    top-k row (``gather_topk_pallas``), on every device."""
    tile = _tile(max(ids.shape[1], k))
    if k > tile:
        raise ValueError(f"gather_topk: k={k} exceeds the {tile}-lane "
                         f"running top-k row (use gather_dist + sort)")
    if x.device.type == "cpu":
        return ref.gather_topk_ref(x, ids, q, k=k, scale=scale)
    from repro_torch.kernels.gather_dist import gather_topk_cuda
    out = gather_topk_cuda(x, ids, q, k=k, scale=scale)
    _count("gather_topk", x)
    return out


def gather_rerank(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                  k: int):
    """Batched f32 rescore of (Q, M) quantized-pass survivor ids (negative
    = masked, in any order) against (Q, d) queries: the exactness-restoring
    stage of the quantized path.  Distance ties go to the lower id, so the
    result is the reference's ``gather_rerank`` on the ids sorted ascending
    (``quantize.sort_candidates``), which the plain version does first and
    the kernel keys on instead.  Every M and every k (the reference's
    kernel stops at k = 128)."""
    if x.device.type == "cpu":
        return ref.gather_rerank_ref(x, ids, q, k=k)
    from repro_torch.kernels.gather_dist import gather_rerank_cuda
    out = gather_rerank_cuda(x, ids, q, k=k)
    _count("gather_rerank")
    return out


def beam_single(x: torch.Tensor, scale, nbrs: torch.Tensor, qv, lo, hi,
                entry, *, ef: int, steps_cap: int, early_stop: bool):
    """The bw-1 beam's whole hop loop over a batch: x (n,d) the corpus the
    traversal scores (f32, or int8/bf16 with ``scale``), nbrs (n,m) i32,
    qv (Q,d) f32, lo/hi (Q,) rank bounds, entry (Q,) or (Q,E) ->
    (cand_d (Q,ef) f32, cand_ids (Q,ef) i64, hops (Q,), ndist (Q,)): the
    final pool, ascending.  The plain version is the lockstep loop
    (``ref.beam_single_ref``); a CUDA tensor launches one fused kernel for
    the batch."""
    if x.device.type == "cpu":
        return ref.beam_single_ref(x, scale, nbrs, qv, lo, hi, entry, ef=ef,
                                   steps_cap=steps_cap,
                                   early_stop=early_stop)
    from repro_torch.kernels.beam import beam_single_cuda
    out = beam_single_cuda(x, scale, nbrs, qv, lo, hi, entry, ef=ef,
                           steps_cap=steps_cap, early_stop=early_stop)
    _count("beam_single", x)
    return out


def beam_batched(x: torch.Tensor, scale, nbrs: torch.Tensor, qv, lo, hi,
                 entry, *, ef: int, steps_cap: int, early_stop: bool,
                 beam_width: int):
    """The bw-``beam_width`` beam's whole hop loop over a batch, as
    ``beam_single`` (plain version: ``ref.beam_batched_ref``)."""
    if x.device.type == "cpu":
        return ref.beam_batched_ref(x, scale, nbrs, qv, lo, hi, entry,
                                    ef=ef, steps_cap=steps_cap,
                                    beam_width=beam_width,
                                    early_stop=early_stop)
    from repro_torch.kernels.beam import beam_batched_cuda
    out = beam_batched_cuda(x, scale, nbrs, qv, lo, hi, entry, ef=ef,
                            steps_cap=steps_cap, early_stop=early_stop,
                            beam_width=beam_width)
    _count("beam_batched", x)
    return out


def range_scan(x: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
               q: torch.Tensor, *, bucket: int, k: int, n_valid: int = 0,
               scale: torch.Tensor | None = None,
               live: torch.Tensor | None = None):
    """Per-query masked scan + top-k over contiguous rank slices of x.
    ``n_valid`` masks the zero rows padding x to a row-tile multiple
    (0 = all of x is real); ``x`` may be a quantized corpus copy whose
    ``scale`` dequantizes int8 rows; ``live`` ((1, n_pad) i32) masks
    tombstoned rows."""
    if x.device.type == "cpu":
        return ref.range_scan_ref(x, starts, lens, q, bucket=bucket, k=k,
                                  n_valid=n_valid, live=live, scale=scale)
    from repro_torch.kernels.range_scan import range_scan_cuda
    out = range_scan_cuda(x, starts, lens, q, bucket=bucket, k=k,
                          n_valid=n_valid, live=live, scale=scale)
    _count("range_scan", x)
    return out
