"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with the reference
kernel's contract: ``-1``/``+inf`` pads, ``n_valid``, ``live`` and the
128-aligned scan window.  The wrappers in ``repro_torch.kernels.ops`` run
these for tensors on the CPU (the tests hold them against the reference's
Pallas kernels); ``chip_smoke.py`` holds the CUDA kernels against them on
the card.

Top-k is a stable ascending sort of the distances, i.e. the lexicographic
key (dist, position), which is the tie order of ``lax.top_k`` and of the
reference kernels' first-occurrence select-min.

A corpus ``x`` may be f32 or a quantized copy (int8/bf16, see
``repro_torch.kernels.quantize``): rows are upcast to f32 and multiplied
by the optional (d,) f32 ``scale`` before scoring, as the kernels do."""
from __future__ import annotations

import torch

from repro_torch.kernels.range_scan import window_rows

INF = float("inf")


def _smallest(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Per-row k smallest of ``d`` by (dist, position), with the ids that
    ride along; rows shorter than k are padded with (+inf, -1), and any
    non-finite survivor comes back as id -1."""
    short = k - d.shape[1]
    if short > 0:
        d = torch.nn.functional.pad(d, (0, short), value=INF)
        ids = torch.nn.functional.pad(ids, (0, short), value=-1)
    o = torch.argsort(d, dim=1, stable=True)[:, :k]
    dk = d.gather(1, o)
    ik = torch.where(torch.isfinite(dk), ids.gather(1, o), -1)
    return ik.to(torch.int32), dk


def l2dist_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q,d) × (N,d) -> (Q,N) squared L2, f32 accumulation: the expansion
    form ‖q‖² − 2 q·x + ‖x‖², clamped at 0 (IEEE f32: TF32 is off
    package-wide)."""
    qf, xf = q.float(), x.float()
    qn = torch.sum(qf * qf, dim=-1, keepdim=True)
    xn = torch.sum(xf * xf, dim=-1)
    return torch.clamp_min(qn - 2.0 * (qf @ xf.T) + xn[None, :], 0.0)


def dequantized_rows(x: torch.Tensor, idx: torch.Tensor,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """f32 rows ``x[idx]`` (any index shape), times ``scale`` when given."""
    rows = x[idx].float()
    return rows if scale is None else rows * scale


def gather_dist_ref(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """x:(N,d) f32/int8/bf16; ids:(Q,M) (clipped to [0, N-1]); q:(Q,d) ->
    (Q,M) Σ(x·scale−q)², the difference form of ``gather_dist_pallas``."""
    rows = dequantized_rows(x, ids.long().clamp(0, x.shape[0] - 1), scale)
    diff = rows - q[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def gather_topk_ref(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                    k: int, scale: torch.Tensor | None = None):
    """(Q,M) ids, negative = masked -> per-query (ids:(Q,k) i32 ascending
    distance (-1 pad), dists:(Q,k) f32 (+inf pad)), ties toward the lower
    input position."""
    ids = ids.long()
    d = torch.where(ids >= 0, gather_dist_ref(x, ids, q, scale), INF)
    return _smallest(d, ids, k)


def gather_rerank_ref(x: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, *,
                      k: int):
    """The f32 rerank: x:(N,d) f32; ids:(Q,M) survivor ranks (negative =
    masked, sorted ascending by the caller); q:(Q,d) -> (ids:(Q,k),
    dists:(Q,k)), ties toward the lower input index — the reference's
    batched ``gather_rerank_ref``, for every k."""
    return gather_topk_ref(x, ids, q, k=k)


def range_scan_ref(x: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                   q: torch.Tensor, *, bucket: int, k: int,
                   n_valid: int = 0, live: torch.Tensor | None = None,
                   scale: torch.Tensor | None = None):
    """x:(n_pad,d_pad) rank-ordered; starts/lens:(Q,); q:(Q,d_pad) ->
    (ids:(Q,k) i32 absolute ranks (-1 pad), dists:(Q,k) f32 (+inf pad)).

    Scores the ``window_rows(bucket)`` rows from the 128-aligned block at or
    below each start, masks ranks outside ``[start, start+len)``, at or past
    ``n_valid``, or with ``live[rank] == 0`` (``live``: (n_pad,)), and uses
    the Pallas kernel's **expansion form** max(‖q‖²−2q·x+‖x‖², 0) — not the
    difference form of the reference's ``range_scan_ref``.  A quantized
    ``x`` is dequantized (``scale``: (d_pad,) f32) before the expansion, as
    the Pallas body does."""
    n_pad = x.shape[0]
    n_valid = int(n_valid) or n_pad
    w = window_rows(bucket)
    starts = starts.long()
    lens = lens.long()
    base = torch.div(starts, 128, rounding_mode="floor") * 128
    rank = base[:, None] + torch.arange(w, device=x.device)[None, :]   # (Q,w)
    rc = rank.clamp(0, n_pad - 1)
    rows = dequantized_rows(x, rc, scale)                              # (Q,w,d)
    dot = torch.einsum("qwd,qd->qw", rows, q)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(rows * rows, dim=-1)
    d2 = torch.clamp_min(-2.0 * dot + qn + xn, 0.0)
    valid = ((rank >= starts[:, None]) & (rank < (starts + lens)[:, None])
             & (rank < n_valid))
    if live is not None:
        valid &= live.reshape(-1)[rc] != 0
    d2 = torch.where(valid, d2, INF)
    return _smallest(d2, rank, k)
