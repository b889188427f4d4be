"""The fused beam search: the CUDA launchers of ``csrc/beam.cu``.

One launch runs the whole hop loop of a batch, one thread block per query
(``beam_single`` for bw 1, ``beam_batched`` for bw > 1), in place of the
lockstep loop's per-hop ``gather_dist`` / ``gather_topk`` launches.  The
host keeps the set-up: the entry pool (``ref.init_pool``), stably sorted
once (the kernel's merge keeps it sorted, which equals the reference's
stable sort of pool + fresh every hop), the entry ids the kernel marks
visited, and for bw 1 the zeroed visited bitmap.  ``beam_plan`` owns the
block's shared-memory layout and hands its byte offsets to the kernel.
The plain version of these kernels is the lockstep loop itself
(``ref.beam_single_ref`` / ``ref.beam_batched_ref``); callers go through
``repro_torch.kernels.ops``."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import init_pool, visited_table_size

#: shared memory one block may hold on an H100 (227 KB, the opt-in
#: maximum; the kernel refuses a layout past the card's own)
SMEM_MAX = 232448
#: control ints of a block: the kernel's 33 scan words and, at 40, the
#: count of the hop's fresh entries
CTL_INTS = 64
#: the byte offsets a plan hands the kernel, in the order of
#: ``csrc/beam.cu``'s ``Layout``: the block's regions, its total, and
#: within one pool buffer the ids, the expanded flags and the buffer's size
LAYOUT = ("q", "scale", "ctl", "sel", "fid", "fok", "fv", "slot", "sd",
          "sid", "fkey", "table", "pool", "total", "pool_id", "pool_e",
          "pool_buf")


def _a16(x: int) -> int:
    return (int(x) + 15) // 16 * 16


@dataclass(frozen=True)
class BeamPlan:
    """How one query's state is laid out: B expansions per hop, F = B·m
    fresh entries, an H-slot visited table (0 for bw 1), the byte offsets
    of ``LAYOUT``, and whether the two pool buffers live in a global
    scratch row (``pool_global``) because they do not fit beside the
    rest."""
    B: int
    F: int
    H: int
    offsets: Tuple[int, ...]
    pool_global: bool

    def at(self, name: str) -> int:
        return self.offsets[LAYOUT.index(name)]

    @property
    def smem(self) -> int:
        """Shared memory of one block, bytes."""
        return self.at("total")


def beam_plan(ef: int, m: int, beam_width: int, d: int) -> BeamPlan:
    """The block layout of ``csrc/beam.cu``, every region 16-aligned: the
    query and the scale, the control ints, the B selected positions, seven
    arrays of F fresh entries (the keys 8 bytes each, the rest 4), the
    bw > 1 table of H+1 ints, and, when it all fits in ``SMEM_MAX``, two
    pool buffers of ef (distance, id, expanded flag).  Raises
    ``ValueError`` when even without the pool the state does not fit (a d
    or a B·m far beyond the main path's)."""
    if ef < 1 or m < 1 or d < 1:
        raise ValueError(f"beam: ef={ef}, m={m}, d={d} must be positive")
    batched = beam_width > 1
    B = min(int(beam_width), ef) if batched else 1
    F = B * m
    H = visited_table_size(ef, m) if batched else 0
    off, o = [], 0
    for size in (4 * d, 4 * d, 4 * CTL_INTS, 4 * B, *[4 * F] * 6, 8 * F,
                 4 * (H + 1) if H else 0):
        off.append(o)
        o += _a16(size)
    pool_id = _a16(4 * ef)
    pool_e = 2 * pool_id
    pool_buf = pool_e + _a16(ef)
    pool_global = o + 2 * pool_buf > SMEM_MAX
    if o > SMEM_MAX:
        raise ValueError(f"beam: ef={ef}, m={m}, beam_width={beam_width}, "
                         f"d={d} needs {o} bytes of shared memory besides "
                         f"the pool; a block holds {SMEM_MAX}")
    total = o if pool_global else o + 2 * pool_buf
    return BeamPlan(B, F, H, (*off, o, total, pool_id, pool_e, pool_buf),
                    pool_global)


def _check(x, nbrs, qv, lo, hi, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA tensor")
    if qv.dtype != torch.float32 or nbrs.dtype != torch.int32:
        raise ValueError(f"{what}: qv must be float32 and nbrs int32, got "
                         f"{qv.dtype}, {nbrs.dtype}")
    if x.dim() != 2 or nbrs.dim() != 2 or qv.shape[1:] != x.shape[1:] \
            or nbrs.shape[0] != x.shape[0]:
        raise ValueError(f"{what}: expected x (n,d), nbrs (n,m), qv (Q,d); "
                         f"got {tuple(x.shape)}, {tuple(nbrs.shape)}, "
                         f"{tuple(qv.shape)}")
    if any(t.device != x.device for t in (nbrs, qv, lo, hi)):
        raise ValueError(f"{what}: x, nbrs, qv, lo and hi must share one "
                         f"device")


def _launch(fn_name, x, scale, nbrs, qv, lo, hi, entry, *, ef: int,
            steps_cap: int, early_stop: bool, beam_width: int):
    what = fn_name.replace("_launch", "")
    _check(x, nbrs, qv, lo, hi, what)
    xc, code, scale = _build.corpus_operands(x, scale, what)
    n, m = nbrs.shape
    nq, d = qv.shape
    plan = beam_plan(ef, m, beam_width, d)
    cand_d, cand_ids, expanded, e0c, ev = init_pool(xc, scale, qv, lo, hi,
                                                    entry, ef)
    o = torch.argsort(cand_d, dim=1, stable=True)     # the merge keeps it
    init_d = cand_d.gather(1, o).contiguous()
    init_id = cand_ids.gather(1, o).int().contiguous()
    init_e = expanded.gather(1, o).to(torch.uint8).contiguous()
    seeds = torch.where(ev, e0c, -1).int().contiguous()
    dev = x.device
    out_d = torch.empty((nq, ef), dtype=torch.float32, device=dev)
    out_id = torch.empty((nq, ef), dtype=torch.int32, device=dev)
    steps = torch.empty(nq, dtype=torch.int32, device=dev)
    ndist = torch.empty(nq, dtype=torch.int32, device=dev)
    words = 0 if plan.H else (n + 32) // 32          # n+1 bits per query
    visited = (torch.zeros((nq, words), dtype=torch.int32, device=dev)
               if words else None)
    pool = (torch.empty((nq, 2 * plan.at("pool_buf")), dtype=torch.uint8,
                        device=dev) if plan.pool_global else None)
    layout = (ctypes.c_longlong * len(LAYOUT))(*plan.offsets)
    # every operand held in a name until the launch is enqueued: a
    # temporary freed mid-call could hand its memory to the next one
    nbrs, qv = nbrs.contiguous(), qv.contiguous()
    lo32, hi32 = lo.int().contiguous(), hi.int().contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = getattr(_build.library("beam"), fn_name)(
        xc.data_ptr(), code, ptr(scale), nbrs.data_ptr(), qv.data_ptr(),
        lo32.data_ptr(), hi32.data_ptr(), seeds.data_ptr(), init_d.data_ptr(),
        init_id.data_ptr(), init_e.data_ptr(), out_d.data_ptr(),
        out_id.data_ptr(), steps.data_ptr(), ndist.data_ptr(), ptr(visited),
        ptr(pool), nq, d, m, seeds.shape[1], ef, plan.B, plan.H, words,
        steps_cap, int(early_stop), int(plan.pool_global), layout,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    return out_d, out_id.long(), steps.long(), ndist.long()


def beam_single_cuda(x, scale, nbrs, qv, lo, hi, entry, *, ef: int,
                     steps_cap: int, early_stop: bool):
    """bw 1 on CUDA tensors: the final (Q, ef) pool (distances, ids),
    hops and ndist per query, as ``ref.beam_single_ref`` returns them."""
    return _launch("beam_single_launch", x, scale, nbrs, qv, lo, hi, entry,
                   ef=ef, steps_cap=steps_cap, early_stop=early_stop,
                   beam_width=1)


def beam_batched_cuda(x, scale, nbrs, qv, lo, hi, entry, *, ef: int,
                      steps_cap: int, early_stop: bool, beam_width: int):
    """bw > 1 on CUDA tensors, as ``ref.beam_batched_ref`` returns it."""
    if beam_width < 2:
        raise ValueError(f"beam_batched: beam_width={beam_width} < 2")
    return _launch("beam_batched_launch", x, scale, nbrs, qv, lo, hi, entry,
                   ef=ef, steps_cap=steps_cap, early_stop=early_stop,
                   beam_width=beam_width)
