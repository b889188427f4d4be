"""Quantized corpus artifacts for the int8/bf16 scoring paths.

The corpus is stored once per precision in the same rank-sorted order as the
f32 vectors, so interval slicing (``x[L : R+1]``), neighbor gathers and the
scan kernel's window arithmetic are unchanged; only the bytes moved per
scored row shrink (4x for int8, 2x for bf16).

* ``int8``: per-dimension symmetric quantization, ``scale[j] =
  max|x[:, j]| / 127`` (1 for an all-zero dimension) and ``data =
  round(x / scale)`` (half to even) clipped to ±127.  The kernels
  dequantize each element (``float(data) * scale``) before scoring.
* ``bf16``: a round-to-nearest-even downcast; no scale.

Both are bit-equal to the reference's ``repro.kernels.quantize`` corpora
(``torch.round`` and ``Tensor.to(torch.bfloat16)`` round half to even, as
``jnp.round`` and ``astype(bfloat16)`` do; the tests compare raw bits).

Quantized scoring alone is approximate; the f32 rerank restores the exact
top-k: the quantized pass over-fetches ``rerank_depth(k, ef)`` survivors,
and the rerank breaks distance ties toward the lower rank, the exact
path's tie (its plain version sorts them first with ``sort_candidates``;
the kernel keys on (dist, id))."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

PRECISIONS = ("f32", "int8", "bf16")

#: the reference scan kernel's running top-k lives in one 128-lane row, so
#: its quantized over-fetch is capped there; the port keeps the cap because
#: it decides which ids survive into the rerank
RERANK_CAP = 128

_INT32_MAX = torch.iinfo(torch.int32).max


def rerank_depth(k: int, ef: int, cap: int = RERANK_CAP) -> int:
    """Quantized-pass over-fetch: ~4*ef survivors, clamped to [k, cap]."""
    return int(min(max(4 * int(ef), int(k)), max(int(cap), int(k))))


@dataclass(frozen=True)
class QuantizedCorpus:
    """One rank-ordered quantized corpus copy.

    data  : (n, d) int8 or bfloat16, same row order as the f32 vectors.
    scale : (d,) f32 per-dimension dequant factors (int8 only; None for
            bf16)."""
    precision: str
    data: torch.Tensor
    scale: Optional[torch.Tensor]

    @property
    def bytes_per_vector(self) -> int:
        return int(self.data.shape[1]) * self.data.element_size()


def quantize_corpus(vecs: torch.Tensor, precision: str) -> QuantizedCorpus:
    """Build the quantized copy of a rank-ordered (n, d) f32 corpus, on the
    corpus's device."""
    x = torch.as_tensor(vecs, dtype=torch.float32)
    if precision == "bf16":
        return QuantizedCorpus("bf16", x.to(torch.bfloat16), None)
    if precision != "int8":
        raise ValueError(f"quantize_corpus: invalid precision {precision!r} "
                         f"(expected one of {PRECISIONS[1:]})")
    abs_max = torch.amax(x.abs(), dim=0)
    # an all-zero dimension would divide by zero; its rows are all zero
    # anyway, so any positive scale round-trips them exactly
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can round 1 ulp away from IEEE division
    scale = torch.where(abs_max > 0,
                        abs_max / torch.full_like(abs_max, 127.0),
                        torch.ones_like(abs_max))
    data = torch.clamp(torch.round(x / scale[None, :]), -127, 127)
    return QuantizedCorpus("int8", data.to(torch.int8), scale)


def dequantize(qc: QuantizedCorpus) -> torch.Tensor:
    """f32 view of the quantized corpus: what the kernels score against."""
    x = qc.data.float()
    if qc.scale is not None:
        x = x * qc.scale[None, :]
    return x


def sort_candidates(ids: torch.Tensor) -> torch.Tensor:
    """Sort candidate rank ids ascending along the last axis, -1 pads last,
    as int32: the order the reference's rerank kernel needs (it breaks
    distance ties toward the lower input index), in which that tie is the
    exact path's tie toward the lower rank."""
    ids = ids.to(torch.int32)
    s = torch.sort(torch.where(ids >= 0, ids, _INT32_MAX), dim=-1).values
    return torch.where(s == _INT32_MAX, -1, s)
