"""Explicit device selection for the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    implied) and none is present: the port never carries on quietly on the
    CPU — a caller that wants the plain PyTorch path passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is present; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev


def resolve_use_kernel(use_kernel, device) -> bool:
    """A search's ``use_kernel``: ``None`` means the fused kernels on a
    CUDA index and their plain versions on a CPU one; an explicit bool is
    kept."""
    if use_kernel is None:
        return torch.device(device).type == "cuda"
    return bool(use_kernel)


#: int32 words each uploaded part starts on (256 bytes: every kernel's
#: vector loads of a part's rows stay aligned)
_PART_ALIGN = 64


def upload(arrays, device: torch.device, pinned: bool = False):
    """Host arrays of 4-byte dtypes (float32 / int32) -> tensors on
    ``device``.  By default one plain copy per array, each returning once
    its data is there: the cheapest for a caller that waits on the card
    anyway.  ``pinned=True`` (a deferred dispatch) packs the arrays into one
    int32 buffer, each part starting on a 256-byte boundary, pins it and
    copies it once without blocking the host, so a caller can enqueue the
    kernels that read it (and other copies) before anything waits on the
    card; on the CPU the tensors view the packed buffer."""
    if not pinned:
        return [torch.as_tensor(a, device=device) for a in arrays]
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, o = [], 0
    for a in arrays:
        if a.dtype.itemsize != 4:
            raise ValueError(f"upload: dtype {a.dtype} is not 4 bytes wide")
        offs.append(o)
        o += -(-a.size // _PART_ALIGN) * _PART_ALIGN
    flat = np.zeros(max(o, 1), np.int32)
    for a, off in zip(arrays, offs):
        flat[off:off + a.size] = a.reshape(-1).view(np.int32)
    buf = torch.from_numpy(flat)
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    out = []
    for a, off in zip(arrays, offs):
        t = buf[off:off + a.size]
        if a.dtype == np.float32:
            t = t.view(torch.float32)
        elif a.dtype != np.int32:
            raise ValueError(f"upload: dtype {a.dtype} is not float32 or "
                             f"int32")
        out.append(t.reshape(a.shape))
    return out
