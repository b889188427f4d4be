"""Explicit device selection for the port's entry points."""
from __future__ import annotations

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
