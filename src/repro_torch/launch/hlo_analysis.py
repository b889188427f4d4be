"""Operation and collective accounting + roofline terms (the counterpart of
the reference's ``repro.launch.hlo_analysis``, which parses compiled HLO).

The port has no HLO: a program is run eagerly on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``, no allocation) and
counted as it runs — its products by ``torch.utils.flop_counter.
FlopCounterMode``, the bytes its tensors allocate by ``AllocCounter``, and
what its collectives move by ``parallel.sharding.CollectiveCounter`` (per
device, under the reference's kinds: ``collective_bytes``).  Eager counting
sees every layer and every recompute, so no depth extrapolation is needed.

The rates are one H100 SXM's (``roofline_terms``; the kernel bounds of
``chip_smoke.py`` and ``benchmarks/run_torch.py`` read them from here).
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# the collective kinds, under the reference module's name
from repro_torch.parallel.sharding import COLLECTIVES  # noqa: F401
from repro_torch.parallel.sharding import CollectiveCounter

#: H100 SXM HBM3 bandwidth, bytes/s (NVIDIA H100 datasheet, SXM5 80 GB)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core peak, FLOP/s (the same datasheet)
BF16_FLOPS = 989e12
#: H100 SXM f32 peak outside the tensor cores, FLOP/s (the same datasheet)
F32_FLOPS = 67e12
#: per-GPU inter-node rate of a 16 × 16 mesh, bytes/s: 256 GPUs span 32
#: nodes of 8, so a collective over the mesh crosses the network, which a
#: DGX H100 reaches through one 400 Gb/s NDR InfiniBand port per GPU
#: (ConnectX-7; DGX H100 user guide): 400e9 / 8
IB_BYTES_PER_S = 50e9
#: one card's memory, bytes (H100 SXM5 80 GB)
HBM_PER_CARD = 80e9



def collective_bytes(counter) -> Dict[str, int]:
    """Per-device operand bytes per collective kind (and 'total'), read
    from a ``parallel.sharding.CollectiveCounter``."""
    return counter.as_dict()


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float, chips: int) -> Dict[str, float]:
    """Three roofline times (seconds), global convention: X_global/(chips·peak)
    == X_per_device/peak."""
    t_compute = per_device_flops / BF16_FLOPS
    t_memory = per_device_bytes / HBM_BYTES_PER_S
    t_coll = per_device_coll_bytes / IB_BYTES_PER_S
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    bound = max(t_compute, t_memory, t_coll)
    return dict(t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
                dominant=dominant, t_bound=bound,
                flops_global=per_device_flops * chips,
                bytes_global=per_device_bytes * chips,
                coll_bytes_global=per_device_coll_bytes * chips)


def model_flops(cfg, shape, n_active: int) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (serve)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


# ---------------------------------------------------------------- counting
def _elementwise_mapping():
    """Operation counts for the beam's distance arithmetic, which has no
    product for ``FlopCounterMode`` to count: one operation per output
    element of a subtraction, product, sum or square, one per summed
    element of a reduction."""
    aten = torch.ops.aten

    def per_out(*args, out_shape=None, **kw):
        n = 1
        for x in out_shape:
            n *= x
        return n

    def per_in(x_shape, *args, **kw):
        n = 1
        for x in x_shape:
            n *= x
        return n

    return {aten.sub: per_out, aten.add: per_out, aten.mul: per_out,
            aten.pow: per_out, aten.sum: per_in}


def count_program(build: Callable, run: Callable,
                  elementwise: bool = False) -> Dict:
    """Run the program on fake tensors and count it: ``build()`` makes its
    inputs (fake tensors made inside it allocate nothing) and returns
    ``(args, argument_bytes)``; ``run(args)`` is the program.  Returns
    ``flops`` (FlopCounterMode's products; ``elementwise`` adds the
    distance arithmetic), ``collectives`` (per-device bytes per kind and
    ``total``), ``calls`` (collectives per kind), ``argument_bytes`` (as
    ``build`` gave it), ``temp_bytes`` (every tensor the program
    allocates), ``seconds`` (the counted run's wall) and ``result`` (its
    fake output)."""
    # meta tensors made from Python data (a schedule's constants) stay
    # plain meta tensors: they hold no data either
    with FakeTensorMode(allow_non_fake_inputs=True):
        args, arg_bytes = build()
        fc = FlopCounterMode(display=False, custom_mapping=(
            _elementwise_mapping() if elementwise else None))
        alloc = AllocCounter()
        t0 = time.perf_counter()
        with fc, CollectiveCounter() as cc, alloc:
            result = run(args)
        secs = time.perf_counter() - t0
    return dict(flops=float(fc.get_total_flops()),
                collectives=collective_bytes(cc), calls=dict(cc.calls),
                argument_bytes=arg_bytes, temp_bytes=alloc.bytes,
                seconds=secs, result=result)


class AllocCounter(TorchDispatchMode):
    """A dispatch mode whose ``bytes`` sums the bytes of every tensor an
    operation creates (outputs that alias an input — views, in-place
    results — excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for r, t in zip(func._schema.returns, outs):
            if r.alias_info is None and isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out
