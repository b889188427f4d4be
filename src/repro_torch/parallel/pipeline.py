"""GPipe-style pipeline parallelism over a ``ShardMesh`` (the reference's
``repro.parallel.pipeline``, which runs it in ``shard_map`` with
``ppermute``).

Stage s of S holds its own slice of the layer stack (params stacked on a
leading stage dim; stage s's slice is moved to the mesh's s-th device).
Micro-batches stream through the classic GPipe schedule: T = M + S - 1
ticks; at tick t stage s is active while 0 <= t - s < M, computes its
current micro-batch and hands the activation to stage s + 1's device (the
``ppermute``).  The last stage records each finished micro-batch; they are
returned stacked on the mesh's first device.  The hand-offs are
``Tensor.to``, so autograd runs back through them and the same schedule
backpropagates.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel.sharding import ShardMesh, on_device
from repro_torch.training.tree import tree_map


def gpipe(stage_fn: Callable, mesh: ShardMesh, axis: str, n_stages: int,
          n_micro: int):
    """Returns pipelined(params_stacked, x_micro) -> y_micro.

    stage_fn(stage_params, x) -> y        (same shape in/out)
    params_stacked: leaves with leading dim n_stages
    x_micro: (n_micro, ...) micro-batches (only stage 0 consumes them)
    """
    if mesh.axis != axis or mesh.size != n_stages:
        raise ValueError(f"gpipe: a mesh of {n_stages} shards on axis "
                         f"{axis!r} is needed, got {mesh.size} on "
                         f"{mesh.axis!r}")

    def pipelined(params_stacked, x_micro):
        devs = mesh.devices
        stage_params = [tree_map(lambda a, s=s: a[s].to(devs[s]),
                                 params_stacked) for s in range(n_stages)]
        inbound = [None] * n_stages         # each stage's activation in
        outs = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            nxt = [None] * n_stages
            for s in range(n_stages):
                if not 0 <= t - s < n_micro:
                    continue
                x_in = x_micro[t].to(devs[0]) if s == 0 else inbound[s]
                with on_device(devs[s]):
                    y = stage_fn(stage_params[s], x_in)
                if s == n_stages - 1:
                    outs[t - s] = y.to(devs[0])
                else:
                    nxt[s + 1] = y.to(devs[s + 1])
            inbound = nxt
        return torch.stack(outs)

    return pipelined
