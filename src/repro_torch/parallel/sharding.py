"""Shard placement: the counterpart of the reference's ``make_mesh_compat``
and ``shard_map_compat``.

The reference's multi-device layer is single-controller: one process
drives a ``jax.Mesh`` through ``shard_map``, and the cross-shard steps are
in-body collectives.  Here one process holds a ``ShardMesh``, one
``torch.device`` per shard; ``shard_map`` runs a per-shard body on its
shard's device, ``all_gather`` stacks the shards' results on the mesh's
first device, and ``all_to_all`` exchanges per-owner slices (the MoE's
expert-parallel dispatch).  The copies are ``Tensor.to``, so autograd
runs back through them.  Shards are placed round-robin over the devices, so S
shards may share one card (they then run back to back on its current
stream) or spread over several."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ShardMesh:
    """One device per shard along ``axis``."""
    devices: Tuple[torch.device, ...]
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` are one card: give every CUDA device
    its index, so per-device state (replicas, uploads, the select kernels'
    arrival counters) never keys one card twice."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_shards: int, devices: Sequence | None = None,
              axis: str = "data") -> ShardMesh:
    """Place shard ``s`` on ``devices[s % len(devices)]``.  ``devices``
    defaults to every visible CUDA card and raises without one (as
    ``resolve_device`` does); pass ``["cpu"]`` for a mesh of CPU shards."""
    if n_shards < 1:
        raise ValueError(f"make_mesh: n_shards={n_shards} must be >= 1")
    if devices is None:
        resolve_device(None)                 # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_canonical(resolve_device(d)) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices given")
    return ShardMesh(tuple(devs[s % len(devs)] for s in range(n_shards)),
                     axis)


def on_device(dev: torch.device):
    """Context that makes ``dev`` the current card (a kernel launches on
    the current card); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def shard_map(body: Callable, mesh: ShardMesh) -> List:
    """``body(s, device)`` for every shard, each run with its device
    current; returns the per-shard results in shard order.  Shards on one
    card are enqueued one after another on its current stream."""
    out = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            out.append(body(s, dev))
    return out


def all_gather(parts: Sequence[torch.Tensor],
               mesh: ShardMesh) -> torch.Tensor:
    """Per-shard tensors of one shape -> one (S, ...) tensor on the mesh's
    first device (a copy only for shards on another device)."""
    dev = mesh.devices[0]
    return torch.stack([p.to(dev, non_blocking=True) for p in parts])


def all_to_all(parts: Sequence[torch.Tensor], mesh: ShardMesh,
               split_dim: int, concat_dim: int) -> List[torch.Tensor]:
    """The tiled ``lax.all_to_all``: shard s splits ``parts[s]`` into S
    equal slices along ``split_dim`` and sends slice r to shard r, which
    concatenates what it receives along ``concat_dim`` in source order.
    Returns the S received tensors, each on its shard's device."""
    S = mesh.size
    pieces = [torch.chunk(p, S, dim=split_dim) for p in parts]
    if any(len(ps) != S or ps[0].shape != ps[-1].shape for ps in pieces):
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{[tuple(p.shape) for p in parts]} does not split "
                         f"into {S} equal slices")
    return [torch.cat([pieces[s][r].to(mesh.devices[r]) for s in range(S)],
                      dim=concat_dim) for r in range(S)]
