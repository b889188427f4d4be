"""Production mesh builders (the reference's ``repro.launch.mesh``):
``ShardMesh`` shapes over ``meta`` devices for the dry-run, and a
(data, model) mesh over the cards at hand."""
from __future__ import annotations

from typing import Sequence, Union

from repro_torch.parallel.sharding import ShardMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """Single pod: 16×16 = 256 devices (data, model).
    Multi-pod: 2×16×16 = 512 devices (pod, data, model).  Every device is
    ``meta``: the dry-run places no data on it."""
    axes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    return make_mesh(axes, ["meta"])


def make_mesh_for(devices: Union[int, Sequence], model_parallel: int = 1
                  ) -> ShardMesh:
    """Elastic helper: a (data, model) mesh over whatever devices survive —
    ``devices`` a count (shards round-robin over the visible cards,
    raising without one) or the devices themselves; checkpoints are
    mesh-agnostic (``parallel.fsdp.unshard_state``), so resuming on a
    different device count just re-shards."""
    n = devices if isinstance(devices, int) else len(devices)
    assert n % model_parallel == 0
    return make_mesh({"data": n // model_parallel, "model": model_parallel},
                     None if isinstance(devices, int) else devices)
