"""ZeRO-1 across pods: the sharded train step with its optimizer moments
split over more mesh axes than their parameters (the ZeRO-1 rules,
``"fsdp"`` -> ``rules["fsdp+"]``, which add the ``pod`` axis), under both
the FSDP strategy's rules and the TP strategy's (``DEFAULT_RULES``).

Against the reference's own sharded step on a (pod 2, data 2, model 2)
``make_mesh_compat`` mesh with its moments placed by the ZeRO-1 rules, as
its dry-run places them (``tests/_torch_train_ref.py``): loss, aux,
gradient norm, every gradient leaf and every post-step parameter and
moment within 1e-4 in f32, over two steps.  Also: every moment block has
the ZeRO-1 spec's block shape (and every parameter block its own spec's),
``shard_state`` / ``unshard_state`` round-trip the layout bit for bit, and
``init_sharded_state`` draws the moments at their blocks."""
import math

import pytest
import torch

from _torch_train_ref import (assert_close, case_cfg, case_plan, port_model,
                              run_port, run_reference)
from repro_torch.models.params import logical_axes
from repro_torch.parallel.fsdp import (StateLayout, _get, init_sharded_state,
                                       shard_state, unshard_state)
from repro_torch.parallel.sharding import (STRATEGIES, local_shape,
                                           spec_axes, spec_for_logical)
from repro_torch.training.train_step import init_train_state
from repro_torch.training.tree import leaves, leaves_with_path

POD = {"pod": 2, "data": 2, "model": 2}
CASES = [("qwen1.5-4b", POD, "fsdp", None, False),
         ("qwen1.5-4b", POD, "tp", None, False)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    return run_reference(CASES, tmp_path_factory.mktemp("ref_zero1"),
                         groups=2)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[2] for c in CASES])
def test_zero1_step_matches_the_reference_step(case, ref_steps):
    got, counters, lay = run_port(CASES[case])
    assert_close(got, ref_steps[case])
    assert lay.zero1                   # the moments split over the pods too
    for path in lay.zero1:
        assert "pod" in {a for e in lay.moments[path].spec
                         for a in spec_axes(e)}, path


@pytest.mark.parametrize("strat", ["fsdp", "tp"])
def test_moment_blocks_have_their_zero1_shapes(strat):
    """Each moment block has the ZeRO-1 spec's block shape wherever that
    splits a leaf into more blocks than its parameter's spec (the pod
    axis added), else its parameter's; each parameter block its spec's;
    the ZeRO-1 leaves' moments are ``1 / pod`` of their parameters'
    blocks."""
    case = ("qwen1.5-4b", POD, strat, None, False)
    model = port_model(case)
    mesh, rules = model.mesh, STRATEGIES[strat]
    zrules = dict(rules, fsdp=rules["fsdp+"])
    lay = StateLayout(model, mesh, rules)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    shards = shard_state(state, model, mesh, rules)
    drawn = init_sharded_state(model, mesh, torch.Generator().manual_seed(0),
                               rules)
    lax_tree = logical_axes(model.cfg, model.plan)
    for path, pl in lay.params.items():
        lg, shp = _get(lax_tree, path), pl.shape
        want_p = local_shape(shp, spec_for_logical(lg, shp, mesh, rules),
                             mesh)
        zshape = local_shape(shp, spec_for_logical(lg, shp, mesh, zrules),
                             mesh)
        want_m = zshape if math.prod(zshape) < math.prod(want_p) else want_p
        if path in lay.zero1:
            assert math.prod(want_m) * POD["pod"] == math.prod(want_p), path
        for sh, dr in zip(shards, drawn):
            assert tuple(_get(sh["params"], path).shape) == want_p, path
            assert tuple(_get(dr["params"], path).shape) == want_p, path
            for k in ("m", "v"):
                assert tuple(_get(sh["opt"][k], path).shape) == want_m, path
                assert tuple(_get(dr["opt"][k], path).shape) == want_m, path
    back = unshard_state(shards, model, mesh, rules)
    for (p, a), (_, b) in zip(leaves_with_path(back),
                              leaves_with_path(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    again = shard_state(back, model, mesh, rules)
    assert all(torch.equal(a, b) for a, b in zip(leaves(again),
                                                 leaves(shards)))
    assert case_plan(POD, strat) == model.plan
    assert case_cfg("qwen1.5-4b") == model.cfg


@pytest.mark.parametrize("variant", ["base", "tp"])
def test_multipod_pass_places_moments_at_zero1_blocks(variant, tmp_path):
    """The dry-run's multi-pod pass (placed, not counted) sizes a train
    cell's arguments by the layout the step runs: shard 0's parameter
    blocks, its moments at their ZeRO-1 blocks (smaller than its
    parameters' blocks would hold them: the pod axis splits them too), the
    step and its batch block; under either strategy."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.lm import Model
    from repro_torch.models.params import DTYPES
    rec = dryrun.run_cell("qwen1.5-4b", "train_4k", True, variant,
                          analysis=False, smoke=True, results=tmp_path)
    share = make_production_mesh(multi_pod=True).share(0)
    cell = dryrun.build_cell("qwen1.5-4b", "train_4k", share, variant,
                             smoke=True)
    rules = STRATEGIES[cell.strategy]
    lay = StateLayout(Model(cell.cfg, cell.plan, mesh=share, device="meta"),
                      share, rules)
    size = lambda pl: math.prod(b.stop - b.start  # noqa: E731
                                for b in lay.block(pl, 0))
    item, opt = (DTYPES[cell.cfg.dtype].itemsize,
                 DTYPES[cell.cfg.opt_dtype].itemsize)
    params = sum(size(pl) * item for pl in lay.params.values())
    moments = sum(2 * size(pl) * opt for pl in lay.moments.values())
    assert lay.zero1 and moments < sum(2 * size(pl) * opt
                                       for pl in lay.params.values())
    batch = sum(t.numel() * t.element_size() for t in dryrun._share_batch(
        input_specs(cell.cfg, cell.shape), cell.cfg, "train", share,
        rules).values())
    assert rec["memory"]["argument_bytes"] == params + moments + 4 + batch
    assert rec["memory"]["param_bytes"] == params
