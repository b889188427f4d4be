"""The port's logical-axis layer (``parallel/sharding.py``) against the
reference's: the rule tables, ``spec_for_logical`` and ``tree_shardings``
on every architecture's parameter tree, under the three strategies, on
meshes of 16 × 16, 2 × 16 × 16, 4 × 2 and 8 × 1 devices (the reference's
side on ``abstract_mesh``, which needs no device), each at the
reference's own ``ShardPlan`` for the strategy (``dryrun.py:117-120``:
TP pads heads and vocabulary to the model axis, every plan pads the
vocabulary to 256); the batch and cache axes, the dry-run's input,
parameter and train-state stand-ins and its cell list; and the activation
hook, which must raise on a local tensor of the wrong shape.  Specs are
equal entry for entry (``None``, an axis name, or a tuple of names)."""
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import cells as ref_cells
from repro.configs.registry import get_config as ref_config
from repro.launch.specs import input_specs as ref_input_specs
from repro.models.lm import Model as RefModel
from repro.models.params import ShardPlan as RefPlan
from repro.models.params import logical_axes as ref_logical
from repro.models.params import param_shapes as ref_param_shapes
from repro.parallel import sharding as RS
from repro.training.train_step import train_state_shapes as ref_state_shapes
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import cells, get_config, list_archs
from repro_torch.launch.specs import input_specs
from repro_torch.models.lm import Model
from repro_torch.models.params import ShardPlan, logical_axes, param_shapes
from repro_torch.parallel import sharding as TS
from repro_torch.training.train_step import train_state_shapes

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
STRATEGIES = ["tp", "fsdp", "replica"]


def _meshes(name):
    sizes, names = MESHES[name]
    return (RS.abstract_mesh(sizes, names),
            TS.make_mesh(dict(zip(names, sizes)), ["meta"]))


def _plans(strategy, mesh_shape):
    tp = mesh_shape["model"] if strategy == "tp" else 1
    kw = dict(tp=tp, fsdp=mesh_shape["data"], dp=mesh_shape.get("pod", 1),
              vocab_multiple=256)
    return RefPlan(**kw), ShardPlan(**kw)


def _leaves(tree, pre=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, strategy, mesh):
    rmesh, tmesh = _meshes(mesh)
    rplan, tplan = _plans(strategy, dict(tmesh.shape))
    rrules, trules = RS.STRATEGIES[strategy], TS.STRATEGIES[strategy]
    rlog = ref_logical(ref_config(arch), rplan)
    tlog = logical_axes(get_config(arch), tplan)
    rshapes = ref_param_shapes(ref_config(arch), rplan)
    tshapes = param_shapes(get_config(arch), tplan)
    rtree = RS.tree_shardings(rlog, rshapes, rmesh, rrules)
    ttree = TS.tree_shardings(tlog, tshapes, tmesh, trules)
    paths = [p for p, _ in _leaves(tlog)]
    assert paths == [p for p, _ in _leaves(rlog)]
    for path in paths:
        lg = _get(tlog, path)
        assert lg == _get(rlog, path), path
        shape = tuple(_get(tshapes, path).shape)
        assert shape == tuple(_get(rshapes, path).shape), path
        want = tuple(RS.spec_for_logical(lg, shape, rmesh, rrules))
        assert TS.spec_for_logical(lg, shape, tmesh, trules) == want, path
        assert _get(ttree, path) == tuple(_get(rtree, path).spec), path


def test_rule_tables_are_the_references():
    assert TS.DEFAULT_RULES == RS.DEFAULT_RULES
    assert TS.FSDP_RULES == RS.FSDP_RULES
    assert TS.REPLICA_RULES == RS.REPLICA_RULES
    assert set(TS.STRATEGIES) == set(RS.STRATEGIES)
    for entry in list(RS.FSDP_RULES.values()) + list(RS.DEFAULT_RULES.values()):
        assert TS._alternatives(entry) == RS._alternatives(entry)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_match_reference(mesh):
    """Every arch × kind × long-context flag, under every strategy, at the
    cells' global batches."""
    rmesh, tmesh = _meshes(mesh)
    for arch in list_archs():
        rcfg, tcfg = ref_config(arch), get_config(arch)
        for kind in ("train", "prefill", "decode"):
            for long in (False, True):
                bl = TS.batch_logical(tcfg, kind, long)
                assert bl == RS.batch_logical(rcfg, kind, long)
                cl = TS.cache_logical(tcfg, long)
                assert cl == RS.cache_logical(rcfg, long)
                for strategy in STRATEGIES:
                    rr, tr = RS.STRATEGIES[strategy], TS.STRATEGIES[strategy]
                    for lg in list(bl.values()) + list(cl.values()):
                        for b in (1, 32, 128, 256):
                            shape = (b,) + (48,) * (len(lg) - 1)
                            assert TS.spec_for_logical(lg, shape, tmesh, tr) \
                                == tuple(RS.spec_for_logical(lg, shape, rmesh,
                                                             rr)), (lg, shape)


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_and_param_stand_ins_match_reference(arch):
    rcfg, tcfg = ref_config(arch), get_config(arch)
    for sname, shape in SHAPES.items():
        got = input_specs(tcfg, shape)
        want = ref_input_specs(rcfg, REF_SHAPES[sname])
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (sname, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            assert got[k].device.type == "meta"
    plan, rplan = ShardPlan(tp=4, vocab_multiple=256), RefPlan(
        tp=4, vocab_multiple=256)
    got = Model(tcfg, plan, device="meta").param_shapes()
    want = RefModel(rcfg, rplan).param_shapes()
    assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(want)]
    for path, t in _leaves(got):
        w = _get(want, path)
        assert tuple(t.shape) == tuple(w.shape) and t.device.type == "meta"
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
    assert logical_axes(tcfg, plan) == ref_logical(rcfg, rplan)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "llama4-maverick-400b-a17b",
                                  "mamba2-780m"])
def test_train_state_shapes_match_reference(arch):
    got = train_state_shapes(Model(get_config(arch), device="meta"))
    want = ref_state_shapes(RefModel(ref_config(arch)))
    assert tuple(got["opt"]["step"].shape) == ()
    assert got["opt"]["step"].dtype == torch.int32
    for key in ("params", ("opt", "m"), ("opt", "v")):
        g = got[key] if isinstance(key, str) else got[key[0]][key[1]]
        w = want[key] if isinstance(key, str) else want[key[0]][key[1]]
        for path, t in _leaves(g):
            ww = _get(w, path)
            assert tuple(t.shape) == tuple(ww.shape), (key, path)
            assert str(t.dtype).split(".")[-1] == str(ww.dtype), (key, path)


def test_cells_match_reference():
    assert cells() == ref_cells()
    assert cells(include_inapplicable=True) == ref_cells(
        include_inapplicable=True)


def test_act_sharder_checks_the_local_shape():
    """Off-mesh the hook is the identity; on a mesh it passes a local block
    of the spec's shape and raises on any other."""
    x = torch.zeros(8, 16, 32)
    assert TS.make_act_sharder(None)(x, ("batch", None, None)) is x
    mesh = TS.make_mesh({"data": 4, "model": 2}, ["cpu"])
    hook = TS.make_act_sharder(mesh, TS.FSDP_RULES)
    hook.global_sizes = {"batch": 8}
    local = torch.zeros(1, 16, 32)          # 8 rows over (data, model)
    assert hook(local, ("batch", None, None)) is local
    with pytest.raises(ValueError, match="act_shard"):
        hook(torch.zeros(2, 16, 32), ("batch", None, None))
    hook.global_sizes = {"batch": 4}        # 4 rows: over data alone
    assert hook(local, ("batch", None, None)) is local
    with pytest.raises(ValueError, match="act_shard"):
        hook(torch.zeros(4, 16, 32), ("batch", None, None))
    # a whole tensor on a mesh that would split it is not a local block
    hook.global_sizes = {}
    with pytest.raises(ValueError, match="act_shard"):
        hook(torch.zeros(8, 16, 32), ("fsdp", None, None))


def test_mesh_axes_groups_and_blocks():
    """Row-major coordinates, the groups of a collective over an axis, and
    a block's slices under a two-axis spec entry."""
    mesh = TS.make_mesh({"data": 4, "model": 2}, ["cpu"])
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.coords(5) == {"data": 2, "model": 1}
    assert mesh.axis_groups("model") == [(0, 1), (2, 3), (4, 5), (6, 7)]
    assert mesh.axis_groups("data") == [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert mesh.axis_groups(("model", "data"))[0] == (0, 2, 4, 6, 1, 3, 5, 7)
    assert TS.block_slices((16, 3), (("data", "model"), None), mesh, 5) == (
        slice(10, 12), slice(0, 3))
    with pytest.raises(ValueError, match="axes"):
        mesh.axis
    one = TS.make_mesh(3, ["cpu"], axis="rows")
    assert one.axis == "rows" and one.axis_groups("rows") == [(0, 1, 2)]
