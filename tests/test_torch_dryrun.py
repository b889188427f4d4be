"""The port's dry-run tools (``launch/mesh.py``, ``hlo_analysis.py``,
``roofline.py``, ``dryrun.py``) and ``DistributedRFANN.lower_for_dryrun``.

Against the reference: the production mesh shapes, ``model_flops`` of
every cell and ``analytic_memory``'s byte terms (the same arithmetic; the
port's fit is against one H100's 80 GB).  Of the port's own counting: a
train cell's share counts more operations under ``remat="full"`` than
under ``"none"`` (the recompute is counted, as XLA counts remat); the
share's counted collective bytes equal those a full mesh of CPU shards
moves per device in the same step; a train cell and a ``replica`` cell of
smoke configs run through ``main()`` and write records with the
reference's keys, counting at least ``model_flops``; a TP cell writes a
``pending`` record with no counted field; the RNSG serving cell at a
reduced shape; ``lower_for_dryrun`` on a small index."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import cells as ref_cells
from repro.configs.registry import get_config as ref_config
from repro.launch import hlo_analysis as RH
from repro.launch import roofline as RR
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import cells, get_config, get_smoke_config
from repro_torch.launch import dryrun, hlo_analysis, roofline
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh
from repro_torch.models.lm import Model
from repro_torch.parallel.fsdp import build_sharded_train_step, shard_state
from repro_torch.parallel.sharding import (FSDP_RULES, CollectiveCounter,
                                           make_act_sharder, make_mesh)
from repro_torch.training.train_step import init_train_state
from repro_torch.training.tree import leaves

#: the reference's counted-record keys (``dryrun.py:344-353``)
COUNTED = {"arch", "shape", "mesh", "chips", "variant", "meta", "lower_s",
           "compile_s", "compile_analysis_s", "cost", "memory",
           "collectives", "roofline", "model_flops", "useful_ratio"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_production_meshes():
    one = make_production_mesh()
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert {d.type for d in one.devices} == {"meta"}
    two = make_production_mesh(multi_pod=True)
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.size == 512
    m = make_mesh_for(["cpu"] * 8, model_parallel=2)
    assert m.shape == {"data": 4, "model": 2}


def test_model_flops_match_reference_for_every_cell():
    assert cells(include_inapplicable=True) == ref_cells(
        include_inapplicable=True)
    for arch, sname, skip in cells():
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert cfg.n_active_params() == rcfg.n_active_params()
        assert hlo_analysis.model_flops(
            cfg, SHAPES[sname], cfg.n_active_params()) == RH.model_flops(
            rcfg, REF_SHAPES[sname], rcfg.n_active_params()), (arch, sname)


def test_analytic_memory_matches_reference():
    for arch, sname, _ in cells():
        got = roofline.analytic_memory(arch, sname)
        want = RR.analytic_memory(arch, sname)
        assert got.pop("fits_80GB") == (got["total"] < 80e9)
        want.pop("fits_16GB")
        assert got == want, (arch, sname)


def test_roofline_terms_use_the_h100_rates():
    t = hlo_analysis.roofline_terms(989e12, 3.35e12, 50e9, 4)
    assert t["t_compute"] == t["t_memory"] == t["t_collective"] == 1.0
    assert t["flops_global"] == 4 * 989e12


def test_remat_full_counts_the_recompute():
    cfg = get_smoke_config("qwen1.5-4b")
    axes = {"data": 4, "model": 2}
    full = dryrun.count_train(dataclasses.replace(cfg, remat="full"), axes,
                              8, 64)
    none = dryrun.count_train(dataclasses.replace(cfg, remat="none"), axes,
                              8, 64)
    assert full["flops"] > none["flops"] > 0
    assert full["collectives"]["all-gather"] > none["collectives"][
        "all-gather"]
    assert full["param_bytes"] == none["param_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "llama4-maverick-400b-a17b"])
def test_share_counts_what_the_mesh_moves(arch):
    """The dry-run's one-device share and a full mesh of CPU shards running
    the same step count the same per-device collective bytes and calls."""
    cfg = get_smoke_config(arch)
    axes = {"data": 4, "model": 2}
    share = dryrun.count_train(cfg, axes, 8, 16)
    mesh = make_mesh(axes, ["cpu"])
    model = Model(cfg, device="cpu",
                  act_shard=make_act_sharder(mesh, FSDP_RULES))
    shards = shard_state(init_train_state(
        model, torch.Generator().manual_seed(0)), model, mesh)
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (8, 16)),
                             dtype=torch.int32) for k in ("tokens", "labels")}
    with CollectiveCounter() as cc:
        build_sharded_train_step(model, mesh)(shards, batch)
    assert cc.as_dict() == share["collectives"]
    assert cc.calls == share["calls"]
    assert share["param_bytes"] == sum(
        t.numel() * t.element_size() for t in leaves(shards[0]["params"]))


def test_main_writes_reference_records(tmp_path, capsys):
    """A train cell and a replica cell (smoke configs on the production
    mesh), and a TP cell, which stays pending."""
    dryrun.main(["--arch", "qwen1.5-4b", "--shape", "train_4k", "--smoke",
                 "--results", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen1.5-4b__train_4k__pod16x16.json")
                     .read_text())
    assert COUNTED <= set(rec) and "pending" not in rec
    assert rec["cost"]["flops_per_device"] * rec["chips"] >= \
        rec["model_flops"] > 0
    assert rec["collectives"]["total"] > 0 and rec["chips"] == 256
    assert set(rec["roofline"]) >= {"t_compute", "t_memory", "t_collective",
                                    "dominant", "t_bound"}
    dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                 "--variant", "replica", "--smoke", "--results",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-780m__decode_32k__pod16x16__replica"
                      ".json").read_text())
    assert COUNTED <= set(rec) and rec["variant"] == "replica"
    assert rec["collectives"]["total"] == 0      # replicas: no collective
    assert rec["cost"]["flops_per_device"] > 0
    dryrun.main(["--arch", "qwen1.5-4b", "--shape", "prefill_32k",
                 "--smoke", "--results", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen1.5-4b__prefill_32k__pod16x16.json")
                     .read_text())
    assert rec["pending"] == "tensor-parallel program"
    assert not {"cost", "collectives", "roofline", "compile_s",
                "useful_ratio"} & set(rec)
    assert rec["memory"]["argument_bytes"] > 0 and rec["model_flops"] > 0
    table = roofline.roofline_table(results=tmp_path)
    assert "qwen1.5-4b | train_4k" in table and "pending" not in table
    assert "tensor-parallel program" in table
    assert "qwen1.5-4b | train_4k" in roofline.dryrun_table(results=tmp_path)
    assert "dry-run complete" in capsys.readouterr().out


def test_rnsg_cell_at_a_reduced_shape(tmp_path):
    nq, k, S = 64, 10, 16
    rec = dryrun.run_rnsg_cell(False, ns=4096, d=32, m=8, nq=nq, k=k,
                               results=tmp_path)
    assert rec["shape"] == f"q{nq}_n{S * 4096}" and rec["chips"] == 256
    # the merge gathers (Q, k) int32 ids, (Q, k) f32 distances and the
    # shard's int64 ndist sum
    assert rec["collectives"]["all-gather"] == nq * k * 8 + 8
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] == (
        4096 * 32 * 4 + 4096 * 8 * 4 + 13 * 4096 * 4 + 4096 * 8
        + nq * 32 * 4 + 2 * nq * 4)
    q = dryrun.run_rnsg_cell(False, "qshard", ns=4096, d=32, m=8, nq=nq,
                             k=k, results=tmp_path)
    assert q["collectives"]["all-gather"] == (nq // 16) * k * 8 + 8
    assert (tmp_path / "rnsg-serve__q64__pod16x16__qshard.json").exists()


def test_lower_for_dryrun_on_a_small_index():
    """The dry-run derives its fakes from the index's parameters; they must
    have the shapes and dtypes of the index's own shard-0 tensors."""
    from repro_torch.serving.distributed import DistributedRFANN
    rng = np.random.default_rng(0)
    v = rng.standard_normal((512, 16)).astype(np.float32)
    a = rng.random(512).astype(np.float32)
    dist = DistributedRFANN(v, a, n_shards=4, mesh=make_mesh(4, ["cpu"]),
                            device="cpu")
    base = [dist.vecs[0], dist.nbrs[0], dist.rmq[0], dist.dist_c[0],
            dist.order[0]]
    for prec in ("f32", "int8", "bf16"):
        real = list(base)
        if prec != "f32":
            slot = dist.mesh_substrate._quant_for(prec)
            real += [t for t in (slot["data"][0], slot["scale"][0])
                     if t is not None]
        for bw in (1, 4):
            r = dist.lower_for_dryrun(32, 16, k=10, ef=32, precision=prec,
                                      beam_width=bw)
            assert [(tuple(t.shape), t.dtype) for t in r["operands"]] == \
                [(tuple(t.shape), t.dtype) for t in real]
            extra = {"f32": 0, "int8": 128 * 16 + 16 * 4,
                     "bf16": 128 * 16 * 2}[prec]
            assert r["operand_bytes"] == sum(
                t.numel() * t.element_size() for t in base) + extra
            assert r["query_bytes"] == 32 * 16 * 4 + 2 * 32 * 4
            assert r["gather_bytes"] == 32 * 10 * 8 + 8
            assert r["flops"] > 0
