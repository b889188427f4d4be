"""Shared corpora and builds of the distributed-path tests
(``test_torch_distributed*.py``): both shard counts use 64 rows per shard,
so the reference compiles each of its search shapes once per process."""
import jax
import numpy as np

from repro.data import ann as jann
from repro.serving.distributed import DistributedRFANN as JDist
from repro_torch.data.ann import make_attrs, make_vectors
from repro_torch.parallel.sharding import make_mesh
from repro_torch.serving.distributed import DistributedRFANN

PER, D, Q, K = 64, 8, 24, 5
KW = dict(m=16, ef_spatial=16, ef_attribute=16)
PRECISIONS = ("f32", "int8", "bf16")


def case_data(n):
    vecs = make_vectors(n, D, seed=0)
    attrs = make_attrs(n, seed=0)
    qv = make_vectors(Q, D, seed=5)
    s = np.sort(attrs)
    rg = np.concatenate([
        jann.selectivity_ranges(attrs, 8, 0.02, seed=1),     # narrow
        jann.selectivity_ranges(attrs, 10, 0.5, seed=2),     # wide
        np.asarray([[s[5] + 1e-7, s[5] + 2e-7],              # empty
                    [s[17], s[17]],                          # one point
                    [s[3], s[40]],                           # one shard
                    [s[PER - 9], s[min(PER + 9, n - 1)]],    # two shards
                    [s[0], s[-1]],                           # full span
                    [s[-30], s[-1]]], np.float32)])
    live = np.random.default_rng(3).random(n) > 0.2
    return vecs, attrs, qv, rg, live


_CACHE: dict = {}


def built(name, shards):
    """One build per (kind, S) per process."""
    key = (name, shards)
    if key not in _CACHE:
        vecs, attrs, *_ = case_data(PER * shards)
        if name == "ref":
            d = JDist(vecs, attrs, n_shards=shards, **KW)
        elif name == "local":
            d = DistributedRFANN(vecs, attrs, n_shards=shards, device="cpu",
                                 **KW)
        elif name == "mesh":
            d = DistributedRFANN(vecs, attrs, n_shards=shards,
                                 mesh=make_mesh(shards, ["cpu"]), **KW)
        elif name == "ref_mesh":
            d = JDist(vecs, attrs, n_shards=shards,
                      mesh=jax.make_mesh((1,), ("data",)), **KW)
        for prec in PRECISIONS[1:]:
            d.install_quantized(prec)
        _CACHE[key] = d
    return _CACHE[key]


def same(got, want):
    gi, gd = (np.asarray(x) for x in got)
    wi, wd = (np.asarray(x) for x in want)
    assert np.array_equal(gi, wi)
    fin = np.isfinite(wd)
    assert np.array_equal(np.isfinite(gd), fin)
    assert np.allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-4)


def check_local_path(shards, plan, bw, precision, use_live):
    """The port's local path against the reference's on one case: equal
    ids, distances within the tolerance, no tombstoned id returned."""
    _, attrs, qv, rg, live = case_data(PER * shards)
    kw = dict(k=K, ef=48, plan=plan, beam_width=bw, precision=precision,
              live=live if use_live else None)
    got = built("local", shards).search(qv, rg, **kw)
    same(got, built("ref", shards).search(qv, rg, **kw))
    if use_live:
        order = np.argsort(attrs, kind="stable")
        dead = set(order[~live].tolist())
        assert not dead & set(got[0][got[0] >= 0].tolist())
