"""The fused beam kernel's algorithm (``csrc/beam.cu``), held on the CPU.

A CUDA kernel cannot run on the CPU, so this file holds its reformulation
of the beam: a per-lane model of what one thread block does, written in
plain numpy/torch below, must return the plain lockstep loop's final pool (ids
and distances at every position), hops and ndist exactly.  The model
follows the kernel step by step: the entry pool stably sorted once and
kept sorted by a rank merge (each pool entry moves down by the fresh keys
strictly below it, each fresh key by the pool entries at or below it); the
first selectable positions of the sorted pool, position 0 for bw 1 when no
unexpanded distance is finite; the fresh list ordered by (dist, position)
keys; the bw > 1 table slots computed before the hop's inserts, the
inserts applied in hop order; and a lane that simply stops.  The corpus
is f32, int8 or bf16 (scored through the plain version's own row sums, so
equality is exact), the graph has -1 pads and duplicate ids within rows,
and the batch holds a lane with lo > hi, narrow lanes that reach the step
cap without ``early_stop``, and a multi-entry variant.

Also: the wrapper's shared-memory plan, that ``use_kernel`` on CPU tensors
runs the plain loop and counts no launch, and the port's ``use_kernel``
search against the JAX reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.beam import beam_search_batch as jbeam
from repro_torch.core import beam as tb
from repro_torch.kernels import beam as kb
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import quantize_corpus

N, D, M, Q = 400, 16, 24, 6
INF = float("inf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small torch ops, and with
    the test workers sharing the cores, more threads only add waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, D)).astype(np.float32)
    nbrs = rng.integers(0, N, (N, M)).astype(np.int32)
    nbrs[rng.random((N, M)) < 0.15] = -1                  # pads
    dup = rng.integers(0, N, 60)
    nbrs[dup, 3] = nbrs[dup, 1]                           # duplicate ids
    q = rng.standard_normal((Q, D)).astype(np.float32)
    lo = np.asarray([0, 50, 120, 300, 10, 200], np.int64)
    hi = np.asarray([N - 1, 60, 260, 299, 14, 399], np.int64)  # lo > hi
    entry = np.stack([(lo + hi) // 2, lo, hi], 1).clip(0, N - 1)
    entry[3, 0] = 77
    entry[1, 1] = -1
    return x, nbrs, q, lo, hi, entry


def _corpus(x, precision):
    xt = torch.as_tensor(x)
    if precision == "f32":
        return xt, None
    qc = quantize_corpus(xt, precision)
    return qc.data, qc.scale


def _score(x, scale, q, ids):
    """The plain version's row sums, so the model scores as it does."""
    ids = torch.as_tensor(np.asarray(ids, np.int64)).reshape(1, -1)
    return ref.gather_dist_ref(x, ids, q[None], scale)[0].numpy()


def _hash(ids, size):
    h1, h2 = ref.hash_slots(torch.as_tensor(np.asarray(ids, np.int64)),
                            size)
    return h1.numpy(), h2.numpy()


def model_lane(x, scale, nbrs, q, lo, hi, entry_row, *, ef, steps_cap,
               early_stop, beam_width):
    """One thread block of ``csrc/beam.cu``: one lane's loop to its end."""
    n, m = nbrs.shape
    d0, i0, e0, e0c, ev = ref.init_pool(
        x, scale, q[None], torch.tensor([lo]), torch.tensor([hi]),
        torch.as_tensor(entry_row)[None], ef)
    o = np.argsort(d0[0].numpy(), kind="stable")        # sorted once
    pd = d0[0].numpy()[o].copy()
    pid = i0[0].numpy()[o].copy()
    pe = e0[0].numpy()[o].copy()
    seeds = torch.where(ev, e0c, -1)[0].numpy()
    batched = beam_width > 1
    B = min(beam_width, ef) if batched else 1
    F = B * m
    if batched:
        H = ref.visited_table_size(ef, m)
        table = np.full(H + 1, -1, np.int64)
        s = seeds[seeds >= 0]
        for sid, h in zip(s, _hash(s, H)[0]):    # empty table: first probe
            table[h] = sid                        # in order: later wins
    else:
        visited = np.zeros(n + 1, bool)
        visited[seeds[seeds >= 0]] = True
    steps = ndist = 0
    while True:
        sel = np.flatnonzero(~pe & np.isfinite(pd))[:B]
        best = pd[sel[0]] if len(sel) else INF
        go = best <= pd[ef - 1] and steps < steps_cap
        if early_stop:
            go = go and best < INF
        if not go:
            break
        if not batched:
            bi = sel[0] if len(sel) else 0       # argmin's first minimum
            pe[bi] = True
            fid = nbrs[max(pid[bi], 0)].astype(np.int64)
            ok = (fid >= 0) & (fid >= lo) & (fid <= hi)
            ok &= ~visited[np.maximum(fid, 0)]   # the whole row, then mark
            visited[fid[ok]] = True
        else:
            pe[sel] = True
            node = np.full(B, -1, np.int64)
            node[:len(sel)] = pid[sel]
            fid = nbrs[np.maximum(node, 0)].reshape(F).astype(np.int64)
            v5 = ((fid >= 0) & (fid >= lo) & (fid <= hi)
                  & np.repeat(node >= 0, m))
            earlier = np.tril(fid[:, None] == fid[None, :], -1) & v5[None, :]
            h1, h2 = _hash(fid, H)
            c1 = table[h1]
            ok = (v5 & ~earlier.any(1) & ~np.isin(fid, pid)
                  & (c1 != fid) & (table[h2] != fid))
            slot = np.where((c1 == -1) | (c1 == fid), h1, h2)
            for i in np.flatnonzero(ok):          # hop order: later wins
                table[slot[i]] = fid[i]
        fd = np.full(F, INF, np.float32)
        if ok.any():
            fd[ok] = _score(x, scale, q, fid[ok])
        # (dist, position) keys of the valid entries, best min(F, ef) kept
        pos = np.flatnonzero(ok)
        keep = pos[np.lexsort((pos, fd[pos]))][:min(F, ef)]
        sd, sid = fd[keep], fid[keep]
        nd, nid, ne = pd.copy(), pid.copy(), pe.copy()
        # each pool entry moves down by the fresh keys strictly below it,
        # each fresh key by the pool entries at or below it
        p_pool = np.arange(ef) + np.searchsorted(sd, pd, side="left")
        p_new = np.arange(len(sd)) + np.searchsorted(pd, sd, side="right")
        a, b = p_pool < ef, p_new < ef
        nd[p_pool[a]], nid[p_pool[a]], ne[p_pool[a]] = pd[a], pid[a], pe[a]
        nd[p_new[b]], nid[p_new[b]], ne[p_new[b]] = sd[b], sid[b], False
        pd, pid, pe = nd, nid, ne
        steps += 1
        ndist += int(ok.sum())
    return pd, pid, steps, ndist


def _run_both(data, precision, bw, ef, early_stop, multi):
    x_np, nbrs_np, q_np, lo, hi, entry = data
    x, scale = _corpus(x_np, precision)
    nbrs = torch.as_tensor(nbrs_np)
    q = torch.as_tensor(q_np)
    ent = entry if multi else entry[:, 0]
    kw = dict(ef=ef, steps_cap=8 * ef + 64, early_stop=early_stop)
    lo_t, hi_t = torch.as_tensor(lo), torch.as_tensor(hi)
    if bw > 1:
        plain = ref.beam_batched_ref(x, scale, nbrs, q, lo_t, hi_t,
                                     torch.as_tensor(ent), beam_width=bw,
                                     **kw)
    else:
        plain = ref.beam_single_ref(x, scale, nbrs, q, lo_t, hi_t,
                                    torch.as_tensor(ent), **kw)
    lanes = [model_lane(x, scale, nbrs_np, q[r], int(lo[r]), int(hi[r]),
                        np.atleast_1d(ent[r]), beam_width=bw, **kw)
             for r in range(Q)]
    return plain, lanes, kw["steps_cap"]


#: (bw, ef, early_stop, precision, multi-entry): every width, ef and
#: precision with the early stop, and every width without it at ef 8 and
#: 64 (each hop count to the 8·ef+64 cap is paid by the lockstep loop too),
#: plus the longest cap, ef=256, at bw 1
CASES = ([(bw, ef, True, p, mu) for bw in (1, 2, 4, 8) for ef in (8, 64, 256)
          for p in ("f32", "int8", "bf16") for mu in (False, True)]
         + [(bw, ef, False, "f32", mu) for bw in (1, 2, 4, 8)
            for ef in (8, 64) for mu in (False, True)]
         + [(1, 256, False, "bf16", True)])


@pytest.mark.parametrize(
    "bw,ef,early_stop,precision,multi", CASES,
    ids=[f"bw{c[0]}-ef{c[1]}-{'stop' if c[2] else 'cap'}-{c[3]}-"
         f"entry{3 if c[4] else 1}" for c in CASES])
def test_kernel_model_equals_lockstep_loop(data, bw, ef, early_stop,
                                           precision, multi):
    """The per-lane model equals the plain loop in the final pool (ids and
    distances at every position), hops and ndist, lane by lane; ef=8 < m;
    bw 8 at ef=256 keeps 192 fresh keys (fm > 128)."""
    (cd, ci, steps, ndist), lanes, cap = _run_both(data, precision, bw, ef,
                                                   early_stop, multi)
    for r, (pd, pid, s, nd) in enumerate(lanes):
        assert np.array_equal(pd, cd[r].numpy()), r
        assert np.array_equal(pid, ci[r].numpy()), r
        assert (s, nd) == (int(steps[r]), int(ndist[r])), r
    assert steps[3] == (0 if early_stop else cap)         # lo > hi
    if not early_stop:
        assert (steps == cap).sum() >= 2                  # capped lanes


def test_duplicate_ids_in_a_row_are_scored_twice(data):
    """bw 1 reads the visited set for the whole row before marking it, so
    a duplicate id of one row counts twice in ndist (the model and the
    plain loop agree on it)."""
    x_np, nbrs_np, q_np, _, _, _ = data
    nbrs = nbrs_np.copy()
    nbrs[0] = np.arange(M) + 100
    nbrs[0, 5] = nbrs[0, 4]
    lo = np.zeros(1, np.int64)
    hi = np.full(1, N - 1, np.int64)
    x, q = torch.as_tensor(x_np), torch.as_tensor(q_np[:1])
    kw = dict(ef=64, steps_cap=1, early_stop=True)
    _, _, steps, ndist = ref.beam_single_ref(
        x, None, torch.as_tensor(nbrs), q, torch.as_tensor(lo),
        torch.as_tensor(hi), torch.zeros(1, dtype=torch.long), **kw)
    pd, pid, s, nd = model_lane(x, None, nbrs, q[0], 0, N - 1,
                                np.zeros(1, np.int64), beam_width=1, **kw)
    assert int(steps[0]) == s == 1
    assert int(ndist[0]) == nd == M
    assert (pid == nbrs[0, 4]).sum() == 2


def test_beam_plan_sizes():
    """The wrapper's layout of one block, which the kernel reads as given:
    every region 16-aligned and in ``LAYOUT`` order, each as large as what
    the kernel stores there, the pool (two buffers, 18·ef bytes) in shared
    memory up to the largest ef that fits beside the rest, in a global
    scratch row past it, and a refusal where even the rest does not fit."""
    def regions(p, d, ef):
        need = dict(q=4 * d, scale=4 * d, ctl=4 * 41, sel=4 * p.B,
                    fid=4 * p.F, fok=4 * p.F, fv=4 * p.F, slot=4 * p.F,
                    sd=4 * p.F, sid=4 * p.F, fkey=8 * p.F,
                    table=4 * (p.H + 1) if p.H else 0,
                    pool=0 if p.pool_global else 2 * p.at("pool_buf"))
        names = kb.LAYOUT[:kb.LAYOUT.index("total") + 1]
        for name, nxt in zip(names, names[1:]):
            assert p.at(name) % 16 == 0, name
            assert p.at(nxt) - p.at(name) >= need[name], name
        assert p.at("pool_id") >= 4 * ef and p.at("pool_id") % 16 == 0
        assert p.at("pool_e") - p.at("pool_id") >= 4 * ef
        assert p.at("pool_buf") - p.at("pool_e") >= ef
        assert p.smem <= kb.SMEM_MAX

    assert len(kb.LAYOUT) == len(kb.beam_plan(8, 4, 1, 4).offsets)
    p = kb.beam_plan(64, 32, 1, 128)
    assert (p.B, p.F, p.H, p.pool_global) == (1, 32, 0, False)
    fixed1 = 2 * 512 + 256 + 16 + 6 * 128 + 256
    assert p.at("pool") == fixed1
    assert p.smem == fixed1 + 18 * 64
    p = kb.beam_plan(64, 32, 4, 128)
    assert (p.B, p.F, p.H) == (4, 128, ref.visited_table_size(64, 32))
    assert p.smem == (2 * 512 + 256 + 16 + 6 * 512 + 1024
                      + 4 * (1024 + 1) + 12 + 18 * 64)
    p = kb.beam_plan(4096, 32, 4, 128)                    # the exact phase
    assert not p.pool_global and p.H == 8192 and p.smem < kb.SMEM_MAX
    for bw, top in ((1, 12784), (4, 10792)):
        assert not kb.beam_plan(top, 32, bw, 128).pool_global
        far = kb.beam_plan(top + 16, 32, bw, 128)
        assert far.pool_global and far.smem == far.at("pool")
    assert kb.beam_plan(10 ** 6, 32, 4, 128).pool_global
    assert kb.beam_plan(8, 32, 64, 128).B == 8            # bw clamps to ef
    for ef, m, bw, d in ((64, 32, 1, 128), (64, 32, 4, 128), (8, 24, 8, 16),
                         (256, 24, 8, 16), (4096, 32, 1, 128),
                         (4096, 32, 4, 128), (13000, 24, 1, 32),
                         (12800, 32, 1, 128), (10 ** 6, 32, 4, 128),
                         (3, 5, 2, 7)):
        regions(kb.beam_plan(ef, m, bw, d), d, ef)
    with pytest.raises(ValueError):
        kb.beam_plan(64, 32, 4, 40000)                    # d too wide
    with pytest.raises(ValueError):
        kb.beam_plan(8192, 64, 8192, 128)                 # B·m too many


@pytest.mark.parametrize("bw", [1, 4])
def test_use_kernel_on_cpu_runs_the_plain_loop(data, bw):
    """On CPU tensors ``use_kernel=True`` is the plain loop, with the same
    answers and no counted launch."""
    x_np, nbrs_np, q_np, lo, hi, entry = data
    args = (torch.as_tensor(x_np), torch.as_tensor(nbrs_np),
            torch.as_tensor(q_np), torch.as_tensor(lo), torch.as_tensor(hi),
            torch.as_tensor(entry[:, 0]))
    ops.reset_launches()
    got = tb.beam_search_batch(*args, k=10, ef=32, beam_width=bw,
                               use_kernel=True)
    assert not any(ops.LAUNCHES.values())
    want = tb.beam_search_batch(*args, k=10, ef=32, beam_width=bw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for s in ("hops", "ndist"):
        assert torch.equal(got[2][s], want[2][s])


@pytest.mark.parametrize("bw", [1, 4, 8])
def test_use_kernel_search_equals_reference(data, bw):
    """``beam_search_batch(use_kernel=True)`` on the CPU against the JAX
    reference's kernel path (Pallas in interpret mode): ids, hops and
    ndist equal, distances within rtol 1e-5."""
    x_np, nbrs_np, q_np, lo, hi, entry = data
    ji, jd, js = jbeam(jnp.asarray(x_np), jnp.asarray(nbrs_np),
                       jnp.asarray(q_np), jnp.asarray(lo, jnp.int32),
                       jnp.asarray(hi, jnp.int32),
                       jnp.asarray(entry, jnp.int32), k=10, ef=48,
                       beam_width=bw, use_kernel=True)
    ti, td, ts = tb.beam_search_batch(
        torch.as_tensor(x_np), torch.as_tensor(nbrs_np),
        torch.as_tensor(q_np), torch.as_tensor(lo), torch.as_tensor(hi),
        torch.as_tensor(entry), k=10, ef=48, beam_width=bw, use_kernel=True)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    fin = np.isfinite(np.asarray(jd))
    assert np.allclose(td.numpy()[fin], np.asarray(jd)[fin], rtol=1e-5)
    for s in ("hops", "ndist"):
        assert np.array_equal(ts[s].numpy(), np.asarray(js[s])), s
