"""The range scan kernel's selection (``csrc/range_scan.cu``), held on the CPU.

A CUDA kernel cannot run on the CPU, so this file holds its algorithm: a
model of what the blocks of one launch do, written in plain numpy below,
must return the plain version's ids and distances exactly
(``ref.range_scan_ref``) and the JAX reference's ids
(``repro.kernels.ops.range_scan``, Pallas in interpret mode for k <= 128,
its oracle past that).  The model scores rows with the plain version's own
distances, so equality is exact, and follows the kernel step by step:

* the chunking of ``scan_plan`` and each block's [lo, hi) of window rows,
  rows masked by the window, ``n_valid`` and ``live`` never scored;
* on the select path (k <= SELECT_K): each warp's rows in steps of 4U
  (U = 8 / itemsize rows per 8-lane group), a 64-key queue of the keys
  that beat the warp's k-th key, flushed before a step could overflow it
  by the kernel's bitonic network and rank merge (a key's place is its
  index plus a binary search in the other list); the block's three
  pairwise merges; and, for a window of several chunks, the last block to
  arrive (in a random order) feeding the chunk lists through the same
  queue, leaving a list at its first key that misses the threshold;
* past SELECT_K the two-pass path: each chunk's best min(k, R) keys, then
  the running-buffer merge (k <= SMEM_K) or the sort of whole sorted runs.

Cases: k in {1, 10, 128, 129, 256, 257, 2048, 4096, 5000 > window},
buckets 64 .. 16384, f32, int8 + scale and bf16 corpora, ``live`` and
``n_valid`` tails, empty windows, one-row tails, unaligned starts and
duplicated rows (exact ties go to the lower rank)."""
import itertools
import re
from bisect import bisect_left, bisect_right
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import range_scan as krs
from repro_torch.kernels.quantize import quantize_corpus

NONE = 0xFFFFFFFFFFFFFFFF
INF_BITS = 0x7F800000
THREADS, QCAP = 256, 64
NWARPS = THREADS // 32
N, DIM, NQ = 3000, 24, 7
KS = [1, 10, 128, 129, 256, 257, 2048, 4096, 5000]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the model -----------------------------------------------------------

def bitonic64(s):
    """The kernel's per-warp sort of its 64-key queue: each stage's 32
    pairs, one per lane, i = 2 lane - (lane & (stride - 1))."""
    s = list(s)
    size = 2
    while size <= QCAP:
        stride = size >> 1
        while stride:
            seen = set()
            for lane in range(32):
                i = 2 * lane - (lane & (stride - 1))
                j = i + stride
                assert i not in seen and j not in seen and i & stride == 0
                seen.update((i, j))
                if (s[i] > s[j]) == ((i & size) == 0):
                    s[i], s[j] = s[j], s[i]
            assert len(seen) == QCAP
            stride >>= 1
        size <<= 1
    return s


def warp_merge(a, na, b, nb, k):
    """The first k keys of the stable merge of a[:na] and b[:nb] by the
    kernel's rank rule; every place below k is written exactly once."""
    out = [None] * k
    for i in range(min(na, k)):
        p = i + bisect_left(b[:nb], a[i])
        if p < k:
            assert out[p] is None
            out[p] = a[i]
    for j in range(min(nb, k)):
        p = j + bisect_right(a[:na], b[j])
        if p < k:
            assert out[p] is None
            out[p] = b[j]
    assert None not in out
    return out


class WarpTopk:
    def __init__(self, k):
        self.k = k
        self.list = [NONE] * k
        self.thr = NONE
        self.queue = []

    def push(self, keys):
        assert len(self.queue) + len(keys) <= QCAP
        self.queue += keys

    def flush(self):
        qc = len(self.queue)
        srt = bitonic64(self.queue + [NONE] * (QCAP - qc))
        assert srt == sorted(srt)
        self.list = warp_merge(self.list, self.k, srt, qc, self.k)
        self.thr = self.list[self.k - 1]
        self.queue = []


def block_merge(lists, k):
    lists = list(lists)
    step = 1
    while step < NWARPS:
        for s in range(0, NWARPS, 2 * step):
            lists[s] = warp_merge(lists[s], k, lists[s + step], k, k)
        step <<= 1
    return lists[0]


def make_key(dist, rank):
    bits = int(np.float32(dist).view(np.uint32))
    return (bits << 32) | int(rank)


def chunk_bounds(start, length, base, c, r, w, n_valid, n_pad):
    lo_rank = base + c * r
    hi = min(start + length, n_valid, n_pad, base + w, lo_rank + r)
    return lo_rank, max(lo_rank, start), hi


def select_block(dist, start, length, base, c, r, w, k, n_valid, n_pad,
                 live, itemsize):
    """One block of range_scan_select: its k best keys."""
    lo_rank, lo, hi = chunk_bounds(start, length, base, c, r, w, n_valid,
                                   n_pad)
    if lo >= hi:
        return [NONE] * k
    first, last = lo - lo_rank, hi - lo_rank
    u_rows = 8 // itemsize
    lists = []
    for warp in range(NWARPS):
        top = WarpTopk(k)
        for t0 in range(warp * 4 * u_rows, last, NWARPS * 4 * u_rows):
            if t0 + 4 * u_rows <= first:
                continue
            if len(top.queue) > QCAP - 4 * u_rows:
                top.flush()
            for u in range(u_rows):
                passing = []
                for grp in range(4):                 # the leaders' lanes
                    row = t0 + 4 * u + grp
                    rank = lo_rank + row
                    ok = first <= row < last
                    if ok and live is not None:
                        ok = live[rank] != 0
                    if ok:
                        key = make_key(dist[rank - base], rank)
                        if key < top.thr:
                            passing.append(key)
                top.push(passing)
        if top.queue:
            top.flush()
        lists.append(top.list)
    return block_merge(lists, k)


def last_block(partial, k):
    """The last block of a query folds the S sorted chunk lists."""
    s = len(partial)
    lists = []
    for warp in range(NWARPS):
        top = WarpTopk(k)
        for cc in range(warp, s, NWARPS):
            for off in range(0, k, 32):
                keys = [partial[cc][off + lane] if off + lane < k else NONE
                        for lane in range(32)]
                if len(top.queue) > QCAP - 32:
                    top.flush()
                passing = [key for key in keys if key < top.thr]
                # a sorted list: the keys that pass lead it
                assert passing == keys[:len(passing)]
                top.push(passing)
                if len(passing) < 32:
                    break
        if top.queue:
            top.flush()
        lists.append(top.list)
    return block_merge(lists, k)


def two_pass_keys(dist, start, length, base, path, r, s, kc, w, k,
                  n_valid, n_pad, live):
    """range_scan_partial's per-chunk best kc keys, then range_scan_merge
    (PATH_SMEM_MERGE) or the sort of whole runs (PATH_RUN_MERGE)."""
    cand = []
    for c in range(s):
        lo_rank, lo, hi = chunk_bounds(start, length, base, c, r, w,
                                       n_valid, n_pad)
        keys = []
        for row in range(r):
            rank = lo_rank + row
            ok = lo <= rank < hi and (live is None or live[rank] != 0)
            keys.append(make_key(dist[rank - base], rank) if ok else NONE)
        cand += sorted(keys)[:kc]
    p = 1 << (k - 1).bit_length()
    if path == krs.PATH_SMEM_MERGE:
        sz = max(2 * p, 1024)
        buf = [NONE] * p
        for t0 in range(0, len(cand), sz - p):
            tile = cand[t0:t0 + sz - p]
            buf = sorted(buf[:p] + tile + [NONE] * (sz - p - len(tile)))
        return buf[:k]
    assert path == krs.PATH_RUN_MERGE
    assert kc == r and s & (s - 1) == 0
    return (sorted(cand) + [NONE] * k)[:k]


def model_scan(x, starts, lens, q, *, bucket, k, n_valid=0, live=None,
               scale=None, seed=0):
    """What one launch of the kernel returns: (ids (Q, k), dists (Q, k))."""
    n_pad = x.shape[0]
    n_valid = int(n_valid) or n_pad
    w = krs.window_rows(bucket)
    base = (starts.long() // 128) * 128
    rank = base[:, None] + torch.arange(w)[None, :]
    rows = ref.dequantized_rows(x, rank.clamp(0, n_pad - 1), scale)
    # the plain version's own arithmetic, so the model scores as it does
    dot = torch.einsum("qwd,qd->qw", rows, q)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(rows * rows, dim=-1)
    d2 = torch.clamp_min(-2.0 * dot + qn + xn, 0.0).numpy()
    live_np = None if live is None else live.reshape(-1).numpy()
    path, r, s, kc = krs.scan_plan(w, k, x.shape[1] * x.element_size())
    rng = np.random.default_rng(seed)
    out = []
    for i in range(q.shape[0]):
        args = (d2[i], int(starts[i]), int(lens[i]), int(base[i]))
        if path != krs.PATH_SELECT:
            out.append(two_pass_keys(*args, path, r, s, kc, w, k, n_valid,
                                     n_pad, live_np))
            continue
        if s == 1:
            assert kc == 0
            out.append(select_block(*args, 0, r, w, k, n_valid, n_pad,
                                    live_np, x.element_size()))
            continue
        assert kc == k
        partial, arrivals, res = [None] * s, 0, None
        for c in rng.permutation(s):               # blocks finish in any order
            partial[c] = select_block(*args, int(c), r, w, k, n_valid,
                                      n_pad, live_np, x.element_size())
            arrivals += 1
            if arrivals == s:                      # the last arrival merges
                res = last_block(partial, k)
                arrivals = 0
        out.append(res)
    keys = np.asarray(out, dtype=np.uint64)
    fin = (keys >> np.uint64(32)) < INF_BITS
    ids = np.where(fin, (keys & np.uint64(0xFFFFFFFF)).astype(np.int64), -1)
    dists = np.where(fin, (keys >> np.uint64(32)).astype(np.uint32)
                     .view(np.float32), np.inf).astype(np.float32)
    return ids.astype(np.int32), dists


# --- data ----------------------------------------------------------------

def _data(precision, bucket, seed):
    rng = np.random.default_rng(seed)
    n_pad = -(-N // 128) * 128
    vecs = np.zeros((n_pad, DIM), np.float32)
    vecs[:N] = rng.standard_normal((N, DIM)).astype(np.float32) * 2
    vecs[1000:1100] = vecs[900:1000]                 # duplicated rows
    xt = torch.as_tensor(vecs)
    scale = None
    if precision != "f32":
        qc = quantize_corpus(xt, precision)
        xt, scale = qc.data, qc.scale
    x = torch.nn.functional.pad(xt, (0, 128 - DIM))
    if scale is not None:
        scale = torch.nn.functional.pad(scale, (0, 128 - DIM), value=1.0)
    starts = rng.integers(0, N, NQ).astype(np.int32)
    lens = rng.integers(bucket // 2, bucket + 1, NQ).astype(np.int32)
    lens[0] = 0                                       # empty window
    starts[1], lens[1] = N - 1, 1                     # one-row tail
    starts[2] = 128 * 3 + 37                          # unaligned start
    starts[3], lens[3] = 880, min(bucket, 300)        # covers the duplicates
    starts[4] = N - 60                                # runs past n_valid
    q = np.zeros((NQ, 128), np.float32)
    q[:, :DIM] = rng.standard_normal((NQ, DIM)).astype(np.float32) * 2
    live = (rng.random((1, n_pad)) < 0.8).astype(np.int32)
    return x, scale, starts, lens, q, live


def _plain(x, scale, starts, lens, q, **kw):
    i, d = ops.range_scan(x, torch.as_tensor(starts), torch.as_tensor(lens),
                          torch.as_tensor(q), scale=scale, **kw)
    return i.numpy(), d.numpy()


def _jax(x, scale, starts, lens, q, live=None, **kw):
    raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    xj = jnp.asarray(raw.numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.view(jnp.bfloat16)
    i, d = jops.range_scan(
        xj, jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(q),
        scale=None if scale is None else jnp.asarray(scale.numpy()),
        live=None if live is None else jnp.asarray(live), **kw)
    return np.asarray(i), np.asarray(d)


# --- tests ---------------------------------------------------------------

@pytest.mark.parametrize("bucket", [64, 2048, 16384])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16"])
def test_model_equals_plain(precision, k, bucket):
    """Every regime of the kernel, with live and n_valid masks: the model
    returns the plain version's ids and distances bit for bit."""
    x, scale, starts, lens, q, live = _data(precision, bucket, k + bucket)
    kw = dict(bucket=bucket, k=k, n_valid=N - 37)
    st, ln = torch.as_tensor(starts), torch.as_tensor(lens)
    for lv in (None, torch.as_tensor(live)):
        got_i, got_d = model_scan(x, st, ln, torch.as_tensor(q), live=lv,
                                  scale=scale, seed=k, **kw)
        want_i, want_d = _plain(x, scale, starts, lens, q, live=lv, **kw)
        assert np.array_equal(got_i, want_i)
        assert np.array_equal(got_d, want_d)
        assert (got_i < N - 37).all()


@pytest.mark.parametrize("k,bucket", [(1, 64), (10, 512), (128, 2048),
                                      (129, 512), (256, 4096), (257, 1024),
                                      (2048, 4096), (4096, 8192),
                                      (5000, 8192)])
@pytest.mark.parametrize("precision", ["f32", "int8", "bf16"])
def test_model_equals_jax_reference(precision, k, bucket):
    """The JAX package's range_scan on the same inputs (its oracle takes k
    up to the window's w rows; every window here holds fewer than 5000
    live rows): distances agree within rtol 1e-4, atol 1e-4 max(1,
    max |x|^2), because XLA and torch sum in another order, and ids are
    equal except where two neighbours' distances lie within that
    tolerance of each other (a near-tie the order of the sums may flip;
    at k = 2048 a few 1-ulp pairs do)."""
    x, scale, starts, lens, q, live = _data(precision, bucket, 7 * k)
    kw = dict(bucket=bucket, k=k, n_valid=N - 37)
    got_i, got_d = model_scan(x, torch.as_tensor(starts),
                              torch.as_tensor(lens), torch.as_tensor(q),
                              live=torch.as_tensor(live), scale=scale, **kw)
    want_i, want_d = _jax(x, scale, starts, lens, q, live=live, **kw)
    fin = np.isfinite(want_d)
    assert np.array_equal(np.isfinite(got_d), fin)
    xf = ref.dequantized_rows(x, torch.arange(x.shape[0]), scale).numpy()
    atol = 1e-4 * max(1.0, float(np.max(np.sum(xf * xf, axis=1))))
    assert np.allclose(got_d[fin], want_d[fin], rtol=1e-4, atol=atol)
    near_tie = np.isclose(got_d, want_d, rtol=1e-4, atol=atol) & fin
    assert not ((got_i != want_i) & ~near_tie).any()


def test_duplicated_rows_tie_to_lower_rank():
    """Query 3's window holds rows 900-999 and their copies at 1000-1099:
    each copy's key ties its original's distance, so the lower rank comes
    first in every select regime."""
    for k in (10, 128, 256):
        x, scale, starts, lens, q, _ = _data("f32", 512, 3)
        q[3] = x[950].numpy()                          # nearest: 950 and 1050
        ids, dists = model_scan(x, torch.as_tensor(starts),
                                torch.as_tensor(lens), torch.as_tensor(q),
                                bucket=512, k=k)
        assert ids[3, 0] == 950 and ids[3, 1] == 1050
        assert dists[3, 0] == dists[3, 1]


def test_bitonic_network_and_rank_merge():
    """The queue sort's pairs cover 64 slots once per stage and sort any
    input; the rank merge places every key once, keeps the first k of the
    stable merge, and fills k places even with pads on both sides."""
    rng = np.random.default_rng(0)
    for trial in range(200):
        vals = rng.integers(0, 40 if trial % 2 else 1 << 40, QCAP).tolist()
        assert bitonic64(vals) == sorted(vals)
        na, nb = int(rng.integers(1, 90)), int(rng.integers(0, 90))
        k = int(rng.integers(1, na + 1))
        lists = []
        for n in (na, nb):
            real = sorted(rng.integers(0, 1 << 40, n).tolist())
            cut = int(rng.integers(0, n + 1))
            lists.append(real[:cut] + [NONE] * (n - cut))   # padded tail
        a, b = lists
        assert warp_merge(a, na, b, nb, k) == sorted(a + b)[:k]


def test_last_arrival_order_is_irrelevant():
    """Any arrival order of a query's blocks gives the same answer."""
    x, scale, starts, lens, q, live = _data("f32", 16384, 11)
    args = (x, torch.as_tensor(starts), torch.as_tensor(lens),
            torch.as_tensor(q))
    first = model_scan(*args, bucket=16384, k=10, live=torch.as_tensor(live),
                       seed=0)
    for seed in (1, 2, 3):
        got = model_scan(*args, bucket=16384, k=10,
                         live=torch.as_tensor(live), seed=seed)
        assert all(np.array_equal(g, f) for g, f in zip(got, first))


@pytest.mark.parametrize("k", [1, 10, 128, 256, 257, 2048, 2049, 5000])
def test_scan_plan_covers_the_window(k):
    """Chunks cover the window, the select path keeps at most
    SELECT_CHUNKS chunks of a multiple of 128 rows (as many as SELECT_BYTES
    of rows each needs, evened out), its shared memory at
    d_pad = 128 stays within the 48 KB a block gets without opting in, and
    the two-pass path keeps its pow2 run count past SMEM_K; the path
    follows k alone."""
    for bucket, row_bytes in itertools.product(
            (1, 64, 100, 512, 8192, 65536, 131072, 1 << 20),
            (128, 256, 512, 1024, 4096)):
        w = krs.window_rows(bucket)
        path, r, s, kc = krs.scan_plan(w, k, row_bytes)
        assert s * r >= w
        if k <= krs.SELECT_K:
            assert path == krs.PATH_SELECT
            assert (s - 1) * r < w
            assert r % 128 == 0 and s <= krs.SELECT_CHUNKS
            rows = max(128, krs.SELECT_BYTES // row_bytes)
            if -(-w // rows) <= krs.SELECT_CHUNKS:
                assert r <= rows and s == -(-w // rows)
            assert kc == (k if s > 1 else 0)
            smem = NWARPS * (2 * k + QCAP) * 8 + 2 * 128 * 4
            assert smem <= 48 * 1024
        elif (1 << (k - 1).bit_length()) <= krs.SMEM_K:
            assert path == krs.PATH_SMEM_MERGE
            assert r & (r - 1) == 0 and (s - 1) * r < w
            assert kc == min(k, r) and r >= k
        else:       # whole sorted runs, a pow2 number of them
            assert path == krs.PATH_RUN_MERGE
            assert kc == r == krs.SMEM_K
            assert s == 1 << (-(-w // r) - 1).bit_length()


def test_model_constants_match_kernel_source():
    """The model's block shape is the kernel's (THREADS and QCAP in
    csrc/range_scan.cu), and the launcher numbers its paths as the wrapper
    does; the choice of path is the wrapper's alone (the kernel source has
    no k threshold of its own)."""
    src = (Path(krs.__file__).resolve().parents[1] / "csrc"
           / "range_scan.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert int(defines["THREADS"]) == THREADS
    assert int(defines["QCAP"]) == QCAP
    assert "SELECT_K" not in defines and "SMEM_K" not in defines
    enum = re.search(r"enum \{([^}]*)\}", src).group(1)
    paths = dict(re.findall(r"(PATH_\w+) = (\d+)", enum))
    assert {name: int(v) for name, v in paths.items()} == {
        "PATH_SELECT": krs.PATH_SELECT,
        "PATH_SMEM_MERGE": krs.PATH_SMEM_MERGE,
        "PATH_RUN_MERGE": krs.PATH_RUN_MERGE}
