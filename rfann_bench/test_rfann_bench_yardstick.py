"""The yardstick on the CPU: the reference against hand-checked cases, the
scan's least bytes from its rank windows, and the controls failing the
committed limits at a size a test run can hold."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rfann_bench import judge, reference, roofline

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hand_case():
    # six points on a line, attribute = position in a shuffled order
    x = torch.tensor([[0.], [1.], [2.], [3.], [4.], [10.]])
    a = torch.tensor([5., 0., 1., 2., 3., 4.])
    return x, a


def test_reference_top_k_in_range_by_hand():
    x, a = _hand_case()
    q = np.array([[2.2], [9.0], [0.0]], np.float32)
    r = np.array([[0., 2.], [3., 5.], [4., 4.]], np.float32)
    ids, d = reference.topk_in_range(x, a, q, r, 2)
    # query 0 may use rows 1, 2, 3 (attrs 0..2): nearest 2 (0.04), 3 (0.64)
    assert ids[0].tolist() == [2, 3]
    np.testing.assert_allclose(d[0], [0.04, 0.64], rtol=1e-6)
    # query 1 may use rows 0, 4, 5 (attrs 5, 3, 4): nearest 5 (1), 4 (25)
    assert ids[1].tolist() == [5, 4]
    np.testing.assert_allclose(d[1], [1.0, 25.0])
    # query 2's range holds row 5 alone: one id, then the -1 / inf pad
    assert ids[2].tolist() == [5, -1]
    assert d[2][0] == 100.0 and np.isinf(d[2][1])


def test_rank_window_and_exact_distances():
    x, a = _hand_case()
    lo, hi = reference.rank_window(a.numpy(), np.array(
        [[0., 2.], [3.5, 3.6], [-1., 9.]], np.float32))
    assert lo.tolist() == [0, 4, 0] and hi.tolist() == [2, 3, 5]
    e = reference.exact_dists(x, np.array([[1.5]], np.float32),
                              np.array([0, 0]), np.array([[0, 7], [5, -1]]))
    assert e[0, 0] == 2.25 and np.isnan(e[0, 1])
    assert e[1, 0] == 72.25 and np.isnan(e[1, 1])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -12,
                      1.0 + 2.0 ** -12])
    assert reference._round_tf32(v).tolist() == [1.0 + 2.0 ** -10,
                                                 1.0 + 2.0 ** -10, 1.0]


def test_gaps_fold_every_broken_guarantee():
    x, a = _hand_case()
    pool = np.array([[2.2]], np.float32)
    ranges = np.array([[0., 2.]], np.float32)
    gt_d = np.array([[0.04, 0.64]])          # rows 2 and 3
    q_idx = np.zeros(6, np.int64)
    ids = np.array([[2, 1], [2, 0], [2, 2], [2, -1], [2, 1], [2, 3]])
    d = np.array([[0.04, 1.44], [0.04, 4.84], [0.04, 0.04], [0.04, np.inf],
                  [0.04, 1.5], [0.04, 0.64]])
    g, t = judge.gaps(x, a.numpy(), pool, ranges, gt_d, q_idx, ids, d)
    assert g[0] < 1e-6               # in range with exact distances ...
    assert t[0] == 1.0               # ... but not the top-2: (1.44-.64)/.64
    _, t0 = judge.gaps(x, a.numpy(), pool, ranges, np.array([[0.04, 1.0]]),
                      q_idx[:1], ids[:1], d[:1])
    assert t0[0] == pytest.approx(0.44)   # the 2nd: 1.44 against 1.0
    assert g[1] == 1.0 and t[1] == 1.0   # row 0's attribute (5) is out
    assert g[2] == 1.0               # a repeated id
    assert g[3] == 1.0 and t[3] == 1.0   # short of min(k, rows in range)
    assert g[4] == pytest.approx(0.06 / 1.44, rel=1e-5)   # wrong distance
    assert g[5] < 1e-6 and t[5] < 1e-6   # the exact answer
    gt = np.array([[2, 3]])
    assert judge.recall(gt, q_idx[:2], ids[:2]) == 0.5
    assert judge.recall(gt, q_idx[5:], ids[5:]) == 1.0


def test_scan_bytes_count_the_union_of_rank_windows():
    lo = np.array([0, 5, 100, 3, 200])
    hi = np.array([9, 20, 149, 4, 199])     # the last window is empty
    assert roofline.union_rows(lo, hi) == 21 + 50
    b = roofline.scan_bytes(lo, hi, d=128, k=10, precision="int8")
    assert b == 71 * 128 + 4 * 128 + 4 * (128 * 4 + 10 * 8)
    assert roofline.scan_ops(lo, hi, d=128) == 2 * 128 * (10 + 16 + 50 + 2)
    s, by = roofline.scan_least_s(lo, hi, 128, 10, "f32")
    assert by == "bytes" and s == roofline.scan_bytes(
        lo, hi, 128, 10, "f32") / roofline.HBM_BYTES_PER_S


@pytest.mark.parametrize("config", ["sift1m-syn", "sift1m-syn-int8"])
def test_control_fails_the_committed_limit(config):
    """Step 2: each of the configuration's controls (the reference in the
    next precision down, with the int8 path's exact rerank of its survivors
    or without) put in the program's place reads above a limit; the f32
    reference does not.  Two clusters, so that a window holds more rows of
    the query's cluster than the control keeps for its rerank."""
    cfg = json.loads((ROOT / "rfann_bench" / "configs" /
                      f"{config}.json").read_text())
    from rfann_bench import data
    cfg.update(n=4096, d=32, queries=256, n_clusters=2)
    c = data.make_corpus(cfg, 256, 64, [0, 1, 2, 3], 2**31 + 5,
                         torch.device("cpu"))
    x, a = torch.as_tensor(c.vectors), torch.as_tensor(c.attrs)
    _, gt_d = reference.topk_in_range(x, a, c.queries, c.ranges, 10)
    q_idx = np.arange(256)
    lim = cfg["limits"]
    for ctl, fails in [({"precision": "f32"}, False)] + [
            (ctl, True) for ctl in cfg["controls"]]:
        ids, d = reference.topk_in_range(x, a, c.queries, c.ranges, 10,
                                         precision=ctl["precision"],
                                         rerank=ctl.get("rerank", 0))
        g, t = judge.gaps(x, c.attrs, c.queries, c.ranges, gt_d, q_idx, ids,
                          d)
        got = {"dist_gap": g.max(), "topk_gap": t.max()}
        over = {n for n in lim if got[n] > lim[n]}
        assert bool(over) == fails, (ctl, got, lim)
        if ctl.get("rerank"):      # survivors reranked: distances exact
            assert over == {"topk_gap"}


def test_rerank_makes_the_int4_control_exact_where_it_keeps_every_row():
    """With as many survivors as rows, int4 selection loses nothing."""
    x = torch.randn(300, 8, generator=torch.Generator().manual_seed(3))
    a = torch.arange(300, dtype=torch.float32)
    q = np.asarray(torch.randn(5, 8).numpy(), np.float32)
    r = np.array([[0., 299.]] * 5, np.float32)
    want, _ = reference.topk_in_range(x, a, q, r, 10)
    got, _ = reference.topk_in_range(x, a, q, r, 10, precision="int4",
                                     rerank=300)
    assert (got == want).all()
