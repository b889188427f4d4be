"""The int8 / bf16 cases of the distributed local path against the
reference (``test_torch_distributed.py`` holds the f32 cases and the rest):
equal ids, distances within rtol 1e-5 / atol 1e-4, at S = 4 and 8, every
plan × beam width, with and without a tombstone mask."""
import pytest
import torch

from _torch_dist_case import check_local_path


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("use_live", [False, True])
@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("plan", ["graph", "auto", "scan", "beam"])
@pytest.mark.parametrize("shards", [4, 8])
def test_local_path_matches_reference_quantized(shards, plan, bw, precision,
                                                use_live):
    check_local_path(shards, plan, bw, precision, use_live)
