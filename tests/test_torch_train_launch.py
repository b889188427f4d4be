"""The port's train launcher (``repro_torch.launch.train``) on the CPU: the
reference's own cases (loss decreases; restart from a checkpoint replays the
loss trajectory), a resume across the packages, the printed lines, and
preemption.

Tolerances: a resume in the port replays its own trajectory within rtol
1e-4 (the reference test's limit; here it is bit-equal).  Across the
packages the smoke configs run in bf16, and the two packages round
intermediate values at different points, so the port's losses after
resuming from the reference's checkpoint follow the reference's
uninterrupted run within one bf16 unit, rtol 2^-8 (measured: at most
4.1e-4 over the four steps)."""
import numpy as np
import pytest
import torch

from repro.launch.train import main as ref_main
from repro_torch.launch import train
from repro_torch.launch.train import main


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small torch ops, cores shared by workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = ["--arch", "mamba2-780m", "--batch", "2", "--seq", "32",
        "--log-every", "1000"]


def test_loss_decreases_under_training(capsys):
    state, losses = main(["--device", "cpu", "--arch", "qwen1.5-4b",
                          "--steps", "30", "--batch", "4", "--seq", "64",
                          "--log-every", "10"])
    assert len(losses) == 30
    assert losses[-1] < losses[0] - 0.1, losses[::10]
    assert int(state["opt"]["step"]) == 30
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(" loss=")[0] for ln in out[:3]] == [
        "[train] step 0", "[train] step 10", "[train] step 20"]
    assert out[-1].startswith(f"[train] done: loss {losses[0]:.3f} -> "
                              f"{losses[-1]:.3f} (") and \
        out[-1].endswith(" tok/s)")


def test_train_resume_equivalence(tmp_path, capsys):
    _, full = main(BASE + ["--device", "cpu", "--steps", "8"])
    d = str(tmp_path / "ck")
    main(BASE + ["--device", "cpu", "--steps", "4", "--ckpt-dir", d,
                 "--ckpt-every", "100"])
    _, resumed = main(BASE + ["--device", "cpu", "--steps", "8",
                              "--ckpt-dir", d, "--resume"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert np.allclose(full[4:], resumed, rtol=1e-4), (full, resumed)


def test_resume_from_the_reference_checkpoint(tmp_path):
    """The reference trains 4 steps and checkpoints; the port resumes 4
    more and follows the reference's uninterrupted 8-step run."""
    _, full = ref_main(BASE + ["--steps", "8"])
    d = str(tmp_path / "ck")
    ref_main(BASE + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "100"])
    _, resumed = main(BASE + ["--device", "cpu", "--steps", "8",
                              "--ckpt-dir", d, "--resume"])
    assert len(resumed) == 4
    assert np.allclose(resumed, full[4:], rtol=2 ** -8, atol=0), (
        full[4:], resumed)


def test_compressed_grads_and_straggler_lines(capsys):
    _, losses = main(BASE + ["--device", "cpu", "--steps", "4",
                             "--compress-grads", "--simulate-straggler",
                             "1.0"])
    assert np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "[train] step 1: stragglers=[3] evict=[]" in out


def test_preemption_checkpoints_and_returns(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(train.PreemptionHandler, "should_stop",
                        lambda self: calls.append(1) or len(calls) >= 3)
    d = str(tmp_path / "ck")
    state, losses = main(BASE + ["--device", "cpu", "--steps", "8",
                                 "--ckpt-dir", d])
    assert len(losses) == 3 and int(state["opt"]["step"]) == 3
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    assert CheckpointManager(d).all_steps() == [3]
