"""The port's launcher on the CPU: the command line trains and logs, and
whatever needs more than one device or an unported module exits 2."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu_torch import launcher
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = TransformerConfig(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                         dtype="float32")


def test_cli_trains_three_steps_and_writes_metrics(tmp_path):
    """The reference's default model (bf16, fp32 masters) through the
    command line, three short steps on the CPU, with a profiler trace."""
    log = tmp_path / "metrics.jsonl"
    prof = tmp_path / "prof"
    out = subprocess.run(
        [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.launcher", "--cpu",
         "--steps", "3", "--batch-size", "2", "--seq-len", "16", "--lr", "1e-3",
         "--metrics-log", str(log), "--profile-dir", str(prof)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "trained 3 steps" in out.stdout
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert np.isfinite([r["loss"] for r in recs]).all()
    assert (prof / "trace.json").stat().st_size > 0


def test_run_job_loss_falls():
    spec = launcher.JobSpec(model=TINY, steps=6, batch_size=4, seq_len=16, lr=1e-2)
    losses = launcher.run_job(spec, device="cpu")
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("argv", [
    ["--mesh", "tensor=2"],
    ["--mesh", "data=2,seq=2"],
    ["--compile-cache", "/nonexistent/cache"],
    ["--mesh", "bogus=2"],
], ids=str)
def test_unported_flags_exit_2(argv, capsys):
    assert launcher.main(["--cpu", "--steps", "1", *argv]) == 2
    assert "error:" in capsys.readouterr().err


def test_multi_chip_allocations_exit_2(tmp_path, monkeypatch, capsys):
    ann = tmp_path / "annotations"
    ann.write_text('elasticgpu.io/container-main="0.0.0,0.1.0"\n')
    assert launcher.main(["--cpu", "--steps", "1", "--annotations", str(ann)]) == 2
    assert "2 chips" in capsys.readouterr().err
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0.0,0.1,1.0")
    assert launcher.main(["--cpu", "--steps", "1"]) == 2
    assert "3 chips" in capsys.readouterr().err
    with pytest.raises(launcher.Unported, match="gang"):
        monkeypatch.delenv("TPU_VISIBLE_CHIPS")
        launcher.check_one_device(launcher.JobSpec(model=TINY),
                                  {"elasticgpu.io/gang-slices": "a,b"})


def test_one_chip_allocation_runs(monkeypatch):
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0.0")
    spec = launcher.JobSpec(model=TINY, steps=2, batch_size=2, seq_len=8)
    assert len(launcher.run_job(spec, device="cpu")) == 2


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run_job(launcher.JobSpec(model=TINY, steps=1))
