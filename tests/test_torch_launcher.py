"""The port's launcher on the CPU: the command line trains and logs, and
whatever it cannot tile exits 2."""

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
    ["--mesh", "pipe=3", "--n-microbatches", "2"],  # 4 layers do not split over 3 stages
    ["--mesh", "expert=3", "--n-experts", "4"],  # 4 experts do not split over 3 ranks
    # MoE pipelined over data: a global microbatch of 2 rows over data=2 is
    # a row a rank, but a rank's 2 rows do not make 4 microbatches
    ["--mesh", "data=2,pipe=2", "--n-microbatches", "4", "--n-experts", "2",
     "--batch-size", "4"],
    ["--mesh", "pipe=2", "--n-microbatches", "3"],  # a rank's 8 rows
    ["--mesh", "tensor=3"],  # 8 heads do not split over 3 ranks
    ["--mesh", "bogus=2"],
], ids=str)
def test_unported_flags_exit_2(argv, capsys):
    assert launcher.main(["--cpu", "--steps", "1", *argv]) == 2
    assert "error:" in capsys.readouterr().err


def test_compile_cache_flag_trains(tmp_path, capsys):
    """``--compile-cache DIR`` is served: the job's kernel library goes
    through a cache in DIR (on the CPU there is no library to build)."""
    cache = tmp_path / "cache"
    assert launcher.main(["--cpu", "--steps", "1", "--batch-size", "2", "--seq-len", "16",
                          "--compile-cache", str(cache)]) == 0
    assert "trained 1 steps" in capsys.readouterr().out


def test_multi_chip_allocations_exit_2(tmp_path, monkeypatch, capsys):
    """A multi-chip allocation trains on a mesh of that many ranks now;
    what it cannot tile still exits 2 by name: a mesh that does not divide
    the allocation, a batch the data axes do not divide.  MoE pipelined
    over the data axis passes the job's checks."""
    ann = tmp_path / "annotations"
    ann.write_text('elasticgpu.io/container-main="0.0.0,0.1.0"\n')
    assert launcher.main(["--cpu", "--steps", "1", "--annotations", str(ann),
                          "--mesh", "tensor=4"]) == 2
    assert "incompatible with 2 devices" in capsys.readouterr().err
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0.0,0.1,1.0")
    assert launcher.main(["--cpu", "--steps", "1", "--batch-size", "2"]) == 2
    assert "not divisible by data*fsdp=3" in capsys.readouterr().err
    moe = TransformerConfig(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                            dtype="float32", n_experts=2, n_microbatches=2)
    launcher.check_mesh_job(launcher.JobSpec(model=moe, mesh=launcher.MeshSpec(data=2, pipe=2)))


def test_one_chip_allocation_runs(monkeypatch):
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0.0")
    spec = launcher.JobSpec(model=TINY, steps=2, batch_size=2, seq_len=8)
    assert len(launcher.run_job(spec, device="cpu")) == 2


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run_job(launcher.JobSpec(model=TINY, steps=1))


def test_more_ranks_than_cards_needs_gloo_by_name(capsys):
    """Two ranks and no card: NCCL is refused by name, never swapped for
    gloo on its own."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    assert launcher.main(["--steps", "1", "--mesh", "tensor=2"]) == 2
    err = capsys.readouterr().err
    assert "NCCL takes one rank a card" in err and "--dist-backend gloo" in err


def test_cli_mesh_trains_like_reference_run_job(tmp_path):
    """``--cpu --mesh tensor=2`` (two gloo ranks) trains the reference's
    default job and equals the reference's ``run_job`` on that mesh.  The
    reference draws its weights from ``jax.random``, so they reach the port
    as a step-0 checkpoint of the same state; the batch stream is the same
    seeded one.  The default model is bf16: losses agree to 2e-2 (the
    bf16 products round differently; the float32 meshes are held to 1e-5
    in test_torch_parallel.py)."""
    import jax

    from elastic_gpu_scheduler_tpu import launcher as jlauncher
    from elastic_gpu_scheduler_tpu.models.train import init_sharded_state
    from elastic_gpu_scheduler_tpu.models.train import make_optimizer as jax_opt
    from elastic_gpu_scheduler_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
    from elastic_gpu_scheduler_tpu_torch.models.checkpoint import CheckpointManager
    from elastic_gpu_scheduler_tpu_torch.models.train import make_optimizer, state_for

    job = dict(steps=3, batch_size=2, seq_len=16, lr=1e-3)
    want = jlauncher.run_job(jlauncher.JobSpec(mesh=JaxMeshSpec(tensor=2), **job),
                             devices=jax.devices()[:2])
    jp, _ = init_sharded_state(jax.random.key(0), jlauncher.JobSpec().model, jax_opt())
    params, state = state_for(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                              make_optimizer(lr=1e-3, grad_clip=1.0))
    ckpt = tmp_path / "ckpt"
    mgr = CheckpointManager(str(ckpt))
    mgr.save(params, state, 0, block=True)
    mgr.close()
    log = tmp_path / "metrics.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.launcher", "--cpu",
         "--mesh", "tensor=2", "--steps", "3", "--batch-size", "2", "--seq-len", "16",
         "--lr", "1e-3", "--checkpoint-dir", str(ckpt), "--metrics-log", str(log)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "trained 3 steps" in out.stdout
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]  # rank 0 alone writes
    np.testing.assert_allclose([r["loss"] for r in recs], want, atol=2e-2)


def test_two_chip_allocation_trains_on_two_ranks(tmp_path):
    """An allocation of two chips and no ``--mesh``: the reference's rule
    gives data=2, and the launcher starts two ranks (gloo on the CPU);
    rank 0 alone writes the metrics log."""
    ann = tmp_path / "annotations"
    ann.write_text('elasticgpu.io/container-main="0.0.0,0.1.0"\n')
    log = tmp_path / "metrics.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.launcher", "--cpu",
         "--annotations", str(ann), "--steps", "2", "--batch-size", "2", "--seq-len", "8",
         "--metrics-log", str(log)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'data': 2" in out.stderr and "trained 2 steps" in out.stdout
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and np.isfinite([r["loss"] for r in recs]).all()
