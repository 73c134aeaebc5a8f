"""The port's torch-format ``CheckpointManager`` and the launcher's resume.

The reference's surface and semantics (``models/checkpoint.py``, orbax):
asynchronous saves that a second save and ``restore`` join; the latest
``keep`` steps on disk; a save taken when it is called, whatever the
train step does to the tensors afterwards; a crash mid-write leaves no
step that ``restore`` would pick.  ``launcher.run_job`` interrupted after
a periodic save and started again on the same directory must give the
uninterrupted job's losses and final checkpoint exactly (float32, CPU),
for a dense and a MoE job; a LoRA train state round-trips and resumes to
the same losses.  Against the reference: three steps after an orbax save
and restore on one CPU device, and three steps after the port's save
and restore from the same start, within 1e-5 (``test_torch_train.py``'s
float32 tolerance for three train steps).
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models.checkpoint import CheckpointManager as RefManager
from elastic_gpu_scheduler_tpu.models.train import (
    init_sharded_state,
    make_jitted_train_step,
    make_optimizer as jax_make_optimizer,
)
from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig
from elastic_gpu_scheduler_tpu_torch import launcher
from elastic_gpu_scheduler_tpu_torch.models import lora, train
from elastic_gpu_scheduler_tpu_torch.models.bridge import (
    opt_state_from_jax,
    params_from_jax,
    params_to_numpy,
)
from elastic_gpu_scheduler_tpu_torch.models.checkpoint import CheckpointManager
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params

torch.set_num_threads(1)

CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32")


def test_async_saves_join_before_restore(tmp_path):
    """Back-to-back non-blocking saves write in the background; restore()
    joins the write in flight and sees the LAST save's values exactly."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    p1 = {"w": torch.ones(8, 8)}
    p2 = {"w": torch.full((8, 8), 3.0)}
    opt = {"mu": torch.zeros(8, 8)}
    mgr.save(p1, opt, 1)  # async
    mgr.save(p2, opt, 2)  # joins save 1, dispatches save 2
    out = mgr.restore(p1, opt)  # joins save 2 before reading
    assert out is not None
    params, _, step = out
    assert step == 2
    assert torch.equal(params["w"], torch.full((8, 8), 3.0))
    mgr.close()


def test_keeps_the_latest_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for step in range(1, 6):
        mgr.save({"w": torch.full((2,), float(step))}, {}, step)
    mgr.close()
    assert mgr.steps() == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004", "step_00000005"]
    # a step at or below the last saved one is skipped, as orbax skips it
    mgr.save({"w": torch.zeros(2)}, {}, 5, block=True)
    assert torch.equal(mgr.restore({"w": torch.zeros(2)}, {})[0]["w"], torch.full((2,), 5.0))


def test_save_snapshots_at_call_time(tmp_path):
    """The train step updates tensors in place right after a save returns;
    the checkpoint holds the values at the call."""
    mgr = CheckpointManager(str(tmp_path))
    p = {"w": torch.arange(1 << 16, dtype=torch.float32)}
    state = train.make_optimizer().init(p)
    mgr.save(p, state, 1)
    with torch.no_grad():
        p["w"].add_(1.0)
        state.mu["w"].fill_(7.0)
    state.count = 5
    out = mgr.restore({"w": torch.zeros(1 << 16)}, train.make_optimizer().init(p))
    params, opt_state, step = out
    assert step == 1
    assert torch.equal(params["w"], torch.arange(1 << 16, dtype=torch.float32))
    assert opt_state.count == 0 and not bool(opt_state.mu["w"].any())


def test_a_half_written_step_is_never_restored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": torch.ones(3)}, {}, 4, block=True)
    # a writer killed mid-write: its temporary directory, half a file
    os.makedirs(tmp_path / ".tmp_step_00000006")
    (tmp_path / ".tmp_step_00000006" / "state.pt").write_bytes(b"PK\x03\x04half")
    os.makedirs(tmp_path / "step_00000009")  # a directory with no state file
    again = CheckpointManager(str(tmp_path))
    assert not (tmp_path / ".tmp_step_00000006").exists()
    assert again.latest_step() == 4
    assert again.restore({"w": torch.zeros(3)}, {})[2] == 4


def test_restore_refuses_a_template_that_does_not_fit(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": torch.ones(3)}, {}, 1, block=True)
    assert CheckpointManager(str(tmp_path / "empty")).restore({"w": torch.ones(3)}, {}) is None
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore({"w": torch.ones(4)}, {})
    with pytest.raises(ValueError, match="fewer leaves"):
        mgr.restore({"w": torch.ones(3), "x": torch.ones(1)}, {})


def test_restore_places_leaves_like_the_template(tmp_path):
    """bf16-at-rest params with a MasterState: every leaf comes back in its
    template's dtype, params requiring grad, the count an int."""
    cfg = TransformerConfig(**dict(CFG, dtype="bfloat16"))
    opt = train.make_optimizer(lr=1e-2, mu_dtype="bfloat16")
    params, state = train.init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    step = train.make_train_step(cfg, opt)
    tokens = torch.randint(0, 128, (2, 9), generator=torch.Generator().manual_seed(1))
    step(params, state, tokens)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(params, state, 1, block=True)
    tp, ts = train.init_state(cfg, opt, torch.Generator().manual_seed(9), "cpu")
    rp, rs, _ = mgr.restore(tp, ts)
    assert isinstance(rs, train.MasterState) and rs.inner.count == 1
    for a, b in zip(train._leaves(rp), train._leaves(params)):
        assert a.dtype == b.dtype and a.requires_grad and torch.equal(a, b)
    assert rp["layers"]["wq"].dtype == rs.inner.mu["layers"]["wq"].dtype == torch.bfloat16
    for a, b in zip(train._leaves(rs.master) + train._leaves(rs.inner.nu),
                    train._leaves(state.master) + train._leaves(state.inner.nu)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def _killed_after(monkeypatch, n_steps: int):
    """The launcher's train step raises on its call ``n_steps`` + 1, as a
    killed pod stops; the checkpoint writes it had started finish."""
    real = launcher.make_train_step

    def make(*a, **k):
        fn, calls = real(*a, **k), [0]

        def step(*args):
            calls[0] += 1
            if calls[0] > n_steps:
                raise KeyboardInterrupt("killed")
            return fn(*args)

        return step

    monkeypatch.setattr(launcher, "make_train_step", make)


def _join_writers():
    for t in threading.enumerate():
        if t.name.startswith("checkpoint-"):
            t.join()


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_interrupted_job_resumes_to_the_uninterrupted_one(tmp_path, monkeypatch, experts):
    model = TransformerConfig(**dict(CFG, n_experts=experts))
    spec = dict(model=model, steps=7, batch_size=4, seq_len=16, lr=1e-2, checkpoint_every=2)
    whole = launcher.run_job(
        launcher.JobSpec(**spec, checkpoint_dir=str(tmp_path / "whole")), device="cpu")
    with monkeypatch.context() as m:
        _killed_after(m, 5)
        with pytest.raises(KeyboardInterrupt):
            launcher.run_job(launcher.JobSpec(**spec, checkpoint_dir=str(tmp_path / "cut")),
                             device="cpu")
        _join_writers()
    assert CheckpointManager(str(tmp_path / "cut")).latest_step() == 4
    resumed = launcher.run_job(
        launcher.JobSpec(**spec, checkpoint_dir=str(tmp_path / "cut")), device="cpu")
    assert resumed == whole[4:]  # steps 4, 5, 6, bit for bit
    # the final checkpoints (step 7) hold the same bits
    fresh = launcher.JobSpec(**spec)
    opt = launcher.make_optimizer(lr=fresh.lr, grad_clip=fresh.grad_clip)
    outs = []
    for name in ("whole", "cut"):
        tp, ts = train.init_state(model, opt, torch.Generator().manual_seed(5), "cpu")
        outs.append(CheckpointManager(str(tmp_path / name)).restore(tp, ts))
    assert outs[0][2] == outs[1][2] == 7
    for a, b in zip(train._leaves(outs[0][0]) + train._leaves(outs[0][1].mu),
                    train._leaves(outs[1][0]) + train._leaves(outs[1][1].mu)):
        assert torch.equal(a, b)
    assert outs[0][1].count == outs[1][1].count == 7


def test_cli_checkpoint_dir_resumes(tmp_path, capsys):
    """``--checkpoint-dir`` / ``--checkpoint-every`` on the command line: a
    second run with more steps resumes, and its metrics continue the step
    count."""
    log = tmp_path / "m.jsonl"
    base = ["--cpu", "--batch-size", "2", "--seq-len", "8", "--checkpoint-dir",
            str(tmp_path / "ck"), "--checkpoint-every", "2", "--metrics-log", str(log)]
    assert launcher.main([*base, "--steps", "2"]) == 0
    assert launcher.main([*base, "--steps", "3"]) == 0
    assert launcher.main([*base, "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "trained 2 steps" in out and "trained 1 steps" in out and "already complete" in out
    assert [json.loads(x)["step"] for x in log.read_text().splitlines()] == [0, 1, 2]
    assert CheckpointManager(str(tmp_path / "ck")).steps() == [2, 3]


def test_lora_state_round_trips_and_resumes(tmp_path):
    cfg = TransformerConfig(**CFG)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = train.make_optimizer(lr=1e-2)
    lo = lora.lora_init(params, rank=4, generator=torch.Generator().manual_seed(1))
    state = opt.init(lo["adapters"])
    step = lora.make_lora_train_step(cfg, opt)
    g = torch.Generator().manual_seed(2)
    batches = [torch.randint(0, 128, (2, 9), generator=g) for _ in range(5)]
    for t in batches[:2]:
        step(lo, state, params, t)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(lo, state, 2)
    tl = lora.lora_init(params, rank=4, generator=torch.Generator().manual_seed(8))
    rl, rs, at = mgr.restore(tl, opt.init(tl["adapters"]))
    assert at == 2 and rs.count == 2 and (rl["alpha"], rl["rank"]) == (lo["alpha"], lo["rank"])
    for a, b in zip(train._leaves(rl["adapters"]), train._leaves(lo["adapters"])):
        assert torch.equal(a, b)
    want = [float(step(lo, state, params, t)[2]) for t in batches[2:]]
    got = [float(step(rl, rs, params, t)[2]) for t in batches[2:]]
    assert got == want


def test_three_resumed_steps_match_the_references_orbax_resume(tmp_path):
    jcfg = JaxConfig(**CFG)
    tokens = np.random.default_rng(3).integers(0, 128, (5, 4, 17)).astype(np.int32)
    jopt = jax_make_optimizer(lr=1e-2)
    jp, js = init_sharded_state(jax.random.key(0), jcfg, jopt, None)
    port_p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    port_s = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    jstep = make_jitted_train_step(jcfg, jopt, None)
    for t in tokens[:2]:
        jp, js, _ = jstep(jp, js, jax.numpy.asarray(t))
    ref_mgr = RefManager(str(tmp_path / "orbax"))
    ref_mgr.save(jp, js, 2)
    jp_t, js_t = init_sharded_state(jax.random.key(9), jcfg, jopt, None)
    jp, js, _ = ref_mgr.restore(jp_t, js_t)
    ref_mgr.close()
    want = []
    for t in tokens[2:]:
        jp, js, loss = jstep(jp, js, jax.numpy.asarray(t))
        want.append(float(loss))

    cfg = TransformerConfig(**CFG)
    opt = train.make_optimizer(lr=1e-2)
    port_p, port_s = train.state_for(port_p, opt)[0], port_s
    pstep = train.make_train_step(cfg, opt)
    for t in tokens[:2]:
        pstep(port_p, port_s, torch.from_numpy(t))
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(port_p, port_s, 2)
    tp, ts = train.init_state(cfg, opt, torch.Generator().manual_seed(9), "cpu")
    port_p, port_s, at = mgr.restore(tp, ts)
    assert at == 2
    got = [float(pstep(port_p, port_s, torch.from_numpy(t))[2]) for t in tokens[2:]]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ref_leaves = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    port_leaves = jax.tree.leaves(params_to_numpy(port_p))
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
