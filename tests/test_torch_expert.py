"""The expert axis, LoRA on a mesh and elastic resumes across the new axes:
the port on CPU ranks over gloo, against the reference on the 8-device
virtual CPU mesh.

One spawn of 4 ranks (a module fixture) runs everything below.

- A MoE model (E 4, capacity factor 1.0, so tokens drop) on expert=2,
  data=2,expert=2, expert=2,tensor=2 and seq=2,expert=2 (the routing is the
  whole batch's: global capacity, global queue order), expert=2,pipe=2,
  data=2,pipe=2 and fsdp=2,pipe=2 (the reference routes each global
  microbatch: its one-device equal is the step that accumulates the same
  microbatches, ``grad_accum`` 2; over data or fsdp each rank pipelines
  its share of every global microbatch) and
  pipe=2,seq=2 with the ring (each seq shard routes its own tokens inside
  the stage, as the reference's manual region does: no one-device equal);
  a dense model on expert=2 (replicated).  Every rank's losses, gradient
  slices and parameter slices over 3 steps within 1e-5 of the reference's
  jitted step on the same MeshSpec and of the port on one device where it
  has an equal; leaves held alike across ``expert`` and ``pipe`` bitwise
  equal.
- LoRA on data=2, fsdp=2 and tensor=2 against the reference's
  ``make_lora_train_step(mesh)``: losses, the adapters' first gradients and
  the adapters after 3 steps within 1e-5, the adapters bitwise equal on
  every rank.
- ``launcher.run_job`` saved on pipe=2 (pipelined) and on expert=2 (MoE) at
  step 2 of 4, resumed on one device (and the pipe=2 job on tensor=2):
  within 1e-5 of the uninterrupted run; ``main --cpu`` on ``--mesh
  pipe=2`` and ``--mesh expert=2`` trains.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu_torch import launcher
from elastic_gpu_scheduler_tpu_torch.models import lora, train
from elastic_gpu_scheduler_tpu_torch.models.bridge import lora_from_jax, params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.parallel.collectives import all_reduce_flat
from elastic_gpu_scheduler_tpu_torch.parallel.distributed import spawn_ranks
from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec
from elastic_gpu_scheduler_tpu_torch.parallel.sharding import local_batch, shard_params
from test_torch_pipeline import (
    BASE,
    OPT,
    SPAWN_TIMEOUT,
    STEPS,
    TOL,
    JaxConfigOf,
    _flat,
    _join,
    _mesh,
    _tokens,
    check_mesh,
    init_trees_of,
    spawn_and_reference,
    train_worker,
)

torch.set_num_threads(1)

MOE = dict(BASE, n_experts=4, capacity_factor=1.0)
CFGS = {
    "moe": MOE,
    "moe_piped": dict(MOE, n_microbatches=2),
    "moe_ring": dict(MOE, n_microbatches=2, use_ring_attention=True),
    "dense": BASE,
}
ROUNDS = [
    [("expert=2", dict(expert=2), (0, 1), "moe"),
     ("expert=2 dense", dict(expert=2), (2, 3), "dense")],
    [("data=2,expert=2", dict(data=2, expert=2), (0, 1, 2, 3), "moe")],
    [("expert=2,tensor=2", dict(expert=2, tensor=2), (0, 1, 2, 3), "moe")],
    [("seq=2,expert=2", dict(seq=2, expert=2), (0, 1, 2, 3), "moe")],
    [("expert=2,pipe=2", dict(expert=2, pipe=2), (0, 1, 2, 3), "moe_piped")],
    [("data=2,pipe=2", dict(data=2, pipe=2), (0, 1, 2, 3), "moe_piped")],
    [("fsdp=2,pipe=2", dict(fsdp=2, pipe=2), (0, 1, 2, 3), "moe_piped")],
    [("pipe=2,seq=2 ring MoE", dict(pipe=2, seq=2), (0, 1, 2, 3), "moe_ring")],
]
# the one-device step equal to each config's mesh runs (by its grad_accum):
# the reference routes each microbatch on its own, as a step that
# accumulates them does; with the ring inside the stages each seq shard
# routes its own tokens too, which no one-device step does
ONE_DEVICE = {"moe": 1, "dense": 1, "moe_piped": 2}

LORA_CFG = dict(BASE, n_layers=2)
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out")
LORA_MESHES = [("data=2", dict(data=2), (0, 1)), ("fsdp=2", dict(fsdp=2), (2, 3)),
               ("tensor=2", dict(tensor=2), (0, 1))]

JOB_PIPE = dict(BASE, n_microbatches=2, remat=False)
JOB_MOE = dict(MOE, remat=False)


def _job(model, steps, ckpt="", mesh=None):
    return launcher.JobSpec(model=TransformerConfig(**model), mesh=mesh or MeshSpec(),
                            steps=steps, batch_size=4, seq_len=16, lr=1e-2, seed=7,
                            checkpoint_dir=ckpt, checkpoint_every=2 if ckpt else 0)


def _jax_lora(jp):
    from elastic_gpu_scheduler_tpu.models import lora as jlora

    lo = jlora.lora_init(jax.random.key(1), jp, rank=4, targets=LORA_TARGETS)
    for n, (t, ab) in enumerate(lo["adapters"].items()):
        lo["adapters"][t]["b"] = jax.random.normal(jax.random.key(8 + n), ab["b"].shape) * 0.02
    return lo


def _lora_rounds(rank, world, init_tree, lora_np, tokens):
    out = {}
    meshes = [_mesh(kw, ranks).connect() for _, kw, ranks in LORA_MESHES]
    for (name, kw, ranks), m in zip(LORA_MESHES, meshes):
        if rank not in ranks:
            continue
        cfg = TransformerConfig(**LORA_CFG)
        params = shard_params(params_from_jax(init_tree, "cpu"), m)
        lo = lora_from_jax(lora_np, "cpu")
        tok = local_batch(torch.from_numpy(tokens), m)
        leaves = _flat(lo["adapters"])
        for p in leaves:
            p.requires_grad_(True)
        loss = lora.lora_loss_fn(lo, params, tok, cfg, m)
        grads = torch.autograd.grad(loss, leaves)
        grads = all_reduce_flat([g.float() for g in grads], m,
                                train.BATCH_AXES + ("tensor",))
        opt = train.make_optimizer(**OPT)
        state = opt.init(lo["adapters"])
        step = lora.make_lora_train_step(cfg, opt, m)
        losses = [float(step(lo, state, params, tok)[2]) for _ in range(STEPS)]
        out[name] = dict(losses=losses, grads=[g.numpy() for g in grads],
                         adapters=[a.detach().numpy() for a in _flat(lo["adapters"])])
    return out


def _elastic_jobs(rank, dirs):
    t2, p2, e2 = MeshSpec(tensor=2), MeshSpec(pipe=2), MeshSpec(expert=2)
    out = {"pipe": launcher.run_job(_job(JOB_PIPE, 4, mesh=p2), device="cpu"),
           "moe": launcher.run_job(_job(JOB_MOE, 4, mesh=e2), device="cpu")}
    launcher.run_job(_job(JOB_PIPE, 2, dirs["pipe"], p2), device="cpu")  # saved at step 2
    launcher.run_job(_job(JOB_PIPE, 2, dirs["pipe_t"], p2), device="cpu")
    launcher.run_job(_job(JOB_MOE, 2, dirs["moe"], e2), device="cpu")
    out["pipe->tensor"] = launcher.run_job(_job(JOB_PIPE, 4, dirs["pipe_t"], t2), device="cpu")
    return out


def elastic_worker(rank, world, rendezvous, dirs):
    _join(rank, world, rendezvous)
    return _elastic_jobs(rank, dirs)


@pytest.fixture(scope="module")
def expert_runs(tmp_path_factory):
    from elastic_gpu_scheduler_tpu.models.transformer import init_params as jax_init_params

    tokens = _tokens()
    init_trees = init_trees_of(CFGS)
    lora_base = jax_init_params(jax.random.key(5), JaxConfigOf(LORA_CFG))
    lora_np = jax.tree.map(np.asarray, _jax_lora(lora_base))
    lora_tree = jax.tree.map(np.asarray, lora_base)
    res, refs, single = spawn_and_reference(
        tmp_path_factory.mktemp("expert"), _all_worker,
        (ROUNDS, CFGS, init_trees, tokens, (lora_tree, lora_np, tokens)),
        ROUNDS, CFGS, tokens, ONE_DEVICE,
        more=lambda: {"lora " + name: lora_reference(lora_base, lora_np, kw, len(ranks), tokens)
                      for name, kw, ranks in LORA_MESHES})
    return res, init_trees, refs, single, tokens, (lora_base, lora_np)


def _all_worker(rank, world, rendezvous, rounds, cfgs, init_trees, tokens, lora_in):
    out = train_worker(rank, world, rendezvous, rounds, cfgs, init_trees, tokens)
    out["lora"] = _lora_rounds(rank, world, *lora_in)
    return out


@pytest.mark.parametrize("case", [c for rnd in ROUNDS for c in rnd], ids=lambda c: c[0])
def test_expert_meshes_match_reference(expert_runs, case):
    res, init_trees, refs, single, _, _ = expert_runs
    name, kw, ranks, cfg_name = case
    check_mesh(name, kw, ranks, CFGS[cfg_name], init_trees[cfg_name], res, refs[name],
               single=single.get(cfg_name), replica_axes=("expert", "pipe"))


def lora_reference(jbase, lora_np, kw, n_ranks, tokens):
    """The reference's ``make_lora_train_step(mesh)`` on a sharded base:
    (the adapters' first gradients, STEPS losses, the adapters after)."""
    from elastic_gpu_scheduler_tpu.models import lora as jlora
    from elastic_gpu_scheduler_tpu.models import train as jtrain
    from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh
    from elastic_gpu_scheduler_tpu.parallel import sharding as jshard

    jcfg = JaxConfigOf(LORA_CFG)
    jm = jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:n_ranks])
    jp = jshard.shard_params(jbase, jm)
    jl = jax.tree.map(jnp.asarray, lora_np)
    jtok = jnp.asarray(tokens)

    def jloss(adapters):
        return jlora.lora_loss_fn({**jl, "adapters": adapters}, jp, jtok, jcfg, jm)

    want_g = jax.jit(jax.grad(jloss))(jl["adapters"])
    opt = jtrain.make_optimizer(**OPT)
    state = opt.init(jl["adapters"])
    step = jlora.make_lora_train_step(jcfg, opt, jm)
    losses = []
    for _ in range(STEPS):
        jl, state, loss = step(jl, state, jp, jtok)
        losses.append(float(loss))
    return (_flat(jax.tree.map(np.asarray, want_g)), losses,
            _flat(jax.tree.map(np.asarray, jl["adapters"])))


@pytest.mark.parametrize("case", LORA_MESHES, ids=lambda c: c[0])
def test_lora_on_meshes_matches_reference(expert_runs, case):
    res, _, refs, _, _, _ = expert_runs
    name, kw, ranks = case
    want_g, want_losses, want_a = refs["lora " + name]
    first = res[ranks[0]]["lora"][name]
    for r in ranks:
        got = res[r]["lora"][name]
        np.testing.assert_allclose(got["losses"], want_losses, err_msg=name, **TOL)
        for g, w in zip(got["grads"], want_g):
            np.testing.assert_allclose(g, w, err_msg=f"{name} grad", **TOL)
        for a, w, a0 in zip(got["adapters"], want_a, first["adapters"]):
            np.testing.assert_allclose(a, w, err_msg=f"{name} adapter", **TOL)
            np.testing.assert_array_equal(a, a0)


def test_elastic_resume_from_pipe_and_expert_meshes(tmp_path):
    """Saved on pipe=2 (pipelined) and on expert=2 (MoE) at step 2 of 4,
    resumed on one device (and the pipe=2 job on tensor=2): the
    uninterrupted trajectory within 1e-5."""
    dirs = {k: str(tmp_path / k) for k in ("pipe", "pipe_t", "moe")}
    res = spawn_ranks(elastic_worker, 2, (dirs,), timeout_s=SPAWN_TIMEOUT,
                      rendezvous=f"file://{tmp_path / 'rendezvous'}")
    assert res[0] == res[1]  # every rank reports the global losses
    full = res[0]
    np.testing.assert_allclose(full["pipe->tensor"], full["pipe"][2:], **TOL)
    resumed = launcher.run_job(_job(JOB_PIPE, 4, dirs["pipe"]), device="cpu")
    np.testing.assert_allclose(resumed, full["pipe"][2:], **TOL)
    resumed = launcher.run_job(_job(JOB_MOE, 4, dirs["moe"]), device="cpu")
    np.testing.assert_allclose(resumed, full["moe"][2:], **TOL)
    # pipelined and MoE on expert=2 are the one-device trajectories
    np.testing.assert_allclose(full["pipe"], launcher.run_job(_job(JOB_PIPE, 4), device="cpu"),
                               **TOL)
    np.testing.assert_allclose(full["moe"], launcher.run_job(_job(JOB_MOE, 4), device="cpu"),
                               **TOL)


def test_cli_trains_on_the_expert_axis(tmp_path):
    """``main --cpu --mesh expert=2 --n-experts 4``: two gloo ranks, the
    reference's default model as a Switch MoE of 4 experts, 2 a rank."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log = tmp_path / "metrics.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.launcher", "--cpu", "--mesh",
         "expert=2", "--n-experts", "4", "--steps", "2", "--batch-size", "4", "--seq-len",
         "16", "--metrics-log", str(log)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'expert': 2" in out.stderr and "trained 2 steps" in out.stdout
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and np.isfinite([r["loss"] for r in recs]).all()
