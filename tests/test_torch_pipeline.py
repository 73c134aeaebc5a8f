"""The pipe axis: the port's GPipe schedule (``parallel/pipeline.py``) on
CPU ranks over gloo, against the reference on the 8-device virtual CPU
mesh.

One spawn of 4 ranks (a module fixture) trains every mesh below from the
reference's weights: a first step's gradients (summed as the step sums
them), then 3 AdamW steps.  Each mesh's test holds every rank's losses,
gradient slices and parameter slices within 1e-5 (float32) of the
reference's ``make_jitted_train_step`` on the same MeshSpec and of the
port on one device, and every leaf that two ranks hold alike across
``pipe`` (the embedding, the final norm, the unembedding; every leaf when
the layers are replicated) bitwise equal on them.  The meshes: pipe=2
with 2 and 4 microbatches, data=2,pipe=2, pipe=2,tensor=2, fsdp=2,pipe=2,
pipe=2,seq=2 with the ring inside the stages, and pipe=2 with no
microbatches (the layers replicated over pipe).

One process: ``microbatch`` and its error; rank slices under
``pipeline=True`` (dense, MoE and ViT trees) equal the reference's
addressable shards; ``n_microbatches`` on one device equals the
reference's plain path; the mesh checks that stay; the ViT step with a
mesh equals the step without one.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu_torch.models import train
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, pipelined
from elastic_gpu_scheduler_tpu_torch.parallel.collectives import axes_of
from elastic_gpu_scheduler_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    spawn_ranks,
)
from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice, make_mesh
from elastic_gpu_scheduler_tpu_torch.parallel.pipeline import (
    microbatch,
    share_rows,
    unmicrobatch,
)
from elastic_gpu_scheduler_tpu_torch.parallel.sharding import (
    leaf_specs,
    local_batch,
    local_slice,
    shard_params,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT = 300  # seconds a spawn of ranks may take before it is killed
WORLD = 4
STEPS = 3
# a small rate: AdamW's first updates are about lr x sign(g) whatever |g|, so
# an element whose gradient is near 0 turns a float32 rounding difference
# (the reference's own pipelined and plain gradients differ by ~6e-8) into
# a parameter difference of up to ~lr; at lr 1e-2 the reference's pipelined
# parameters are 1.4e-4 from its plain ones after 3 steps
OPT = dict(lr=1e-4, weight_decay=0.1, grad_clip=0.5)
BASE = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=64,
            dtype="float32", remat=True, xent_chunks=4)
BATCH, SEQ = 8, 16
CFGS = {
    "m2": dict(BASE, n_microbatches=2),
    "m4": dict(BASE, n_microbatches=4, remat=False, xent_chunks=0),
    "ring": dict(BASE, n_microbatches=2, use_ring_attention=True),
    "m2x0": dict(BASE, n_microbatches=0),
}
# rounds of (name, mesh, ranks, config); meshes of one round run side by side
ROUNDS = [
    [("pipe=2 M2", dict(pipe=2), (0, 1), "m2"), ("pipe=2 M4", dict(pipe=2), (2, 3), "m4")],
    [("data=2,pipe=2", dict(data=2, pipe=2), (0, 1, 2, 3), "m2")],
    [("pipe=2,tensor=2", dict(pipe=2, tensor=2), (0, 1, 2, 3), "m2")],
    [("fsdp=2,pipe=2", dict(fsdp=2, pipe=2), (0, 1, 2, 3), "m2")],
    [("pipe=2,seq=2 ring", dict(pipe=2, seq=2), (0, 1, 2, 3), "ring")],
    [("pipe=2 no microbatches", dict(pipe=2), (0, 1), "m2x0")],
]


def _flat(tree):
    return [tree] if not isinstance(tree, dict) else [x for k in sorted(tree) for x in _flat(tree[k])]


def _join(rank, world, rendezvous):
    torch.set_num_threads(1)
    maybe_initialize_distributed(rendezvous, world, rank, backend="gloo", local_rank=rank,
                                 local_ranks=world, cpu=True)


def _mesh(kw, ranks):
    return make_mesh(MeshSpec(**kw), [RankDevice(r) for r in ranks])


def train_worker(rank, world, rendezvous, rounds, cfgs, init_trees, tokens):
    """Every mesh of ``rounds`` this rank is in: a first step's summed
    gradients, then STEPS steps' losses and the parameters after them."""
    _join(rank, world, rendezvous)
    out = {}
    for rnd in rounds:
        # every rank connects every mesh (process groups are made by the world)
        meshes = [_mesh(kw, ranks).connect() for _, kw, ranks, _ in rnd]
        for (name, kw, ranks, cfg_name), m in zip(rnd, meshes):
            if rank not in ranks:
                continue
            cfg = TransformerConfig(**cfgs[cfg_name])
            piped = pipelined(cfg, m)
            opt = train.make_optimizer(**OPT)
            params, state = train.state_for(
                shard_params(params_from_jax(init_trees[cfg_name], "cpu"), m, pipeline=piped),
                opt)
            tok = local_batch(torch.from_numpy(tokens), m)
            specs = train._leaves(leaf_specs(params, m, piped))
            _, grads = train._grads_of(params, tok, cfg, 1, m)
            grads = train._unflatten(params, train.reduce_grads(grads, specs, m))
            step = train.make_train_step(cfg, opt, m)
            losses = [float(step(params, state, tok)[2]) for _ in range(STEPS)]
            out[name] = dict(losses=losses,
                             grads=[g.detach().numpy() for g in _flat(grads)],
                             params=[p.detach().numpy() for p in _flat(params)])
    return out


def spawn_and_reference(tmp_path, worker, args, rounds, cfgs, tokens, single_cfgs,
                        more=dict):
    """``worker(rank, world, rendezvous, *args)`` on WORLD spawned ranks
    (from a thread) while this process computes, for every mesh of
    ``rounds``, the reference's ``reference_run``, for the configs in
    ``single_cfgs`` (name → grad_accum) the port on one device, and
    ``more()``: (the ranks' results, references by mesh name (and
    ``more``'s), one-device runs by config name)."""
    box = {}

    def run():
        try:
            box["res"] = spawn_ranks(worker, WORLD, args,
                                     rendezvous=f"file://{tmp_path / 'rendezvous'}",
                                     timeout_s=SPAWN_TIMEOUT)
        except BaseException as e:  # re-raised below
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()
    try:
        refs = {name: reference_run(cfgs[c], kw, len(ranks), tokens)
                for rnd in rounds for name, kw, ranks, c in rnd}
        init_trees = args[2]
        single = {n: single_device_run(cfgs[n], init_trees[n], tokens, accum)
                  for n, accum in single_cfgs.items()}
        refs.update(more())
    finally:
        th.join()
    if "err" in box:
        raise box["err"]
    return box["res"], refs, single


def init_trees_of(cfgs):
    from elastic_gpu_scheduler_tpu.models.transformer import init_params as jax_init_params

    return {n: jax.tree.map(np.asarray, jax_init_params(jax.random.key(5), JaxConfigOf(c)))
            for n, c in cfgs.items()}


def JaxConfigOf(c):
    from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig

    return JaxConfig(**c)


def reference_run(cfg_kw, kw, n_ranks, tokens):
    """The reference on the same MeshSpec: (first-step gradients, STEPS
    losses, parameters after them), all whole."""
    from elastic_gpu_scheduler_tpu.models import train as jtrain
    from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh

    jcfg = JaxConfigOf(cfg_kw)
    jm = jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:n_ranks])
    opt = jtrain.make_optimizer(**OPT)
    jp, js = jtrain.init_sharded_state(jax.random.key(5), jcfg, opt, jm)
    jtok = jnp.asarray(tokens)
    jgrads = jax.jit(lambda p, t: jax.grad(jtrain.loss_fn)(p, t, jcfg, jm))(jp, jtok)
    step = jtrain.make_jitted_train_step(jcfg, opt, jm)
    losses = []
    for _ in range(STEPS):
        jp, js, loss = step(jp, js, jtok)
        losses.append(float(loss))
    return ([np.asarray(x) for x in _flat(jax.tree.map(np.asarray, jgrads))], losses,
            [np.asarray(x) for x in _flat(jax.tree.map(np.asarray, jp))])


def single_device_run(cfg_kw, init_tree, tokens, grad_accum=1):
    """The port on one device: (losses, parameters after STEPS steps)."""
    opt = train.make_optimizer(**OPT)
    params, state = train.state_for(params_from_jax(init_tree, "cpu"), opt)
    step = train.make_train_step(TransformerConfig(**cfg_kw), opt, grad_accum=grad_accum)
    losses = [float(step(params, state, torch.from_numpy(tokens))[2]) for _ in range(STEPS)]
    return losses, [p.detach().numpy() for p in _flat(params)]


def check_mesh(name, kw, ranks, cfg_kw, init_tree, res, want, single=None,
               replica_axes=("pipe",)):
    """Every rank's losses, gradient slices and parameter slices against
    ``want``, the reference's ``reference_run`` (and ``single``, the port on
    one device, when given); every leaf two ranks hold alike across
    ``replica_axes`` bitwise equal."""
    want_g, want_losses, want_p = want
    pm = _mesh(kw, ranks)
    piped = pipelined(TransformerConfig(**cfg_kw), pm)
    specs = _flat(leaf_specs(init_tree, pm, piped))

    def mine(full, spec, r):
        return local_slice(torch.from_numpy(np.array(full)), spec, pm, r).numpy()

    for r in ranks:
        got = res[r][name]
        np.testing.assert_allclose(got["losses"], want_losses, err_msg=name, **TOL)
        if single is not None:
            np.testing.assert_allclose(got["losses"], single[0], err_msg=name, **TOL)
        for g, w, sp in zip(got["grads"], want_g, specs):
            np.testing.assert_allclose(g, mine(w, sp, r), err_msg=f"{name} grad", **TOL)
        for i, (p, w, sp) in enumerate(zip(got["params"], want_p, specs)):
            np.testing.assert_allclose(p, mine(w, sp, r), err_msg=f"{name} param", **TOL)
            if single is not None:
                np.testing.assert_allclose(p, mine(single[1][i], sp, r),
                                           err_msg=f"{name} param", **TOL)
    # leaves held alike across the replica axes: the same bytes
    held_by = {}
    for r in ranks:
        c = list(pm.coords(r))
        for a in replica_axes:
            c[list(pm.axis_names).index(a)] = 0
        held_by.setdefault(tuple(c), []).append(r)
    for group in held_by.values():
        for i, sp in enumerate(specs):
            if any(a in replica_axes for ax in sp for a in axes_of(ax)):
                continue
            first = res[group[0]][name]["params"][i]
            for r in group[1:]:
                np.testing.assert_array_equal(res[r][name]["params"][i], first,
                                              err_msg=f"{name} leaf {i} rank {r}")


def _tokens():
    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches

    return next(batches(SyntheticTokenDataset(128, seed=3), BATCH, SEQ, seed=4))


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    tokens = _tokens()
    init_trees = init_trees_of(CFGS)
    res, refs, single = spawn_and_reference(
        tmp_path_factory.mktemp("pipe"), train_worker, (ROUNDS, CFGS, init_trees, tokens),
        ROUNDS, CFGS, tokens, dict.fromkeys(CFGS, 1))
    return res, init_trees, refs, single


@pytest.mark.parametrize("case", [c for rnd in ROUNDS for c in rnd], ids=lambda c: c[0])
def test_pipe_meshes_match_reference_and_one_device(pipe_runs, case):
    res, init_trees, refs, single = pipe_runs
    name, kw, ranks, cfg_name = case
    check_mesh(name, kw, ranks, CFGS[cfg_name], init_trees[cfg_name], res, refs[name],
               single=single[cfg_name])


# -- one process ---------------------------------------------------------------------


def test_microbatch_round_trips_and_names_the_batch():
    from elastic_gpu_scheduler_tpu.parallel.pipeline import microbatch as jax_microbatch

    x = torch.arange(6 * 5).reshape(6, 5)
    m = microbatch(x, 3)
    assert tuple(m.shape) == (3, 2, 5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jax_microbatch(jnp.asarray(x.numpy()), 3)))
    assert torch.equal(unmicrobatch(m), x)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        microbatch(x, 4)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        jax_microbatch(jnp.zeros((6, 5)), 4)


PIPE_MESHES = [dict(data=2, pipe=2, tensor=2), dict(fsdp=2, pipe=2, seq=2),
               dict(expert=2, pipe=2, tensor=2), dict(data=2, expert=4)]


@pytest.mark.parametrize("kw", PIPE_MESHES, ids=str)
@pytest.mark.parametrize("tree", ["dense", "moe", "vit"])
def test_pipeline_and_expert_slices_are_the_addressable_shards(kw, tree):
    """``shard_params(pipeline=True)``: every leaf's slice on every rank is
    the shard the reference's ``shard_params(pipeline=True)`` places on
    that rank's device, expert-stacked 4-d leaves included, and
    ``leaf_specs`` names the reference's specs with the mesh's unit axes
    dropped."""
    from elastic_gpu_scheduler_tpu.models.transformer import init_params as jax_init_params
    from elastic_gpu_scheduler_tpu.models.vit import ViTConfig, init_vit_params
    from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh
    from elastic_gpu_scheduler_tpu.parallel import sharding as jshard

    if tree == "vit":
        jt = init_vit_params(jax.random.key(0), ViTConfig(d_model=32, n_layers=4, n_heads=2,
                                                          d_ff=64, dtype="float32"))
    else:
        jt = jax_init_params(jax.random.key(0), JaxConfigOf(
            dict(BASE, n_experts=4 if tree == "moe" else 0)))
    jt = jax.tree.map(np.asarray, jt)
    n = MeshSpec(**kw).num_devices
    jm = jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:n])
    pm = _mesh(kw, range(n))
    placed = jshard.shard_params(jt, jm, pipeline=True)
    full = params_from_jax(jt, "cpu")
    specs = _flat(leaf_specs(full, pm, pipeline=True))
    want_specs = _flat(jshard.param_specs(jt, pipeline=True))
    for sp, w in zip(specs, want_specs):
        assert sp == tuple(ax if pm.axes_size(axes_of(ax)) > 1 else None for ax in w)
    for rank in range(n):
        mine = _flat(shard_params(full, pm, pipeline=True, rank=rank))
        for got, arr in zip(mine, _flat(placed)):
            shard = next(s for s in arr.addressable_shards if s.device.id == rank)
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_n_microbatches_on_one_device_is_the_plain_path():
    """The reference runs its plain scan when there is no pipe axis past 1;
    so does the port, and a serving engine takes such a config too."""
    from elastic_gpu_scheduler_tpu.models import train as jtrain
    from elastic_gpu_scheduler_tpu.models.transformer import init_params as jax_init_params
    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.models.transformer import forward

    cfg_kw = CFGS["m2"]
    jcfg = JaxConfigOf(cfg_kw)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.key(5), jcfg))
    tokens = _tokens()
    opt = jtrain.make_optimizer(**OPT)
    jparams, jstate = jtrain.init_sharded_state(jax.random.key(5), jcfg, opt)
    step = jtrain.make_jitted_train_step(jcfg, opt)
    want = []
    for _ in range(STEPS):
        jparams, jstate, loss = step(jparams, jstate, jnp.asarray(tokens))
        want.append(float(loss))
    got, params = single_device_run(cfg_kw, jp, tokens)
    np.testing.assert_allclose(got, want, **TOL)
    for p, w in zip(params, _flat(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(p, w, **TOL)
    cfg = TransformerConfig(**cfg_kw)
    plain = TransformerConfig(**dict(cfg_kw, n_microbatches=0))
    tp = params_from_jax(jp, "cpu")
    tok = torch.from_numpy(tokens[:, :-1])
    assert torch.equal(forward(tp, tok, cfg), forward(tp, tok, plain))
    eng = serving.InferenceEngine(tp, cfg, max_batch=2, max_len=32, page_size=8, device="cpu")
    assert eng.cfg.n_microbatches == 2


def test_mesh_checks_that_stay():
    """What the mesh cannot cut is a ValueError by name; MoE pipelined over
    a batch cut by data or fsdp passes, and a global microbatch its row
    ranks cannot share is a ValueError by name."""
    from elastic_gpu_scheduler_tpu_torch.models.transformer import check_mesh_model

    cfg = TransformerConfig(**CFGS["m2"])
    with pytest.raises(ValueError, match="n_layers=4 not divisible by pipe=3"):
        check_mesh_model(cfg, MeshSpec(pipe=3))
    check_mesh_model(TransformerConfig(**CFGS["m2x0"]), MeshSpec(pipe=3))  # replicated
    moe = TransformerConfig(**dict(CFGS["m2"], n_experts=4))
    with pytest.raises(ValueError, match="n_experts=4 not divisible by expert=3"):
        check_mesh_model(moe, MeshSpec(expert=3))
    check_mesh_model(moe, MeshSpec(data=2, pipe=2))
    check_mesh_model(moe, MeshSpec(fsdp=2, pipe=2))
    check_mesh_model(moe, MeshSpec(expert=2, pipe=2))
    with pytest.raises(ValueError, match="microbatch of 2 rows .* data\\*fsdp=4"):
        share_rows(8, 4, 4, 0)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        share_rows(6, 4, 2, 0)


@pytest.mark.parametrize("batch,n_micro,n", [(8, 2, 2), (8, 2, 4), (12, 3, 2), (8, 1, 2),
                                             (8, 4, 2)], ids=str)
def test_microbatch_shares_cut_the_reference_microbatches(batch, n_micro, n):
    """Row rank i's rows (``share_rows``), microbatched, are block i of every
    one of the reference's microbatches of the global batch, and the ranks'
    rows together are the batch once."""
    from elastic_gpu_scheduler_tpu.parallel.pipeline import microbatch as jax_microbatch

    glob = np.arange(batch * 3).reshape(batch, 3)
    want = np.asarray(jax_microbatch(jnp.asarray(glob), n_micro))
    share = batch // (n_micro * n)
    seen = []
    for i in range(n):
        rows = share_rows(batch, n_micro, n, i)
        got = microbatch(torch.from_numpy(glob[rows]), n_micro).numpy()
        np.testing.assert_array_equal(got, want[:, i * share:(i + 1) * share])
        seen += rows
    assert sorted(seen) == list(range(batch))


def test_local_batch_must_divide_by_the_microbatches(tmp_path):
    """The batch a rank pipelines is its rows: the error names it."""
    res = spawn_ranks(_batch_error_worker, 2, (), timeout_s=SPAWN_TIMEOUT,
                      rendezvous=f"file://{tmp_path / 'rendezvous'}")
    assert all("batch 2 not divisible by 4 microbatches" in r for r in res)


def _batch_error_worker(rank, world, rendezvous):
    _join(rank, world, rendezvous)
    m = _mesh(dict(pipe=2), range(2)).connect()
    cfg = TransformerConfig(**dict(BASE, n_microbatches=4))
    opt = train.make_optimizer()
    params, _ = train.init_sharded_state(cfg, opt, torch.Generator().manual_seed(0), "cpu", m)
    try:
        train.loss_fn(params, torch.zeros((2, 9), dtype=torch.long), cfg, m)
    except ValueError as e:
        return str(e)
    return "no error"


def test_vit_step_with_a_mesh_is_the_step_without():
    from elastic_gpu_scheduler_tpu_torch.models import vit

    cfg = vit.ViTConfig(image_size=16, patch_size=4, n_classes=4, d_model=32, n_layers=2,
                        n_heads=2, d_ff=64, dtype="float32")
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, 4))
    out = []
    for mesh in (None, _mesh(dict(data=2, tensor=2), range(4))):
        params = vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = train.make_optimizer(lr=1e-2)
        state = opt.init(params)
        step = vit.make_vit_train_step(cfg, opt, mesh)
        losses = [float(step(params, state, images, labels)[2]) for _ in range(STEPS)]
        out.append((losses, [p.detach().clone() for p in _flat(params)]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_cli_trains_on_the_pipe_axis(tmp_path):
    """``main --cpu --mesh pipe=2 --n-microbatches 2``: two gloo ranks, the
    reference's default model in the pipeline schedule."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log = tmp_path / "metrics.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.launcher", "--cpu", "--mesh",
         "pipe=2", "--n-microbatches", "2", "--steps", "2", "--batch-size", "4", "--seq-len",
         "16", "--metrics-log", str(log)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'pipe': 2" in out.stderr and "trained 2 steps" in out.stdout
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and np.isfinite([r["loss"] for r in recs]).all()
