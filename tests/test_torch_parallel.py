"""The port on a mesh of CPU ranks over gloo, against the reference on the
8-device virtual CPU mesh.

Each test starts its ranks once (``parallel/distributed.spawn_ranks``: the
spawn start method, a ``FileStore`` rendezvous under ``tmp_path``, so
parallel pytest workers never share a port) and runs several meshes in
them; meshes on disjoint ranks run side by side (every rank connects
every mesh: torch makes a process group with the whole world).  The ranks import torch and the
port only: JAX runs in the test process, which holds each rank's slices
against the reference's whole arrays cut the port's way.

- ring attention (seq 2 and 4) and the tensor-parallel loss (tensor 2 and
  4): values and gradients within 1e-5 of the reference's
  ``ring_attention_sharded`` / ``chunked_softmax_xent_tp``, the ring also
  against plain attention;
- a train step's loss and gradients, then 3 AdamW steps (losses and
  parameters), on data=2, fsdp=2, tensor=2, seq=2 (ring), fsdp=2,tensor=2,
  seq=2,tensor=2 (ring) and fsdp=2,seq=2 (ring), and on tensor=2 with the
  dense loss and seq=2 without the ring: within 1e-5 (float32) of the reference's
  ``make_jitted_train_step`` on the same MeshSpec and of the port's
  single-device step;
- a two-process gang from bind annotations;
- elastic resume through ``launcher.run_job``: tensor=2 → one rank, and
  data=2 → tensor=2, against the uninterrupted trajectory.
"""

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu_torch import launcher
from elastic_gpu_scheduler_tpu_torch.models import train
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.ops.attention import mha_reference
from elastic_gpu_scheduler_tpu_torch.ops.xent import chunked_softmax_xent_tp
from elastic_gpu_scheduler_tpu_torch.parallel import collectives as C
from elastic_gpu_scheduler_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    spawn_ranks,
)
from elastic_gpu_scheduler_tpu_torch.parallel.mesh import (
    ANNOTATION_GANG_PEERS,
    ANNOTATION_GANG_RANK,
    MeshSpec,
    RankDevice,
    gang_mesh,
    make_mesh,
)
from elastic_gpu_scheduler_tpu_torch.parallel.ring import ring_attention
from elastic_gpu_scheduler_tpu_torch.parallel.sharding import (
    leaf_specs,
    local_batch,
    local_slice,
    shard_params,
)

TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT = 240  # seconds a spawn of ranks may take before it is killed


def _join(rank, world, rendezvous):
    torch.set_num_threads(1)
    maybe_initialize_distributed(rendezvous, world, rank, backend="gloo", local_rank=rank,
                                 local_ranks=world, cpu=True)


def _mesh(kw, ranks):
    return make_mesh(MeshSpec(**kw), [RankDevice(r) for r in ranks]).connect()


def _spawn(tmp_path, fn, world, *args):
    return spawn_ranks(fn, world, args, rendezvous=f"file://{tmp_path / 'rendezvous'}",
                       timeout_s=SPAWN_TIMEOUT)


# -- ring attention and the tensor-parallel loss ---------------------------------

RING_MESHES = {"seq4": dict(seq=4), "seq2": dict(data=2, seq=2)}
XENT_MESHES = {"tensor4": dict(tensor=4), "tensor2": dict(data=2, tensor=2)}
XENT_CHUNKS = 8


def _ops_worker(rank, world, rendezvous, ring_in, xent_in):
    _join(rank, world, rendezvous)
    out = {}
    q, k, v, do = (torch.from_numpy(a) for a in ring_in)
    for name, kw in RING_MESHES.items():
        m = _mesh(kw, range(world))
        n, i = m.shape["seq"], m.axis_index("seq")
        s = q.shape[2] // n
        ql, kl, vl = (t[:, :, i * s:(i + 1) * s].clone().requires_grad_(True) for t in (q, k, v))
        o = ring_attention(ql, kl, vl, m)
        (o * do[:, :, i * s:(i + 1) * s]).sum().backward()
        out[name] = (i, o.detach().numpy(), ql.grad.numpy(), kl.grad.numpy(), vl.grad.numpy())
    x, w, t = (torch.from_numpy(a) for a in xent_in)
    for name, kw in XENT_MESHES.items():
        m = _mesh(kw, range(world))
        T_, ti = m.shape["tensor"], m.axis_index("tensor")
        vl_ = w.shape[1] // T_
        xr = x.clone().requires_grad_(True)
        wl = w[:, ti * vl_:(ti + 1) * vl_].clone().requires_grad_(True)
        loss = chunked_softmax_xent_tp(xr, wl, t, XENT_CHUNKS, m)
        loss.backward()
        out[name] = (ti, float(loss), xr.grad.numpy(), wl.grad.numpy())
    return out


def test_ring_attention_and_tp_xent_match_reference(tmp_path):
    import jax
    import jax.numpy as jnp

    from elastic_gpu_scheduler_tpu.ops.xent import chunked_softmax_xent_tp as jax_xent_tp
    from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh
    from elastic_gpu_scheduler_tpu.parallel.ring import ring_attention_sharded

    rng = np.random.default_rng(0)
    B, H, S, D = 2, 3, 32, 8
    ring_in = [rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4)]
    N, Dm, V = 12, 16, 64
    x = rng.standard_normal((N, Dm)).astype(np.float32)
    w = (rng.standard_normal((Dm, V)) * 0.5).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[3], t[7] = -1, V + 5  # ignored targets
    res = _spawn(tmp_path, _ops_worker, 4, ring_in, (x, w, t))

    q, k, v, do = (jnp.asarray(a) for a in ring_in)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in ring_in[:3])
    plain = mha_reference(qt, kt, vt, causal=True)[0]
    (plain * torch.from_numpy(ring_in[3])).sum().backward()
    plain_all = [plain.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()]
    for name, kw in RING_MESHES.items():
        jm = jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:4])
        @jax.jit
        def fwd_bwd(a, b, c, g, jm=jm):
            out, vjp = jax.vjp(lambda a, b, c: ring_attention_sharded(a, b, c, jm), a, b, c)
            return (out,) + vjp(g)

        want = [np.asarray(x) for x in fwd_bwd(q, k, v, do)]
        n = kw["seq"]
        s = S // n
        for rank_out in res:
            i, *got = rank_out[name]
            for g, wnt, pl in zip(got, want, plain_all):
                np.testing.assert_allclose(g, wnt[:, :, i * s:(i + 1) * s], **TOL)
                np.testing.assert_allclose(g, pl[:, :, i * s:(i + 1) * s], **TOL)

    for name, kw in XENT_MESHES.items():
        jm = jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:4])
        loss, (gx, gw) = jax.jit(jax.value_and_grad(
            lambda a, b: jax_xent_tp(a, b, jnp.asarray(t), XENT_CHUNKS, jm), argnums=(0, 1)))(
            jnp.asarray(x), jnp.asarray(w))
        T_ = kw["tensor"]
        for rank_out in res:
            ti, l_, dx, dw = rank_out[name]
            assert l_ == pytest.approx(float(loss), rel=1e-6)
            np.testing.assert_allclose(dx, np.asarray(gx), **TOL)
            vl_ = V // T_
            np.testing.assert_allclose(dw, np.asarray(gw)[:, ti * vl_:(ti + 1) * vl_], **TOL)


def test_tp_xent_rejects_what_the_reference_rejects():
    m = make_mesh(MeshSpec(tensor=2), [RankDevice(0), RankDevice(1)])
    x, w, t = torch.zeros(4, 8), torch.zeros(8, 12), torch.zeros(4, dtype=torch.long)
    for n_chunks in (3, 10):  # not a multiple of tensor; V/T = 12 not divisible by 5
        with pytest.raises(ValueError, match="xent_chunks"):
            chunked_softmax_xent_tp(x, w, t, n_chunks, m)


# -- train steps on seven meshes ----------------------------------------------------

BASE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
            dtype="float32", remat=True, xent_chunks=4)
CFGS = {
    "chunked": BASE,
    "ring": dict(BASE, use_ring_attention=True),
    "dense": dict(BASE, xent_chunks=0, remat=False),
    "window": dict(BASE, window_size=5),
}
OPT = dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
# rounds of (name, mesh, ranks, config); meshes of one round run side by side
ROUNDS = [
    [("data=2", dict(data=2), (0, 1), "chunked"), ("fsdp=2", dict(fsdp=2), (2, 3), "chunked")],
    [("tensor=2", dict(tensor=2), (0, 1), "chunked"), ("seq=2", dict(seq=2), (2, 3), "ring")],
    [("fsdp=2,tensor=2", dict(fsdp=2, tensor=2), (0, 1, 2, 3), "chunked")],
    [("seq=2,tensor=2", dict(seq=2, tensor=2), (0, 1, 2, 3), "ring")],
    [("fsdp=2,seq=2", dict(fsdp=2, seq=2), (0, 1, 2, 3), "ring")],
    [("tensor=2 dense loss", dict(tensor=2), (0, 1), "dense"),
     ("seq=2 gathered keys", dict(seq=2), (2, 3), "window")],
]
STEPS = 3


def _flat(tree):
    return [tree] if not isinstance(tree, dict) else [x for k in sorted(tree) for x in _flat(tree[k])]


def _train_worker(rank, world, rendezvous, init_trees, tokens):
    _join(rank, world, rendezvous)
    out = {}
    for rnd in ROUNDS:
        # every rank connects every mesh (process groups are made by the world)
        meshes = [_mesh(kw, ranks) for _, kw, ranks, _ in rnd]
        for (name, kw, ranks, cfg_name), m in zip(rnd, meshes):
            if rank not in ranks:
                continue
            cfg = TransformerConfig(**CFGS[cfg_name])
            opt = train.make_optimizer(**OPT)
            params, state = train.state_for(
                shard_params(params_from_jax(init_trees[cfg_name], "cpu"), m), opt)
            tok = local_batch(torch.from_numpy(tokens), m)
            specs = train._leaves(leaf_specs(params, m))
            _, grads = train._grads_of(params, tok, cfg, 1, m)
            grads = train.reduce_grads(grads, specs, m)
            grads = train._unflatten(params, grads)
            step = train.make_train_step(cfg, opt, m)
            losses = [float(step(params, state, tok)[2]) for _ in range(STEPS)]
            out[name] = dict(losses=losses,
                             grads=[g.detach().numpy() for g in _flat(grads)],
                             params=[p.detach().numpy() for p in _flat(params)])
    return out


def test_train_steps_on_meshes_match_reference(tmp_path):
    import jax
    import jax.numpy as jnp

    from elastic_gpu_scheduler_tpu.models import train as jtrain
    from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig
    from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh
    from elastic_gpu_scheduler_tpu_torch.models.data import SyntheticTokenDataset, batches

    tokens = next(batches(SyntheticTokenDataset(128, seed=3), 4, 16, seed=4))
    init_trees = {n: jax.tree.map(np.asarray, jtrain.init_params(jax.random.key(5), JaxConfig(**c)))
                  for n, c in CFGS.items()}
    res = _spawn(tmp_path, _train_worker, 4, init_trees, tokens)

    # the port on one device, from the same weights and tokens
    single = {}
    for n, c in CFGS.items():
        opt = train.make_optimizer(**OPT)
        params, state = train.state_for(params_from_jax(init_trees[n], "cpu"), opt)
        step = train.make_train_step(TransformerConfig(**c), opt)
        single[n] = ([float(step(params, state, torch.from_numpy(tokens))[2])
                      for _ in range(STEPS)], params)

    for rnd in ROUNDS:
        for name, kw, ranks, cfg_name in rnd:
            jcfg = JaxConfig(**CFGS[cfg_name])
            jm = jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:len(ranks)])
            opt = jtrain.make_optimizer(**OPT)
            jp, js = jtrain.init_sharded_state(jax.random.key(5), jcfg, opt, jm)
            jtok = jnp.asarray(tokens)
            jgrads = jax.jit(lambda p, t, c=jcfg, m=jm: jax.grad(jtrain.loss_fn)(p, t, c, m))(
                jp, jtok)
            step = jtrain.make_jitted_train_step(jcfg, opt, jm)
            jlosses = []
            for _ in range(STEPS):
                jp, js, loss = step(jp, js, jtok)
                jlosses.append(float(loss))
            pm = make_mesh(MeshSpec(**kw), [RankDevice(r) for r in ranks])
            specs = _flat(leaf_specs(init_trees[cfg_name], pm))
            want_g = [np.asarray(x) for x in _flat(jax.tree.map(np.asarray, jgrads))]
            want_p = [np.asarray(x) for x in _flat(jax.tree.map(np.asarray, jp))]
            one_losses, one_params = single[cfg_name]
            one_p = [p.detach().numpy() for p in _flat(one_params)]
            for r in ranks:
                got = res[r][name]
                np.testing.assert_allclose(got["losses"], jlosses, err_msg=name, **TOL)
                np.testing.assert_allclose(got["losses"], one_losses, err_msg=name, **TOL)

                def mine(full, spec, r=r):
                    return local_slice(torch.from_numpy(np.array(full)), spec, pm, r).numpy()

                for g, w, sp in zip(got["grads"], want_g, specs):
                    np.testing.assert_allclose(g, mine(w, sp), err_msg=f"{name} grad", **TOL)
                for p, w, o, sp in zip(got["params"], want_p, one_p, specs):
                    np.testing.assert_allclose(p, mine(w, sp), err_msg=f"{name} param", **TOL)
                    np.testing.assert_allclose(p, mine(o, sp), err_msg=f"{name} param", **TOL)


# -- a gang from bind annotations ------------------------------------------------------


def _gang_worker(rank, world, rendezvous):
    torch.set_num_threads(1)
    ann = {ANNOTATION_GANG_RANK: str(rank),
           ANNOTATION_GANG_PEERS: "default/member-0,default/member-1"}
    m = gang_mesh(MeshSpec(data=2), ann, coordinator=rendezvous, backend="gloo",
                  cpu=True).connect()
    local = (torch.arange(4, dtype=torch.float32) + 1.0) * (1 + m.rank)
    total = float(C.all_reduce(local, m, "data").sum())
    return m.rank, m.ranks.reshape(-1).tolist(), total


def test_two_process_gang_from_bind_annotations(tmp_path):
    """Each member joins as its gang rank with peer 0 as the rendezvous
    (here a file), builds the gang mesh and sums over it: both agree."""
    res = _spawn(tmp_path, _gang_worker, 2)
    assert [r[0] for r in res] == [0, 1]
    assert all(r[1] == [0, 1] for r in res)
    assert [r[2] for r in res] == [30.0, 30.0]  # (1+2+3+4) * (1+2)


# -- elastic resume through the launcher -------------------------------------------------

JOB_MODEL = dict(BASE, remat=False)


def _job(steps, ckpt="", mesh=None):
    return launcher.JobSpec(model=TransformerConfig(**JOB_MODEL), mesh=mesh or MeshSpec(),
                            steps=steps, batch_size=4, seq_len=16, lr=1e-2, seed=7,
                            checkpoint_dir=ckpt, checkpoint_every=2 if ckpt else 0)


def _elastic_worker(rank, world, rendezvous, dirs):
    _join(rank, world, rendezvous)
    t2, d2 = MeshSpec(tensor=2), MeshSpec(data=2)
    out = {"tensor": launcher.run_job(_job(4, mesh=t2), device="cpu")}
    launcher.run_job(_job(2, dirs["tensor"], t2), device="cpu")  # saved at step 2
    out["data"] = launcher.run_job(_job(4, mesh=d2), device="cpu")
    launcher.run_job(_job(2, dirs["data"], d2), device="cpu")
    out["data->tensor"] = launcher.run_job(_job(4, dirs["data"], t2), device="cpu")
    return out


def test_elastic_resume_across_meshes(tmp_path):
    dirs = {"tensor": str(tmp_path / "ck_tensor"), "data": str(tmp_path / "ck_data")}
    res = _spawn(tmp_path, _elastic_worker, 2, dirs)
    assert res[0] == res[1]  # every rank reports the global losses
    full_t = res[0]["tensor"]
    assert len(full_t) == 4
    # tensor=2 → one rank (this process, no process group)
    resumed = launcher.run_job(_job(4, dirs["tensor"]), device="cpu")
    np.testing.assert_allclose(resumed, full_t[2:], **TOL)
    # data=2 → tensor=2
    full_d = res[0]["data"]
    np.testing.assert_allclose(res[0]["data->tensor"], full_d[2:], **TOL)
    # the three uninterrupted trajectories are one trajectory
    np.testing.assert_allclose(full_t, full_d, **TOL)
    np.testing.assert_allclose(full_t, launcher.run_job(_job(4), device="cpu"), **TOL)
