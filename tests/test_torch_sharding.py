"""The port's sharding rules and each rank's slice, with no processes.

``param_specs`` must equal the reference's PartitionSpecs leaf for leaf
(dense, MoE, pipelined and ViT trees).  A rank's slice of a leaf
(``sharding.local_slice`` / ``shard_params``) must equal the addressable
shard the reference's ``shard_params`` places on the device that rank
stands for, on the 8-device virtual CPU mesh, strict and fitted
(``_fit_spec``).  The GQA head split under ``tensor``: a rank's query heads
read the KV heads they read unsharded, so its attention output is its
slice of the whole one.
"""

import jax
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig
from elastic_gpu_scheduler_tpu.models.transformer import init_params as jax_init_params
from elastic_gpu_scheduler_tpu.models.vit import ViTConfig as JaxViTConfig
from elastic_gpu_scheduler_tpu.models.vit import init_vit_params
from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh
from elastic_gpu_scheduler_tpu.parallel import sharding as jshard
from elastic_gpu_scheduler_tpu_torch.models import transformer as T
from elastic_gpu_scheduler_tpu_torch.models.bridge import params_from_jax
from elastic_gpu_scheduler_tpu_torch.parallel import mesh as pmesh
from elastic_gpu_scheduler_tpu_torch.parallel import sharding as pshard
from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice

torch.set_num_threads(1)

BASE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            dtype="float32")


def _jax_tree(**kw):
    cfg = JaxConfig(**dict(BASE, **kw))
    return jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), cfg))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [(path, tree)]


def _same_specs(jtree, ptree, **kw):
    want = {p: tuple(s) for p, s in _flat(jshard.param_specs(jtree, **kw))}
    got = dict(_flat(pshard.param_specs(ptree, **kw)))
    assert got == want


@pytest.mark.parametrize("kw", [{}, dict(n_experts=4)], ids=["dense", "moe"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_param_specs_match_reference(kw, pipeline):
    jt = _jax_tree(**kw)
    _same_specs(jt, params_from_jax(jt, "cpu"), pipeline=pipeline)


def test_vit_param_specs_match_reference():
    cfg = JaxViTConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32")
    jt = jax.tree.map(np.asarray, init_vit_params(jax.random.key(0), cfg))
    _same_specs(jt, params_from_jax(jt, "cpu"))


def test_batch_and_activation_specs_match_reference():
    assert pshard.batch_spec() == tuple(jshard.batch_spec())
    assert pshard.activation_spec() == tuple(jshard.activation_spec())


MESHES = [dict(data=2, fsdp=2, tensor=2), dict(tensor=4, seq=2), dict(fsdp=4, tensor=2),
          dict(fsdp=8), dict(data=2, tensor=2, seq=2)]


@pytest.mark.parametrize("kw", MESHES, ids=str)
@pytest.mark.parametrize("strict", [True, False])
def test_rank_slices_are_the_addressable_shards(kw, strict):
    """Every leaf, every rank: the port's slice equals the shard the
    reference places on that rank's device.  The fitted mode on a vocab
    (97) that no axis divides: those leaves replicate."""
    vocab = 128 if strict else 97
    jt = _jax_tree(vocab_size=vocab)
    jm = jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:8])
    pm = pmesh.make_mesh(MeshSpec(**kw), [RankDevice(i) for i in range(8)])
    placed = jshard.shard_params(jt, jm, strict=strict)
    full = params_from_jax(jt, "cpu")
    for rank in range(8):
        mine = dict(_flat(pshard.shard_params(full, pm, strict=strict, rank=rank)))
        for path, arr in _flat(placed):
            shard = next(s for s in arr.addressable_shards if s.device.id == rank)
            np.testing.assert_array_equal(mine[path].numpy(), np.asarray(shard.data),
                                          err_msg=f"{path} rank {rank}")
    for path, sp in _flat(pshard.param_specs(full)):
        leaf = dict(_flat(full))[path]
        assert pshard._fit_spec(sp, pm, leaf.shape) == tuple(
            jshard._fit_spec(jax.sharding.PartitionSpec(*sp), jm, leaf.shape)), path


def test_strict_rules_refuse_what_does_not_divide():
    full = params_from_jax(_jax_tree(vocab_size=97), "cpu")
    pm = pmesh.make_mesh(MeshSpec(tensor=2), [RankDevice(0), RankDevice(1)])
    with pytest.raises(ValueError, match="embed"):
        pshard.shard_params(full, pm, rank=0)


def test_full_leaf_and_local_batch_on_one_rank():
    pm = pmesh.make_mesh(MeshSpec(), [RankDevice(0)]).connect()
    w = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(pshard.full_leaf(w, ("fsdp", "tensor"), pm), w)
    tok = torch.arange(8).reshape(4, 2)
    assert torch.equal(pshard.local_batch(tok, pm), tok)
    m = pmesh.make_mesh(MeshSpec(data=2, fsdp=2), [RankDevice(i) for i in range(4)])
    m.rank = 2  # the batch row block of (data 1, fsdp 0)
    assert pshard.local_batch(tok, m).tolist() == [[4, 5]]


@pytest.mark.parametrize("tp", [2, 4])
def test_gqa_heads_split_under_tensor(tp):
    """16 query / 8 KV heads: each tensor rank's column slices of wq / wk /
    wv give the query heads whose KV heads it holds, so its local
    attention output is exactly its heads' slice of the whole output."""
    cfg = T.TransformerConfig(vocab_size=64, d_model=128, n_layers=1, n_heads=16,
                              n_kv_heads=8, d_ff=64, dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pm = pmesh.make_mesh(MeshSpec(tensor=tp), [RankDevice(i) for i in range(tp)])
    x = torch.randn(2, 10, 128, generator=torch.Generator().manual_seed(1))
    lp = T.layer_slice(params["layers"], 0)
    B, S, Dh = 2, 10, cfg.head_dim

    def heads(p, hq, hkv):
        q = (x @ p["wq"]).reshape(B, S, hq, Dh)
        k = (x @ p["wk"]).reshape(B, S, hkv, Dh)
        v = (x @ p["wv"]).reshape(B, S, hkv, Dh)
        c = T.TransformerConfig(n_heads=hq, n_kv_heads=hkv, d_model=hq * Dh, dtype="float32")
        return T._attention(q, k, v, c)

    whole = heads(lp, 16, 8)
    specs = pshard.param_specs(params)["layers"]
    for rank in range(tp):
        mine = {n: pshard.local_slice(params["layers"][n], specs[n], pm, rank)[0]
                for n in ("wq", "wk", "wv")}
        got = heads(mine, 16 // tp, 8 // tp)
        lo = rank * 16 // tp
        torch.testing.assert_close(got, whole[:, :, lo:lo + 16 // tp], rtol=0, atol=1e-6)
