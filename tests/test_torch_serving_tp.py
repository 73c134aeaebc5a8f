"""Serving on a mesh: the port's engine on gloo CPU ranks against the
reference engine on one device, float32.

One spawn of 4 ranks (a module fixture) runs every engine below while this
process runs the reference engine (sequential mode, behind
``reference_engine_copies_uploads``) on the same weights and prompts.
Rank 0 submits and drives the engine; the other ranks ``follow`` its
tickets.  Two tensor=2 meshes run side by side on ranks (0, 1) and (2, 3),
then data=2,tensor=2 on all four:

- greedy tokens equal the reference's, and so do its counters
  (``steps_run``, ``prefills_run``, ``spec_passes``, ``spec_accepted``,
  ``spills``), on the gather path, the paged kernel, the paged kernel with
  spec_k 3, int8 KV with 3 heads (attention replicated, the MLP cut),
  prefix cache + chunked prefill, int8 weights, mixed adapters, a draft
  model, a spill and resume, and the overlapped loop;
- every rank's emissions (in order), ``lengths``, tables, free pages and
  counters are equal;
- each rank's weight and pool slices are the reference's addressable
  shards on the device at its mesh position, or whole where the port's
  whole-heads rule replicates;
- the disaggregated verbs through rank 0's tickets: a bundle the
  reference engine exported, imported into tensor=2 and exported again,
  is the same bytes (a dense pool, an int8 pool, the odd-head whole pool)
  and its warm hit gives the reference's tokens; a tensor=2 bundle adopted
  by the reference engine and by the port on one device gives their own
  warm hit's tokens; a geometry or payload refusal lands nothing; pool
  pressure stops both ranks where it stops the reference; sessions
  migrated tensor=2 → one device and one device → tensor=2 keep their
  greedy tokens (the reference's), seeded draws and logprobs (the port's
  unmigrated run's); the ranks' ``_mirror_digest`` agree after each;
- warm-up on a mesh (``compilecache.warmup_engine``; the paged kernel,
  prefix cache + chunked prefill + int8 KV, spec_k 3, int8 weights): the
  lattice's labels are the one-device engine's, every rank runs every
  point (each a ticket's task), the ranks' ``_mirror_digest`` agree after
  each, the pool's pages but the scratch page keep their bytes across the
  warm-up of an engine with live slots, and the tokens after it equal an
  unwarmed mesh engine's and the reference's; a point that raises on a
  follower ends the warm-up in ``error`` on rank 0 and ends the follower's
  ``follow``;
- a mesh without ``tensor`` raises ``ValueError``, the paged kernel over
  heads ``tensor`` does not divide raises, a follower's own call of a
  disaggregated verb, of a warm-up point or of ``submit`` is refused by
  name while rank 0's succeeds;
- after a fault, rank 0's loop sends no further ticket, fails every
  waiting request and later submit, and ``/healthz`` answers 503.

The MoE meshes and ``serve --tensor`` are in ``test_torch_serving_mesh_moe``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.models import serving as jax_serving
from elastic_gpu_scheduler_tpu_torch.compilecache import CompileCache, warmup_engine
from elastic_gpu_scheduler_tpu_torch.models.bridge import lora_from_jax, params_from_jax
from elastic_gpu_scheduler_tpu_torch.models.serving import (
    SCRATCH_PAGE,
    InferenceEngine,
    MeshWarmupError,
    Request,
)
from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig
from elastic_gpu_scheduler_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    spawn_ranks,
)
from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice, make_mesh
from elastic_gpu_scheduler_tpu_torch.utils import kvwire
from test_torch_engine import _CopyingJnp, reference_engine_copies_uploads  # noqa: F401

torch.set_num_threads(1)

WORLD = 4
SPAWN_TIMEOUT = 300  # seconds a spawn of ranks may take before it is killed
CFGS = {
    "dense": dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  d_ff=128, dtype="float32"),
    "odd": dict(vocab_size=97, d_model=48, n_layers=2, n_heads=3, d_ff=96, dtype="float32"),
    "draft": dict(vocab_size=97, d_model=32, n_layers=1, n_heads=2, d_ff=64, dtype="float32"),
}
PROMPTS = [[5, 17, 3], [60, 2, 9, 9], list(range(1, 17)), [42]]
SHARED = list(range(1, 18))  # two full pages of 8
COUNTERS = ("steps_run", "prefills_run", "spec_passes", "spec_accepted", "spills")
BASE = dict(max_batch=4, max_len=64, page_size=8)
LORAS = [("a1", 4, ("wq", "wv", "w_out")), ("a2", 2, ("wk", "wo", "w_in", "w_gate"))]

# name → how it runs: the model (cfg) and its weights (tree, a key of
# ``jax_trees``), engine kwargs shared by both engines, prompts, new
# tokens, and optional flags
DENSE = dict(cfg=CFGS["dense"], tree="dense")
CASES = {
    "gather": dict(DENSE, eng=BASE, keep=True),
    "paged": dict(DENSE, eng=dict(BASE, paged_kernel=True)),
    "paged_spec": dict(DENSE, eng=dict(BASE, paged_kernel=True, spec_k=3)),
    "odd_int8kv": dict(cfg=CFGS["odd"], tree="odd",
                       eng=dict(BASE, max_batch=2, max_len=32, kv_int8=True),
                       prompts=PROMPTS[:2], new=6, keep=True),
    "prefix_chunked": dict(DENSE, eng=dict(BASE, prefix_cache=True, prefill_chunk=4,
                                           paged_kernel=True),
                           prompts=[SHARED + [40], SHARED + [7, 7], [5, 17, 3], SHARED + [9]]),
    "int8_weights": dict(DENSE, tree="dense/int8", eng=BASE, keep=True),
    "adapters": dict(DENSE, eng=dict(BASE, fused_steps=4), adapters=True,
                     prompts=[[5, 17, 3], [5, 17, 3], SHARED + [40], [9], [60, 2, 33, 8]],
                     adapter_of=["", "a1", "a2", "a1", "a2"]),
    "draft": dict(DENSE, eng=dict(BASE, max_len=96, spec_k=3), draft=True,
                  prompts=[[5, 17, 3], [60, 2, 9, 9, 9, 9], list(range(1, 20)), [42, 5]],
                  new=10),
    "spill": dict(DENSE, eng=dict(max_batch=2, max_len=64, page_size=8, n_pages=6,
                                  fused_steps=2), kind="spill"),
    "overlapped": dict(DENSE, eng=BASE, overlap=True),
    "refused": dict(DENSE, eng=dict(BASE, prefix_cache=True), kind="refused"),
    # the disaggregated verbs, each held against the reference engine (the
    # one-device side of each flow runs in the test process)
    "disagg": dict(DENSE, eng=dict(BASE, prefix_cache=True), kind="disagg", pool="dense",
                   full=True),
    "disagg_int8": dict(DENSE, eng=dict(BASE, prefix_cache=True, kv_int8=True),
                        kind="disagg", pool="int8"),
    "disagg_odd": dict(cfg=CFGS["odd"], tree="odd", eng=dict(BASE, prefix_cache=True),
                       kind="disagg", pool="odd"),
    "disagg_pressure": dict(DENSE, eng=dict(BASE, prefix_cache=True, n_pages=4), pool="dense",
                            kind="pressure"),
    # warm-up on the mesh, held against an unwarmed mesh engine and the
    # reference; "fail" plants a fault on the follower's third point
    "warm_paged": dict(DENSE, eng=dict(BASE, paged_kernel=True), kind="warm", fail=True),
    "warm_prefix_int8kv": dict(DENSE, eng=dict(BASE, prefix_cache=True, prefill_chunk=4,
                                               kv_int8=True, paged_kernel=True), kind="warm",
                               prompts=[SHARED + [40], SHARED + [7, 7], [5, 17, 3]]),
    "warm_spec": dict(DENSE, eng=dict(BASE, paged_kernel=True, spec_k=3), kind="warm"),
    "warm_int8_weights": dict(DENSE, tree="dense/int8", eng=BASE, kind="warm"),
}
# rounds of (mesh name, axes, ranks, cases); meshes of one round run side by side
ROUNDS = [
    [("tensor=2 a", dict(tensor=2), (0, 1),
      ["gather", "paged", "paged_spec", "odd_int8kv", "prefix_chunked", "refused",
       "disagg_int8", "disagg_odd", "disagg_pressure", "warm_paged", "warm_spec"]),
     ("tensor=2 b", dict(tensor=2), (2, 3),
      ["int8_weights", "adapters", "draft", "spill", "overlapped", "disagg",
       "warm_prefix_int8kv", "warm_int8_weights"])],
    [("data=2,tensor=2", dict(data=2, tensor=2), (0, 1, 2, 3), ["gather"])],
]
SPILL_PROMPT, SPILL_HIGH = [3, 9, 14, 27, 5, 1, 2, 6], [2, 4, 6, 8, 10, 12, 1, 7]
# the disaggregated flows: a 41-token prefix (5 full pages of 8) the
# reference exports, a suffix after it, and two sessions that migrate
# after one step, one greedy and one seeded with logprobs
LONG = [(7 * i + 3) % 97 for i in range(41)]
SUFFIX = [7, 7, 2]
MIGRANTS = [dict(prompt=list(range(2, 23)), max_new_tokens=16),
            dict(prompt=list(range(5, 26)), max_new_tokens=16, temperature=0.8, top_k=8,
                 seed=777, logprobs=3)]
# the pool each disaggregated case ships: (the model, its weights, kv_int8)
POOLS = {"dense": ("dense", False), "int8": ("dense", True), "odd": ("odd", False)}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _join(rank, world, rendezvous):
    torch.set_num_threads(1)
    maybe_initialize_distributed(rendezvous, world, rank, backend="gloo", local_rank=rank,
                                 local_ranks=world, cpu=True)


def _mesh(kw, ranks):
    return make_mesh(MeshSpec(**kw), [RankDevice(r) for r in ranks])


def _requests(case, request_cls):
    prompts = case.get("prompts", PROMPTS)
    new = case.get("new", 8)
    adapters = case.get("adapter_of", [""] * len(prompts))
    return [request_cls(prompt=list(p), max_new_tokens=new, adapter=a)
            for p, a in zip(prompts, adapters)]


def _port_kwargs(case, trees):
    kw = dict(case["eng"], overlap=case.get("overlap", False))
    if case.get("kind") == "warm":
        kw["compile_cache"] = CompileCache(None)
    if case.get("adapters"):
        kw["adapters"] = {n: lora_from_jax(lo, "cpu") for n, lo in trees["loras"].items()}
    if case.get("draft"):
        kw["draft"] = (params_from_jax(trees["draft"], "cpu"), TransformerConfig(**CFGS["draft"]))
    return kw


def _refusals(eng, mesh, trees):
    """A follower's own call of each disaggregated verb (and of
    ``submit``), as the message it raised; rank 0's calls, as what they
    returned (a resumed session then runs with the round)."""
    out = {}
    hdr, pages = kvwire.decode_bundle(trees["bundles"]["dense"])
    calls = {
        "export_prefix_pages": lambda: eng.export_prefix_pages([1, 2, 3]),
        "import_pages": lambda: eng.import_pages(hdr, pages),
        "migrate_out_bundle": lambda: eng.migrate_out_bundle(0),
        "resume_session": lambda: eng.resume_session({"prompt": [1, 2], "max_new_tokens": 3}),
        "warm_point": lambda: sorted(eng.warm_point("prefill", tpad=8, width=1)["ranks"]),
    }
    for name, call in calls.items():
        try:
            got = call()
            out[name] = ("ok", got if isinstance(got, (dict, list, type(None)))
                         else type(got).__name__)
        except RuntimeError as e:
            out[name] = ("refused", str(e))
    if not eng.leader:
        try:
            eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
        except RuntimeError as e:
            out["follower_submit"] = str(e)
    try:
        InferenceEngine(params_from_jax(trees["odd"], "cpu"), TransformerConfig(**CFGS["odd"]),
                        device="cpu", mesh=mesh, paged_kernel=True)
    except ValueError as e:
        out["paged_kernel_heads"] = str(e)
    return out


def _import_refusals(eng, hdr, pages) -> dict:
    """Rank 0: a bundle of another page size and a cut payload, refused
    before a ticket; what the pool held before and after."""
    def held():
        return (sorted(eng.free_pages), sorted(eng.prefix_entries.values()), eng.kv_imports)

    before, errors = held(), []
    for h, p in ((dict(hdr, page_size=16), pages), (hdr, [(pages[0][0], pages[0][1][:-4])])):
        try:
            eng.import_pages(h, p)
        except ValueError as e:
            errors.append(str(e))
    return {"errors": errors, "unchanged": held() == before}


def _disagg_leader(eng, case, bundles) -> dict:
    """Rank 0 of a disaggregated case: every verb is a direct call, which
    rank 0 sends in a ticket of its own; the followers ``follow``."""
    out = {}
    hdr, pages = kvwire.decode_bundle(bundles[case["pool"]])
    if case.get("kind") == "pressure":
        out["import"] = eng.import_pages(hdr, pages)
        out["cached"] = len(eng.cached_prefix_pages(LONG))
        return out
    out["import"] = eng.import_pages(hdr, pages)
    out["round_trip"] = eng.export_prefix_pages(LONG)
    warm = eng.submit(Request(prompt=LONG + SUFFIX, max_new_tokens=8))
    hits = eng.prefix_hit_tokens
    eng.run_until_idle(max_steps=100_000)
    out["warm"] = (warm.output, eng.prefix_hit_tokens - hits, warm.error)
    if not case.get("full"):
        return out
    out["refusals"] = _import_refusals(eng, hdr, pages)
    primed = eng.submit(Request(prompt=list(SHARED), max_new_tokens=2))
    eng.run_until_idle(max_steps=100_000)
    out["export"] = (eng.export_prefix_pages(SHARED), primed.error)
    # sessions out to one device after one step of this mesh ...
    reqs = [eng.submit(Request(**m)) for m in MIGRANTS]
    eng.exchange_ticket()
    eng.round()
    lost = eng.chunks_discarded
    out["sessions"] = [eng.migrate_out_bundle(i) for i in range(len(reqs))]
    out["lost"] = eng.chunks_discarded - lost
    # ... and in from one device
    resumed = []
    for data in bundles["sessions"]:
        h, p = kvwire.decode_bundle(data)
        if p:
            eng.import_pages(h, p)
        resumed.append(eng.resume_session(h["request"]))
    eng.run_until_idle(max_steps=100_000)
    out["resumed"] = [(r.output, r.token_logprobs, r.top_logprobs, r.error) for r in resumed]
    return out


def _watch_warmup(eng) -> dict:
    """Record on this rank every lattice point it runs, the mirror digest
    after each, and the pool's pages but the scratch page before the
    first and after the last."""
    seen = {"points": [], "digests": []}
    warm, task = eng._warm, eng._warm_task

    def pages():
        return {k: v[:, SCRATCH_PAGE + 1:].clone() for k, v in eng.kv.items()}

    def logged(**point):
        seen["points"].append(point)
        warm(**point)

    def run_task(t):
        seen.setdefault("before", pages())
        got = task(t)
        seen["digests"].append(eng._mirror_digest().hex())
        seen["after"] = pages()
        return got

    eng._warm, eng._warm_task = logged, run_task
    return seen


def _lead(eng, fn):
    """``fn()`` on rank 0, then the stop ticket; a follower follows."""
    if not eng.leader:
        eng.follow()
        return None
    got = fn()
    eng.stop_followers()
    return got


def _warm_case(eng, case, mesh, trees) -> dict:
    """A warm case: an unwarmed mesh engine's tokens; ``eng`` warmed
    after two rounds of its batch (its slots live), then run to the end;
    with "fail", an engine whose follower raises at its third point."""
    cfg = TransformerConfig(**case["cfg"])
    params = params_from_jax(trees[case["tree"]], "cpu")
    out = {}

    def run(e):
        reqs = [e.submit(r) for r in _requests(case, Request)]
        e.run_until_idle(max_steps=100_000)
        return [r.output for r in reqs]

    cold = InferenceEngine(params, cfg, device="cpu", mesh=mesh, **_port_kwargs(case, trees))
    out["cold_tokens"] = _lead(cold, lambda: run(cold))
    seen = _watch_warmup(eng)

    def warmed():
        reqs = [eng.submit(r) for r in _requests(case, Request)]
        for _ in range(2):
            eng.exchange_ticket()
            eng.round()
        st = warmup_engine(eng)
        eng.run_until_idle(max_steps=100_000)
        one = InferenceEngine(params, cfg, device="cpu", **_port_kwargs(case, trees))
        return {"warmup": st.to_dict(), "tokens": [r.output for r in reqs],
                "errors": [r.error for r in reqs],
                "labels": [label for label, _ in eng.aot_signatures()],
                "one_device_labels": [label for label, _ in one.aot_signatures()]}

    out.update(_lead(eng, warmed) or {})
    out["points"], out["digests"] = seen["points"], seen["digests"]
    out["pages_kept"] = all(torch.equal(seen["before"][k], seen["after"][k])
                            for k in seen["before"])
    if case.get("fail"):
        bad = InferenceEngine(params, cfg, device="cpu", mesh=mesh, **_port_kwargs(case, trees))
        if bad.leader:
            st = warmup_engine(bad)
            out["fault"] = (st.state, st.detail, st.built, st.errors)
        else:
            warm, n = bad._warm, [0]

            def planted(**point):
                warm(**point)
                n[0] += 1
                if n[0] == 3:
                    raise RuntimeError("planted fault")

            bad._warm = planted
            try:
                bad.follow()
                out["fault"] = "followed to the stop ticket"
            except MeshWarmupError as e:
                out["fault"] = str(e)
    return out


def run_case(name, case, mesh, trees) -> dict:
    """One engine of ``case`` on this rank: rank 0 submits and drives, the
    others follow.  Returns what the test holds: rank 0's tokens and
    errors, every rank's emission log and host state, and the engine's
    local leaves where ``keep``."""
    cfg = TransformerConfig(**case["cfg"])
    eng = InferenceEngine(params_from_jax(trees[case["tree"]], "cpu"), cfg, device="cpu",
                          mesh=mesh, **_port_kwargs(case, trees))
    log = []
    emit = eng._emit

    def logged(req, tok, *a, **k):
        log.append((tuple(req.prompt), int(tok)))
        emit(req, tok, *a, **k)

    eng._emit = logged
    out = {}
    if case.get("kind") == "refused":
        out["refused"] = _refusals(eng, mesh, trees)
    if case.get("kind") == "warm":
        out.update(_warm_case(eng, case, mesh, trees))
    elif eng.leader and case.get("kind") in ("disagg", "pressure"):
        out["disagg"] = _disagg_leader(eng, case, trees["bundles"])
        eng.stop_followers()
    elif eng.leader:
        if case.get("kind") == "spill":
            victim = eng.submit(Request(prompt=list(SPILL_PROMPT), max_new_tokens=30))
            for _ in range(40):  # rounds until the pool runs dry, the victim mid-flight
                eng.exchange_ticket()
                if not eng.round() or not eng.free_pages:
                    break
            out["pressure"] = (not victim.done.is_set(), len(eng.free_pages))
            reqs = [victim, eng.submit(Request(prompt=list(SPILL_HIGH), max_new_tokens=8,
                                               priority=5))]
        elif case.get("kind") == "refused":
            reqs = []
        else:
            reqs = [eng.submit(r) for r in _requests(case, Request)]
        eng.run_until_idle(max_steps=100_000)
        eng.stop_followers()
        out["tokens"] = [r.output for r in reqs]
        out["errors"] = [r.error for r in reqs]
    else:
        eng.follow()
    out["log"] = log
    out["state"] = dict({c: int(getattr(eng, c)) for c in COUNTERS},
                        lengths=eng.lengths.tolist(), tables=eng.tables.tolist(),
                        free_pages=sorted(eng.free_pages), tickets=eng.tickets,
                        graph_replays=eng.graph_replays, digest=eng._mirror_digest().hex())
    out["kv_shapes"] = {k: tuple(v.shape) for k, v in eng.kv.items()}
    if case.get("keep"):
        out["leaves"] = [(p, t.detach().numpy().copy()) for p, t in _flat(eng.params)]
    return out


def serve_worker(rank, world, rendezvous, rounds, cases, trees):
    _join(rank, world, rendezvous)
    out = {}
    for rnd in rounds:
        # every rank connects every mesh (process groups are made by the world)
        meshes = [_mesh(kw, ranks).connect() for _, kw, ranks, _ in rnd]
        for (mname, _kw, ranks, names), m in zip(rnd, meshes):
            if rank not in ranks:
                continue
            for name in names:
                out[(mname, name)] = run_case(name, cases[name], m, trees)
    return out


# -- the reference on one device ------------------------------------------------


def jax_trees():
    """The reference's weights (numpy leaves) by CFGS name, the dense
    model's int8 tree ("dense/int8") and its adapters ("loras")."""
    from elastic_gpu_scheduler_tpu.models import lora as jlora
    from elastic_gpu_scheduler_tpu.models.quantize import quantize_params
    from elastic_gpu_scheduler_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
        init_params,
    )

    trees = {}
    for n, (name, c) in enumerate(CFGS.items()):
        trees[name] = jax.tree.map(np.asarray, init_params(jax.random.key(2 + n),
                                                           JaxConfig(**c)))
    dense = jax.tree.map(jnp.asarray, trees["dense"])
    trees["dense/int8"] = jax.tree.map(np.asarray, quantize_params(dense))
    loras = {}
    for n, (name, rank, targets) in enumerate(LORAS):
        lo = jlora.lora_init(jax.random.key(10 + n), dense, rank=rank, targets=targets)
        for t, ab in lo["adapters"].items():
            lo["adapters"][t]["b"] = jax.random.normal(jax.random.key(20 + n),
                                                       ab["b"].shape) * 0.3
        loras[name] = jax.tree.map(np.asarray, lo)
    trees["loras"] = loras
    return trees


def jax_case(case, trees) -> dict:
    """The reference engine on one device, sequential, on the same case."""
    from elastic_gpu_scheduler_tpu.models.serving import InferenceEngine as JaxEngine
    from elastic_gpu_scheduler_tpu.models.serving import Request as JaxRequest
    from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig

    to_jax = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    kw = dict(case["eng"], overlap=False)
    if case.get("adapters"):
        kw["adapters"] = {n: to_jax(lo) for n, lo in trees["loras"].items()}
    if case.get("draft"):
        kw["draft"] = (to_jax(trees["draft"]), JaxConfig(**CFGS["draft"]))
    eng = JaxEngine(to_jax(trees[case["tree"]]), JaxConfig(**case["cfg"]), **kw)
    if case.get("kind") == "spill":
        victim = eng.submit(JaxRequest(prompt=list(SPILL_PROMPT), max_new_tokens=30))
        for _ in range(40):
            eng._admit()
            if not any(s is not None for s in eng.slots):
                break
            eng.step()
            if not eng.free_pages:
                break
        reqs = [victim, eng.submit(JaxRequest(prompt=list(SPILL_HIGH), max_new_tokens=8,
                                              priority=5))]
    else:
        reqs = [eng.submit(r) for r in _requests(case, JaxRequest)]
    eng.run_until_idle(max_steps=100_000)
    for r in reqs:
        assert r.done.is_set() and not r.error, r.error
    return {"tokens": [r.output for r in reqs],
            "counters": {c: int(getattr(eng, c)) for c in COUNTERS}}


def _jax_engine(tree, trees, **kw):
    """The reference engine on one device, sequential, prefix-cached."""
    from elastic_gpu_scheduler_tpu.models.serving import InferenceEngine as JaxEngine
    from elastic_gpu_scheduler_tpu.models.transformer import TransformerConfig as JaxConfig

    return JaxEngine(jax.tree.map(jnp.asarray, trees[tree]), JaxConfig(**CFGS[tree]),
                     **dict(BASE, prefix_cache=True, overlap=False, **kw))


def _port_engine(trees, tree="dense", **kw):
    """The port on one device, sequential, prefix-cached."""
    return InferenceEngine(params_from_jax(trees[tree], "cpu"), TransformerConfig(**CFGS[tree]),
                           device="cpu", **dict(BASE, prefix_cache=True, overlap=False, **kw))


def _run(eng, req_cls, prompt, new):
    """One request through ``eng``: (it, the prefix tokens its admission hit)."""
    hits = eng.prefix_hit_tokens
    req = eng.submit(req_cls(prompt=list(prompt), max_new_tokens=new))
    eng.run_until_idle(max_steps=100_000)
    assert req.done.is_set() and not req.error, req.error
    return req, eng.prefix_hit_tokens - hits


def disagg_bundles(trees) -> dict:
    """Before the spawn: the reference's bundle of LONG's pages from each
    pool, and the port's one-device sessions detached after one step."""
    from elastic_gpu_scheduler_tpu.models.serving import Request as JaxRequest

    out = {}
    for pool, (tree, int8) in POOLS.items():
        eng = _jax_engine(tree, trees, kv_int8=int8)
        _run(eng, JaxRequest, LONG, 2)
        out[pool] = eng.export_prefix_pages(LONG, "")
    src = _port_engine(trees)
    for m in MIGRANTS:
        src.submit(Request(**m))
    src._admit()
    src.step()
    lost = src.chunks_discarded
    out["sessions"] = [src.migrate_out_bundle(i) for i in range(len(MIGRANTS))]
    out["sessions_lost"] = src.chunks_discarded - lost
    return out


def disagg_reference(trees) -> dict:
    """While the ranks run: each pool's warm hit of LONG + SUFFIX on the
    reference, its import into a 4-page pool, the warm hit of SHARED +
    SUFFIX, and the migrants unmigrated (greedy on the reference; the
    seeded one on the port, whose seeded draws are its own)."""
    from elastic_gpu_scheduler_tpu.models.serving import Request as JaxRequest

    out = {}
    for pool, (tree, int8) in POOLS.items():
        eng = _jax_engine(tree, trees, kv_int8=int8)
        _run(eng, JaxRequest, LONG, 2)
        warm, hits = _run(eng, JaxRequest, LONG + SUFFIX, 8)
        out["warm " + pool] = (warm.output, hits)
    eng = _jax_engine("dense", trees, n_pages=4)
    hdr, pages = kvwire.decode_bundle(trees["bundles"]["dense"])
    out["pressure"] = (eng.import_pages(hdr, pages), len(eng.cached_prefix_pages(LONG, "")))
    eng = _jax_engine("dense", trees)
    _run(eng, JaxRequest, SHARED, 2)
    warm, hits = _run(eng, JaxRequest, SHARED + SUFFIX, 8)
    out["warm shared"] = (warm.output, hits)
    out["greedy"] = _run(_jax_engine("dense", trees), JaxRequest, MIGRANTS[0]["prompt"],
                         MIGRANTS[0]["max_new_tokens"])[0].output
    port = _port_engine(trees)
    reqs = [port.submit(Request(**m)) for m in MIGRANTS]
    port.run_until_idle(max_steps=100_000)
    out["unmigrated"] = [(r.output, r.token_logprobs, r.top_logprobs) for r in reqs]
    return out


def spawn_and_reference(tmp_path, rounds, cases, trees, reference):
    """``serve_worker`` on WORLD ranks (from a thread) while this process
    computes ``reference()``; returns (the ranks' results, the reference's)."""
    box = {}

    def run():
        try:
            box["res"] = spawn_ranks(serve_worker, WORLD, (rounds, cases, trees),
                                     rendezvous=f"file://{tmp_path / 'rendezvous'}",
                                     timeout_s=SPAWN_TIMEOUT)
        except BaseException as e:  # re-raised below
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_serving, "jnp", _CopyingJnp())
            refs = reference()
    finally:
        th.join()
    if "err" in box:
        raise box["err"]
    return box["res"], refs


def check_case(res, refs, mname, ranks, name, case):
    """Rank 0's tokens and counters against the reference's; every rank's
    emission log and host state equal."""
    got = res[ranks[0]][(mname, name)]
    want = refs[name]
    assert got["errors"] == [""] * len(got["tokens"]), got["errors"]
    assert got["tokens"] == want["tokens"], (mname, name)
    if not case.get("overlap"):
        state = {c: got["state"][c] for c in COUNTERS}
        assert state == want["counters"], (mname, name)
    assert got["log"], (mname, name)
    check_mirrors(res, mname, ranks, name)


def check_mirrors(res, mname, ranks, name):
    """Every rank's emission log and host state (its ``_mirror_digest``
    included) equal rank 0's."""
    got = res[ranks[0]][(mname, name)]
    for r in ranks[1:]:
        other = res[r][(mname, name)]
        assert other["log"] == got["log"], (mname, name, r)
        assert other["state"] == got["state"], (mname, name, r)


def addressable_shard(leaf, jmesh, coords):
    """The reference leaf's shard on the device at mesh position ``coords``."""
    dev = jmesh.devices[coords]
    (shard,) = [s for s in leaf.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def check_slices(res, kw, ranks, tree, replicated=()):
    """Each rank's leaves are the reference's addressable shards on the
    device at its mesh position (whole for the leaves ``replicated``
    names: the port keeps attention heads whole)."""
    from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh_mod

    jmesh = jmesh_mod.make_mesh(jmesh_mod.MeshSpec(**kw), jax.devices()[:len(ranks)])
    placed = jax_serving._shard_params_for_mesh(jax.tree.map(jnp.asarray, tree), jmesh)
    whole = dict(_flat(tree))
    ref = dict(_flat(placed))
    pm = _mesh(kw, ranks)
    for r in ranks:
        coords = pm.coords(r)
        for path, leaf in res[r]:
            want = (whole[path] if any(f"/{n}/" in f"/{path}/" for n in replicated)
                    else addressable_shard(ref[path], jmesh, coords))
            np.testing.assert_array_equal(leaf, want, err_msg=f"{path} rank {r}")


# -- the tests ---------------------------------------------------------------


NOT_GENERATING = ("refused", "disagg", "pressure")  # kinds with flows of their own


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    trees = jax_trees()
    trees["bundles"] = disagg_bundles(trees)

    def reference():
        names = {n for rnd in ROUNDS for _, _, _, ns in rnd for n in ns}
        refs = {n: jax_case(CASES[n], trees) for n in sorted(names)
                if CASES[n].get("kind") not in NOT_GENERATING and not CASES[n].get("overlap")}
        refs["disagg"] = disagg_reference(trees)
        return refs

    res, refs = spawn_and_reference(tmp_path_factory.mktemp("tp"), ROUNDS, CASES, trees,
                                    reference)
    refs["overlapped"] = refs["gather"]  # the same engine, the sequential reference
    return res, refs, trees


MESH_CASES = [(m, kw, ranks, n) for rnd in ROUNDS for m, kw, ranks, ns in rnd for n in ns
              if CASES[n].get("kind") not in NOT_GENERATING]


@pytest.mark.parametrize("case", MESH_CASES, ids=lambda c: f"{c[0]}-{c[3]}".replace(" ", ""))
def test_mesh_engine_matches_the_reference_on_one_device(mesh_runs, case):
    res, refs, _ = mesh_runs
    mname, _kw, ranks, name = case
    check_case(res, refs, mname, ranks, name, CASES[name])


def test_spill_reached_pressure_and_resumed(mesh_runs):
    res, _, _ = mesh_runs
    got = res[2][("tensor=2 b", "spill")]
    assert got["pressure"] == (True, 0)
    assert got["state"]["spills"] >= 1 and len(got["tokens"][0]) == 30


def test_overlapped_mesh_runs_chunks_eagerly(mesh_runs):
    """On the CPU nothing captures; the counters say the loop ran eagerly."""
    res, _, _ = mesh_runs
    for r in (2, 3):
        assert res[r][("tensor=2 b", "overlapped")]["state"]["graph_replays"] == 0


@pytest.mark.parametrize("mname,kw,ranks", [("tensor=2 a", dict(tensor=2), (0, 1)),
                                             ("data=2,tensor=2", dict(data=2, tensor=2),
                                              (0, 1, 2, 3))], ids=["tensor2", "data2tensor2"])
def test_weights_and_pool_are_the_reference_shards(mesh_runs, mname, kw, ranks):
    res, _, trees = mesh_runs
    leaves = {r: res[r][(mname, "gather")]["leaves"] for r in ranks}
    check_slices(leaves, kw, ranks, trees["dense"])
    # really cut: wq holds half its heads, the pool half its kv heads
    wq = dict(leaves[ranks[0]])["layers/wq"]
    assert wq.shape == (2, 64, 32)
    for r in ranks:
        assert res[r][(mname, "gather")]["kv_shapes"]["k"] == (2, 33, 8, 1, 16)


def test_int8_weights_are_the_reference_shards(mesh_runs):
    res, _, trees = mesh_runs
    ranks = (2, 3)
    leaves = {r: res[r][("tensor=2 b", "int8_weights")]["leaves"] for r in ranks}
    check_slices(leaves, dict(tensor=2), ranks, trees["dense/int8"])
    got = dict(leaves[2])
    assert got["layers/wq/q8"].shape == (2, 64, 32) and got["layers/wq/scale"].shape == (2, 1, 32)
    assert got["layers/wo/scale"].shape == (2, 1, 64)  # row-parallel: its scale whole


def test_odd_heads_replicate_attention_and_cut_the_mlp(mesh_runs):
    """3 heads on tensor=2: the attention leaves and the pool stay whole
    (the port's whole-heads rule), the MLP, embed and unembed are the
    reference's shards."""
    res, _, trees = mesh_runs
    ranks = (0, 1)
    leaves = {r: res[r][("tensor=2 a", "odd_int8kv")]["leaves"] for r in ranks}
    check_slices(leaves, dict(tensor=2), ranks, trees["odd"],
                 replicated=("wq", "wk", "wv", "wo"))
    got = dict(leaves[0])
    assert got["layers/wq"].shape == (2, 48, 48) and got["layers/w_in"].shape == (2, 48, 48)
    assert res[0][("tensor=2 a", "odd_int8kv")]["kv_shapes"]["ks"][-1] == 3


def test_mesh_refusals_name_what_they_refuse(mesh_runs):
    """A follower's own call of each disaggregated verb is refused by
    name (it takes its work from rank 0's tickets); rank 0's call runs,
    through a ticket, on both ranks."""
    res, _, _ = mesh_runs
    verbs = ("export_prefix_pages", "import_pages", "migrate_out_bundle", "resume_session",
             "warm_point")
    lead = res[0][("tensor=2 a", "refused")]["refused"]
    follower = res[1][("tensor=2 a", "refused")]["refused"]
    for verb in verbs:
        kind, msg = follower[verb]
        assert kind == "refused" and verb in msg and "rank 0's tickets" in msg, (verb, msg)
    assert lead["export_prefix_pages"] == ("ok", None)  # nothing cached yet
    assert lead["import_pages"] == ("ok", {"imported": 5, "already": 0, "tokens": 40,
                                           "stopped": None})
    assert lead["migrate_out_bundle"] == ("ok", None)  # no live session
    assert lead["resume_session"] == ("ok", "Request")
    assert lead["warm_point"] == ("ok", [0, 1])  # ran on both ranks
    for r in (0, 1):
        assert "divisible" in res[r][("tensor=2 a", "refused")]["refused"]["paged_kernel_heads"]
    assert "tickets" in follower["follower_submit"]
    check_mirrors(res, "tensor=2 a", (0, 1), "refused")
    assert res[0][("tensor=2 a", "refused")]["state"]["tickets"] >= 4


WARM = {"warm_paged": ("tensor=2 a", (0, 1)), "warm_spec": ("tensor=2 a", (0, 1)),
        "warm_prefix_int8kv": ("tensor=2 b", (2, 3)),
        "warm_int8_weights": ("tensor=2 b", (2, 3))}


@pytest.mark.parametrize("name", sorted(WARM))
def test_mesh_warmup_runs_the_one_device_lattice_on_every_rank(mesh_runs, name):
    """The mirrored engine's lattice is the one-device engine's (and so the
    reference's labels, ``test_torch_compilecache``); every rank ran every
    point in rank 0's order, the digests agreed after each, the pool's
    pages but the scratch page kept their bytes, and the tokens equal an
    unwarmed mesh engine's and the reference's."""
    res, refs, _ = mesh_runs
    mname, ranks = WARM[name]
    lead = res[ranks[0]][(mname, name)]
    n = len(lead["labels"])
    assert n > 0 and lead["labels"] == lead["one_device_labels"]
    wu = lead["warmup"]
    assert wu["state"] == "ready" and wu["errors"] == 0 and wu["built"] == wu["lattice_size"] == n
    assert wu["mesh"] == {"tensor": 2}
    assert sorted(wu["ranks"]) == [str(r) for r in ranks]
    assert all(v["built"] == n for v in wu["ranks"].values())
    for r in ranks:
        got = res[r][(mname, name)]
        assert got["points"] == lead["points"] and len(got["points"]) == n, r
        assert got["digests"] == lead["digests"] and len(got["digests"]) == n, r
        assert got["pages_kept"], r
    assert lead["errors"] == [""] * len(lead["tokens"])
    assert lead["tokens"] == lead["cold_tokens"] == refs[name]["tokens"]


def test_mesh_warmup_point_failing_on_a_follower_ends_it_on_every_rank(mesh_runs):
    """A point that raises on the follower (its third) raises on both
    ranks: rank 0's warm-up ends in ``error`` after two points, naming the
    rank, and the follower leaves ``follow``."""
    res, _, _ = mesh_runs
    state, detail, built, errors = res[0][("tensor=2 a", "warm_paged")]["fault"]
    assert (state, built, errors) == ("error", 2, 1)
    assert "rank(s) 1: RuntimeError: planted fault" in detail
    follower = res[1][("tensor=2 a", "warm_paged")]["fault"]
    assert "rank(s) 1: RuntimeError: planted fault" in follower


def test_a_mesh_warmup_point_failing_stops_the_replica(monkeypatch):
    """Rank 0 behind HTTP: a warm-up point that a follower reports failed
    goes through the round's fault path (the loop stops, waiting requests
    fail); the warm-up ends in ``error`` and ``/healthz`` answers 503
    with ``failed`` and ``warmup_failed``."""
    import http.client
    import json
    from types import SimpleNamespace

    from elastic_gpu_scheduler_tpu_torch.compilecache import WarmupState, start_warmup_thread
    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    eng = InferenceEngine(params_from_jax(jax_trees()["dense"], "cpu"),
                          TransformerConfig(**CFGS["dense"]), device="cpu",
                          compile_cache=CompileCache(None), **BASE)
    eng.mirrored, eng.mesh = True, SimpleNamespace(rank=0, shape={"tensor": 2}, size=2)
    monkeypatch.setattr(serving, "broadcast_object", lambda obj, mesh: obj)
    monkeypatch.setattr(serving, "all_gather_object", lambda obj, mesh: [
        obj, (1, "RuntimeError: planted fault", 0.0, 0.0, obj[-1])])
    monkeypatch.setattr(eng, "_warm", lambda **point: None)  # rank 0's side of the point
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    try:
        loop.warmup = WarmupState()
        start_warmup_thread(eng, loop.warmup).join(60)
        assert loop.failed.wait(30)
        wu = loop.warmup
        assert (wu.state, wu.built, wu.errors) == ("error", 0, 1)
        assert "rank(s) 1: RuntimeError: planted fault" in wu.detail
        conn = http.client.HTTPConnection(*server.server_address, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 503 and body["failed"] and body["warmup_failed"]
        assert body["warmup"]["state"] == "error"
        late = eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
        assert late.done.is_set() and late.error == serving.ENGINE_FAILED_ERROR
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


DISAGG = {"dense": ("tensor=2 b", (2, 3), "disagg"),
          "int8": ("tensor=2 a", (0, 1), "disagg_int8"),
          "odd": ("tensor=2 a", (0, 1), "disagg_odd")}


@pytest.mark.parametrize("pool", sorted(DISAGG))
def test_disagg_round_trip_is_byte_identical(mesh_runs, pool):
    """The reference's bundle imported into tensor=2 and exported again is
    the same bytes (the head-sharded dense and int8 pools gather their
    heads; the odd-head pool is whole on each rank), and the warm hit on
    the imported pages gives the reference's tokens and hits."""
    res, refs, trees = mesh_runs
    mname, ranks, name = DISAGG[pool]
    got = res[ranks[0]][(mname, name)]["disagg"]
    assert got["import"] == {"imported": 5, "already": 0, "tokens": 40, "stopped": None}
    assert got["round_trip"] == trees["bundles"][pool]
    tokens, hits, err = got["warm"]
    assert not err and (tokens, hits) == tuple(refs["disagg"]["warm " + pool])
    assert hits == 40
    sharded = pool != "odd"
    heads = res[ranks[0]][(mname, name)]["kv_shapes"]["k"][3]
    assert heads == (CFGS["dense"]["n_kv_heads"] // 2 if sharded else 3)
    check_mirrors(res, mname, ranks, name)


def test_disagg_tensor_bundle_adopted_by_one_device_engines(mesh_runs):
    """A prefix primed and exported on tensor=2, adopted by the reference
    engine and by the port on one device: each gives its own local warm
    hit's tokens, with the same pages matched."""
    from elastic_gpu_scheduler_tpu.models.serving import Request as JaxRequest

    res, refs, trees = mesh_runs
    data, err = res[2][("tensor=2 b", "disagg")]["disagg"]["export"]
    assert not err and data is not None
    want = tuple(refs["disagg"]["warm shared"])
    assert want[1] == 16
    hdr, pages = kvwire.decode_bundle(data)
    assert len(pages) == 2
    for eng, req_cls in ((_jax_engine("dense", trees), JaxRequest),
                         (_port_engine(trees), Request)):
        assert eng.import_pages(hdr, pages)["imported"] == 2
        req, hits = _run(eng, req_cls, SHARED + SUFFIX, 8)
        assert (req.output, hits) == want, type(eng)


def test_disagg_import_refusals_land_nothing(mesh_runs):
    """Another page size and a cut payload are refused on rank 0 before a
    ticket: nothing lands on either rank, whose mirrors still agree."""
    res, _, _ = mesh_runs
    got = res[2][("tensor=2 b", "disagg")]["disagg"]["refusals"]
    assert len(got["errors"]) == 2
    assert "page_size" in got["errors"][0] and "payload size" in got["errors"][1]
    assert got["unchanged"]
    check_mirrors(res, "tensor=2 b", (2, 3), "disagg")


def test_disagg_import_pool_pressure_stops_both_ranks_alike(mesh_runs):
    """A 5-page bundle into a pool of 3 usable pages: both ranks stop at
    the reference's page, with a leading run cached."""
    res, refs, _ = mesh_runs
    got = res[0][("tensor=2 a", "disagg_pressure")]["disagg"]
    want, cached = refs["disagg"]["pressure"]
    assert got["import"] == want and want["stopped"] == "page pool exhausted"
    assert got["cached"] == cached == want["imported"] > 0
    check_mirrors(res, "tensor=2 a", (0, 1), "disagg_pressure")


def _same_logprobs(got, want):
    lps, tops = got
    wlps, wtops = want
    assert len(lps) == len(wlps) and len(tops) == len(wtops)
    assert all(a == b or abs(a - b) < 1e-4 for a, b in zip(lps, wlps))
    for g, w in zip(tops, wtops):
        assert [t for t, _ in g] == [t for t, _ in w]
        assert all(abs(ga - wa) < 1e-4 for (_, ga), (_, wa) in zip(g, w))


def test_disagg_sessions_migrate_across_the_mesh(mesh_runs):
    """Sessions detached after one step, tensor=2 → one device (the port's
    and, greedy, the reference's) and one device → tensor=2: the greedy
    one keeps the reference's tokens, the seeded one the port's unmigrated
    draws and logprobs, each losing at most one chunk."""
    res, refs, trees = mesh_runs
    got = res[2][("tensor=2 b", "disagg")]["disagg"]
    want = refs["disagg"]["unmigrated"]
    assert [w[0] for w in want][0] == refs["disagg"]["greedy"]
    assert got["lost"] <= 1 and trees["bundles"]["sessions_lost"] <= 1
    # tensor=2 → one device
    dst = _port_engine(trees)
    resumed = []
    for data in got["sessions"]:
        hdr, pages = kvwire.decode_bundle(data)
        if pages:
            dst.import_pages(hdr, pages)
        resumed.append(dst.resume_session(hdr["request"]))
    dst.run_until_idle(max_steps=100_000)
    for r, w in zip(resumed, want):
        assert not r.error and r.output == w[0]
        _same_logprobs((r.token_logprobs, r.top_logprobs), w[1:])
    jdst = _jax_engine("dense", trees)
    hdr, pages = kvwire.decode_bundle(got["sessions"][0])
    jdst.import_pages(hdr, pages)
    greedy = jdst.resume_session(hdr["request"])
    jdst.run_until_idle(max_steps=100_000)
    assert greedy.output == refs["disagg"]["greedy"]
    # one device → tensor=2
    for (out, lps, tops, err), w in zip(got["resumed"], want):
        assert not err and out == w[0]
        _same_logprobs((lps, tops), w[1:])
    check_mirrors(res, "tensor=2 b", (2, 3), "disagg")


def test_mesh_without_a_tensor_axis_raises():
    cfg = TransformerConfig(**CFGS["dense"])
    params = params_from_jax(jax_trees()["dense"], "cpu")
    mesh = make_mesh(MeshSpec()).connect()
    mesh.axis_names = ("data",)  # a mesh whose axes do not name tensor
    with pytest.raises(ValueError, match="tensor"):
        InferenceEngine(params, cfg, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="connect"):
        InferenceEngine(params, cfg, device="cpu", mesh=make_mesh(MeshSpec()))


def test_a_follower_whose_state_parted_raises(monkeypatch):
    """The ticket carries rank 0's host-state digest: a follower whose own
    matches applies the ticket; one whose state parted raises, naming the
    ticket, before it runs another round."""
    from types import SimpleNamespace

    from elastic_gpu_scheduler_tpu_torch.models import serving

    eng = InferenceEngine(params_from_jax(jax_trees()["dense"], "cpu"),
                          TransformerConfig(**CFGS["dense"]), device="cpu", **BASE)
    eng.mirrored, eng.leader, eng.mesh = True, False, SimpleNamespace(rank=1)
    ticket = {"new": [(0, {"prompt": [5, 17, 3], "max_new_tokens": 4})], "cancel": [],
              "draining": False, "stop": False, "preempt": False,
              "digest": eng._mirror_digest()}
    monkeypatch.setattr(serving, "broadcast_object", lambda obj, mesh: ticket)
    eng.exchange_ticket()
    assert eng.queue.qsize() == 1 and eng.tickets == 1
    ticket = dict(ticket, new=[], digest=eng._mirror_digest())
    eng.lengths[0] += 1  # this rank's state parts from rank 0's
    with pytest.raises(RuntimeError, match="parted from rank 0's before ticket 1"):
        eng.exchange_ticket()


def test_a_mesh_engine_that_faults_stops_serving(monkeypatch):
    """Rank 0's ``EngineLoop`` on a mirrored engine: a fault in a round
    fails every waiting request at once, sends no further ticket (a
    follower may be inside a collective), and leaves the replica unhealthy
    so it is restarted: /healthz and a later completion answer 503."""
    import http.client
    import json
    from types import SimpleNamespace

    from elastic_gpu_scheduler_tpu_torch.models import serving
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    eng = InferenceEngine(params_from_jax(jax_trees()["dense"], "cpu"),
                          TransformerConfig(**CFGS["dense"]), device="cpu", **BASE)
    eng.mirrored, eng.mesh = True, SimpleNamespace(rank=0)  # rank 0 of a mesh
    tickets = []
    monkeypatch.setattr(serving, "broadcast_object",
                        lambda obj, mesh: tickets.append(obj) or obj)
    faults = []

    def admit():
        if eng.queue.qsize():
            faults.append(eng.queue.qsize())
            raise RuntimeError("a collective failed")

    monkeypatch.setattr(eng, "_admit", admit)
    server, loop = serve_inference(eng, port=0, host="127.0.0.1")
    addr = server.server_address
    try:
        waiting = [eng.submit(Request(prompt=list(p), max_new_tokens=4)) for p in PROMPTS[:2]]
        assert loop.failed.wait(30)
        loop._thread.join(30)
        assert not loop._thread.is_alive() and len(faults) == 1
        for r in waiting:
            assert r.done.is_set() and r.error == serving.ENGINE_FAILED_ERROR
        assert tickets and not any(t["stop"] for t in tickets)
        late = eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
        assert late.done.is_set() and late.error == serving.ENGINE_FAILED_ERROR
        conn = http.client.HTTPConnection(*addr, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 503 and json.loads(resp.read())["failed"]
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [1, 2], "max_tokens": 2}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 503
        assert json.loads(resp.read())["error"] == serving.ENGINE_FAILED_ERROR
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
