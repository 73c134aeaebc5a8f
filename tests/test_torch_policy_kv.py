"""The port's ``kv`` policy verb against the reference's.

``elastic_gpu_scheduler_tpu_torch.policy`` is an own copy of the
reference's policy language, VM and the registry's ``kv`` verb.  The same
policy source compiled by both must give the same bytecode fingerprint,
the same scores and the same KV-page preemption victim on the same seeded
slot inputs; a faulting policy falls back to the built-in ranking and is
counted; bad sources and verbs are refused alike.  Then the port's
serving loop picks its victim through the verb, and a replica's
``/policy/load``, ``/policy/rollback`` and ``/debug/policy`` drive it.
"""

import http.client
import json
import zlib

import numpy as np
import pytest
import torch

from elastic_gpu_scheduler_tpu.policy import PolicyPlane as RefPlane
from elastic_gpu_scheduler_tpu.policy import compile_expr as ref_compile
from elastic_gpu_scheduler_tpu.policy import evaluate as ref_evaluate
from elastic_gpu_scheduler_tpu.policy import run as ref_run
from elastic_gpu_scheduler_tpu.policy.rater import KV_INPUTS as REF_KV_INPUTS
from elastic_gpu_scheduler_tpu_torch.metrics import POLICY_EVALS
from elastic_gpu_scheduler_tpu_torch.policy import (
    KV_INPUTS,
    POLICIES,
    CompileError,
    PolicyPlane,
    compile_expr,
    run,
)

POLICY_SOURCES = [
    "tokens",
    "matched - tokens",
    "pages * 2 + (priority < 1 ? 100 : 0) - slot / 8",
    "max(pages, tokens / 4, matched) - 3 * priority",
    "clamp(tokens - matched, 0, 64) % 7 + floor(pages / 3) + ceil(slot / 2)",
    "not (priority > 0) and pages >= 2 or matched == 0",
    "min(abs(tokens - 40), pages) # comment to the end of the line",
    "-slot",
]


def _slots(rng, n: int) -> list[dict]:
    return [{"slot": float(i), "priority": float(rng.integers(-1, 3)),
             "pages": float(rng.integers(0, 12)), "tokens": float(rng.integers(0, 200)),
             "matched": float(rng.integers(0, 4) * 16)} for i in range(n)]


def test_kv_inputs_match():
    assert KV_INPUTS == REF_KV_INPUTS


@pytest.mark.parametrize("source", POLICY_SOURCES)
def test_same_source_same_scores_and_victim(source):
    ref_p, port_p = ref_compile(source, REF_KV_INPUTS), compile_expr(source, KV_INPUTS)
    assert (port_p.fingerprint, port_p.code, port_p.consts, port_p.slots) == (
        ref_p.fingerprint, ref_p.code, ref_p.consts, ref_p.slots)
    ref_plane, port_plane = RefPlane(), PolicyPlane()
    ref_plane.load("p", "kv", source, skip_gate=True)
    port_plane.load("p", "kv", source)
    rng = np.random.default_rng(zlib.crc32(source.encode()))
    for _ in range(25):
        slots = _slots(rng, int(rng.integers(1, 9)))
        for s in slots:
            vals = [s[n] for n in port_p.slots]
            assert run(port_p, vals) == ref_evaluate(ref_p, vals) == ref_run(ref_p, vals)
        assert port_plane.select_kv_victim(slots) == ref_plane.select_kv_victim(slots)
    assert port_plane.canary["kv"].evals == ref_plane.canary["kv"].evals > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builtin_ranking_matches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        slots = _slots(rng, int(rng.integers(1, 9)))
        assert PolicyPlane().select_kv_victim(slots) == RefPlane().select_kv_victim(slots)


@pytest.mark.parametrize("source,kind", [
    ("1 / (pages - pages)", "math"),
    ("tokens % (slot - slot)", "math"),
    ("1e308 * 1e308 * tokens", "math"),
])
def test_faulting_policy_falls_back_and_is_counted(source, kind):
    rng = np.random.default_rng(5)
    slots = _slots(rng, 6)
    ref_plane, port_plane = RefPlane(), PolicyPlane()
    ref_plane.load("faulty", "kv", source, skip_gate=True)
    port_plane.load("faulty", "kv", source)
    with POLICY_EVALS._lock:
        before = POLICY_EVALS._values.get(("kv", "fault"), 0.0)
    builtin = PolicyPlane().select_kv_victim(slots)
    assert port_plane.select_kv_victim(slots) == ref_plane.select_kv_victim(slots) == builtin
    ref_pol, pol = ref_plane.canary["kv"], port_plane.canary["kv"]
    assert (pol.evals, pol.faults, pol.fault_kinds) == (ref_pol.evals, ref_pol.faults,
                                                        ref_pol.fault_kinds)
    assert pol.fault_kinds == {kind: 1}
    with POLICY_EVALS._lock:
        assert POLICY_EVALS._values.get(("kv", "fault"), 0.0) - before == 1.0


def test_budget_trip_falls_back():
    source = " + ".join(["tokens"] * 40)
    port_plane, ref_plane = PolicyPlane(), RefPlane()
    port_plane.load("long", "kv", source, budget=16)
    ref_plane.load("long", "kv", source, skip_gate=True, budget=16)
    slots = _slots(np.random.default_rng(9), 4)
    assert port_plane.select_kv_victim(slots) == ref_plane.select_kv_victim(slots)
    assert port_plane.canary["kv"].fault_kinds == ref_plane.canary["kv"].fault_kinds == {
        "budget": 1}


@pytest.mark.parametrize("bad", ["", "tokens +", "unknown_input * 2", "min(tokens)",
                                 "(((((tokens", "tokens $ 2", "and", "x" * 5000])
def test_bad_sources_refused_alike(bad):
    with pytest.raises(CompileError) as port_e:
        compile_expr(bad, KV_INPUTS)
    with pytest.raises(ValueError) as ref_e:
        ref_compile(bad, REF_KV_INPUTS)
    assert str(port_e.value) == str(ref_e.value)
    plane = PolicyPlane()
    with pytest.raises(CompileError):
        plane.load("bad", "kv", bad)
    assert plane.canary == {}


def test_other_verbs_refused():
    with pytest.raises(ValueError, match="unknown verb 'score'"):
        PolicyPlane().load("s", "score", "1")


def small_engine():
    from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine
    from elastic_gpu_scheduler_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                            dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return InferenceEngine(params, cfg, max_batch=3, max_len=64, page_size=8, fused_steps=4,
                           device="cpu", overlap=False)


def test_serving_loop_picks_its_victim_through_the_verb():
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request
    from elastic_gpu_scheduler_tpu_torch.server.inference import choose_kv_victim

    eng = small_engine()
    for n, pri in ((20, 1), (4, 0), (12, 0)):
        eng.submit(Request(prompt=list(range(1, n + 1)), max_new_tokens=30, priority=pri))
    eng._admit()
    eng.step()
    try:
        assert choose_kv_victim(eng) == 2  # built-in: priority 0, most pages
        POLICIES.load("most-pages-low-priority", "kv", "pages - 10 * priority + slot / 100")
        assert choose_kv_victim(eng) == 2
        POLICIES.load("fewest-pages", "kv", "-pages")
        assert choose_kv_victim(eng) == 1
        assert POLICIES.debug_state()["canary"]["kv"]["name"] == "fewest-pages"
        POLICIES.load("faulty", "kv", "1 / (slot - slot)")
        assert choose_kv_victim(eng) == 2  # the fault falls back to the built-in
        assert POLICIES.canary["kv"].faults == 1
    finally:
        POLICIES.reset()
    eng.run_until_idle(max_steps=100_000)


def _call(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


@pytest.fixture
def replica():
    from elastic_gpu_scheduler_tpu_torch.server.inference import serve_inference

    server, loop = serve_inference(small_engine(), port=0, host="127.0.0.1")
    try:
        yield server.server_address
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        POLICIES.reset()


def test_replica_routes_load_inspect_and_roll_back_a_kv_policy(replica):
    from elastic_gpu_scheduler_tpu_torch.server.inference import choose_kv_victim

    assert _call(replica, "GET", "/debug/policy")[1]["canary"] == {}
    code, out = _call(replica, "POST", "/policy/load",
                      {"name": "fewest-pages", "verb": "kv", "expr": "-pages", "budget": 64,
                       "canary_pct": 10.0, "skip_gate": True})
    assert code == 200 and out["state"] == "canary" and out["verb"] == "kv"
    state = _call(replica, "GET", "/debug/policy")[1]
    pol = state["canary"]["kv"]
    assert (pol["name"], pol["budget"], pol["inputs"]) == ("fewest-pages", 64, ["pages"])
    assert pol["fingerprint"] == ref_compile("-pages", REF_KV_INPUTS).fingerprint
    eng = small_engine()
    from elastic_gpu_scheduler_tpu_torch.models.serving import Request

    for n in (20, 4, 12):
        eng.submit(Request(prompt=list(range(1, n + 1)), max_new_tokens=30))
    eng._admit()
    eng.step()
    assert choose_kv_victim(eng) == 1  # the loaded policy, not the built-in's 0
    ref_plane = RefPlane()
    ref_plane.load("fewest-pages", "kv", "-pages", skip_gate=True)
    code, out = _call(replica, "POST", "/policy/rollback", {"verb": "kv", "reason": "test"})
    assert code == 200 and out == ref_plane.rollback("kv", reason="test")
    assert choose_kv_victim(eng) == 0
    history = _call(replica, "GET", "/debug/policy")[1]["history"]
    assert [h["event"] for h in history] == ["canary", "rollback"]
    eng.run_until_idle(max_steps=100_000)


@pytest.mark.parametrize("body,match", [
    ({"name": "p", "verb": "kv", "expr": "tokens +"}, None),
    ({"name": "p", "verb": "kv", "expr": "unknown_input * 2"}, None),
    ({"name": "p", "verb": "score", "expr": "1"}, "unknown verb 'score'"),
    ({"name": "p", "verb": "kv"}, "missing field 'expr'"),
    ({"name": "p", "verb": "kv", "expr": "1", "budget": "many"}, "invalid literal"),
    ([1, 2], "JSON object"),
])
def test_replica_refuses_a_bad_load(replica, body, match):
    """``match`` None: a bad expression, refused with the reference
    compiler's own message."""
    code, out = _call(replica, "POST", "/policy/load", body)
    if match is None:
        with pytest.raises(ValueError) as ref_e:
            ref_compile(body["expr"], REF_KV_INPUTS)
        match = str(ref_e.value)
    assert code == 400 and match in out["Error"]
    assert _call(replica, "GET", "/debug/policy")[1]["canary"] == {}


def test_replica_rollback_with_nothing_loaded(replica):
    code, out = _call(replica, "POST", "/policy/rollback", {})
    with pytest.raises(ValueError) as ref_e:
        RefPlane().rollback("kv")
    assert code == 400 and out["Error"] == str(ref_e.value)
