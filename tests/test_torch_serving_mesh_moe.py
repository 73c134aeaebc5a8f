"""MoE serving on a mesh, and ``serve --tensor``: the port's engine on gloo
CPU ranks against the reference engine on one device, float32.

One spawn of 4 ranks (a module fixture, the machinery of
``test_torch_serving_tp``) serves the reference's MoE test model (E 4,
router sharpened x8) on tensor=2 (ranks 0, 1) beside expert=2 (ranks 2,
3), then on expert=2,tensor=2 (all four), while this process runs the
reference engine:

- greedy tokens and counters equal the reference's on every mesh, with
  int8 weights too, and with spec_k 3 on expert=2,tensor=2; a 40-token
  prompt on tensor=2 (the reference's grouped-matmul case);
- every rank's emissions and host state are equal;
- each rank's slices are the reference's addressable shards; under
  expert=2 a rank holds half the experts (KE runs on them, tokens routed
  to the other rank's experts are zero rows);
- ``serve --init --cpu --tensor 2 --warmup lattice`` answers /healthz 503
  ``{"warming": true}`` before 200, with every lattice point built on
  both ranks by then, answers two completions with the tokens
  ``--tensor 1`` gives on the same seed, reports its mesh on
  ``/v1/stats`` and exits 0 on SIGTERM; with a follower lost, the
  waiting request is a 503 and ``serve`` exits 1.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import reference_engine_copies_uploads  # noqa: F401
from test_torch_serving_tp import (
    check_case,
    check_slices,
    jax_case,
    spawn_and_reference,
)

torch.set_num_threads(1)

MOE_CFG = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_ff=64, dtype="float32",
               n_experts=4, capacity_factor=4.0)
MOE = dict(cfg=MOE_CFG, tree="moe", eng=dict(max_batch=4, max_len=48, page_size=8))
PROMPTS = [[5, 17, 3], [60, 2], [9, 9, 9, 9], list(range(1, 20))]
LONG = [int(t) for t in np.random.default_rng(4).integers(1, 60, 40)]
CASES = {
    "moe": dict(MOE, prompts=PROMPTS, new=6, keep=True),
    "moe_int8": dict(MOE, tree="moe/int8", prompts=PROMPTS, new=6, keep=True),
    "moe_spec": dict(MOE, eng=dict(MOE["eng"], spec_k=3),
                     prompts=[[5, 17, 3, 5, 17, 3, 5, 17], [60, 2] * 6], new=6),
    "moe_long": dict(MOE, prompts=[LONG], new=6),
}
ROUNDS = [
    [("tensor=2", dict(tensor=2), (0, 1), ["moe", "moe_int8", "moe_long"]),
     ("expert=2", dict(expert=2), (2, 3), ["moe", "moe_int8"])],
    [("expert=2,tensor=2", dict(expert=2, tensor=2), (0, 1, 2, 3),
      ["moe", "moe_spec", "moe_int8"])],
]


def moe_trees():
    from elastic_gpu_scheduler_tpu.models.quantize import quantize_params
    from elastic_gpu_scheduler_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
        init_params,
    )

    params = init_params(jax.random.key(1), JaxConfig(**MOE_CFG))
    # the reference test's sharpened router: routing margins clear of noise
    params["layers"]["moe_gate"] = params["layers"]["moe_gate"] * 8.0
    return {"moe": jax.tree.map(np.asarray, params),
            "moe/int8": jax.tree.map(np.asarray, quantize_params(params))}


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    trees = moe_trees()

    def reference():
        return {n: jax_case(c, trees) for n, c in CASES.items()}

    res, refs = spawn_and_reference(tmp_path_factory.mktemp("moe"), ROUNDS, CASES, trees,
                                    reference)
    return res, refs, trees


MESH_CASES = [(m, kw, ranks, n) for rnd in ROUNDS for m, kw, ranks, ns in rnd for n in ns]


@pytest.mark.parametrize("case", MESH_CASES, ids=lambda c: f"{c[0]}-{c[3]}")
def test_moe_mesh_engine_matches_the_reference_on_one_device(moe_runs, case):
    res, refs, _ = moe_runs
    mname, _kw, ranks, name = case
    check_case(res, refs, mname, ranks, name, CASES[name])


@pytest.mark.parametrize("case", [c for c in MESH_CASES if CASES[c[3]].get("keep")],
                         ids=lambda c: f"{c[0]}-{c[3]}")
def test_moe_slices_are_the_reference_shards(moe_runs, case):
    res, _, trees = moe_runs
    mname, kw, ranks, name = case
    leaves = {r: res[r][(mname, name)]["leaves"] for r in ranks}
    check_slices(leaves, kw, ranks, trees[CASES[name]["tree"]])
    # the expert stacks are really cut: E over expert, F over tensor
    E = 4 // kw.get("expert", 1)
    F = 64 // kw.get("tensor", 1)
    suffix = "/q8" if name == "moe_int8" else ""
    got = dict(leaves[ranks[0]])
    assert got["layers/w_gate" + suffix].shape == (2, E, 32, F)
    assert got["layers/w_out" + suffix].shape == (2, E, F, 32)


def test_expert_mesh_holds_half_the_experts(moe_runs):
    res, _, _ = moe_runs
    for r in (2, 3):
        leaves = dict(res[r][("expert=2", "moe")]["leaves"])
        assert leaves["layers/w_in"].shape[1] == 2
        assert leaves["layers/moe_gate"].shape == (2, 32, 4)  # the router is whole


# -- serve --tensor ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _serve(tensor: int, *more):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.serve", "--init", "--cpu",
           "--tensor", str(tensor), "--port", str(port), "--host", "127.0.0.1",
           "--vocab-size", "97", "--d-model", "64", "--n-layers", "2", "--n-heads", "4",
           "--d-ff", "128", "--dtype", "float32", "--max-batch", "2", "--max-len", "64",
           "--page-size", "8", "--fused-steps", "4", *more]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, port


def _wait_up(proc, port):
    deadline = time.monotonic() + 120
    while True:
        try:
            return _call(port, "/healthz")
        except OSError:
            pass
        assert proc.poll() is None, proc.stderr.read()
        assert time.monotonic() < deadline, "serve did not come up"
        time.sleep(0.2)


def _healthz_until_ready(proc, port) -> list:
    """/healthz polled from the start until it answers 200; the 503
    bodies seen on the way."""
    deadline, seen = time.monotonic() + 120, []
    while True:
        try:
            _call(port, "/healthz")
            return seen
        except urllib.error.HTTPError as e:
            seen.append(json.loads(e.read()))
        except OSError:
            pass
        assert proc.poll() is None, proc.stderr.read()
        assert time.monotonic() < deadline, "serve did not become ready"
        time.sleep(0.02)


def test_serve_tensor_2_answers_like_tensor_1():
    procs = [_serve(1), _serve(2, "--warmup", "lattice")]
    try:
        answers, stats = [], []
        warming = _healthz_until_ready(*procs[1])
        assert warming and all(b["warming"] and not b["ok"] for b in warming)
        wu = _call(procs[1][1], "/v1/stats")["warmup"]
        assert wu["state"] == "ready" and wu["errors"] == 0 and wu["mesh"] == {"tensor": 2}
        assert wu["lattice_size"] > 0 and wu["built"] == wu["lattice_size"]
        assert sorted(wu["ranks"]) == ["0", "1"]
        assert all(r["built"] == wu["lattice_size"] for r in wu["ranks"].values())
        for proc, port in procs:
            _wait_up(proc, port)
            answers.append([_call(port, "/v1/completions", {"prompt": p, "max_tokens": 8})
                            ["tokens"] for p in ([5, 17, 3], [60, 2, 9, 9])])
            stats.append(_call(port, "/v1/stats"))
        assert answers[0] == answers[1] and all(len(t) == 8 for t in answers[0])
        assert stats[0]["mesh"] is None
        assert stats[1]["mesh"] == {"shape": {"tensor": 2}, "ranks": 2}
        for proc, _ in procs:
            proc.send_signal(signal.SIGTERM)
        for proc, _ in procs:
            assert proc.wait(timeout=90) == 0, proc.stderr.read()
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _rank_processes(pid: int) -> list[int]:
    """The ranks ``serve`` started: its children that run a spawned rank
    (not multiprocessing's resource tracker)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline") as f:
                cmd = f.read()
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid and "spawn_main" in cmd:
            out.append(int(d))
    return out


def test_serve_tensor_2_prefill_replica_feeds_a_decode_replica():
    """``serve --tensor 2 --fleet-role prefill`` prefills (/v1/prefill) and
    ships whole-head pages (/v1/kv/export through rank 0's tickets); a
    one-device ``--fleet-role decode`` replica adopts them through
    ``X-KV-Source`` and answers with ``--tensor 1``'s tokens."""
    from elastic_gpu_scheduler_tpu_torch.utils import kvwire

    P = _serve(2, "--prefix-cache", "--fleet-role", "prefill")
    D = _serve(1, "--prefix-cache", "--fleet-role", "decode")
    B = _serve(1)
    procs = [P, D, B]
    prompts = [list(range(3, 23)), [60, 2, 9, 9] * 5 + [1]]  # 2 and 2 full pages of 8
    try:
        for proc, port in procs:
            _wait_up(proc, port)
        want = [_call(B[1], "/v1/completions", {"prompt": p, "max_tokens": 8})["tokens"]
                for p in prompts]
        got = []
        for p in prompts:
            assert _call(P[1], "/v1/prefill", {"prompt": p})["pages"] == 2
            req = urllib.request.Request(
                f"http://127.0.0.1:{D[1]}/v1/completions",
                data=json.dumps({"prompt": p, "max_tokens": 8}).encode(),
                headers={"Content-Type": "application/json",
                         kvwire.KV_SOURCE_HEADER: f"127.0.0.1:{P[1]}"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                got.append(json.loads(resp.read())["tokens"])
        assert got == want
        req = urllib.request.Request(f"http://127.0.0.1:{P[1]}/v1/kv/export",
                                     data=json.dumps({"tokens": prompts[0]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            hdr, pages = kvwire.decode_bundle(resp.read())
        assert hdr["kv_heads"] == 4 and len(pages) == 2
        sp, sd = _call(P[1], "/v1/stats"), _call(D[1], "/v1/stats")
        assert sp["mesh"] == {"shape": {"tensor": 2}, "ranks": 2} and sp["role"] == "prefill"
        assert sp["kv"]["pages_exported"] == 6 and sp["kv"]["export_bundles"] == 3
        assert sd["role"] == "decode" and sd["kv"]["pages_imported"] == 4
        assert sd["kv"]["prefix_hits"] == 2
        for proc, _ in procs:
            proc.send_signal(signal.SIGTERM)
        for proc, _ in procs:
            assert proc.wait(timeout=90) == 0, proc.stderr.read()
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_serve_tensor_2_exits_when_a_rank_is_lost():
    """A follower lost mid-service: rank 0's next collective fails, the
    request waiting on it is a 503 at once (not a timeout), and ``serve``
    exits 1 so the replica is restarted."""
    proc, port = _serve(2)
    try:
        _wait_up(proc, port)
        ranks = _rank_processes(proc.pid)
        assert len(ranks) == 1, ranks
        os.kill(ranks[0], signal.SIGKILL)
        with pytest.raises(urllib.error.HTTPError) as err:
            _call(port, "/v1/completions", {"prompt": [5, 17, 3], "max_tokens": 8})
        assert err.value.code == 503
        assert "failed" in json.loads(err.value.read())["error"]
        assert proc.wait(timeout=90) == 1, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_tensor_refuses_what_it_cannot_run():
    from elastic_gpu_scheduler_tpu_torch import serve

    for role in ("prefill", "decode"):
        args = serve.build_args(["--init", "--cpu", "--tensor", "2", "--prefix-cache",
                                 "--fleet-role", role])
        assert serve.start_checks(args) == role
    with pytest.raises(SystemExit, match="--fleet-role prefill requires --prefix-cache"):
        serve.main(["--init", "--cpu", "--tensor", "2", "--fleet-role", "prefill"])
    with pytest.raises(SystemExit, match="at least 1"):
        serve.main(["--init", "--cpu", "--tensor", "0"])
    args = serve.build_args(["--init", "--tensor", "4"])
    if torch.cuda.device_count() < 4:
        with pytest.raises(SystemExit, match="--tensor 4 needs that many devices"):
            serve.check_tensor_devices(args)
    serve.check_tensor_devices(serve.build_args(["--init", "--tensor", "4",
                                                 "--dist-backend", "gloo"]))
