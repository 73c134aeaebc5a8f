"""``serve --hf`` / ``--draft-hf`` and the port's checkpoint readers.

The port's own safetensors reader (``utils/safetensors``) and
``convert.load_hf_state_dict`` against ``transformers``' and the
``safetensors`` package's files: ``save_pretrained`` with safetensors,
then ``.bin`` only, and BF16 / F16 files from ``safetensors.torch``; the
tensors must be equal bit for bit.  The port's writer reads back in the
``safetensors`` package.

``serve --hf DIR --cpu`` runs in its own process, as a pod would start it,
and must answer completions token-identical (float32 greedy) to the
reference's engine on the reference's conversion of the same weights
(behind ``reference_engine_copies_uploads``); ``--int8`` with a
``--draft-hf`` draft and ``--spec-k`` must answer what the port's engine
answers in memory on the quantized import without speculation.
``--draft-hf`` without ``--spec-k`` exits before any weight is read.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import safetensors.torch
import torch
import transformers

from elastic_gpu_scheduler_tpu import serve as ref_serve
from elastic_gpu_scheduler_tpu.models import convert as ref_convert
from elastic_gpu_scheduler_tpu.models.serving import (
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from elastic_gpu_scheduler_tpu_torch import serve
from elastic_gpu_scheduler_tpu_torch.models import convert
from elastic_gpu_scheduler_tpu_torch.models.quantize import quantize_params
from elastic_gpu_scheduler_tpu_torch.models.serving import InferenceEngine, Request
from elastic_gpu_scheduler_tpu_torch.utils import safetensors as port_st

from test_torch_engine import reference_engine_copies_uploads  # noqa: F401  (autouse)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = ["--max-batch", "2", "--max-len", "64", "--page-size", "8", "--fused-steps", "4"]
PROMPTS = [[3, 17, 42, 99, 7], [5, 6, 7, 1, 2, 3, 4, 8, 9], [11]]
MAX_NEW = 7


def _model(seed, layers=2):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=layers,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{"st": safetensors dir, "bin": .bin-only dir, "draft": a 1-layer
    draft (safetensors)} and the base model."""
    model = _model(0)
    dirs = {}
    for name, safe in (("st", True), ("bin", False)):
        d = tmp_path_factory.mktemp(name)
        model.save_pretrained(d, safe_serialization=safe)
        dirs[name] = str(d)
    d = tmp_path_factory.mktemp("draft")
    _model(1, layers=1).save_pretrained(d, safe_serialization=True)
    dirs["draft"] = str(d)
    return dirs, model


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_reader_reads_save_pretrained_safetensors(hf_dirs):
    dirs, model = hf_dirs
    files = sorted(f for f in os.listdir(dirs["st"]) if f.endswith(".safetensors"))
    assert files
    want = {}
    for f in files:
        want.update(safetensors.torch.load_file(os.path.join(dirs["st"], f)))
    _same(convert.load_hf_state_dict(dirs["st"]), want)
    _same(want, model.state_dict())


def test_reader_reads_bin_only_dirs(hf_dirs):
    dirs, model = hf_dirs
    assert not [f for f in os.listdir(dirs["bin"]) if f.endswith(".safetensors")]
    _same(convert.load_hf_state_dict(dirs["bin"]), model.state_dict())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_reader_reads_each_dtype(tmp_path, dtype):
    g = torch.Generator().manual_seed(4)
    tensors = {"a.weight": torch.randn(5, 7, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype),
               "scalar": torch.tensor(2.5, dtype=dtype)}
    path = tmp_path / "w.safetensors"
    safetensors.torch.save_file(tensors, str(path), metadata={"format": "pt"})
    _same(port_st.load_file(path), tensors)


def test_writer_reads_back_in_safetensors(tmp_path):
    g = torch.Generator().manual_seed(5)
    tensors = {"x": torch.randn(4, 6, generator=g).to(torch.bfloat16),
               "y": torch.randn(9, generator=g), "z": torch.randn(2, 3, generator=g).half()}
    path = tmp_path / "w.safetensors"
    n = port_st.save_file(tensors, path, metadata={"format": "pt"})
    assert n == path.stat().st_size
    _same(safetensors.torch.load_file(str(path)), tensors)
    with safetensors.safe_open(str(path), "pt") as f:
        assert f.metadata() == {"format": "pt"}
    _same(port_st.load_file(path), tensors)


def test_reader_refuses_other_dtypes_and_prefers_safetensors(tmp_path):
    safetensors.torch.save_file({"i": torch.arange(4)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        port_st.load_file(tmp_path / "i.safetensors")
    d = tmp_path / "both"
    d.mkdir()
    safetensors.torch.save_file({"w": torch.ones(2)}, str(d / "model.safetensors"))
    (d / "pytorch_model.bin").write_bytes(b"not a pickle")  # never opened
    _same(convert.load_hf_state_dict(d), {"w": torch.ones(2)})
    with pytest.raises(SystemExit, match="no weight files found under"):
        convert.load_hf_state_dict(tmp_path / "nothing-here")


def test_source_flags_match_the_references():
    for argv in (["--hf", "d"], ["--init"], ["--hf", "d", "--draft-hf", "e", "--spec-k", "4"]):
        ref, port = ref_serve.build_args(argv), serve.build_args(argv)
        assert (port.hf, port.init, port.draft_hf, port.spec_k) == (
            ref.hf, ref.init, ref.draft_hf, ref.spec_k)
    for argv in ([], ["--hf", "d", "--init"]):
        with pytest.raises(SystemExit):
            serve.build_args(argv)
        with pytest.raises(SystemExit):
            ref_serve.build_args(argv)


def test_draft_hf_without_spec_k_exits_before_reading(monkeypatch):
    def no_read(*_a, **_k):
        raise AssertionError("a weight was read")

    monkeypatch.setattr(convert, "load_hf_state_dict", no_read)
    monkeypatch.setattr(convert, "load_file", no_read)
    with pytest.raises(SystemExit, match="--draft-hf requires --spec-k > 0"):
        serve.main(["--hf", "/no/such/dir", "--draft-hf", "/no/such/draft", "--cpu"])


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _call(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _serve_tokens(args: list) -> tuple[list, str, dict]:
    """Greedy tokens of PROMPTS from ``serve --cpu`` with ``args`` in its own
    process, its log and its ``/v1/stats``; SIGTERM drains it and it exits 0."""
    port = _free_port()
    cmd = [sys.executable, "-m", "elastic_gpu_scheduler_tpu_torch.serve", "--cpu",
           "--port", str(port), "--host", "127.0.0.1", *ENGINE, *args]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    addr = ("127.0.0.1", port)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _call(addr, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline, "serve did not come up"
            time.sleep(0.2)
        out = []
        for p in PROMPTS:
            code, body = _call(addr, "POST", "/v1/completions",
                               {"prompt": p, "max_tokens": MAX_NEW})
            assert code == 200, body
            out.append(body["tokens"])
        stats = _call(addr, "GET", "/v1/stats")[1]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        return out, proc.stderr.read(), stats
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_hf_answers_as_the_reference_engine(hf_dirs):
    """``serve --hf`` of a ``save_pretrained`` directory against the
    reference's engine on the reference's conversion of the same state dict
    (the reference's own ``serve --hf`` cannot start: it hands the
    ``config.json`` dict to a converter that reads attributes)."""
    dirs, model = hf_dirs
    got, err, stats = _serve_tokens(["--hf", dirs["st"]])
    assert stats["spec_k"] == 0
    assert "serving hf-imported model (2 layers, d=64)" in err
    rcfg = ref_convert.config_from_hf_llama(model.config)
    rparams = ref_convert.params_from_hf_llama(model.state_dict(), rcfg)
    eng = JaxEngine(rparams, rcfg, max_batch=2, max_len=64, page_size=8, fused_steps=4,
                    overlap=False)
    reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=MAX_NEW)) for p in PROMPTS]
    eng.run_until_idle()
    assert got == [r.output for r in reqs]
    assert all(len(t) == MAX_NEW for t in got)


def test_serve_hf_int8_with_a_draft_answers_as_the_engine_in_memory(hf_dirs):
    """``--hf --int8 --draft-hf --spec-k 3``: the quantized import served
    with draft-model speculation answers the port's engine on the same
    quantized params without speculation (greedy speculation is exact)."""
    dirs, _ = hf_dirs
    got, err, stats = _serve_tokens(["--hf", dirs["bin"], "--int8", "--draft-hf",
                                     dirs["draft"], "--spec-k", "3"])
    assert "serving hf-imported model" in err
    assert stats["spec_k"] == 3 and stats["spec_passes"] > 0
    params, cfg = convert.load_hf(dirs["st"])
    eng = InferenceEngine(quantize_params(params), cfg, max_batch=2, max_len=64, page_size=8,
                          fused_steps=4, overlap=False, device="cpu")
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW)) for p in PROMPTS]
    eng.run_until_idle()
    assert got == [r.output for r in reqs]
    assert [len(t) for t in got] == [MAX_NEW] * len(PROMPTS)
