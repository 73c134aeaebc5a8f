"""Weight import: HF Llama-architecture checkpoints into the port's params.

Counterpart of ``elastic_gpu_scheduler_tpu/models/convert.py``.  The
flagship decoder (``models/transformer.py``) is a Llama-family decoder
(RMSNorm pre-norm, SwiGLU MLP, half-split RoPE, no biases), so HF
``LlamaForCausalLM`` weights map one to one:

    model.embed_tokens.weight         → embed            (V, D)
    layers.N.input_layernorm          → attn_norm[N]     (D,)
    layers.N.self_attn.{q,k,v}_proj   → wq/wk/wv[N]      (D, H)   [transposed]
    layers.N.self_attn.o_proj         → wo[N]            (H, D)   [transposed]
    layers.N.post_attention_layernorm → mlp_norm[N]      (D,)
    layers.N.mlp.gate_proj            → w_gate[N]        (D, F)   [transposed]
    layers.N.mlp.up_proj              → w_in[N]          (D, F)   [transposed]
    layers.N.mlp.down_proj            → w_out[N]         (F, D)   [transposed]
    model.norm                        → final_norm       (D,)
    lm_head.weight                    → unembed          (D, V)   [transposed]

GQA checkpoints map through ``n_kv_heads``, Mistral-style sliding windows
through ``window_size``.  The model runs in float32, as the reference's
conversion sets it.

``config_from_hf_llama`` takes a config object (``transformers``'
``LlamaConfig``) or the plain dict of a ``config.json``, which it reads
through an attribute view, so ``serve --hf`` can hand it the file's
contents.  ``load_hf_state_dict`` reads a checkpoint directory with the
port's own safetensors reader (``utils/safetensors``), or ``torch.load``
with ``weights_only=True`` for ``pytorch_model*.bin`` shards when the
directory holds no safetensors file.  Conversion runs on the host; the
engine moves the params to its device once.
"""

from __future__ import annotations

import json
import pathlib

import torch

from ..utils.safetensors import load_file
from .transformer import TransformerConfig, resolve_device


class _AttrView:
    """A ``config.json`` dict read the way a config object is read:
    ``getattr(view, key[, default])``."""

    def __init__(self, d: dict):
        self._d = d

    def __getattr__(self, name):
        try:
            return self.__dict__["_d"][name]
        except KeyError:
            raise AttributeError(name) from None


def config_from_hf_llama(hf_config) -> TransformerConfig:
    """The port's config of an HF Llama / Mistral config; raises on what
    the forward does not model (rope scaling, biases, a head_dim other
    than hidden / heads) rather than convert it wrongly."""
    if isinstance(hf_config, dict):
        hf_config = _AttrView(hf_config)
    if getattr(hf_config, "rope_scaling", None):
        raise ValueError("rope_scaling (e.g. llama3 long-context scaling) not supported")
    if getattr(hf_config, "attention_bias", False) or getattr(hf_config, "mlp_bias", False):
        raise ValueError("bias terms (attention_bias/mlp_bias) not supported")
    explicit_hd = getattr(hf_config, "head_dim", None)
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    if explicit_hd and explicit_hd != derived_hd:
        raise ValueError(f"explicit head_dim {explicit_hd} != hidden/heads {derived_hd}")
    heads = hf_config.num_attention_heads
    kv = getattr(hf_config, "num_key_value_heads", None) or heads
    window = getattr(hf_config, "sliding_window", None) or 0
    return TransformerConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=heads,
        n_kv_heads=0 if kv == heads else kv,
        window_size=int(window),
        d_ff=hf_config.intermediate_size,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        dtype="float32",
    )


def params_from_hf_llama(state_dict, cfg: TransformerConfig, device=None) -> dict:
    """The port's params tree (float32, weights (in, out), layers stacked)
    of an HF ``LlamaForCausalLM`` state dict; tied embeddings (no
    ``lm_head.weight``) give ``unembed = embed.T``."""
    dev = resolve_device(device)

    def get(name: str) -> torch.Tensor:
        return state_dict[name].detach().to(device=dev, dtype=torch.float32)

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        return torch.stack([get(fmt.format(i)).t() if transpose else get(fmt.format(i))
                            for i in range(cfg.n_layers)]).contiguous()

    embed = get("model.embed_tokens.weight").contiguous()
    if "lm_head.weight" in state_dict:
        unembed = get("lm_head.weight").t().contiguous()
    else:  # tied embeddings
        unembed = embed.t().contiguous()
    layer = "model.layers.{}."
    return {
        "embed": embed,
        "layers": {
            "attn_norm": stack(layer + "input_layernorm.weight", False),
            "wq": stack(layer + "self_attn.q_proj.weight", True),
            "wk": stack(layer + "self_attn.k_proj.weight", True),
            "wv": stack(layer + "self_attn.v_proj.weight", True),
            "wo": stack(layer + "self_attn.o_proj.weight", True),
            "mlp_norm": stack(layer + "post_attention_layernorm.weight", False),
            "w_gate": stack(layer + "mlp.gate_proj.weight", True),
            "w_in": stack(layer + "mlp.up_proj.weight", True),
            "w_out": stack(layer + "mlp.down_proj.weight", True),
        },
        "final_norm": get("model.norm.weight").contiguous(),
        "unembed": unembed,
    }


def load_hf_state_dict(path) -> dict[str, torch.Tensor]:
    """Every weight of an HF checkpoint directory, as CPU tensors.

    ``*.safetensors`` files are preferred when present (hub directories
    often carry both formats; reading both would read every tensor
    twice); otherwise the ``pytorch_model*.bin`` shards (never other
    ``.bin`` files such as ``training_args.bin``) go through
    ``torch.load(weights_only=True)``, so an untrusted directory cannot run
    code through pickle.  Exits when the directory holds neither."""
    hf_dir = pathlib.Path(path)
    sd: dict[str, torch.Tensor] = {}
    st_files = sorted(hf_dir.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            sd.update(load_file(f))
    else:
        for f in sorted(hf_dir.glob("pytorch_model*.bin")):
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    if not sd:
        raise SystemExit(f"no weight files found under {hf_dir}")
    return sd


def load_hf(path, device="cpu") -> tuple[dict, TransformerConfig]:
    """(params, cfg) of an HF checkpoint directory: its ``config.json``
    and its weights, converted on ``device`` (the host by default)."""
    hf_dir = pathlib.Path(path)
    cfg = config_from_hf_llama(json.loads((hf_dir / "config.json").read_text()))
    return params_from_hf_llama(load_hf_state_dict(hf_dir), cfg, device), cfg
