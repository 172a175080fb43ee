"""HF checkpoint loading: safetensors -> the port's stacked parameters.

Reads a HuggingFace Llama-family directory (``config.json`` +
``*.safetensors``), transposes ``[out, in]`` projection weights to the
``[in, out]`` convention and stacks per-layer weights on a leading axis,
exactly as the JAX package's loader does. The safetensors files are parsed
here (an 8-byte header length, a JSON header, then raw little-endian
tensors), so loading needs no package beyond torch and numpy.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from runbookai_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    get_config,
    init_params,
    init_params_quantized,
)
from runbookai_tpu_torch.models.quant import LAYER_QUANT_KEYS, quantize_array_np

# Our layer-stacked param leaf -> (HF template, transpose?)
_LAYER_MAP = {
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
}

# Mixtral's expert leaves -> the HF expert part that replaces the dense MLP.
_MOE_MAP = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}

# Qwen2-only bias leaves (1-D per layer, no transpose).
_BIAS_MAP = {
    "bq": "model.layers.{i}.self_attn.q_proj.bias",
    "bk": "model.layers.{i}.self_attn.k_proj.bias",
    "bv": "model.layers.{i}.self_attn.v_proj.bias",
}

SUPPORTED_MODEL_TYPES = ("llama", "qwen2", "mistral", "mixtral")

_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16,
              "I64": np.int64, "I32": np.int32}


def config_from_hf(model_dir: str | Path, name: str = "hf-model") -> LlamaConfig:
    raw = json.loads((Path(model_dir) / "config.json").read_text())
    model_type = raw.get("model_type", "llama")
    if model_type not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"model_type {model_type!r} not supported; known: "
            f"{SUPPORTED_MODEL_TYPES}")
    # Llama-3.1-style long-context rope scaling (rope_type "llama3"). Other
    # schemes would silently change long-context logits: refuse them.
    rs = raw.get("rope_scaling") or {}
    rope_scaling = None
    rs_type = rs.get("rope_type", rs.get("type"))
    if rs_type == "llama3":
        rope_scaling = (
            float(rs["factor"]),
            float(rs.get("low_freq_factor", 1.0)),
            float(rs.get("high_freq_factor", 4.0)),
            int(rs.get("original_max_position_embeddings", 8192)),
        )
    elif rs_type not in (None, "default"):
        raise ValueError(
            f"rope_scaling type {rs_type!r} not supported (only 'llama3'); "
            f"loading without it would silently change long-context numerics")
    return LlamaConfig(
        name=name,
        vocab_size=raw["vocab_size"],
        dim=raw["hidden_size"],
        n_layers=raw["num_hidden_layers"],
        n_heads=raw["num_attention_heads"],
        n_kv_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
        ffn_dim=raw["intermediate_size"],
        rope_theta=raw.get("rope_theta", 500_000.0),
        rope_scaling=rope_scaling,
        norm_eps=raw.get("rms_norm_eps", 1e-5),
        # Sliding-window checkpoints are served with full attention, exact
        # only up to the window, so the window clamps the context.
        max_seq_len=min(raw.get("max_position_embeddings", 8192),
                        raw.get("sliding_window") or 1 << 30),
        tie_embeddings=raw.get("tie_word_embeddings", False),
        qkv_bias=model_type == "qwen2",
        family=model_type,
        n_experts=raw.get("num_local_experts", 0) if model_type == "mixtral" else 0,
        top_k_experts=raw.get("num_experts_per_tok", 2),
    )


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                             f"{info['dtype']}")
        start, end = info["data_offsets"]
        arr = np.frombuffer(body[start:end], dtype=_ST_DTYPES[info["dtype"]])
        t = torch.from_numpy(arr.copy()).reshape(info["shape"])
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def _read_dir(model_dir: Path) -> dict[str, torch.Tensor]:
    shards = sorted(model_dir.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    tensors: dict[str, torch.Tensor] = {}
    for shard in shards:
        tensors.update(read_safetensors(shard))
    return tensors


def load_params(model_dir: str | Path, cfg: Optional[LlamaConfig] = None,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                quantize_int8: bool = False) -> tuple[LlamaConfig, Params]:
    """Load stacked params from an HF Llama-family directory onto
    ``device``. Norm weights load as float32, everything else as
    ``dtype``. ``quantize_int8`` quantizes the seven stacked layer matrices
    on the host (``quantize_array_np``) into ``{"q": int8, "s": float32}``
    leaves, so their full-precision copies never reach the device. Mixtral
    directories load their experts as ``[L, E, in, out]`` leaves (int8 per
    expert and output channel) and the router as ``[L, D, E]``."""
    model_dir = Path(model_dir)
    cfg = cfg or config_from_hf(model_dir)
    raw = _read_dir(model_dir)

    def put(x: torch.Tensor, leaf_dtype: torch.dtype) -> torch.Tensor:
        return x.to(device=device, dtype=leaf_dtype).contiguous()

    layers: dict[str, torch.Tensor] = {}

    def store(leaf: str, stacked: torch.Tensor) -> None:
        if quantize_int8 and leaf in LAYER_QUANT_KEYS:
            q, s = quantize_array_np(stacked.float().numpy())
            layers[leaf] = {"q": put(torch.from_numpy(q), torch.int8),
                            "s": put(torch.from_numpy(s), torch.float32)}
            return
        layers[leaf] = put(stacked, torch.float32 if leaf.endswith("norm") else dtype)

    for leaf, (tmpl, transpose) in _LAYER_MAP.items():
        if cfg.n_experts and leaf in _MOE_MAP:
            continue
        mats = [raw[tmpl.format(i=i)] for i in range(cfg.n_layers)]
        store(leaf, torch.stack([m.T if transpose else m for m in mats]))
    if cfg.n_experts:
        # Mixtral: each layer's experts stacked on an E axis (w1 = gate, w3 =
        # up, w2 = down, all [out, in], transposed); the router, never
        # quantized, in the activation dtype.
        for leaf, part in _MOE_MAP.items():
            tmpl = "model.layers.{i}.block_sparse_moe.experts.{e}." + part + ".weight"
            store(leaf, torch.stack([
                torch.stack([raw[tmpl.format(i=i, e=e)].T for e in range(cfg.n_experts)])
                for i in range(cfg.n_layers)]))
        layers["router"] = put(torch.stack(
            [raw[f"model.layers.{i}.block_sparse_moe.gate.weight"].T
             for i in range(cfg.n_layers)]), dtype)
    if cfg.qkv_bias:
        for leaf, tmpl in _BIAS_MAP.items():
            layers[leaf] = put(torch.stack(
                [raw[tmpl.format(i=i)] for i in range(cfg.n_layers)]), dtype)
    params: Params = {
        "embed": put(raw["model.embed_tokens.weight"], dtype),
        "layers": layers,
        "final_norm": put(raw["model.norm.weight"], torch.float32),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = put(raw["lm_head.weight"].T, dtype)
    return cfg, params


def load_or_init(model_name: str, model_path: Optional[str | Path],
                 dtype: torch.dtype = torch.bfloat16, device="cuda", seed: int = 0,
                 quantize_int8: bool = False) -> tuple[LlamaConfig, Params]:
    """Load an HF directory at ``model_path`` when it exists, else draw
    ``model_name``'s params at random from ``seed``, on ``device`` (cuda
    unless the caller passes ``device="cpu"``). ``quantize_int8`` gives the
    seven layer matrices as int8 ``{"q", "s"}`` leaves, quantized on the host
    when loaded (``load_params``), drawn directly in int8 when random
    (``init_params_quantized``); ``dtype`` is the activation dtype."""
    if model_path and Path(model_path).exists():
        cfg = config_from_hf(model_path, name=model_name)
        return load_params(model_path, cfg, dtype=dtype, device=device,
                           quantize_int8=quantize_int8)
    cfg = get_config(model_name)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = init_params_quantized if quantize_int8 else init_params
    return cfg, init(cfg, dtype=dtype, device=device, generator=gen)
