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

from runbookai_tpu_torch.models.llama import LlamaConfig, Params
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

# safetensors dtype codes <-> torch dtypes.
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I8": torch.int8}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}


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


def iter_safetensors(path: str | Path):
    """``(name, tensor)`` for every tensor of one ``.safetensors`` file, on
    the CPU, in file order. Each tensor's bytes are read straight into its
    own storage (``readinto``), so the host holds the tensors once and, when
    the caller moves each away before the next, one tensor at a time."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        body = 8 + n
        entries = sorted(((name, info) for name, info in header.items()
                          if name != "__metadata__"),
                         key=lambda item: item[1]["data_offsets"][0])
        for name, info in entries:
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                                 f"{info['dtype']}")
            start, end = info["data_offsets"]
            t = torch.empty(info["shape"], dtype=_ST_DTYPES[info["dtype"]])
            if t.numel() * t.element_size() != end - start:
                raise ValueError(f"{path}: tensor {name} holds {end - start} bytes, "
                                 f"not {info['shape']} {info['dtype']}")
            f.seek(body + start)
            if f.readinto(t.reshape(-1).view(torch.uint8).numpy()) != end - start:
                raise ValueError(f"{path}: tensor {name} is cut short")
            yield name, t


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    return dict(iter_safetensors(path))


def write_safetensors(path: str | Path, tensors: dict) -> None:
    """Write ``tensors`` (name -> torch tensor, on any device, or numpy
    array) as one ``.safetensors`` file in insertion order: the 8-byte
    little-endian header length, the JSON header padded with spaces to 8
    bytes, then each tensor's raw little-endian bytes. Tensors reach the
    host one at a time."""
    tensors = {name: torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray)
               else x for name, x in tensors.items()}
    header, off = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _ST_CODES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors code")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)


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
