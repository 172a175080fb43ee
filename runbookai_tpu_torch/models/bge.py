"""bge-base-en-v1.5 (BERT-base) encoder in PyTorch — the knowledge embedder model.

A port of the JAX package's ``models/bge.py``: the same parameter layout
(``layers`` stacked ``[L, ...]``, projections ``[in, out]``), post-LN BERT
blocks, bidirectional attention with an additive padding mask of -1e30, an
f32 softmax, the tanh-approximated GELU (``jax.nn.gelu``'s default), CLS
pooling and L2 normalisation with ``max(norm, 1e-9)``. The encoder is plain
torch ops, one code path on the CPU and the card; f32 matmuls stay full f32
(no TF32), as the reference computes them.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from runbookai_tpu_torch.models.hf_loader import _read_dir


@dataclass(frozen=True)
class BertConfig:
    name: str
    vocab_size: int = 30_522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS = {
    "bge-base-en-v1.5": BertConfig(name="bge-base-en-v1.5"),
    "bge-test": BertConfig(name="bge-test", vocab_size=262, dim=32, n_layers=2,
                           n_heads=4, ffn_dim=64, max_positions=128),
}

LAYER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "attn_norm_w",
              "attn_norm_b", "w1", "b1", "w2", "b2", "mlp_norm_w", "mlp_norm_b")


def init_params(cfg: BertConfig, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """Random params in the JAX layout: normal / sqrt(fan_in) matrices, zero
    biases, unit norms. Drawn on the CPU from ``generator`` (a CPU
    generator) in the JAX package's order and moved to ``device``, so one
    seed gives the same weights on the CPU and on the card. JAX draws from
    its own PRNG, so the values differ from the JAX package's."""
    L, D, Fd = cfg.n_layers, cfg.dim, cfg.ffn_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32) / math.sqrt(fan_in)
        return w.to(device=device, dtype=dtype)

    def const(shape, value, leaf_dtype):
        return torch.full(shape, value, dtype=leaf_dtype, device=device)

    params = {
        "word_emb": dense((cfg.vocab_size, D), D),
        "pos_emb": dense((cfg.max_positions, D), D),
        "type_emb": dense((cfg.type_vocab_size, D), D),
        "emb_norm_w": const((D,), 1.0, torch.float32),
        "emb_norm_b": const((D,), 0.0, torch.float32),
    }
    layers = {"wq": dense((L, D, D), D), "wk": dense((L, D, D), D),
              "wv": dense((L, D, D), D), "wo": dense((L, D, D), D),
              "w1": dense((L, D, Fd), D), "w2": dense((L, Fd, D), Fd)}
    for b, n in (("bq", D), ("bk", D), ("bv", D), ("bo", D), ("b1", Fd), ("b2", D)):
        layers[b] = const((L, n), 0.0, dtype)
    for norm in ("attn_norm", "mlp_norm"):
        layers[f"{norm}_w"] = const((L, D), 1.0, torch.float32)
        layers[f"{norm}_b"] = const((L, D), 0.0, torch.float32)
    params["layers"] = {k: layers[k] for k in LAYER_KEYS}
    return params


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (((xf - mean) * torch.rsqrt(var + eps)) * w + b).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


class BertEncoder(nn.Module):
    """The encoder over ``params`` (the JAX layout): top-level leaves are
    buffers of this module, the stacked layer leaves buffers of
    ``self.layers``. Inference only."""

    def __init__(self, cfg: BertConfig, params: dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.Module()
        for name, value in params.items():
            if name != "layers":
                self.register_buffer(name, value)
        for name in LAYER_KEYS:
            self.layers.register_buffer(name, params["layers"][name])

    @property
    def device(self) -> torch.device:
        return self.word_emb.device

    @torch.inference_mode()
    def encode(self, tokens: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``tokens``, ``attention_mask`` [B, T] (mask 1 for real tokens) ->
        L2-normalised [B, dim] float32 embeddings (CLS pooling). Runs
        eagerly: on the card it refuses to run inside a CUDA graph capture."""
        if tokens.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the bge encoder runs eagerly: a CUDA graph capture is open")
        cfg = self.cfg
        b, t = tokens.shape
        nh, hd = cfg.n_heads, cfg.head_dim
        h = self.word_emb[tokens.long()] + self.pos_emb[None, :t] + self.type_emb[0][None, None, :]
        h = layer_norm(h, self.emb_norm_w, self.emb_norm_b, cfg.norm_eps)
        # Additive mask [B, 1, 1, T]: padded keys masked for every query.
        mask = torch.where(attention_mask[:, None, None, :] > 0,
                           torch.zeros((), dtype=torch.float32, device=h.device),
                           torch.full((), -1e30, dtype=torch.float32, device=h.device))
        lw = self.layers
        for i in range(cfg.n_layers):
            q = (h @ lw.wq[i] + lw.bq[i]).reshape(b, t, nh, hd)
            k = (h @ lw.wk[i] + lw.bk[i]).reshape(b, t, nh, hd)
            v = (h @ lw.wv[i] + lw.bv[i]).reshape(b, t, nh, hd)
            scores = torch.einsum("bthd,bshd->bhts", q, k).float()
            scores = scores / math.sqrt(hd) + mask
            attn = torch.softmax(scores, dim=-1).to(h.dtype)
            ctx = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, cfg.dim)
            h = layer_norm(h + (ctx @ lw.wo[i] + lw.bo[i]),
                           lw.attn_norm_w[i], lw.attn_norm_b[i], cfg.norm_eps)
            ffn = gelu(h @ lw.w1[i] + lw.b1[i]) @ lw.w2[i] + lw.b2[i]
            h = layer_norm(h + ffn, lw.mlp_norm_w[i], lw.mlp_norm_b[i], cfg.norm_eps)
        cls = h[:, 0].float()
        return cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-9)


# --------------------------------------------------------------------------- #
# HF loading                                                                  #
# --------------------------------------------------------------------------- #

_HF_LAYER = {
    "wq": ("encoder.layer.{i}.attention.self.query.weight", True),
    "bq": ("encoder.layer.{i}.attention.self.query.bias", False),
    "wk": ("encoder.layer.{i}.attention.self.key.weight", True),
    "bk": ("encoder.layer.{i}.attention.self.key.bias", False),
    "wv": ("encoder.layer.{i}.attention.self.value.weight", True),
    "bv": ("encoder.layer.{i}.attention.self.value.bias", False),
    "wo": ("encoder.layer.{i}.attention.output.dense.weight", True),
    "bo": ("encoder.layer.{i}.attention.output.dense.bias", False),
    "attn_norm_w": ("encoder.layer.{i}.attention.output.LayerNorm.weight", False),
    "attn_norm_b": ("encoder.layer.{i}.attention.output.LayerNorm.bias", False),
    "w1": ("encoder.layer.{i}.intermediate.dense.weight", True),
    "b1": ("encoder.layer.{i}.intermediate.dense.bias", False),
    "w2": ("encoder.layer.{i}.output.dense.weight", True),
    "b2": ("encoder.layer.{i}.output.dense.bias", False),
    "mlp_norm_w": ("encoder.layer.{i}.output.LayerNorm.weight", False),
    "mlp_norm_b": ("encoder.layer.{i}.output.LayerNorm.bias", False),
}


def load_params(model_dir: str | Path, dtype: torch.dtype = torch.float32,
                device="cuda") -> tuple[BertConfig, dict]:
    """Load a bge/BERT checkpoint from an HF directory (safetensors) onto
    ``device``: names with or without the ``bert.`` prefix, ``[out, in]``
    projections transposed, norms in float32."""
    model_dir = Path(model_dir)
    raw = json.loads((model_dir / "config.json").read_text())
    cfg = BertConfig(
        name=model_dir.name,
        vocab_size=raw["vocab_size"], dim=raw["hidden_size"],
        n_layers=raw["num_hidden_layers"], n_heads=raw["num_attention_heads"],
        ffn_dim=raw["intermediate_size"],
        max_positions=raw.get("max_position_embeddings", 512),
        type_vocab_size=raw.get("type_vocab_size", 2),
        norm_eps=raw.get("layer_norm_eps", 1e-12),
    )
    tensors = _read_dir(model_dir)

    def get(name: str) -> torch.Tensor:
        for candidate in (name, f"bert.{name}"):
            if candidate in tensors:
                return tensors[candidate]
        raise KeyError(name)

    def put(x: torch.Tensor, leaf_dtype: torch.dtype) -> torch.Tensor:
        return x.to(device=device, dtype=leaf_dtype).contiguous()

    params: dict[str, Any] = {
        "word_emb": put(get("embeddings.word_embeddings.weight"), dtype),
        "pos_emb": put(get("embeddings.position_embeddings.weight"), dtype),
        "type_emb": put(get("embeddings.token_type_embeddings.weight"), dtype),
        "emb_norm_w": put(get("embeddings.LayerNorm.weight"), torch.float32),
        "emb_norm_b": put(get("embeddings.LayerNorm.bias"), torch.float32),
    }
    layers: dict[str, torch.Tensor] = {}
    for leaf, (tmpl, transpose) in _HF_LAYER.items():
        mats = [get(tmpl.format(i=i)) for i in range(cfg.n_layers)]
        stacked = torch.stack([m.T if transpose else m for m in mats])
        layers[leaf] = put(stacked, torch.float32 if "norm" in leaf else dtype)
    params["layers"] = layers
    return cfg, params


def load_or_init(model_name: str, model_path: Optional[str | Path],
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda") -> tuple[BertConfig, dict]:
    """The HF directory at ``model_path`` when it exists, else
    ``model_name``'s config (``bge-test`` for an unknown name, as the JAX
    package does) with random params from ``seed``, on ``device``."""
    if model_path and Path(model_path).exists():
        return load_params(model_path, dtype=dtype, device=device)
    cfg = CONFIGS.get(model_name, CONFIGS["bge-test"])
    gen = torch.Generator().manual_seed(seed)
    return cfg, init_params(cfg, gen, device=device, dtype=dtype)
