"""Int8 weight-only quantization for serving.

The counterpart of ``runbookai_tpu/models/quant.py``. For a weight
``w [.., in, out]``, ``scale = max|w| / 127`` over the input axis (one scale
per output channel, clamped at 1e-8 for all-zero channels) and ``q =
round(w / scale)``, clipped to [-127, 127]. The matmul widens ``q`` to the
activation dtype and applies the scale to the output, which equals
dequantize-then-matmul because the scale is constant along the contraction:
``sum_i x_i q_io s_o == s_o sum_i x_i q_io``.

Quantized leaves are plain dicts ``{"q": int8 [L, in, out], "s": float32
[L, 1, out]}``, the JAX package's layout, so parameters convert one to one;
MoE experts ``[L, E, in, out]`` take one scale a (layer, expert, output
channel), ``[L, E, 1, out]``. Norms, embeddings, the LM head and a MoE
router stay in the activation dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Params = dict[str, Any]

# Stacked layer matrices that dominate the byte budget.
LAYER_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_array_np(w, in_axis: int = -2) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy) quantization for the weight-loading path: the full
    tensor never reaches the device. Returns ``(q int8, s float32)``."""
    wf = np.asarray(w, dtype=np.float32)
    s = np.abs(wf).max(axis=in_axis, keepdims=True) / 127.0
    s = np.maximum(s, 1e-8)
    q = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def quantize_tensor(w: torch.Tensor, in_axis: int = -2) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: ``{"q": int8, "s": float32}``, the
    scale keeping the reduced axis. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    wf = w.float()
    s = wf.abs().amax(dim=in_axis, keepdim=True) / 127.0
    s = s.clamp_min(1e-8)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_tensor(w: dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (w["q"].float() * w["s"]).to(dtype)


def quantize_params(params: Params) -> Params:
    """Serving transform: quantize the seven stacked layer matrices."""
    out = dict(params)
    out["layers"] = {k: quantize_tensor(v) if k in LAYER_QUANT_KEYS else v
                     for k, v in params["layers"].items()}
    return out


def dequantize_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    out = dict(params)
    out["layers"] = {k: dequantize_tensor(v, dtype) if is_quantized(v) else v
                     for k, v in params["layers"].items()}
    return out


def weight_bytes(params: Any) -> int:
    """Total bytes across all weight leaves (quantized or not)."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
