"""Rotary position embeddings (RoPE) for the Llama family.

Frequencies come from the config and apply at arbitrary (ragged) positions,
as the paged engine needs: decode applies RoPE at per-sequence positions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def rope_frequencies(head_dim: int, theta: float,
                     scaling: Optional[tuple] = None,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32.

    ``scaling`` is the Llama-3.1 long-context NTK-by-parts tuple
    ``(factor, low_freq_factor, high_freq_factor, original_max_pos)``:
    wavelengths shorter than ``orig/high`` keep their frequency, longer
    than ``orig/low`` divide by ``factor``, and the band between
    interpolates smoothly."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if scaling is None:
        return inv_freq
    factor, low, high, orig_max = (float(s) for s in scaling)
    wavelen = 2.0 * math.pi / inv_freq
    smooth = ((orig_max / wavelen - low) / (high - low)).clamp(0.0, 1.0)
    # smooth==1 (short wavelen) -> unscaled; smooth==0 (long) -> /factor.
    return (1.0 - smooth) * inv_freq / factor + smooth * inv_freq


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[tuple] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [B, T, 1, head_dim // 2] at ``positions`` [B, T], float32
    — computed once per forward and shared by every layer."""
    inv_freq = rope_frequencies(head_dim, theta, scaling, positions.device)
    angles = positions.float()[:, :, None] * inv_freq[None, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of ``x`` [B, T, H, D] in float32, returned in
    ``x``'s dtype (the layout of HF Llama checkpoints)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling: Optional[tuple] = None) -> torch.Tensor:
    """Rotate ``x`` of shape [B, T, H, D] at integer ``positions`` [B, T]."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, scaling)
    return rotate(x, cos, sin)
