"""Paged KV writes, int8 KV quantization and the blockwise reference attention.

:func:`write_kv_pages_batch` is the KV scatter of the serving forward. A pool
is a tensor ``[num_pages * page_size, n_kv, head_dim]`` or, for an int8 KV
cache, a ``(values int8 [..., head_dim], scales float32 [...])`` tuple with
one absmax scale per (token, kv head), written once per token and never
rescaled (:func:`quantize_kv`), as in ``runbookai_tpu/ops/attention.py``.
:func:`paged_attention` is the counterpart of the JAX package's portable XLA
path; the serving forward does not call it (it runs the kernels of
:mod:`runbookai_tpu_torch.ops.paged_attention`). It is kept as a test
reference with the XLA path's semantics, including its fully masked rows,
which average V over the block instead of returning zeros.
"""

from __future__ import annotations

import math
from typing import Union

import torch

NEG_INF = -1e30

Pool = Union[torch.Tensor, tuple]


def quantize_kv(new_kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 values, float32 absmax-per-vector scales [...]).
    The scale is clamped at 1e-8 before the division by 127, unlike
    ``models.quant.quantize_tensor``."""
    x = new_kv.float()
    scale = x.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(x / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def dequant_gather(kv_flat: Pool, idx: torch.Tensor) -> torch.Tensor:
    """Pool rows at ``idx`` as float32, dequantized for an int8 pool."""
    if isinstance(kv_flat, tuple):
        vals, scales = kv_flat
        return vals[idx].float() * scales[idx][..., None]
    return kv_flat[idx].float()


def write_kv_pages_batch(
    kv_flat: Pool,  # [num_pages * page_size, n_kv, head_dim]
    new_kv: torch.Tensor,  # [B, T, n_kv, head_dim]
    positions: torch.Tensor,  # [B, T] absolute positions (pads -> trash column)
    page_tables: torch.Tensor,  # [B, max_pages(+1)] physical page ids per seq
    page_size: int,
) -> Pool:
    """Scatter a whole batch's new K/V into ``kv_flat`` IN PLACE, in one
    flat ``index_copy_`` (one each for an int8 pool's values and scales,
    quantized with :func:`quantize_kv`), and return it.

    Sequences own disjoint pages, so destinations only repeat for padding
    rows, whose positions resolve through the trailing trash column to the
    reserved null page 0, which is never read.
    """
    b, t = positions.shape
    pos = positions.long()
    phys = torch.gather(page_tables, 1, pos // page_size).long()
    dest = (phys * page_size + pos % page_size).reshape(b * t)
    flat_new = new_kv.reshape((b * t,) + tuple(new_kv.shape[2:]))
    if isinstance(kv_flat, tuple):
        vals, scales = kv_flat
        q, s = quantize_kv(flat_new)
        vals.index_copy_(0, dest, q)
        scales.index_copy_(0, dest, s)
        return kv_flat
    return kv_flat.index_copy_(0, dest, flat_new.to(kv_flat.dtype))


def paged_attention(
    q: torch.Tensor,  # [B, T, n_q, head_dim]
    k_flat: Pool,  # [num_pages * page_size, n_kv, head_dim]
    v_flat: Pool,  # same
    page_tables: torch.Tensor,  # [B, max_pages]
    ctx_lens: torch.Tensor,  # [B] cached tokens per sequence (incl. chunk)
    q_positions: torch.Tensor,  # [B, T] absolute positions of the queries
    page_size: int,
    block_pages: int = 32,
) -> torch.Tensor:
    """Blockwise online-softmax attention over the page table, causal over
    each query's own position. Returns [B, T, n_q, head_dim]."""
    b, t, n_q, d = q.shape
    n_kv = (k_flat[0] if isinstance(k_flat, tuple) else k_flat).shape[1]
    group = n_q // n_kv
    max_pages = page_tables.shape[1]
    n_blocks = max(1, -(-max_pages // block_pages))
    block_tokens = block_pages * page_size
    dev = q.device

    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(b, t, n_kv, group, d)
    m = torch.full((b, t, n_kv, group), NEG_INF, device=dev)
    l = torch.zeros((b, t, n_kv, group), device=dev)
    acc = torch.zeros((b, t, n_kv, group, d), device=dev)
    token_off = torch.arange(block_tokens, device=dev)
    for blk in range(n_blocks):
        page_idx = (blk * block_pages + torch.arange(block_pages, device=dev)) % max_pages
        phys = page_tables[:, page_idx].long()  # [B, block_pages]
        flat_idx = phys[:, token_off // page_size] * page_size + token_off % page_size
        kb = dequant_gather(k_flat, flat_idx)  # [B, block_tokens, n_kv, d]
        vb = dequant_gather(v_flat, flat_idx)
        cache_pos = blk * block_tokens + token_off
        valid = (cache_pos[None, :] < ctx_lens[:, None])[:, None, :]
        causal = cache_pos[None, None, :] <= q_positions[:, :, None]
        mask = (valid & causal)[:, :, None, None, :]
        scores = torch.einsum("btkgd,bskd->btkgs", qf, kb)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum("btkgs,bskd->btkgd", p, vb)
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.reshape(b, t, n_q, d).to(q.dtype)
