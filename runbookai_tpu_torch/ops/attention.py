"""Paged KV writes and the blockwise reference attention.

:func:`write_kv_pages_batch` is the KV scatter of the serving forward.
:func:`paged_attention` is the counterpart of the JAX package's portable XLA
path; the serving forward does not call it (it runs the kernels of
:mod:`runbookai_tpu_torch.ops.paged_attention`). It is kept as a test
reference with the XLA path's semantics, including its fully masked rows,
which average V over the block instead of returning zeros.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def write_kv_pages_batch(
    kv_flat: torch.Tensor,  # [num_pages * page_size, n_kv, head_dim]
    new_kv: torch.Tensor,  # [B, T, n_kv, head_dim]
    positions: torch.Tensor,  # [B, T] absolute positions (pads -> trash column)
    page_tables: torch.Tensor,  # [B, max_pages(+1)] physical page ids per seq
    page_size: int,
) -> torch.Tensor:
    """Scatter a whole batch's new K/V into ``kv_flat`` IN PLACE, in one
    flat ``index_copy_``, and return it.

    Sequences own disjoint pages, so destinations only repeat for padding
    rows, whose positions resolve through the trailing trash column to the
    reserved null page 0, which is never read.
    """
    b, t = positions.shape
    pos = positions.long()
    phys = torch.gather(page_tables, 1, pos // page_size).long()
    dest = (phys * page_size + pos % page_size).reshape(b * t)
    flat_new = new_kv.reshape((b * t,) + tuple(new_kv.shape[2:]))
    return kv_flat.index_copy_(0, dest, flat_new.to(kv_flat.dtype))


def paged_attention(
    q: torch.Tensor,  # [B, T, n_q, head_dim]
    k_flat: torch.Tensor,  # [num_pages * page_size, n_kv, head_dim]
    v_flat: torch.Tensor,  # same
    page_tables: torch.Tensor,  # [B, max_pages]
    ctx_lens: torch.Tensor,  # [B] cached tokens per sequence (incl. chunk)
    q_positions: torch.Tensor,  # [B, T] absolute positions of the queries
    page_size: int,
    block_pages: int = 32,
) -> torch.Tensor:
    """Blockwise online-softmax attention over the page table, causal over
    each query's own position. Returns [B, T, n_q, head_dim]."""
    b, t, n_q, d = q.shape
    n_kv = k_flat.shape[1]
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
        kb = k_flat[flat_idx].float()  # [B, block_tokens, n_kv, d]
        vb = v_flat[flat_idx].float()
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
