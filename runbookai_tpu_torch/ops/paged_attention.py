"""Paged attention kernels of the serving forward and their plain versions.

Two CUDA kernels (``csrc/paged_attention.cu``) replace the Pallas TPU
kernels of ``runbookai_tpu/ops/paged_attention_pallas.py``:

- :func:`paged_decode_attention` — one query token per sequence (T = 1);
  replaces Pallas ``paged_decode_attention`` and, over an int8 pool, its
  ``_paged_decode_attention_int8``.
- :func:`paged_chunk_attention` — T > 1 (chunked prefill and the speculative
  verify); replaces Pallas ``paged_chunk_attention``. Over an int8 pool it
  serves the calls that the JAX package sends to its XLA gather path.

A pool is a float32 or bfloat16 tensor, or an int8 pool: a ``(values int8,
scales float32)`` tuple with one absmax scale per (token, kv head)
(:func:`runbookai_tpu_torch.ops.attention.quantize_kv`), dequantized as each
page is loaded.

Semantics follow the Pallas kernels, not the XLA reference
``ops/attention.paged_attention``: a row that sees no key (ctx 0) gives
zeros, and chunk query positions derive from ``q_positions[:, 0] + t`` (the
contiguity contract; the prefill pad tail breaks it, but those rows are
discarded by every caller).

A wrapper given CPU tensors computes the plain version below; given CUDA
tensors it launches the kernel or raises. The kernels are built on first use
(:mod:`runbookai_tpu_torch.ops.build`). ``launches`` counts kernel launches
per wrapper and pool type.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from runbookai_tpu_torch.ops.attention import Pool, dequant_gather
from runbookai_tpu_torch.ops.build import library, raise_on

NEG_INF = -1e30

# Kernel launches per wrapper and pool type (plain-version calls are not
# counted).
launches = {"paged_decode_attention": 0, "paged_chunk_attention": 0,
            "paged_decode_attention_int8": 0, "paged_chunk_attention_int8": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ----------------------------------------------------------- plain version


def plain_paged_attention(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_flat: Pool,  # [num_pages * page_size, n_kv, hd]
    v_flat: Pool,  # same
    page_tables: torch.Tensor,  # [B, P] int32
    ctx_lens: torch.Tensor,  # [B] int32
    q_start: Optional[torch.Tensor],  # [B] int32; None = no causal mask
    page_size: int,
) -> torch.Tensor:
    """Plain PyTorch version of both kernels: gather (and dequantize) each
    sequence's pages, mask keys at ``pos >= ctx`` (and, with ``q_start``, at
    ``pos > q_start + t``), softmax in f32 with masked probabilities zeroed and the
    normaliser clamped at 1e-30. Returns [B, T, n_q, hd] in q's dtype."""
    b, t, n_q, hd = q.shape
    n_kv = (k_flat[0] if isinstance(k_flat, tuple) else k_flat).shape[1]
    group = n_q // n_kv
    max_ctx = int(ctx_lens.max()) if b else 0
    n_pages = min(page_tables.shape[1], -(-max_ctx // page_size))
    if n_pages <= 0:
        return torch.zeros_like(q)
    dev = q.device
    pages = page_tables[:, :n_pages].long()
    rows = (pages[:, :, None] * page_size
            + torch.arange(page_size, device=dev)).reshape(b, -1)  # [B, S]
    k = dequant_gather(k_flat, rows)  # [B, S, n_kv, hd] float32
    v = dequant_gather(v_flat, rows)
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, t, n_kv, group, hd)
    scores = torch.einsum("btkgd,bskd->btkgs", qf, k)
    pos = torch.arange(rows.shape[1], device=dev)
    mask = (pos[None, :] < ctx_lens[:, None].long())[:, None, :]  # [B, 1, S]
    if q_start is not None:
        qpos = q_start[:, None].long() + torch.arange(t, device=dev)  # [B, T]
        mask = mask & (pos[None, None, :] <= qpos[:, :, None])
    mask = mask[:, :, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("btkgs,bskd->btkgd", p, v) / l.clamp_min(1e-30)
    return out.reshape(b, t, n_q, hd).to(q.dtype)


# ------------------------------------------------------------------ wrappers


def _split(k_flat: Pool, v_flat: Pool):
    """(k values, v values, k scales, v scales); scales are None unless the
    pools are int8 ``(values, scales)`` tuples."""
    if isinstance(k_flat, tuple) != isinstance(v_flat, tuple):
        raise ValueError("K and V pools must both be int8 tuples or both tensors")
    if isinstance(k_flat, tuple):
        return k_flat[0], v_flat[0], k_flat[1], v_flat[1]
    return k_flat, v_flat, None, None


def _check(q, k_flat, v_flat, k_scale, v_scale, page_tables, ctx_lens, page_size,
           extra=()):
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, got {q.device}")
    scales = () if k_scale is None else (k_scale, v_scale)
    tensors = (q, k_flat, v_flat, *scales, page_tables, ctx_lens, *extra)
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"tensors on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError("paged attention needs contiguous tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q {q.dtype}: kernels take float32 or bfloat16 queries")
    want = (torch.int8,) if scales else (torch.float32, torch.bfloat16)
    if k_flat.dtype not in want:
        raise TypeError(f"pool {k_flat.dtype}: kernels take float32 or bfloat16 "
                        f"pools, or int8 values with float32 scales")
    if v_flat.dtype != k_flat.dtype or v_flat.shape != k_flat.shape:
        raise ValueError("K and V pools differ in dtype or shape")
    for sc in scales:
        if sc.dtype != torch.float32 or sc.shape != k_flat.shape[:2]:
            raise ValueError(f"int8 pool scales must be float32 "
                             f"{tuple(k_flat.shape[:2])}, got {sc.dtype} "
                             f"{tuple(sc.shape)}")
    for x in (page_tables, ctx_lens, *extra):
        if x.dtype != torch.int32:
            raise TypeError(f"page tables and lengths must be int32, got {x.dtype}")
    n_q, hd = q.shape[-2:]
    if k_flat.ndim != 3 or k_flat.shape[2] != hd or k_flat.shape[0] % page_size:
        raise ValueError(f"pool shape {tuple(k_flat.shape)} does not hold "
                         f"pages of {page_size} x [n_kv, {hd}]")
    if n_q % k_flat.shape[1]:
        raise ValueError(f"{n_q} query heads do not group over {k_flat.shape[1]} kv heads")
    b = q.shape[0]
    if page_tables.ndim != 2 or page_tables.shape[0] != b or ctx_lens.shape != (b,):
        raise ValueError("page tables must be [B, P] and ctx_lens [B]")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def paged_decode_attention(
    q: torch.Tensor,  # [B, n_q, hd]
    k_flat: Pool,  # [num_pages * page_size, n_kv, hd]
    v_flat: Pool,  # same
    page_tables: torch.Tensor,  # [B, P] int32 (physical page ids; 0 = null)
    ctx_lens: torch.Tensor,  # [B] int32
    page_size: int,
) -> torch.Tensor:
    """Ragged paged attention for decode (one query token per sequence)."""
    if q.device.type == "cpu":
        return plain_paged_attention(q[:, None], k_flat, v_flat, page_tables,
                                     ctx_lens, None, page_size)[:, 0]
    k, v, ks, vs = _split(k_flat, v_flat)
    _check(q, k, v, ks, vs, page_tables, ctx_lens, page_size)
    b, n_q, hd = q.shape
    out = torch.empty_like(q)
    rc = library().rb_paged_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
        page_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        b, n_q, k.shape[1], hd, page_size, page_tables.shape[1],
        1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    name = "paged_decode_attention" + ("_int8" if ks is not None else "")
    raise_on(rc, name)
    launches[name] += 1
    return out


def chunk_q_block(n_q: int, n_kv: int, t: int) -> int:
    """Query tokens per chunk-kernel block: about 32 query-head rows."""
    return max(1, min(t, 32 // (n_q // n_kv)))


def paged_chunk_attention(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_flat: Pool,  # [num_pages * page_size, n_kv, hd]
    v_flat: Pool,  # same
    page_tables: torch.Tensor,  # [B, P] int32
    ctx_lens: torch.Tensor,  # [B] int32, cache length AFTER the chunk
    q_positions: torch.Tensor,  # [B, T] int32, contiguous ascending per row
    page_size: int,
) -> torch.Tensor:
    """Ragged paged attention for T > 1 chunks (prefill / speculative
    verify), causal over ``q_positions[:, 0] + t``."""
    q_start = q_positions[:, 0].contiguous()
    if q.device.type == "cpu":
        return plain_paged_attention(q, k_flat, v_flat, page_tables, ctx_lens,
                                     q_start, page_size)
    k, v, ks, vs = _split(k_flat, v_flat)
    _check(q, k, v, ks, vs, page_tables, ctx_lens, page_size, (q_start,))
    b, t, n_q, hd = q.shape
    n_kv = k.shape[1]
    out = torch.empty_like(q)
    rc = library().rb_paged_chunk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
        page_tables.data_ptr(), ctx_lens.data_ptr(), q_start.data_ptr(),
        out.data_ptr(), b, t, n_q, n_kv, hd, page_size, page_tables.shape[1],
        chunk_q_block(n_q, n_kv, t), 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    name = "paged_chunk_attention" + ("_int8" if ks is not None else "")
    raise_on(rc, name)
    launches[name] += 1
    return out
