"""Paged attention kernels of the serving forward and their plain versions.

CUDA kernels (``csrc/paged_attention.cu``) replace the Pallas TPU kernels
of ``runbookai_tpu/ops/paged_attention_pallas.py``:

- :func:`paged_decode_attention` — one query token per sequence (T = 1);
  replaces Pallas ``paged_decode_attention`` and, over an int8 pool, its
  ``_paged_decode_attention_int8``.
- :func:`paged_chunk_attention` — T > 1 (chunked prefill and the speculative
  verify); replaces Pallas ``paged_chunk_attention``. Over an int8 pool it
  serves the calls that the JAX package sends to its XLA gather path.
- :func:`paged_decode_attention_partial` — the decode kernel over one page
  shard's slice of the pool, returning the un-normalised flash partials
  ``(acc, m, l)`` for the merge across page shards; replaces Pallas
  ``paged_decode_attention_partial``.
- :func:`paged_chunk_attention_partial` — the same for T > 1; replaces the
  XLA ``_partial_flash`` of ``runbookai_tpu/parallel/kv_split.py``.

:func:`paged_decode_attention_tp` and :func:`paged_chunk_attention_tp` run
the first two per head shard of a tensor-parallel mesh, as the JAX
package's ``shard_map`` wrappers of the same names do.

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
            "paged_decode_attention_int8": 0, "paged_chunk_attention_int8": 0,
            "paged_decode_attention_partial": 0, "paged_chunk_attention_partial": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ----------------------------------------------------------- plain version


def plain_paged_attention_partial(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_flat: Pool,  # [pages * page_size, n_kv, hd]: the whole pool, or a slice
    v_flat: Pool,  # same
    page_tables: torch.Tensor,  # [B, P] int32 GLOBAL page ids
    ctx_lens: torch.Tensor,  # [B] int32
    q_start: Optional[torch.Tensor],  # [B] int32; None = no causal mask
    page_size: int,
    shard: int = 0,
    pages_local: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of every kernel: gather (and dequantize) each
    sequence's pages, mask keys at ``pos >= ctx`` (and, with ``q_start``, at
    ``pos > q_start + t``), softmax in f32 with masked probabilities zeroed.
    With ``pages_local``, ``k_flat``/``v_flat`` hold page shard ``shard``'s
    slice (global pages ``[shard * pages_local, (shard + 1) * pages_local)``)
    and keys on other shards' pages are masked too. Returns the
    un-normalised flash partials ``(acc [B, T, n_q, hd], m [B, T, n_q],
    l [B, T, n_q])`` in f32; a row that sees no key gives ``(0, -1e30, 0)``."""
    b, t, n_q, hd = q.shape
    n_kv = (k_flat[0] if isinstance(k_flat, tuple) else k_flat).shape[1]
    group = n_q // n_kv
    dev = q.device
    max_ctx = int(ctx_lens.max()) if b else 0
    n_pages = min(page_tables.shape[1], -(-max_ctx // page_size))
    if n_pages <= 0:
        return (torch.zeros(q.shape, device=dev),
                torch.full(q.shape[:3], NEG_INF, device=dev),
                torch.zeros(q.shape[:3], device=dev))
    pages = page_tables[:, :n_pages].long()
    owned = None
    if pages_local is not None:
        owned = (pages // pages_local == shard).repeat_interleave(page_size, dim=1)
        pages = (pages - shard * pages_local).clamp(0, pages_local - 1)
    rows = (pages[:, :, None] * page_size
            + torch.arange(page_size, device=dev)).reshape(b, -1)  # [B, S]
    k = dequant_gather(k_flat, rows)  # [B, S, n_kv, hd] float32
    v = dequant_gather(v_flat, rows)
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, t, n_kv, group, hd)
    scores = torch.einsum("btkgd,bskd->btkgs", qf, k)
    pos = torch.arange(rows.shape[1], device=dev)
    mask = pos[None, :] < ctx_lens[:, None].long()  # [B, S]
    if owned is not None:
        mask = mask & owned
    mask = mask[:, None, :]  # [B, 1, S]
    if q_start is not None:
        qpos = q_start[:, None].long() + torch.arange(t, device=dev)  # [B, T]
        mask = mask & (pos[None, None, :] <= qpos[:, :, None])
    mask = mask[:, :, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("btkgs,bskd->btkgd", p, v)
    return (acc.reshape(b, t, n_q, hd), m.reshape(b, t, n_q), l.reshape(b, t, n_q))


def plain_paged_attention(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_flat: Pool,  # [num_pages * page_size, n_kv, hd]
    v_flat: Pool,  # same
    page_tables: torch.Tensor,  # [B, P] int32
    ctx_lens: torch.Tensor,  # [B] int32
    q_start: Optional[torch.Tensor],  # [B] int32; None = no causal mask
    page_size: int,
) -> torch.Tensor:
    """Plain PyTorch version of the decode and chunk kernels: the partials
    of :func:`plain_paged_attention_partial` over the whole pool, normalised
    with the normaliser clamped at 1e-30 (a row that sees no key gives
    zeros). Returns [B, T, n_q, hd] in q's dtype."""
    acc, _, l = plain_paged_attention_partial(q, k_flat, v_flat, page_tables,
                                              ctx_lens, q_start, page_size)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


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


# ------------------------------------------------------- page-split partials


def _check_partial(q, k_local, v_local, page_tables, ctx_lens, page_size,
                   shard, pages_local, extra=()):
    _check(q, k_local, v_local, None, None, page_tables, ctx_lens, page_size, extra)
    if k_local.shape[0] != pages_local * page_size:
        raise ValueError(f"local pool of {k_local.shape[0]} tokens is not "
                         f"{pages_local} pages of {page_size}")
    if shard < 0:
        raise ValueError(f"page shard {shard} < 0")


def paged_decode_attention_partial(
    q: torch.Tensor,  # [B, n_q, hd]
    k_local: torch.Tensor,  # [pages_local * page_size, n_kv, hd]
    v_local: torch.Tensor,  # same
    page_tables: torch.Tensor,  # [B, P] int32 GLOBAL page ids
    ctx_lens: torch.Tensor,  # [B] int32
    my_pg: int,  # this shard's index on the page axis
    page_size: int,
    pages_local: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention over page shard ``my_pg``'s slice of the pool (global
    page g lives on shard ``g // pages_local``, at local page ``g - my_pg *
    pages_local``). Pages of other shards are skipped. Returns the flash
    partials ``(acc [B, n_q, hd], m [B, n_q], l [B, n_q])`` in f32."""
    if q.device.type == "cpu":
        acc, m, l = plain_paged_attention_partial(
            q[:, None], k_local, v_local, page_tables, ctx_lens, None, page_size,
            my_pg, pages_local)
        return acc[:, 0], m[:, 0], l[:, 0]
    _check_partial(q, k_local, v_local, page_tables, ctx_lens, page_size, my_pg,
                   pages_local)
    b, n_q, hd = q.shape
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, n_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = library().rb_paged_decode_attention_partial(
        q.data_ptr(), k_local.data_ptr(), v_local.data_ptr(), page_tables.data_ptr(),
        ctx_lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, n_q, k_local.shape[1], hd, page_size, page_tables.shape[1], my_pg,
        pages_local, 1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_local.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(rc, "paged_decode_attention_partial")
    launches["paged_decode_attention_partial"] += 1
    return acc, m, l


def paged_chunk_attention_partial(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_local: torch.Tensor,  # [pages_local * page_size, n_kv, hd]
    v_local: torch.Tensor,  # same
    page_tables: torch.Tensor,  # [B, P] int32 GLOBAL page ids
    ctx_lens: torch.Tensor,  # [B] int32, cache length AFTER the chunk
    q_positions: torch.Tensor,  # [B, T] int32, contiguous ascending per row
    my_pg: int,
    page_size: int,
    pages_local: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`paged_decode_attention_partial` for T > 1 chunks, causal over
    ``q_positions[:, 0] + t``. Returns ``(acc [B, T, n_q, hd], m [B, T,
    n_q], l [B, T, n_q])`` in f32."""
    q_start = q_positions[:, 0].contiguous()
    if q.device.type == "cpu":
        return plain_paged_attention_partial(q, k_local, v_local, page_tables,
                                             ctx_lens, q_start, page_size, my_pg,
                                             pages_local)
    _check_partial(q, k_local, v_local, page_tables, ctx_lens, page_size, my_pg,
                   pages_local, (q_start,))
    b, t, n_q, hd = q.shape
    n_kv = k_local.shape[1]
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, t, n_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = library().rb_paged_chunk_attention_partial(
        q.data_ptr(), k_local.data_ptr(), v_local.data_ptr(), page_tables.data_ptr(),
        ctx_lens.data_ptr(), q_start.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), b, t, n_q, n_kv, hd, page_size, page_tables.shape[1],
        chunk_q_block(n_q, n_kv, t), my_pg, pages_local, 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_local.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(rc, "paged_chunk_attention_partial")
    launches["paged_chunk_attention_partial"] += 1
    return acc, m, l


# ------------------------------------------------------ per head shard (TP)


def paged_decode_attention_tp(qs, k_pools, v_pools, page_tables, ctx_lens,
                              page_size: int) -> list[torch.Tensor]:
    """:func:`paged_decode_attention` on each shard of a model-only mesh:
    shard r's query heads over its own kv heads (head blocks are contiguous
    and kv-major, so a GQA group never straddles shards). Every argument but
    ``page_size`` is a list with one entry per shard; attention mixes only
    across the context, so no collective is needed."""
    return [paged_decode_attention(q, k, v, tab, ctx, page_size)
            for q, k, v, tab, ctx in zip(qs, k_pools, v_pools, page_tables, ctx_lens)]


def paged_chunk_attention_tp(qs, k_pools, v_pools, page_tables, ctx_lens,
                             q_positions, page_size: int) -> list[torch.Tensor]:
    """:func:`paged_chunk_attention` on each shard of a model-only mesh."""
    return [paged_chunk_attention(q, k, v, tab, ctx, pos, page_size)
            for q, k, v, tab, ctx, pos in zip(qs, k_pools, v_pools, page_tables,
                                              ctx_lens, q_positions)]
