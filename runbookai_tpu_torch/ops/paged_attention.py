"""Paged attention kernels of the serving forward and their plain versions.

CUDA kernels (``csrc/paged_attention.cu``, ``csrc/chunk_attention.cu``,
``csrc/decode_attention.cu``, ``csrc/ragged_attention.cu`` with
``csrc/ragged_plan.cu``) replace the Pallas TPU kernels of
``runbookai_tpu/ops/paged_attention_pallas.py``:

- :func:`paged_decode_attention` — one query token per sequence (T = 1);
  replaces Pallas ``paged_decode_attention`` and, over an int8 pool, its
  ``_paged_decode_attention_int8``. bf16 queries over a bf16 or int8 pool
  (:func:`decode_route`) take the tensor-core kernel of
  ``decode_attention.cu``, split over page-table columns as
  :func:`decode_plan` says and merged in the same launch; the rest take the
  CUDA-core kernel of ``paged_attention.cu``.
- :func:`paged_chunk_attention` — T > 1 (chunked prefill and the speculative
  verify); replaces Pallas ``paged_chunk_attention``. Over an int8 pool it
  serves the calls that the JAX package sends to its XLA gather path. bf16
  queries (:func:`chunk_mma_eligible`) take the tensor-core kernel of
  ``chunk_attention.cu``, split over page-table columns as
  :func:`chunk_plan` says and merged by :func:`chunk_merge`; f32 queries
  take the CUDA-core kernel of ``paged_attention.cu``.
- :func:`paged_ragged_attention` — a flat mixed prefill+decode batch in
  8-token blocks, each owned by one row; replaces Pallas
  ``paged_ragged_attention`` (W1). bf16 queries take the ragged kernel of
  ``ragged_attention.cu``: a tile list over the batch's runs
  (:func:`ragged_plan`, one launch of ``ragged_plan.cu``'s kernel; the
  ragged forward builds it once for all its layers), then one launch
  (:func:`ragged_tile_attention`) whose prefill tiles of 128 rows run on
  wgmma and whose one-block tiles on mma.sync, split over key ranges and
  merged in the same launch; f32 queries take the CUDA-core chunk kernel
  at ``[N / 8, 8]``.
- :func:`paged_decode_attention_partial` — the decode kernel over one page
  shard's slice of the pool, returning the un-normalised flash partials
  ``(acc, m, l)`` for the merge across page shards; replaces Pallas
  ``paged_decode_attention_partial``. bf16 queries over a bf16 slice take
  the tensor-core decode kernel over the shard's own pages, split as
  :func:`decode_plan` says and merged in the same launch.
- :func:`paged_chunk_attention_partial` — the same for T > 1; replaces the
  XLA ``_partial_flash`` of ``runbookai_tpu/parallel/kv_split.py``. bf16
  queries over a bf16 slice take the tensor-core chunk partial of
  ``chunk_attention.cu`` over the shard's own pages, split as
  :func:`chunk_plan` says and merged in the same launch.

:func:`paged_decode_attention_tp` and :func:`paged_chunk_attention_tp` run
the first two per head shard of a tensor-parallel mesh, as the JAX
package's ``shard_map`` wrappers of the same names do; the mixed forward on
such a mesh runs K2 at ``[N / 8, 8]`` per head shard.

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

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from runbookai_tpu_torch.ops.attention import Pool, dequant_gather
from runbookai_tpu_torch.ops.build import SMS, library, raise_on, split_workspace

NEG_INF = -1e30

# Kernel launches per wrapper and pool type (plain-version calls are not
# counted). A chunk call counts once, whether or not it was split.
launches = {"paged_decode_attention": 0, "paged_chunk_attention": 0,
            "paged_decode_attention_int8": 0, "paged_chunk_attention_int8": 0,
            "paged_ragged_attention": 0, "paged_ragged_attention_int8": 0,
            "paged_decode_attention_partial": 0, "paged_chunk_attention_partial": 0}
# Launches of the merge of a split chunk call (:func:`chunk_merge`).
merge_launches = {"paged_chunk_merge": 0}
# Launches of W1's tile list (:func:`ragged_plan`).
plan_launches = {"ragged_plan": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for counts in (launches, merge_launches, plan_launches):
        for name in counts:
            counts[name] = 0


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
    cols: Optional[tuple[int, int]] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of every kernel: gather (and dequantize) each
    sequence's pages, mask keys at ``pos >= ctx`` (and, with ``q_start``, at
    ``pos > q_start + t``), softmax in f32 with masked probabilities zeroed.
    With ``pages_local``, ``k_flat``/``v_flat`` hold page shard ``shard``'s
    slice (global pages ``[shard * pages_local, (shard + 1) * pages_local)``)
    and keys on other shards' pages are masked too. With ``cols = (c0,
    c1)``, only the keys of table columns ``[c0, c1)`` count (one split of
    the chunk kernel). Returns the un-normalised flash partials ``(acc [B,
    T, n_q, hd], m [B, T, n_q], l [B, T, n_q])`` in f32; a row that sees no
    key gives ``(0, -1e30, 0)``."""
    b, t, n_q, hd = q.shape
    n_kv = (k_flat[0] if isinstance(k_flat, tuple) else k_flat).shape[1]
    group = n_q // n_kv
    dev = q.device
    max_ctx = int(ctx_lens.max()) if b else 0
    n_pages = min(page_tables.shape[1], -(-max_ctx // page_size))
    if cols is not None:
        n_pages = min(n_pages, cols[1])
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
    if cols is not None:
        mask = mask & (pos[None, :] >= cols[0] * page_size)
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


def combine_partials(parts, device: torch.device):
    """Combine flash partials ``(acc, m, l)`` into one, on ``device``, in
    f32: ``m`` the max of the m's, each part's correction ``exp(m_part -
    m)``, ``l`` and ``acc`` the corrected sums in the parts' order. Parts
    that saw no key (``(0, -1e30, 0)``) move nothing; if none did, the
    result is ``(0, -1e30, 0)``. The plain version of the chunk partial's
    merge of its splits, made in the kernel's launch."""
    accs = [a.to(device) for a, _, _ in parts]
    ms = [m.to(device) for _, m, _ in parts]
    ls = [l.to(device) for _, _, l in parts]
    m_g = torch.stack(ms).amax(dim=0)
    corr = [torch.exp(m - m_g) for m in ms]
    l_g = sum(l * c for l, c in zip(ls, corr))
    acc_g = sum(a * c[..., None] for a, c in zip(accs, corr))
    return acc_g, m_g, l_g


def merge_partials(parts, device: torch.device) -> torch.Tensor:
    """Merge flash partials ``(acc, m, l)`` (of page shards, or of the splits
    of a chunk call) on ``device``, in f32: :func:`combine_partials`, then
    acc over l with the normaliser clamped at 1e-30. A row that no part saw
    a key for stays zeros. The plain version of the merge kernel
    (:func:`chunk_merge`), before its cast."""
    acc, _, l = combine_partials(parts, device)
    return acc / l.clamp_min(1e-30)[..., None]


def plain_chunk_partials(q, k_flat: Pool, v_flat: Pool, page_tables, ctx_lens, q_start,
                         page_size: int, cols: int):
    """Plain version of a split chunk call's workspace: the partials of
    every split of ``cols`` table columns, stacked: ``(acc [S, B, T, n_q,
    hd], m [S, B, T, n_q], l [S, B, T, n_q])``. ``merge_partials`` of them
    is the unsplit result."""
    p = page_tables.shape[1]
    parts = [plain_paged_attention_partial(q, k_flat, v_flat, page_tables, ctx_lens,
                                           q_start, page_size, cols=(c0, c0 + cols))
             for c0 in range(0, max(p, 1), max(cols, 1))]
    return tuple(torch.stack(x) for x in zip(*parts))


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
           extra=(), rows: Optional[int] = None):
    """Checks of a kernel call on CUDA tensors; ``rows`` is the tables' row
    count where it is not q's leading dimension (the ragged call)."""
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
    b = q.shape[0] if rows is None else rows
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
    """Ragged paged attention for decode (one query token per sequence). On
    CUDA tensors the kernel is chosen by :func:`decode_route`."""
    if q.device.type == "cpu":
        return plain_paged_attention(q[:, None], k_flat, v_flat, page_tables,
                                     ctx_lens, None, page_size)[:, 0]
    k, v, ks, vs = _split(k_flat, v_flat)
    _check(q, k, v, ks, vs, page_tables, ctx_lens, page_size)
    b, n_q, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    name = "paged_decode_attention" + ("_int8" if ks is not None else "")
    if decode_route(q.dtype, hd, k.dtype) == "mma":
        _decode_mma(q, k, v, ks, vs, page_tables, ctx_lens, page_size, out, stream)
    else:
        rc = library().rb_paged_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
            page_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            b, n_q, k.shape[1], hd, page_size, page_tables.shape[1],
            1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], stream)
        raise_on(rc, name)
    launches[name] += 1
    return out


def decode_route(q_dtype: torch.dtype, hd: int, pool_dtype: torch.dtype,
                 partial: bool = False) -> str:
    """The kernel a decode call (or, with ``partial``, a page-split decode
    or chunk partial) on CUDA tensors launches, decided before the launch:
    ``"mma"`` (the tensor-core kernels: ``decode_attention.cu`` for decode
    calls, K3 and K4; ``chunk_attention.cu`` for the chunk partial) for bf16
    queries with head_dim 64 or 128 over a bf16 pool, or an int8 pool
    outside the page split; ``"cuda_core"`` (``paged_attention.cu``) for f32
    queries and for f32 pools; any other call raises, and so does a partial
    over an int8 pool (the page split refuses int8 KV)."""
    if partial and pool_dtype == torch.int8:
        raise ValueError("the page-split partials take no int8 pools")
    if chunk_mma_eligible(q_dtype, hd) and pool_dtype in (torch.bfloat16, torch.int8):
        return "mma"
    if q_dtype == torch.float32 or (q_dtype == torch.bfloat16 and pool_dtype == torch.float32):
        return "cuda_core"
    raise ValueError(f"no decode kernel takes {q_dtype} queries with head_dim {hd} over "
                     f"a {pool_dtype} pool: bf16 queries over bf16 or int8 pools need "
                     f"head_dim 64 or 128")


# At least this many table columns (one 64-key tile of 16-token pages) a
# decode split.
DECODE_MIN_COLS = 4


@dataclass(frozen=True)
class DecodePlan:
    """How the tensor-core decode kernel covers one call."""

    splits: int  # splits over page-table columns
    cols: int  # table columns per split
    workspace_floats: int  # f32 (acc, m, l) of every split; 0 unsplit


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, n_q: int, n_kv: int, hd: int, p: int) -> DecodePlan:
    """Split count of a decode call, from its shapes only (never
    ``ctx_lens``, so the wrapper makes no host sync): ``min(ceil(2 * SMS /
    n_kv), floor(P / DECODE_MIN_COLS))`` splits (at least one), so that one
    sequence whose context fills the table spreads its kv heads' blocks
    over every SM, each of ``ceil(P / S)`` columns (the count then shrunk
    so that no split is empty). Blocks past a sequence's context exit
    before loading; the live ones merge in the launch."""
    splits = max(1, min(-(-2 * SMS // n_kv), p // DECODE_MIN_COLS))
    cols = -(-p // splits)
    if cols:
        splits = -(-p // cols)
    return DecodePlan(splits, cols, 0 if splits == 1 else b * n_q * splits * (hd + 2))


def _decode_launch_plan(q, k, v, page_tables, stream):
    """Checks of a tensor-core decode call, its :func:`decode_plan` and, when
    split, the stream's (counters, workspace)."""
    b, n_q, hd = q.shape
    n_kv = k.shape[1]
    if n_q // n_kv > 16:
        raise ValueError(f"the bf16 decode kernel takes GQA groups of at most 16 query "
                         f"heads, not {n_q // n_kv}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 decode kernel needs q and the pools 16-byte aligned")
    plan = decode_plan(b, n_q, n_kv, hd, page_tables.shape[1])
    counters = ws = None
    if plan.splits > 1:
        counters, ws = split_workspace(q.device, stream, b * n_kv, plan.workspace_floats)
    return plan, counters, ws


def _decode_mma(q, k, v, ks, vs, page_tables, ctx_lens, page_size, out, stream):
    """The tensor-core decode kernel (K1, or K3 over an int8 pool), one
    launch, into ``out``."""
    plan, counters, ws = _decode_launch_plan(q, k, v, page_tables, stream)
    b, n_q, hd = q.shape
    rc = library().rb_paged_decode_attention_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), page_tables.data_ptr(),
        ctx_lens.data_ptr(), out.data_ptr(), _ptr(ws), _ptr(counters), b, n_q, k.shape[1],
        hd, page_size, page_tables.shape[1], plan.splits, plan.cols, 1.0 / math.sqrt(hd),
        _DTYPE_CODES[k.dtype], stream)
    raise_on(rc, "paged_decode_attention" + ("_int8" if ks is not None else ""))


def chunk_q_block(n_q: int, n_kv: int, t: int) -> int:
    """Query tokens per block of the CUDA-core chunk kernels: about 32
    query-head rows."""
    return max(1, min(t, 32 // (n_q // n_kv)))


def chunk_mma_eligible(q_dtype: torch.dtype, hd: int) -> bool:
    """Whether a chunk call takes the tensor-core kernel: bf16 queries with
    head_dim 64 or 128 (every model of the catalogue but the tiny test
    configs)."""
    return q_dtype == torch.bfloat16 and hd in (64, 128)


def chunk_route(q_dtype: torch.dtype, hd: int) -> str:
    """The kernel a chunk call on CUDA tensors launches, decided before the
    launch: ``"mma"`` (``chunk_attention.cu``) where
    :func:`chunk_mma_eligible` holds, ``"cuda_core"`` (``paged_attention.cu``)
    for f32 queries; any other call raises."""
    if chunk_mma_eligible(q_dtype, hd):
        return "mma"
    if q_dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"no chunk kernel takes {q_dtype} queries with head_dim {hd}: "
                     f"bf16 needs head_dim 64 or 128 (chunk_mma_eligible)")


@dataclass(frozen=True)
class ChunkPlan:
    """How the tensor-core chunk kernel covers one call."""

    rows: int  # query rows (tokens x group heads) per block: 32 or 64
    q_tiles: int  # row tiles per (sequence, kv head)
    splits: int  # splits over page-table columns
    cols: int  # table columns per split
    workspace_bytes: int  # f32 (acc, m, l) of every split; 0 unsplit


@functools.lru_cache(maxsize=256)
def chunk_plan(b: int, t: int, n_q: int, n_kv: int, hd: int, p: int) -> ChunkPlan:
    """Split count of a chunk call, from its shapes only (never ``ctx_lens``,
    so the wrapper makes no host sync): none where the ``B * n_kv *
    q_tiles`` blocks already reach two per SM; else ``min(ceil(264 /
    blocks), ceil(P / 16))`` splits, each of ``ceil(P / S)`` table columns
    (the count then shrunk so that no split is empty). The splits cover the
    table's width, not the live context: where every context is short, the
    later splits see no key."""
    group = n_q // n_kv
    rows = 32 if t * group <= 32 else 64
    q_tiles = -(-t * group // rows)
    ctas = b * n_kv * q_tiles
    target = 2 * SMS
    splits = 1 if ctas >= target else max(1, min(-(-target // max(ctas, 1)), -(-p // 16)))
    cols = -(-p // splits)
    if cols:
        splits = -(-p // cols)
    workspace = 0 if splits == 1 else splits * b * t * n_q * (hd + 2) * 4
    return ChunkPlan(rows, q_tiles, splits, cols, workspace)


def chunk_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Merge S flash partials ``acc [S, ..., hd]``, ``m`` and ``l [S, ...]``
    (f32) in split order, in ``dtype``: the second pass of a split chunk
    call. The plain version is :func:`merge_partials` and the cast."""
    if acc.device.type == "cpu":
        return merge_partials(list(zip(acc, m, l)), acc.device).to(dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"chunk_merge runs on cuda or cpu tensors, got {acc.device}")
    for x in (acc, m, l):
        if x.device != acc.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("chunk_merge takes contiguous f32 partials on one device")
    if m.shape != acc.shape[:-1] or l.shape != m.shape:
        raise ValueError(f"partials acc {tuple(acc.shape)}, m {tuple(m.shape)}, "
                         f"l {tuple(l.shape)} do not match")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"chunk_merge writes float32 or bfloat16, not {dtype}")
    return _merge(acc, m, l, dtype, torch.cuda.current_stream(acc.device).cuda_stream)


def _merge(acc, m, l, dtype, stream):
    """The merge kernel on partials the caller has checked."""
    out = torch.empty(acc.shape[1:], dtype=dtype, device=acc.device)
    rc = library().rb_paged_chunk_merge(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), acc.shape[0],
        out.numel() // acc.shape[-1], acc.shape[-1], _DTYPE_CODES[dtype], stream)
    raise_on(rc, "paged_chunk_merge")
    merge_launches["paged_chunk_merge"] += 1
    return out


def _chunk_mma(q, k, v, ks, vs, page_tables, ctx_lens, q_start, page_size,
               plan: ChunkPlan):
    """The tensor-core chunk kernel, split as ``plan`` says and merged."""
    if k.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"the bf16 chunk kernel takes bf16 or int8 pools, not {k.dtype}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 chunk kernel needs q and the pools 16-byte aligned")
    b, t, n_q, hd = q.shape
    n_kv, p = k.shape[1], page_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.splits == 1:
        out = torch.empty_like(q)
        ws = (None, None, None)
    else:  # one allocation: acc [S, B, T, n_q, hd], then m and l [S, B, T, n_q]
        out = None
        n = plan.splits * b * t * n_q
        flat = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=q.device)
        ws = (flat[:n * hd].view(plan.splits, b, t, n_q, hd),
              flat[n * hd:n * (hd + 1)].view(plan.splits, b, t, n_q),
              flat[n * (hd + 1):].view(plan.splits, b, t, n_q))
    rc = library().rb_paged_chunk_attention_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
        page_tables.data_ptr(), ctx_lens.data_ptr(), q_start.data_ptr(), _ptr(out),
        *map(_ptr, ws), b, t, n_q, n_kv, hd, page_size, p, plan.rows, plan.splits,
        plan.cols, 1.0 / math.sqrt(hd), _DTYPE_CODES[k.dtype], stream)
    raise_on(rc, "paged_chunk_attention" + ("_int8" if ks is not None else ""))
    return out if out is not None else _merge(*ws, q.dtype, stream)


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
    verify), causal over ``q_positions[:, 0] + t``. On CUDA tensors the
    kernel is chosen by :func:`chunk_route`."""
    return _chunk_call(q, k_flat, v_flat, page_tables, ctx_lens, q_positions, page_size,
                       "paged_chunk_attention")


def _chunk_call(q, k_flat, v_flat, page_tables, ctx_lens, q_positions, page_size,
                name: str) -> torch.Tensor:
    """One chunk-kernel call (the plain version on CPU tensors), counted
    under ``name`` (``_int8`` appended over an int8 pool)."""
    q_start = q_positions[:, 0].contiguous()
    if q.device.type == "cpu":
        return plain_paged_attention(q, k_flat, v_flat, page_tables, ctx_lens,
                                     q_start, page_size)
    k, v, ks, vs = _split(k_flat, v_flat)
    _check(q, k, v, ks, vs, page_tables, ctx_lens, page_size, (q_start,))
    b, t, n_q, hd = q.shape
    name += "_int8" if ks is not None else ""
    n_kv = k.shape[1]
    if chunk_route(q.dtype, hd) == "mma":
        plan = chunk_plan(b, t, n_q, n_kv, hd, page_tables.shape[1])
        out = _chunk_mma(q, k, v, ks, vs, page_tables, ctx_lens, q_start, page_size, plan)
        launches[name] += 1
        return out
    out = torch.empty_like(q)
    rc = library().rb_paged_chunk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
        page_tables.data_ptr(), ctx_lens.data_ptr(), q_start.data_ptr(),
        out.data_ptr(), b, t, n_q, n_kv, hd, page_size, page_tables.shape[1],
        chunk_q_block(n_q, n_kv, t), 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(rc, name)
    launches[name] += 1
    return out


# --------------------------------------------------------- ragged (W1)

# Query rows of a prefill tile of the ragged kernel: two wgmma warpgroups of 64.
RAGGED_TILE_ROWS = 128
# A one-block tile's keys split into at most this many ranges, of at least
# RAGGED_MIN_SPLIT_KEYS keys each (whole 64-key tiles).
RAGGED_MAX_SPLITS = 8
RAGGED_MIN_SPLIT_KEYS = 512
# One-block runs of a batch that split: the first this many (in the batch's
# order) whose keys exceed one split; later ones walk all their keys in one
# tile. Bounds the split workspace by shapes: 16 runs of 8 kv heads in 8
# splits are 1,024 tiles, several waves of the card's 132 SMs.
RAGGED_SPLIT_RUNS = 16
# int32 fields of a tile record: row, first token of the run, kv head, first
# row, row count, key bound, split, split count (0: a prefill tile), the
# split run's workspace slot.
RAGGED_FIELDS = 9


@dataclass(frozen=True)
class RaggedShape:
    """What the ragged kernel's tile list and launch take from shapes alone
    (never from the data, so the list is built without a host sync and a
    CUDA graph can hold the launch)."""

    rq: int  # tokens a block (the engine's ragged block, 8)
    group: int  # query heads per kv head
    capacity: int  # tile records: an upper bound of the live tiles
    ctas: int  # persistent blocks: min(capacity, SMS)
    keys_per_split: int  # keys of a one-block tile's split
    max_splits: int  # splits of a one-block tile at the table's width
    split_runs: int  # one-block runs that may split: min(N / rq, RAGGED_SPLIT_RUNS)
    counters: int  # int32: 2 (the tile schedule) + one per (split run, kv head)
    workspace_floats: int  # f32 split partials of every (split run, kv head, split)


@functools.lru_cache(maxsize=256)
def ragged_shape(n: int, n_q: int, n_kv: int, hd: int, p: int, page_size: int,
                 rq: int = 8) -> RaggedShape:
    """The shapes-only part of :func:`ragged_plan`. A one-block tile's keys
    (at most ``P * page_size``) split into ranges of ``keys_per_split``: a
    multiple of 64, at least ``RAGGED_MIN_SPLIT_KEYS``, so that a row as wide
    as the table takes at most ``RAGGED_MAX_SPLITS``. The capacity bounds the
    live tiles of any layout of ``N / rq`` blocks, per kv head: one tile a
    one-block run, ``max_splits - 1`` more for each of at most
    ``split_runs``, and ``ceil(L * rq * group / 128) <= L * rq * group / 128
    + L / 2`` for a run of L >= 2 blocks."""
    nb, group = n // rq, n_q // n_kv
    keys = 64 * max(RAGGED_MIN_SPLIT_KEYS // 64, -(-p * page_size // (64 * RAGGED_MAX_SPLITS)))
    max_splits = max(1, -(-p * page_size // keys))
    split_runs = min(nb, RAGGED_SPLIT_RUNS)
    per_head = nb + split_runs * (max_splits - 1) + -(-nb * rq * group // RAGGED_TILE_ROWS)
    capacity = n_kv * per_head
    return RaggedShape(rq, group, capacity, min(capacity, SMS), keys, max_splits, split_runs,
                       2 + split_runs * n_kv,
                       split_runs * n_kv * max_splits * rq * group * (hd + 2))


@dataclass(frozen=True)
class RaggedPlan:
    """One mixed batch's tile list for the ragged kernel: built once per
    forward (:func:`ragged_plan`) and reused by every layer's launch."""

    shape: RaggedShape
    tiles: torch.Tensor  # [capacity, RAGGED_FIELDS] int32, the live ones first, heaviest first
    live: torch.Tensor  # [1] int32: live tiles
    weight: torch.Tensor  # [capacity] int32: keys each tile walks (-1 past the live ones)


def plain_ragged_plan(row_ids: torch.Tensor, ctx_lens: torch.Tensor,
                      q_positions: torch.Tensor, n_q: int, n_kv: int, hd: int, p: int,
                      page_size: int, ragged_block: int = 8) -> RaggedPlan:
    """Plain version of the tile list's kernel (:func:`ragged_plan`), in
    tensor ops on ``row_ids``' device (no host sync).

    Blocks of ``ragged_block`` tokens with the same row and next to each
    other form a run. A run of one block (a decode slot, a short chunk, a pad
    block) is one tile of ``rq * group`` rows; the first ``split_runs`` such
    runs whose keys exceed ``keys_per_split`` split over key ranges of that
    many keys, each with its own workspace slot (its rank among them); a
    longer run (a prefill chunk) is cut into tiles of up to 128 rows, its
    (token, group head) rows flattened kv-major. Each tile is repeated for
    every kv head. A tile's keys end at the row's context, the table's width
    and its last query position (its block's first position plus the token's
    place in the block, as the plain version reads it). The list is sorted
    by the keys each tile walks, heaviest first, stably; the records past the
    live count are zero, with weight -1."""
    n = row_ids.shape[0]
    rq = ragged_block
    shape = ragged_shape(n, n_q, n_kv, hd, p, page_size, rq)
    nb, group, ks = n // rq, shape.group, shape.keys_per_split
    dev = row_ids.device
    brow = row_ids.reshape(nb, rq)[:, 0].long()
    bpos = q_positions.reshape(nb, rq)[:, 0].long()
    idx = torch.arange(nb, device=dev)
    start = torch.ones(nb, dtype=torch.bool, device=dev)
    start[1:] = brow[1:] != brow[:-1]
    run = torch.cumsum(start.long(), 0) - 1  # run of each block
    # Per run (nb slots; the slots past the last run are empty): first block,
    # length in blocks, row, context, key bound of its last token.
    first = torch.full((nb,), nb - 1, dtype=torch.long, device=dev).scatter_reduce_(
        0, run, idx, "amin")
    length = torch.zeros(nb, dtype=torch.long, device=dev).scatter_add_(
        0, run, torch.ones_like(run))
    row = brow[first]
    key_cap = ctx_lens.long()[row].clamp_max(p * page_size)
    last_pos = bpos[(first + length - 1).clamp(0, nb - 1)] + rq - 1
    run_hi = torch.minimum(key_cap, last_pos + 1).clamp_min(0)
    small = length == 1
    wide = small & (run_hi > ks)
    slot = torch.cumsum(wide.long(), 0) - 1  # rank among the wide runs
    split_run = wide & (slot < shape.split_runs)
    count = torch.where(split_run, -(-run_hi // ks),
                        torch.where(small, 1, -(-length * rq * group // RAGGED_TILE_ROWS)))
    count = torch.where(length > 0, count, 0)
    ends = torch.cumsum(count, 0)
    # Tile i of a kv head: run r, the run's tile `local`.
    per_head = shape.capacity // n_kv
    i = torch.arange(per_head, device=dev)
    r = torch.searchsorted(ends, i, right=True).clamp_max(nb - 1)
    local = i - (ends[r] - count[r])
    live = i < ends[-1]
    t_small, t_split = small[r], split_run[r]
    r0 = torch.where(t_small, 0, local * RAGGED_TILE_ROWS)
    nr = torch.where(t_small, rq * group,
                     (length[r] * rq * group - r0).clamp_max(RAGGED_TILE_ROWS))
    tok_last = (r0 + nr - 1) // group  # the tile's last token, within the run
    pos_last = bpos[(first[r] + tok_last // rq).clamp(0, nb - 1)] + tok_last % rq
    hi = torch.where(t_small, torch.where(t_split, torch.minimum(run_hi[r], (local + 1) * ks),
                                          run_hi[r]),
                     torch.minimum(key_cap[r], pos_last + 1).clamp_min(0))
    lo = torch.where(t_split, local * ks, 0)
    zero = torch.zeros_like(r)
    fields = torch.stack([row[r], first[r] * rq, zero, r0, nr, hi,
                          torch.where(t_split, local, 0), torch.where(t_small, count[r], 0),
                          torch.where(t_split, slot[r], 0)],
                         dim=1)  # [per_head, RAGGED_FIELDS]
    tiles = fields[:, None, :].repeat(1, n_kv, 1)
    tiles[:, :, 2] = torch.arange(n_kv, device=dev)
    tiles = torch.where(live[:, None, None], tiles, 0)
    weight = torch.where(live, hi - lo, -1)[:, None].expand(per_head, n_kv).reshape(-1)
    order = torch.sort(weight, descending=True, stable=True).indices
    return RaggedPlan(shape, tiles.reshape(-1, RAGGED_FIELDS)[order].to(torch.int32).contiguous(),
                      (live.sum() * n_kv).to(torch.int32).reshape(1),
                      weight[order].to(torch.int32))


def ragged_plan(row_ids: torch.Tensor, ctx_lens: torch.Tensor, q_positions: torch.Tensor,
                n_q: int, n_kv: int, hd: int, p: int, page_size: int,
                ragged_block: int = 8) -> RaggedPlan:
    """The ragged kernel's tile list for one mixed batch (what
    :func:`plain_ragged_plan` says, record for record). On CPU tensors: the
    plain version. On CUDA tensors: one launch of ``ragged_plan.cu``'s
    kernel, counted under ``ragged_plan`` (one CTA: the runs and their tile
    counts from the blocks' rows, prefix sums, each tile's rank by weight,
    the records written for every kv head; no host sync)."""
    if row_ids.device.type == "cpu":
        return plain_ragged_plan(row_ids, ctx_lens, q_positions, n_q, n_kv, hd, p, page_size,
                                 ragged_block)
    n = row_ids.shape[0]
    shape = ragged_shape(n, n_q, n_kv, hd, p, page_size, ragged_block)
    for x in (row_ids, ctx_lens, q_positions):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.device != row_ids.device:
            raise ValueError("row_ids, ctx_lens and q_positions must be contiguous int32 "
                             "tensors on one device")
    if q_positions.shape != (n,) or n % ragged_block:
        raise ValueError(f"q_positions must be [{n}] and {n} tokens whole blocks of "
                         f"{ragged_block}")
    tiles = torch.empty((shape.capacity, RAGGED_FIELDS), dtype=torch.int32,
                        device=row_ids.device)
    live = torch.empty(1, dtype=torch.int32, device=row_ids.device)
    weight = torch.empty(shape.capacity, dtype=torch.int32, device=row_ids.device)
    rc = library().rb_ragged_plan(
        row_ids.data_ptr(), q_positions.data_ptr(), ctx_lens.data_ptr(), tiles.data_ptr(),
        live.data_ptr(), weight.data_ptr(), n // ragged_block, ragged_block, shape.group,
        n_kv, p * page_size, shape.keys_per_split, shape.split_runs,
        shape.capacity // n_kv, torch.cuda.current_stream(row_ids.device).cuda_stream)
    raise_on(rc, "ragged_plan")
    plan_launches["ragged_plan"] += 1
    return RaggedPlan(shape, tiles, live, weight)


def plain_ragged_attention(q, k_flat: Pool, v_flat: Pool, page_tables, ctx_lens, q_positions,
                           row_ids, page_size: int, ragged_block: int = 8) -> torch.Tensor:
    """Plain version of W1: each block's table row and context gathered, then
    :func:`plain_paged_attention` at ``[N / rq, rq]`` with positions
    ``q_positions[block, 0] + t``. Returns [N, n_q, hd] in q's dtype."""
    n, n_q, hd = q.shape
    nb = n // ragged_block
    rows = row_ids.reshape(nb, ragged_block)[:, 0]
    out = plain_paged_attention(
        q.reshape(nb, ragged_block, n_q, hd), k_flat, v_flat, page_tables.index_select(0, rows),
        ctx_lens.index_select(0, rows),
        q_positions.reshape(nb, ragged_block)[:, 0].contiguous(), page_size)
    return out.reshape(n, n_q, hd)


def ragged_route(q_dtype: torch.dtype, hd: int, group: int, ragged_block: int) -> str:
    """The kernel a ragged call on CUDA tensors launches: ``"mma"`` (the
    ragged kernel of ``ragged_attention.cu``) for bf16 queries with head_dim
    64 or 128 whose one-block tiles (``ragged_block * group`` rows) fit 128
    rows; ``"cuda_core"`` (``paged_attention.cu``'s chunk kernel at ``[N /
    rq, rq]``) for f32 queries; any other call raises."""
    if chunk_mma_eligible(q_dtype, hd):
        if ragged_block * group > RAGGED_TILE_ROWS or ragged_block % 2:
            raise ValueError(f"the ragged kernel takes blocks of an even number of tokens "
                             f"times a GQA group of at most {RAGGED_TILE_ROWS} rows, not "
                             f"{ragged_block} x {group}")
        return "mma"
    if q_dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"no ragged kernel takes {q_dtype} queries with head_dim {hd}: "
                     f"bf16 needs head_dim 64 or 128 (chunk_mma_eligible)")


def paged_ragged_attention(
    q: torch.Tensor,  # [N, n_q, hd] flat ragged token batch
    k_flat: Pool,  # [num_pages * page_size, n_kv, hd]
    v_flat: Pool,  # same
    page_tables: torch.Tensor,  # [R, P] int32 per-ROW page tables
    ctx_lens: torch.Tensor,  # [R] int32, cache length incl. this step's tokens
    q_positions: torch.Tensor,  # [N] int32 absolute query positions
    row_ids: torch.Tensor,  # [N] int32 row owning each token
    page_size: int,
    ragged_block: int = 8,
) -> torch.Tensor:
    """Ragged paged attention over a flat mixed prefill+decode batch (W1).

    Layout contract (EngineCore._run_mixed upholds it): each row's
    token run is contiguous ascending and starts at a multiple of
    ``ragged_block``, so every block of ``ragged_block`` queries belongs
    to one row. A pad block (a null row, ``ctx_len = 0``) gives zeros; pad
    tokens inside a row's last block act as later queries at
    ``q_positions[block, 0] + t``, whose outputs the caller discards. On CUDA
    tensors: the call's tile list (:func:`ragged_plan`), then one launch of
    the ragged kernel (:func:`ragged_tile_attention`); the ragged forward
    builds the list once above its layer loop instead. Returns [N, n_q,
    hd]."""
    if q.device.type == "cpu":
        return plain_ragged_attention(q, k_flat, v_flat, page_tables, ctx_lens, q_positions,
                                      row_ids, page_size, ragged_block)
    n_kv = (k_flat[0] if isinstance(k_flat, tuple) else k_flat).shape[1]
    plan = None
    if ragged_route(q.dtype, q.shape[2], q.shape[1] // n_kv, ragged_block) == "mma":
        plan = ragged_plan(row_ids, ctx_lens, q_positions, q.shape[1], n_kv, q.shape[2],
                           page_tables.shape[1], page_size, ragged_block)
    return ragged_tile_attention(q, k_flat, v_flat, page_tables, ctx_lens, q_positions,
                                 row_ids, plan, page_size, ragged_block)


def ragged_tile_attention(
    q: torch.Tensor,  # [N, n_q, hd]
    k_flat: Pool,
    v_flat: Pool,
    page_tables: torch.Tensor,  # [R, P] int32 per-row tables
    ctx_lens: torch.Tensor,  # [R] int32
    q_positions: torch.Tensor,  # [N] int32
    row_ids: torch.Tensor,  # [N] int32
    plan: Optional[RaggedPlan],  # ragged_plan of these rows, positions and contexts
    page_size: int,
    ragged_block: int = 8,
) -> torch.Tensor:
    """W1's launch on a tile list built beforehand (the ragged forward builds
    it once above its layer loop), counted under ``paged_ragged_attention``
    (``_int8`` over an int8 pool). On CPU tensors: the plain version. On CUDA
    tensors, by :func:`ragged_route`: bf16 queries take the ragged kernel on
    ``plan`` (required there), one launch a call with no allocation but the
    output (split partials and counters in the stream's
    :func:`split_workspace`); f32 queries take the CUDA-core chunk kernel at
    ``[N / rq, rq]`` on the blocks' gathered tables. Only the ragged kernel
    reads ``plan``: the other routes take None."""
    rq = ragged_block
    if q.device.type == "cpu":
        return plain_ragged_attention(q, k_flat, v_flat, page_tables, ctx_lens, q_positions,
                                      row_ids, page_size, rq)
    k, v, ks, vs = _split(k_flat, v_flat)
    _check(q, k, v, ks, vs, page_tables, ctx_lens, page_size, (q_positions, row_ids),
           rows=page_tables.shape[0])
    n, n_q, hd = q.shape
    n_kv = k.shape[1]
    name = "paged_ragged_attention" + ("_int8" if ks is not None else "")
    if q_positions.shape != (n,) or row_ids.shape != (n,) or n % rq:
        raise ValueError(f"q_positions and row_ids must be [{n}] and {n} tokens whole "
                         f"blocks of {rq}")
    if ragged_route(q.dtype, hd, n_q // n_kv, rq) == "cuda_core":
        nb = n // rq
        rows = row_ids.reshape(nb, rq)[:, 0]
        out = _chunk_call(q.reshape(nb, rq, n_q, hd), k_flat, v_flat,
                          page_tables.index_select(0, rows), ctx_lens.index_select(0, rows),
                          q_positions.reshape(nb, rq), page_size, "paged_ragged_attention")
        return out.reshape(n, n_q, hd)
    shape = ragged_shape(n, n_q, n_kv, hd, page_tables.shape[1], page_size, rq)
    if plan is None or shape != plan.shape:
        raise ValueError(f"the ragged kernel needs a tile list planned for {shape}, not "
                         f"{None if plan is None else plan.shape}")
    if plan.tiles.device != q.device or plan.live.device != q.device:
        raise ValueError("the tile list must lie on the queries' device")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the ragged kernel needs q and the pools 16-byte aligned")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters, ws = split_workspace(q.device, stream, shape.counters, shape.workspace_floats)
    out = torch.empty_like(q)
    rc = library().rb_paged_ragged_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), page_tables.data_ptr(),
        ctx_lens.data_ptr(), q_positions.data_ptr(), plan.tiles.data_ptr(),
        plan.live.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), shape.ctas,
        n_q, n_kv, hd, page_size, page_tables.shape[1], rq, shape.keys_per_split,
        shape.max_splits, 1.0 / math.sqrt(hd), _DTYPE_CODES[k.dtype], stream)
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
    pages_local``). Pages of other shards are never loaded. Returns the flash
    partials ``(acc [B, n_q, hd], m [B, n_q], l [B, n_q])`` in f32. On CUDA
    tensors the kernel is chosen by :func:`decode_route`."""
    if q.device.type == "cpu":
        acc, m, l = plain_paged_attention_partial(
            q[:, None], k_local, v_local, page_tables, ctx_lens, None, page_size,
            my_pg, pages_local)
        return acc[:, 0], m[:, 0], l[:, 0]
    _check_partial(q, k_local, v_local, page_tables, ctx_lens, page_size, my_pg,
                   pages_local)
    b, n_q, hd = q.shape
    n_kv, p = k_local.shape[1], page_tables.shape[1]
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, n_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if decode_route(q.dtype, hd, k_local.dtype, partial=True) == "mma":
        plan, counters, ws = _decode_launch_plan(q, k_local, v_local, page_tables, stream)
        rc = library().rb_paged_decode_attention_partial_mma(
            q.data_ptr(), k_local.data_ptr(), v_local.data_ptr(), page_tables.data_ptr(),
            ctx_lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), _ptr(ws),
            _ptr(counters), b, n_q, n_kv, hd, page_size, p, plan.splits, plan.cols, my_pg,
            pages_local, 1.0 / math.sqrt(hd), stream)
    else:
        rc = library().rb_paged_decode_attention_partial(
            q.data_ptr(), k_local.data_ptr(), v_local.data_ptr(), page_tables.data_ptr(),
            ctx_lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, n_q, n_kv, hd, page_size, p, my_pg, pages_local, 1.0 / math.sqrt(hd),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_local.dtype], stream)
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
    n_q], l [B, T, n_q])`` in f32. On CUDA tensors the kernel is chosen by
    :func:`decode_route`."""
    if q.device.type == "cpu":
        return plain_paged_attention_partial(q, k_local, v_local, page_tables,
                                             ctx_lens, q_positions[:, 0], page_size,
                                             my_pg, pages_local)
    b, t, n_q, hd = q.shape
    n_kv, p = k_local.shape[1], page_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if decode_route(q.dtype, hd, k_local.dtype, partial=True) == "mma":
        # The kernel reads each row's first position from [B, T] itself.
        q_positions = q_positions.contiguous()
        _check_partial(q, k_local, v_local, page_tables, ctx_lens, page_size, my_pg,
                       pages_local, (q_positions,))
        out = _chunk_partial_mma(q, k_local, v_local, page_tables, ctx_lens, q_positions,
                                 my_pg, page_size, pages_local, stream)
        launches["paged_chunk_attention_partial"] += 1
        return out
    q_start = q_positions[:, 0].contiguous()
    _check_partial(q, k_local, v_local, page_tables, ctx_lens, page_size, my_pg,
                   pages_local, (q_start,))
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, t, n_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = library().rb_paged_chunk_attention_partial(
        q.data_ptr(), k_local.data_ptr(), v_local.data_ptr(), page_tables.data_ptr(),
        ctx_lens.data_ptr(), q_start.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), b, t, n_q, n_kv, hd, page_size, p,
        chunk_q_block(n_q, n_kv, t), my_pg, pages_local, 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_local.dtype], stream)
    raise_on(rc, "paged_chunk_attention_partial")
    launches["paged_chunk_attention_partial"] += 1
    return acc, m, l


def _chunk_partial_mma(q, k, v, page_tables, ctx_lens, q_positions, shard, page_size,
                       pages_local, stream):
    """The tensor-core chunk partial over page shard ``shard``'s own pages,
    split as :func:`chunk_plan` says and merged in the launch."""
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 chunk kernel needs q and the pools 16-byte aligned")
    b, t, n_q, hd = q.shape
    n_kv, p = k.shape[1], page_tables.shape[1]
    plan = chunk_plan(b, t, n_q, n_kv, hd, p)
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((b, t, n_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    counters = ws = None
    if plan.splits > 1:
        counters, ws = split_workspace(q.device, stream, plan.q_tiles * b * n_kv,
                                        plan.workspace_bytes // 4)
    rc = library().rb_paged_chunk_attention_partial_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), page_tables.data_ptr(),
        ctx_lens.data_ptr(), q_positions.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), _ptr(ws), _ptr(counters), b, t, n_q, n_kv, hd, page_size, p, plan.rows,
        plan.splits, plan.cols, shard, pages_local, 1.0 / math.sqrt(hd), stream)
    raise_on(rc, "paged_chunk_attention_partial")
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
