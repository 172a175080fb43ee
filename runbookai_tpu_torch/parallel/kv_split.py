"""KV page-split serving: tensor parallelism past the GQA kv-head count.

The counterpart of ``runbookai_tpu/parallel/kv_split.py``. Megatron TP
shards the KV pool by kv heads, so tp stops at ``n_kv_heads``; past it the
remaining factor goes on a second mesh axis:

- ``model`` (= ``kv_shards``) shards kv heads, as plain TP does;
- ``seq`` (= ``pg_shards``) shards the page pool's token axis: shard s owns
  the global pages ``[s * pages_local, (s + 1) * pages_local)`` and attends
  only over context tokens stored there.

Query heads shard over both axes, model-major, so every query head stays
with its kv head. Within a model group each page shard runs the partial
kernel over its own pages for the group's full query-head set (JAX's
``all_gather`` over ``seq``), the flash partials ``(acc, m, l)`` merge
across ``seq`` (one max and two sums, :func:`merge_partials`), and each
shard keeps its own heads of the result. Page writes land only on the
shard that owns the destination page.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from runbookai_tpu_torch.ops.paged_attention import (
    paged_chunk_attention_partial,
    paged_decode_attention_partial,
)
from runbookai_tpu_torch.parallel.mesh import Mesh, all_gather


@dataclass(frozen=True)
class KVSplitPlan:
    """How a requested tp factor maps onto (kv_shards, pg_shards)."""

    tp: int
    kv_shards: int  # shards of the KV-head axis  -> mesh 'model'
    pg_shards: int  # shards of the page/token axis -> mesh 'seq'


def plan_kv_split(cfg, tp: int) -> KVSplitPlan:
    """The KV layout for ``tp``-way model parallelism: tp that divides the
    kv heads shards heads only (pg_shards = 1); otherwise heads shard as far
    as they go and the remaining factor goes on the page axis, which needs
    each device's query heads to share its kv head."""
    if tp <= 1:
        return KVSplitPlan(tp=tp, kv_shards=max(tp, 1), pg_shards=1)
    kv_shards = math.gcd(cfg.n_kv_heads, tp)
    pg_shards = tp // kv_shards
    group = cfg.n_heads // cfg.n_kv_heads
    if pg_shards > 1:
        if cfg.n_heads % tp != 0:
            raise ValueError(
                f"n_heads={cfg.n_heads} not divisible by tp={tp}")
        if group % pg_shards != 0:
            raise ValueError(
                f"KV split needs group ({group}) % pg_shards "
                f"({pg_shards}) == 0 so each device's query heads share "
                f"its kv head; use tp <= {cfg.n_kv_heads * group}")
    return KVSplitPlan(tp=tp, kv_shards=kv_shards, pg_shards=pg_shards)


# ----------------------------------------------------------------- write


def split_destinations(positions: torch.Tensor, page_tables: torch.Tensor,
                       page_size: int, shard: int, tokens_local: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch rows whose K/V lands in page shard ``shard``'s slice and
    their local rows there: ``(rows, local)``, both int64. A destination on
    another shard is left out, never wrapped: on shards above 0 it is
    negative, and a negative index would write this shard's mirror slot."""
    b, t = positions.shape
    pos = positions.long()
    phys = torch.gather(page_tables, 1, pos // page_size).long()
    dest = (phys * page_size + pos % page_size).reshape(b * t)
    local = dest - shard * tokens_local
    rows = torch.nonzero((local >= 0) & (local < tokens_local)).squeeze(1)
    return rows, local.index_select(0, rows)


def write_rows(kv_local: torch.Tensor, new_kv: torch.Tensor,
               rows: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Write batch rows ``rows`` of ``new_kv`` [B, T, n_kv, hd] at local rows
    ``local`` of the slice, IN PLACE (:func:`split_destinations`)."""
    flat = new_kv.reshape((-1,) + tuple(new_kv.shape[2:]))
    return kv_local.index_copy_(0, local, flat.index_select(0, rows).to(kv_local.dtype))


# ------------------------------------------------------------- attention


def merge_partials(parts, device: torch.device) -> torch.Tensor:
    """Merge the page shards' flash partials ``(acc, m, l)`` on ``device``,
    in f32: the max of the m's, each shard's correction ``exp(m - m_max)``,
    the corrected sums of l and acc, and their quotient with the normaliser
    clamped at 1e-30. A row that no shard saw a key for stays zeros."""
    accs = [a.to(device) for a, _, _ in parts]
    ms = [m.to(device) for _, m, _ in parts]
    ls = [l.to(device) for _, _, l in parts]
    m_g = torch.stack(ms).amax(dim=0)
    corr = [torch.exp(m - m_g) for m in ms]
    l_g = sum(l * c for l, c in zip(ls, corr))
    acc_g = sum(a * c[..., None] for a, c in zip(accs, corr))
    return acc_g / l_g.clamp_min(1e-30)[..., None]


def _kv_split(mesh: Mesh, qs, partial) -> list[torch.Tensor]:
    """Per model group: gather the group's query heads over ``seq``, run
    ``partial(rank, s, q_full)`` on every page shard, merge on the group's
    first device and hand each shard its own heads."""
    outs: list = [None] * mesh.tp
    for m in range(mesh.model):
        ranks = [mesh.rank(m, s) for s in range(mesh.seq)]
        home = mesh.devices[ranks[0]]
        q_full = all_gather([qs[r] for r in ranks], dim=-2, device=home)
        parts = [partial(r, s, q_full.to(mesh.devices[r])) for s, r in enumerate(ranks)]
        out = merge_partials(parts, home).to(q_full.dtype)
        nql = qs[ranks[0]].shape[-2]
        for s, r in enumerate(ranks):
            outs[r] = out[..., s * nql:(s + 1) * nql, :].to(mesh.devices[r])
    return outs


def paged_decode_attention_kv_split(mesh: Mesh, qs, k_locals, v_locals,
                                    page_tables, ctx_lens, page_size: int
                                    ) -> list[torch.Tensor]:
    """Decode attention over the (kv head x page)-sharded pool. Every
    argument but ``mesh`` and ``page_size`` has one entry per TP rank:
    ``qs[r]`` [B, n_q / tp, hd], ``k_locals[r]`` the shard's pool slice
    [tokens / seq, n_kv / model, hd], replicated page tables and lengths.
    Returns each shard's heads of the result, [B, n_q / tp, hd]."""
    def partial(r, s, q_full):
        return paged_decode_attention_partial(
            q_full, k_locals[r], v_locals[r], page_tables[r], ctx_lens[r], s,
            page_size, k_locals[r].shape[0] // page_size)

    return _kv_split(mesh, qs, partial)


def paged_attention_kv_split(mesh: Mesh, qs, k_locals, v_locals, page_tables,
                             ctx_lens, q_positions, page_size: int
                             ) -> list[torch.Tensor]:
    """:func:`paged_decode_attention_kv_split` for T > 1 chunks (prefill and
    the speculative verify): ``qs[r]`` [B, T, n_q / tp, hd], causal over
    ``q_positions[:, 0] + t``."""
    def partial(r, s, q_full):
        return paged_chunk_attention_partial(
            q_full, k_locals[r], v_locals[r], page_tables[r], ctx_lens[r],
            q_positions[r], s, page_size, k_locals[r].shape[0] // page_size)

    return _kv_split(mesh, qs, partial)
