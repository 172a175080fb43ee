"""Serving memory planner: does (model, context, batch) fit the card?

A copy of the JAX package's ``engine/memory_plan.py``: the residency
arithmetic of weights and KV bytes per device, with the KV-split
factorization of :mod:`runbookai_tpu_torch.parallel.kv_split` folded in so
plans stay correct past the GQA head count. KV bytes scale linearly with
context and fill device memory long before compute becomes the limit, so a
long context is planned, not defaulted.

The device's memory has no default here: the caller passes it
(``serve`` passes ``torch.cuda.get_device_properties(device).total_memory``).
The 1.5 GiB headroom is the JAX package's constant, kept as it is.
"""

from __future__ import annotations

from dataclasses import dataclass

from runbookai_tpu_torch.parallel.kv_split import plan_kv_split

GiB = 1024**3


@dataclass(frozen=True)
class ServingPlan:
    model: str
    tp: int
    kv_shards: int
    pg_shards: int
    hbm_bytes: int
    weight_bytes_per_chip: int
    kv_bytes_per_token_per_chip: float
    pool_budget_bytes: int  # device memory left for the KV pool after weights+headroom
    max_seq_len: int
    batch: int

    @property
    def context_bytes_per_chip(self) -> float:
        return self.kv_bytes_per_token_per_chip * self.max_seq_len

    @property
    def max_concurrent_contexts(self) -> int:
        if self.context_bytes_per_chip <= 0:
            return 0
        return int(self.pool_budget_bytes // self.context_bytes_per_chip)

    @property
    def fits(self) -> bool:
        return self.max_concurrent_contexts >= self.batch

    def explain(self) -> str:
        return (
            f"{self.model} tp{self.tp} (kv{self.kv_shards}×pg"
            f"{self.pg_shards}): weights {self.weight_bytes_per_chip / GiB:.2f}"
            f" GiB/chip, KV {self.kv_bytes_per_token_per_chip / 1024:.1f}"
            f" KiB/token/chip → {self.max_seq_len} ctx = "
            f"{self.context_bytes_per_chip / GiB:.2f} GiB; pool budget "
            f"{self.pool_budget_bytes / GiB:.2f} GiB holds "
            f"{self.max_concurrent_contexts} concurrent (need {self.batch})"
            f" → {'FITS' if self.fits else 'DOES NOT FIT'}"
        )


def _moe_bytes(cfg, weights: str, tp: int, kv_shards: int, layer_matmul: int, wkv: int,
               emb_head: int) -> float:
    """A MoE model's weight bytes a device, norms aside, as the tree holds
    them: the experts at 2 bytes a weight, or at int8 1 byte and a float32
    scale a (layer, expert, output channel), split over ``model`` where E
    divides by tp (``param_splits``); the router in the activation dtype on
    every shard; attention as the dense count has it."""
    L, D, E, F = cfg.n_layers, cfg.dim, cfg.n_experts, cfg.ffn_dim
    ep = kv_shards if E % max(tp, 1) == 0 else 1
    experts, router = L * E * 3 * D * F, L * D * E
    attn = layer_matmul - experts - router
    rest = router * 2 + emb_head * 2 / max(tp, 1)
    if weights == "int8":
        attn_scales = L * (cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim
                           + D)
        return ((attn - wkv + attn_scales * 4) / max(tp, 1) + wkv / max(kv_shards, 1)
                + (experts + L * E * (2 * F + D) * 4) / ep + rest)
    return ((attn - wkv) * 2 / max(tp, 1) + wkv * 2 / max(kv_shards, 1)
            + experts * 2 / ep + rest)


def plan_serving(
    cfg,
    max_seq_len: int,
    *,
    hbm_bytes: int,
    batch: int = 1,
    tp: int = 1,
    weights: str = "int8",
    kv_dtype_bytes: int = 2,
    kv_scale_bytes: int = 0,
    headroom_bytes: int = int(1.5 * GiB),
) -> ServingPlan:
    """Arithmetic plan for serving ``cfg`` at ``max_seq_len`` × ``batch`` on
    devices of ``hbm_bytes`` each.

    ``weights``: "int8" (1B/param + f32 scales, embeddings/head bf16) or
    "bf16". KV shards by the full tp via :func:`plan_kv_split` (heads as far
    as they divide, pages for the rest). ``kv_scale_bytes``: extra bytes per
    (token, kv head): 4 for the int8 KV pool's f32 absmax scales, 0 for
    raw-dtype pools. Weights count every expert of a MoE model, as the
    tree holds them (the JAX package counts only the active ones, and
    offers their difference to the pool), and int8 weights one scale an
    output channel (the JAX package counts ``ffn_dim`` of them for w_down's
    ``dim``): at tp = 1 the plan's weight bytes are the tree's
    (``models/quant.py::weight_bytes``). The JAX package's host spill
    tier (``kv_spill_pages``) is not ported (ROADMAP.md queue 1 item 9).
    """
    plan = plan_kv_split(cfg, tp)

    # Every layer weight the tree holds: all experts of a MoE layer, where
    # the JAX package's ``matmul_params`` counts only the top_k active ones.
    norms = (cfg.n_layers * 2 + 1) * cfg.dim
    layer_matmul = (cfg.total_params - norms
                    - cfg.vocab_size * cfg.dim * (1 if cfg.tie_embeddings else 2))
    wkv = cfg.n_layers * 2 * cfg.dim * cfg.n_kv_heads * cfg.head_dim
    emb_head = 2 * cfg.vocab_size * cfg.dim  # embed + lm head (or tied x2)
    if cfg.n_experts:
        per_chip = _moe_bytes(cfg, weights, tp, plan.kv_shards, layer_matmul, wkv,
                              emb_head)
    elif weights == "int8":
        # wk/wv shard kv_shards-way only; everything else full-tp. One f32
        # scale an output channel of each of the seven matrices.
        scales = cfg.n_layers * (cfg.n_heads * cfg.head_dim
                                 + 2 * cfg.n_kv_heads * cfg.head_dim
                                 + 2 * cfg.dim + 2 * cfg.ffn_dim)
        per_chip = ((layer_matmul - wkv) / max(tp, 1)
                    + wkv / max(plan.kv_shards, 1)
                    + scales * 4 / max(tp, 1)
                    + emb_head * 2 / max(tp, 1))  # bf16
    else:
        per_chip = ((layer_matmul - wkv) * 2 / max(tp, 1)
                    + wkv * 2 / max(plan.kv_shards, 1)
                    + emb_head * 2 / max(tp, 1))
    per_chip += norms * 4  # replicated

    kv_per_token = (cfg.n_layers * 2
                    * (cfg.n_kv_heads / max(plan.kv_shards, 1))
                    * (cfg.head_dim * kv_dtype_bytes + kv_scale_bytes)
                    / max(plan.pg_shards, 1))
    budget = max(0, hbm_bytes - int(per_chip) - headroom_bytes)
    return ServingPlan(
        model=cfg.name, tp=tp, kv_shards=plan.kv_shards,
        pg_shards=plan.pg_shards, hbm_bytes=hbm_bytes,
        weight_bytes_per_chip=int(per_chip),
        kv_bytes_per_token_per_chip=kv_per_token,
        pool_budget_bytes=budget, max_seq_len=max_seq_len, batch=batch,
    )
