"""Mixture-of-experts FFN with fixed-shape dispatch (Mixtral).

The counterpart of ``runbookai_tpu/ops/moe.py``, as plain torch ops (the
JAX package runs it on XLA, with no Pallas kernel). Routing is Mixtral's:
softmax over every expert's float32 logit, the top k, renormalised. The
dispatch is capacity-slotted with one scatter:

- each (token, k) pair takes a slot in its expert's queue, the running
  count of earlier pairs sent to the same expert in (token, k) order; a
  pair whose slot reaches the capacity goes to the overflow row
  ``E * cap`` and adds nothing;
- tokens scatter into ``[E * cap + 1, D]`` (slots are unique per expert, so
  only the discarded overflow row takes duplicate indices);
- the experts run as batched products over the leading E axis;
- outputs gather back by the same rows (the overflow row reads zeros) and
  combine with the gate weights in the activation dtype.

Every shape is fixed by ``N`` and the capacity, with no host read, so the
engine's step graphs capture it. Capacity is ``clamp(ceil(capacity_factor
* N * top_k / E), 1, N)``; ``capacity_factor <= 0`` (the config default)
is dropless, ``C = N``.

Expert parallelism: a shard that holds experts ``[first, first + E_local)``
of the bank passes its own expert leaves and ``first``. It routes every
token over all ``E`` experts (the router is whole on every shard), keeps
the pairs whose expert it holds and returns their part of the output; the
shards' parts sum to the unsharded result.
"""

from __future__ import annotations

import math
from typing import Any

import torch


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Fixed per-expert queue length for a dispatch of ``n_tokens``.
    ``capacity_factor <= 0`` is dropless: ``n_tokens``, the worst case of
    every token choosing one expert."""
    if capacity_factor <= 0:
        return n_tokens
    c = math.ceil(capacity_factor * n_tokens * top_k / n_experts)
    return max(1, min(int(c), n_tokens))


def route(x: torch.Tensor, router: torch.Tensor,
          top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate weights (float32, renormalised over the top k) and expert ids
    [N, K] of the rows of ``x`` [N, D]. The logits are ``x.float() @
    router.float()``. Ties go to the lower expert id first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order): a
    stable descending sort. An all-zero row ties every expert."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals / vals.sum(dim=-1, keepdim=True), idx


def moe_ffn(y: torch.Tensor, router: torch.Tensor, w_gate: Any, w_up: Any, w_down: Any,
            top_k: int, capacity_factor: float, first: int = 0) -> torch.Tensor:
    """SwiGLU MoE block over ``y`` [B, T, D] (the residual is not added).

    ``router`` [D, E]; ``w_gate``/``w_up`` [E_local, D, F] and ``w_down``
    [E_local, F, D], plain or int8 ``{"q", "s"}`` with scales [E_local, 1,
    out], holding experts ``[first, first + E_local)``. Pairs routed to
    other experts contribute zero here."""
    from runbookai_tpu_torch.models.llama import qmm  # deferred: models -> ops

    b, t, d = y.shape
    e = router.shape[-1]
    e_local = (w_gate["q"] if isinstance(w_gate, dict) else w_gate).shape[0]
    n = b * t
    cap = expert_capacity(n, e, top_k, capacity_factor)
    x = y.reshape(n, d)

    gate, idx = route(x, router, top_k)
    flat_idx = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_idx, e)  # [N*K, E]
    slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    # The pair's row in this shard's [E_local * cap] queues, or the overflow
    # row for a dropped pair and for an expert this shard does not hold.
    local = flat_idx - first
    keep = (slot < cap) & (local >= 0) & (local < e_local)
    overflow = e_local * cap
    dest = torch.where(keep, local * cap + slot, torch.full_like(slot, overflow))

    # Only the overflow row takes duplicate indices; its value is never
    # read, so whichever write lands there does not matter (the reason
    # ``torch.use_deterministic_algorithms`` would have to be told).
    buf = torch.zeros((overflow + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, x.repeat_interleave(top_k, dim=0))
    xe = buf[:overflow].reshape(e_local, cap, d)

    act = torch.nn.functional.silu(qmm(xe, w_gate)) * qmm(xe, w_up)
    out_e = qmm(act, w_down)  # [E_local, cap, D]

    flat = torch.cat([out_e.reshape(overflow, d), out_e.new_zeros((1, d))])
    back = flat.index_select(0, dest).reshape(n, top_k, d)
    combined = torch.sum(back * gate[..., None].to(back.dtype), dim=1)
    return combined.reshape(b, t, d)
