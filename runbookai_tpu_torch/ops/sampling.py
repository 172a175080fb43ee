"""Token sampling: greedy / temperature / top-p / top-k, plus logit masks.

Runs on the logits' device. The order of operations is the JAX package's:
bias, penalties, mask, greedy or temperature, top-p, top-k.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor,
                  top_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temperature-scaled logits with everything outside the top-p (and
    top-k) support set to ``NEG_INF``. Top-p keeps the smallest sorted
    prefix whose cumulative probability reaches ``top_p``; top-k composes
    with it (a token must survive both filters)."""
    vocab = logits.shape[-1]
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cumprobs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # Clamped to the vocab: with top_p = 1.0, float32 rounding can leave
    # every cumprob just below 1.0.
    keep = ((cumprobs < top_p[:, None]).sum(dim=-1) + 1).clamp_max(vocab)
    cutoff = torch.gather(sorted_logits, 1, (keep - 1)[:, None])
    filtered = torch.where(scaled >= cutoff, scaled, NEG_INF)
    if top_k is not None:
        k_eff = torch.where(top_k > 0, top_k, vocab).long()
        k_idx = (k_eff - 1).clamp(0, vocab - 1)
        cutoff_k = torch.gather(sorted_logits, 1, k_idx[:, None])
        filtered = torch.where(scaled >= cutoff_k, filtered, NEG_INF)
    return filtered


def seeded_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator of one seeded draw: a function of (seed, position)
    alone, so the draw does not depend on the batch around it."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(position)) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def sample_tokens(
    logits: torch.Tensor,  # [B, vocab] float32
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B] float32; 0 -> greedy
    top_p: torch.Tensor,  # [B] float32 in (0, 1]
    mask: Optional[torch.Tensor] = None,  # [B, vocab] bool, True = allowed
    top_k: Optional[torch.Tensor] = None,  # [B] int; 0 -> disabled
    counts: Optional[torch.Tensor] = None,  # [B, vocab] int token counts
    presence: Optional[torch.Tensor] = None,  # [B] float32
    frequency: Optional[torch.Tensor] = None,  # [B] float32
    seeds: Optional[torch.Tensor] = None,  # [B] int; -1 -> ``generator``
    positions: Optional[torch.Tensor] = None,  # [B] int (seeded draws)
    bias: Optional[torch.Tensor] = None,  # [B, vocab] float32 logit_bias
) -> torch.Tensor:
    """Sample one token per row; returns int32 [B].

    OpenAI-style penalties subtract ``presence*(count>0) + frequency*count``
    before masking. Rows with ``seeds[i] >= 0`` draw from a generator
    derived from ``(seed, positions[i])``; other rows draw from
    ``generator``."""
    if bias is not None:
        logits = logits + bias
    if counts is not None:
        pen = torch.zeros_like(logits)
        if presence is not None:
            pen = pen + presence[:, None] * (counts > 0)
        if frequency is not None:
            pen = pen + frequency[:, None] * counts.to(logits.dtype)
        logits = logits - pen
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)

    greedy = torch.argmax(logits, dim=-1)
    sampling = temperature > 0.0
    if not bool(sampling.any()):
        return greedy.to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature, top_p, top_k), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    if seeds is not None:
        pos = positions if positions is not None else torch.zeros_like(seeds)
        seeds_h, pos_h = seeds.tolist(), pos.tolist()
        for i, seed in enumerate(seeds_h):
            if seed >= 0:
                g = seeded_generator(seed, pos_h[i], logits.device)
                sampled[i] = torch.multinomial(probs[i], 1, generator=g)[0]
    return torch.where(sampling, sampled, greedy).to(torch.int32)
