"""Llama-3 family in PyTorch — the paged serving forward and the training forward.

The counterpart of ``runbookai_tpu/models/llama.py`` on one GPU:

- Params are a plain dict with every transformer layer **stacked on a
  leading axis** (``[L, in, out]``, computed as ``x @ w``), the JAX
  package's layout, so parameters convert one to one
  (:mod:`runbookai_tpu_torch.models.convert`). The layer ``lax.scan``
  becomes a Python loop over the ``[L, ...]`` slices.
- One forward covers chunked prefill and decode (decode is T = 1): the
  chunk's K/V are written into the paged pool IN PLACE (this replaces the
  JAX package's buffer donation), then the queries attend over the pool
  through the decode kernel (T = 1) or the chunk kernel (T > 1).
- GQA, RMSNorm in float32, the projections and LM head as plain matmuls in
  the activation dtype, logits cast to float32 after the LM-head product.
- int8 weights (:mod:`runbookai_tpu_torch.models.quant`): the seven layer
  matrices may be ``{"q", "s"}`` leaves, multiplied by :func:`qmm`. The KV
  pools may be int8 ``(values, scales)`` tuples
  (:mod:`runbookai_tpu_torch.ops.attention`).
- Mixtral's routed experts (:mod:`runbookai_tpu_torch.ops.moe`): with
  ``n_experts`` the FFN leaves are ``[L, E, in, out]`` and a router
  ``[L, D, E]`` (never quantized) picks each token's top k.
- Tensor parallelism: with ``mesh=`` (:mod:`runbookai_tpu_torch.parallel`)
  the params are one dict per shard (``shard_params``) and the pools one
  per shard; the forward loops over the shards inside the layer loop and
  writes out the collectives that XLA inserts from the JAX package's
  shardings (:func:`_forward_hidden_sharded`).
- Training (:func:`forward_train`): the same layer pieces under autograd
  over dense causal attention, for ``train/trainer.py`` and
  ``train/lora_trainer.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from runbookai_tpu_torch.models.lora import layer_lora, with_lora
from runbookai_tpu_torch.models.quant import is_quantized
from runbookai_tpu_torch.ops.attention import write_kv_pages_batch
from runbookai_tpu_torch.ops.moe import moe_ffn
from runbookai_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_chunk_attention_tp,
    paged_decode_attention,
    paged_decode_attention_tp,
    RaggedPlan,
    ragged_plan,
    ragged_route,
    ragged_tile_attention,
)
from runbookai_tpu_torch.ops.qmm import qmm_eligible, qmm_int8
from runbookai_tpu_torch.ops.rope import rope_cos_sin, rotate
from runbookai_tpu_torch.parallel import kv_split
from runbookai_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce_sum,
    map_replicated,
    replicate,
)
from runbookai_tpu_torch.parallel.sharding import check_mesh, param_splits

Params = dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    rope_theta: float = 500_000.0
    # Llama-3.1 long-context rope scaling (NTK-by-parts): tuple
    # (factor, low_freq_factor, high_freq_factor, original_max_pos) or
    # None. Set from HF config.json's rope_scaling (rope_type "llama3").
    rope_scaling: Optional[tuple] = None
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # Qwen2-family attention: biases on the q/k/v projections only (HF
    # ``Qwen2Attention``); Llama/Mistral run bias-free. The scan-stacked
    # layer dict simply carries three extra [L, heads*hd] leaves.
    qkv_bias: bool = False
    # Model family ("llama" | "qwen2" | "mistral" | "mixtral") — drives the
    # chat template. Set from HF config.json's authoritative ``model_type``
    # by the loader; name sniffing is only the fallback for bare names.
    family: str = "llama"
    # Mixture-of-Experts (Mixtral): 0 = dense FFN. When > 0 the FFN leaves
    # gain a leading expert axis ([L, E, D, F]) plus a router [L, D, E].
    n_experts: int = 0
    top_k_experts: int = 2
    # Per-expert queue headroom. 0 (default) = dropless: capacity N, exact
    # Mixtral/transformers numerics at E× the buffer cost. Perf-tuned
    # serving can trade exactness for smaller dispatch buffers by setting
    # e.g. 1.25–2.0 (token-expert assignments past the capacity drop).
    capacity_factor: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def matmul_params(self) -> int:
        """Analytic count of params that participate in matmuls *per token*
        (layer projections + LM head; excludes the embedding gather) — the
        ``N`` in the decode-FLOPs model ``2·N`` used for MFU reporting. For
        MoE this counts the ``top_k`` ACTIVE experts (the FLOPs actually
        spent per token), not the full expert bank."""
        D, hd = self.dim, self.head_dim
        ffn_mult = self.top_k_experts if self.n_experts else 1
        per_layer = (
            D * self.n_heads * hd          # wq
            + 2 * D * self.n_kv_heads * hd  # wk, wv
            + self.n_heads * hd * D         # wo
            + ffn_mult * 3 * D * self.ffn_dim  # active FFN experts
            + (D * self.n_experts if self.n_experts else 0)  # router
        )
        return self.n_layers * per_layer + D * self.vocab_size

    @property
    def total_params(self) -> int:
        """All weights, including every expert (the memory-side count)."""
        D = self.dim
        embed = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        norms = self.n_layers * 2 * D + D
        ffn_mult = self.n_experts if self.n_experts else 1
        ffn_delta = (ffn_mult - (self.top_k_experts if self.n_experts else 1)
                     ) * 3 * D * self.ffn_dim * self.n_layers
        return (self.matmul_params - D * self.vocab_size + embed + norms
                + ffn_delta)


CONFIGS: dict[str, LlamaConfig] = {
    "llama3-8b-instruct": LlamaConfig(
        name="llama3-8b-instruct", vocab_size=128_256, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_dim=14_336,
    ),
    "llama3-70b-instruct": LlamaConfig(
        name="llama3-70b-instruct", vocab_size=128_256, dim=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, ffn_dim=28_672,
    ),
    "llama3-1b-bench": LlamaConfig(
        # Small-dim stand-in for quick single-chip bench sanity runs.
        name="llama3-1b-bench", vocab_size=128_256, dim=2048, n_layers=16,
        n_heads=32, n_kv_heads=8, ffn_dim=8192,
    ),
    # Llama-3.1/3.2: same blocks with NTK-by-parts rope scaling for 128k
    # contexts; 3.2 ties embeddings. (8B dims match llama3-8b.)
    "llama3.1-8b-instruct": LlamaConfig(
        name="llama3.1-8b-instruct", vocab_size=128_256, dim=4096,
        n_layers=32, n_heads=32, n_kv_heads=8, ffn_dim=14_336,
        max_seq_len=131_072, rope_scaling=(8.0, 1.0, 4.0, 8192),
    ),
    "llama3.1-70b-instruct": LlamaConfig(
        name="llama3.1-70b-instruct", vocab_size=128_256, dim=8192,
        n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28_672,
        max_seq_len=131_072, rope_scaling=(8.0, 1.0, 4.0, 8192),
    ),
    # Llama-3.3-70B ships the 3.1-70B architecture exactly (dims, rope
    # scaling, 128k window) — served under its own name for HF parity.
    "llama3.3-70b-instruct": LlamaConfig(
        name="llama3.3-70b-instruct", vocab_size=128_256, dim=8192,
        n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28_672,
        max_seq_len=131_072, rope_scaling=(8.0, 1.0, 4.0, 8192),
    ),
    "llama3.2-1b-instruct": LlamaConfig(
        name="llama3.2-1b-instruct", vocab_size=128_256, dim=2048,
        n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192,
        max_seq_len=131_072, rope_scaling=(32.0, 1.0, 4.0, 8192),
        tie_embeddings=True,
    ),
    "llama3.2-3b-instruct": LlamaConfig(
        name="llama3.2-3b-instruct", vocab_size=128_256, dim=3072,
        n_layers=28, n_heads=24, n_kv_heads=8, ffn_dim=8192,
        max_seq_len=131_072, rope_scaling=(32.0, 1.0, 4.0, 8192),
        tie_embeddings=True,
    ),
    "llama3-test": LlamaConfig(
        # Tiny config for CPU tests; vocab matches the byte tokenizer (262).
        # max_seq_len covers real agent/orchestrator prompts (byte tokenizer:
        # 1 token per byte), so live-eval e2e runs fit without truncation.
        name="llama3-test", vocab_size=262, dim=64, n_layers=2, n_heads=4,
        n_kv_heads=2, ffn_dim=128, max_seq_len=8192, rope_theta=10_000.0,
    ),
    # Qwen2 family: identical block structure with q/k/v projection biases
    # and ChatML prompts (HF ``Qwen2ForCausalLM``; config.json model_type
    # "qwen2"). Serving/training/TP paths are shared with Llama.
    "qwen2-7b-instruct": LlamaConfig(
        name="qwen2-7b-instruct", vocab_size=152_064, dim=3584, n_layers=28,
        n_heads=28, n_kv_heads=4, ffn_dim=18_944, rope_theta=1_000_000.0,
        max_seq_len=32_768, qkv_bias=True, family="qwen2",
    ),
    # Qwen2.5-7B ships the same architecture/dims as Qwen2-7B (vocab,
    # qkv biases, theta) — served under its own name for HF parity.
    "qwen2.5-7b-instruct": LlamaConfig(
        name="qwen2.5-7b-instruct", vocab_size=152_064, dim=3584,
        n_layers=28, n_heads=28, n_kv_heads=4, ffn_dim=18_944,
        rope_theta=1_000_000.0, max_seq_len=32_768, qkv_bias=True,
        family="qwen2",
    ),
    "qwen2.5-14b-instruct": LlamaConfig(
        name="qwen2.5-14b-instruct", vocab_size=152_064, dim=5120,
        n_layers=48, n_heads=40, n_kv_heads=8, ffn_dim=13_824,
        rope_theta=1_000_000.0, max_seq_len=32_768, qkv_bias=True,
        family="qwen2",
    ),
    "qwen2.5-32b-instruct": LlamaConfig(
        name="qwen2.5-32b-instruct", vocab_size=152_064, dim=5120,
        n_layers=64, n_heads=40, n_kv_heads=8, ffn_dim=27_648,
        rope_theta=1_000_000.0, max_seq_len=32_768, qkv_bias=True,
        family="qwen2",
    ),
    "qwen2-test": LlamaConfig(
        name="qwen2-test", vocab_size=262, dim=64, n_layers=2, n_heads=4,
        n_kv_heads=2, ffn_dim=128, max_seq_len=8192, rope_theta=10_000.0,
        qkv_bias=True, family="qwen2",
    ),
    # Mistral v0.3: Llama block structure exactly (GQA, no bias), different
    # dims/vocab/theta. Sliding-window variants (v0.1) are served with full
    # attention — exact for contexts ≤ the window (4096).
    "mistral-7b-instruct": LlamaConfig(
        name="mistral-7b-instruct", vocab_size=32_768, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_dim=14_336, rope_theta=1_000_000.0,
        max_seq_len=32_768, family="mistral",
    ),
    # Mixtral 8x7B: Mistral attention + 8-expert top-2 MoE FFN.
    "mixtral-8x7b-instruct": LlamaConfig(
        name="mixtral-8x7b-instruct", vocab_size=32_000, dim=4096,
        n_layers=32, n_heads=32, n_kv_heads=8, ffn_dim=14_336,
        rope_theta=1_000_000.0, max_seq_len=32_768, family="mixtral",
        n_experts=8, top_k_experts=2,
    ),
    "mixtral-test": LlamaConfig(
        name="mixtral-test", vocab_size=262, dim=64, n_layers=2, n_heads=4,
        n_kv_heads=2, ffn_dim=128, max_seq_len=8192, rope_theta=10_000.0,
        family="mixtral", n_experts=4, top_k_experts=2,
    ),
}


def get_config(name: str) -> LlamaConfig:
    if name not in CONFIGS:
        raise KeyError(f"Unknown model {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]


def _layer_shapes(cfg: LlamaConfig) -> dict[str, tuple[tuple[int, ...], int]]:
    """The stacked layer matrices as ``name -> (shape, fan_in)``. MoE
    configs put a leading expert axis on the FFN leaves and add the router
    ``[L, D, E]``, which stays in the dense dtype under the int8 init."""
    L, D, KV, F = cfg.n_layers, cfg.dim, cfg.n_kv_heads, cfg.ffn_dim
    H, hd = cfg.n_heads, cfg.head_dim
    shapes = {
        "wq": ((L, D, H * hd), D),
        "wk": ((L, D, KV * hd), D),
        "wv": ((L, D, KV * hd), D),
        "wo": ((L, H * hd, D), H * hd),
    }
    experts = (cfg.n_experts,) if cfg.n_experts else ()
    shapes.update({
        "w_gate": ((L, *experts, D, F), D),
        "w_up": ((L, *experts, D, F), D),
        "w_down": ((L, *experts, F, D), F),
    })
    if cfg.n_experts:
        shapes["router"] = ((L, D, cfg.n_experts), D)
    return shapes


# The largest float32 draw of a 2-D leaf (64 MiB), below one layer matrix of
# the 8B (4096 x 14336).
_DRAW_ELEMS = 1 << 24


def _build_params(cfg: LlamaConfig, dtype: torch.dtype, device,
                  generator: Optional[torch.Generator], layer_init=None) -> Params:
    """Random-init params directly on ``device``. Dense leaves are scaled
    normal (``1/sqrt(fan_in)``): each layer of a stacked leaf, and each
    slice of at most ``_DRAW_ELEMS`` elements (whole rows) of the embedding
    and head, is drawn in float32 and cast into the ``dtype`` tensor, so no
    whole leaf, let alone a full-width model, exists in float32 or on the
    host. ``layer_init(shape, fan_in)``, when given, makes the seven layer
    matrices instead (the router stays dense, as in the JAX package)."""
    device = torch.device(device)

    def dense(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=device)
        parts = (out.flatten(0, -3) if len(shape) >= 3
                 else out.split(max(1, _DRAW_ELEMS // shape[-1])))
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device) / math.sqrt(fan_in))
        return out

    L, D = cfg.n_layers, cfg.dim
    layers: dict[str, Any] = {
        name: (dense if name == "router" else layer_init or dense)(shape, fan_in)
        for name, (shape, fan_in) in _layer_shapes(cfg).items()}
    layers["attn_norm"] = torch.ones((L, D), dtype=torch.float32, device=device)
    layers["mlp_norm"] = torch.ones((L, D), dtype=torch.float32, device=device)
    if cfg.qkv_bias:
        hd = cfg.head_dim
        layers["bq"] = torch.zeros((L, cfg.n_heads * hd), dtype=dtype, device=device)
        layers["bk"] = torch.zeros((L, cfg.n_kv_heads * hd), dtype=dtype, device=device)
        layers["bv"] = torch.zeros((L, cfg.n_kv_heads * hd), dtype=dtype, device=device)
    params: Params = {
        "embed": dense((cfg.vocab_size, D), D),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size), D)
    return params


def init_params(cfg: LlamaConfig, dtype: torch.dtype = torch.bfloat16,
                device="cuda", generator: Optional[torch.Generator] = None
                ) -> Params:
    """Random-init params (scaled normal, ``1/sqrt(fan_in)``) directly on
    ``device``. ``generator`` must live on ``device``."""
    return _build_params(cfg, dtype, device, generator)


def init_params_quantized(cfg: LlamaConfig, dtype: torch.dtype = torch.bfloat16,
                          device="cuda", generator: Optional[torch.Generator] = None
                          ) -> Params:
    """Random-init params with the seven layer matrices directly in int8,
    so a full-width model never exists in ``dtype``: ``q`` uniform in
    [-127, 127] (std 127/sqrt(3)) with the per-channel scale
    ``sqrt(3) / (127 sqrt(fan_in))``, which gives the dequantized weights the
    std ``1/sqrt(fan_in)`` of :func:`init_params`. Leaves are ``{"q": int8,
    "s": float32 [L, 1, out]}`` (MoE experts: ``[L, E, 1, out]``); the rest,
    the router included, is as :func:`init_params`."""

    def qdense(shape, fan_in):
        q = torch.empty(shape, dtype=torch.int8, device=device)
        for part in q.flatten(0, -3):
            part.random_(-127, 128, generator=generator)
        scale = 3 ** 0.5 / (127.0 * fan_in ** 0.5)
        s = torch.full(shape[:-2] + (1, shape[-1]), scale, dtype=torch.float32,
                       device=device)
        return {"q": q, "s": s}

    return _build_params(cfg, dtype, device, generator, qdense)


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain or an int8 ``{"q", "s"}`` weight.

    The route is chosen by shape, as the JAX package's ``qmm(impl="pallas")``
    chooses it: an eligible 2-D ``[M, K] @ [K, N]`` (decode and verify) goes
    to the int8 kernel :func:`qmm_int8`; any other quantized product
    (prefill, and the MoE experts' batched ``[E, C, K] @ [E, K, N]`` with
    scales ``[E, 1, N]``) to ``(x @ q) * s`` in x's dtype through
    ``torch.matmul``, which widens the whole int8 matrix first."""
    if is_quantized(w) and w["q"].dim() == 2:
        k_dim, n = w["q"].shape
        lead = x.shape[:-1]
        if qmm_eligible(math.prod(lead), k_dim, n):
            return qmm_int8(x.reshape(-1, k_dim), w["q"], w["s"].reshape(1, n)).reshape(*lead, n)
    return qmm_widened(x, w)


def qmm_widened(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` through ``torch.matmul`` for every shape: an int8 ``{"q",
    "s"}`` weight as ``(x @ q) * s`` with ``q`` widened to x's dtype first.
    This is the JAX package's ``qmm(impl="xla")``, which its training forward
    takes; it has a backward, where the kernel behind :func:`qmm` has none."""
    if not is_quantized(w):
        return x @ w
    return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * weight).to(x.dtype)


def ffn_block(y: torch.Tensor, lp: dict, cfg: LlamaConfig, first_expert: int = 0,
              matmul=qmm) -> torch.Tensor:
    """SwiGLU FFN, dense (its products through ``matmul``) or Mixtral's
    routed experts (:func:`moe_ffn`, over the experts ``lp`` holds from
    ``first_expert`` on; their 3-D products always widen int8); the
    residual is added by the caller."""
    if cfg.n_experts:
        return moe_ffn(y, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                       cfg.top_k_experts, cfg.capacity_factor, first=first_expert)
    return matmul(torch.nn.functional.silu(matmul(y, lp["w_gate"])) * matmul(y, lp["w_up"]),
                  lp["w_down"])


def lm_head_logits(params: Params, cfg: LlamaConfig, hidden: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Final norm + (tied or untied) LM head. The product runs in the
    activation dtype; the logits are cast to float32 after it. With a
    ``mesh``, ``params`` holds one dict per shard: each shard projects onto
    its vocabulary slice and the slices are concatenated on rank 0's device
    (the sampling device)."""
    if mesh is not None:
        return _lm_head_sharded(params, cfg, hidden, mesh)
    h = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head).float()


def _layer(stacked: Any, i: int) -> Any:
    """Layer ``i`` of a stacked leaf: a tensor, a ``{"q", "s"}`` dict or an
    int8 pool's ``(values, scales)`` tuple."""
    if isinstance(stacked, dict):
        return {k: v[i] for k, v in stacked.items()}
    if isinstance(stacked, tuple):
        return tuple(v[i] for v in stacked)
    return stacked[i]


@dataclass(frozen=True)
class RaggedRows:
    """W1's inputs in a mixed forward, fixed for its layers: the rows' own
    page tables and contexts, the flat positions and row ids, the block
    size, and the tile list (:func:`ragged_plan`; None where the ragged
    kernel does not run: CPU tensors, f32 activations)."""

    page_tables: torch.Tensor  # [R, P] int32
    ctx_lens: torch.Tensor  # [R] int32
    q_positions: torch.Tensor  # [N] int32
    row_ids: torch.Tensor  # [N] int32
    ragged_block: int
    plan: Optional[RaggedPlan]


@torch.no_grad()
def forward_hidden(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] int token ids for the current chunk
    positions: torch.Tensor,  # [B, T] int32 absolute positions
    kv_k: Any,  # [n_layers, num_pages * page_size, n_kv, head_dim], or int8
    kv_v: Any,  # (values, scales [n_layers, num_pages * page_size, n_kv])
    page_tables: torch.Tensor,  # [B, max_pages(+1)] int32
    ctx_lens: torch.Tensor,  # [B] int32 cache length AFTER this chunk
    page_size: int,
    mesh: Optional[Mesh] = None,
    ragged: Optional[RaggedRows] = None,
    adapter_ids: Optional[torch.Tensor] = None,  # [B] int64 LoRA rows
) -> torch.Tensor:
    """Transformer stack over one paged chunk, WITHOUT the LM head.

    Returns hidden [B, T, D]. ``kv_k``/``kv_v`` are updated IN PLACE: each
    layer's chunk K/V are written into its pool slice before attention.
    T = 1 runs the decode kernel, T > 1 the chunk kernel; on CPU tensors
    both run their plain versions. ``ragged`` marks the blocks of a mixed
    batch (:func:`forward_ragged_impl`): ``page_tables`` and ``ctx_lens``
    are then gathered per block for the K/V writes, and each layer's
    attention is W1's launch (:func:`ragged_tile_attention`) on the rows'
    own tables and contexts and the batch's tile list. With a ``mesh``,
    ``params`` and the pools hold one entry per shard
    (:func:`_forward_hidden_sharded`).

    LoRA (:mod:`runbookai_tpu_torch.models.lora`): with a ``"lora"`` tree in
    ``params``, row b adds adapter ``adapter_ids[b]``'s deltas to q, k, v
    and o (every row takes the zero adapter when ``adapter_ids`` is None);
    without one no LoRA op runs."""
    lora = _lora_of(params, mesh)
    if lora is not None and adapter_ids is None:
        adapter_ids = torch.zeros((tokens.shape[0],), dtype=torch.long, device=tokens.device)
    if mesh is not None:
        return _forward_hidden_sharded(params, cfg, tokens, positions, kv_k, kv_v,
                                       page_tables, ctx_lens, page_size, mesh,
                                       adapter_ids if lora is not None else None)
    b, t = tokens.shape
    hd, n_kv, n_q = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    h = params["embed"][tokens]
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, cfg.rope_scaling)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: _layer(w, i) for name, w in layers.items()}
        lpl = layer_lora(lora, i)
        k_pool, v_pool = _layer(kv_k, i), _layer(kv_v, i)
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = qmm(x, lp["wq"]), qmm(x, lp["wk"]), qmm(x, lp["wv"])
        if lpl is not None:
            q = with_lora(q, x, lpl, "wq", adapter_ids)
            k = with_lora(k, x, lpl, "wk", adapter_ids)
            v = with_lora(v, x, lpl, "wv", adapter_ids)
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = rotate(q.reshape(b, t, n_q, hd), cos, sin)
        k = rotate(k.reshape(b, t, n_kv, hd), cos, sin)
        v = v.reshape(b, t, n_kv, hd)
        write_kv_pages_batch(k_pool, k, positions, page_tables, page_size)
        write_kv_pages_batch(v_pool, v, positions, page_tables, page_size)
        if ragged is not None:
            attn = ragged_tile_attention(
                q.reshape(b * t, n_q, hd), k_pool, v_pool, ragged.page_tables,
                ragged.ctx_lens, ragged.q_positions, ragged.row_ids, ragged.plan,
                page_size, ragged.ragged_block).reshape(b, t, n_q, hd)
        elif t == 1:
            attn = paged_decode_attention(q[:, 0], k_pool, v_pool,
                                          page_tables, ctx_lens, page_size)
        else:
            attn = paged_chunk_attention(q, k_pool, v_pool, page_tables,
                                         ctx_lens, positions, page_size)
        ctx = attn.reshape(b, t, n_q * hd)
        h = h + with_lora(qmm(ctx, lp["wo"]), ctx, lpl, "wo", adapter_ids)
        y = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + ffn_block(y, lp, cfg)
    return h


def _lora_of(params: Params, mesh: Optional[Mesh]) -> Optional[dict]:
    """The params' stacked adapter tree (rank 0's on a mesh), or None."""
    return (params if mesh is None else params[0]).get("lora")


@torch.no_grad()
def forward_impl(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    kv_k: Any,
    kv_v: Any,
    page_tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    page_size: int,
    mesh: Optional[Mesh] = None,
    adapter_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One forward chunk: logits [B, T, vocab] float32. The KV pools are
    updated in place (see :func:`forward_hidden`; ``adapter_ids`` [B] are
    the rows' LoRA adapters)."""
    h = forward_hidden(params, cfg, tokens, positions, kv_k, kv_v,
                       page_tables, ctx_lens, page_size, mesh=mesh, adapter_ids=adapter_ids)
    return lm_head_logits(params, cfg, h, mesh=mesh)


@torch.no_grad()
def forward_ragged_impl(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N] flat ragged token batch
    positions: torch.Tensor,  # [N] int32 absolute positions (pads: trash position)
    row_ids: torch.Tensor,  # [N] int32 row (sequence) owning each token
    kv_k: Any,
    kv_v: Any,
    page_tables: torch.Tensor,  # [R, max_pages(+1)] int32 per-ROW page tables
    ctx_lens: torch.Tensor,  # [R] int32 cache length AFTER this step, per row
    sel_idx: torch.Tensor,  # [S] flat token indices whose logits are wanted
    page_size: int,
    mesh: Optional[Mesh] = None,
    ragged_block: int = 8,
    adapter_ids: Optional[torch.Tensor] = None,  # [R] int64 LoRA rows, per ROW
) -> torch.Tensor:
    """Mixed prefill+decode forward over ONE flat ragged token batch: decode
    rows feed one token each and prefill rows a chunk, with per-token
    ``row_ids`` selecting each token's table row and context length.

    Layout contract (EngineCore._run_mixed upholds it): every row's token
    run is contiguous ascending and starts at a multiple of
    ``ragged_block``; pad tokens carry the trash position (their K/V land
    in the null page) and either their run's row id or a null row with
    ``ctx_len = 0``. Each block then belongs to one row, so the stack runs
    as a ``[N / ragged_block, ragged_block]`` chunked forward with the
    tables and contexts gathered per block for the K/V writes; each layer's
    attention is W1's launch (:func:`ragged_tile_attention`) on the rows'
    own tables. Where that launch is the ragged kernel (bf16 activations on
    the card) its tile list (:func:`ragged_plan`, one kernel launch) is
    built ONCE, above the layer loop. On a tensor-parallel ``mesh`` (seq =
    1) attention runs per head shard through
    :func:`paged_chunk_attention_tp` (K2 at ``[N / ragged_block,
    ragged_block]``). ``adapter_ids`` gives each row's LoRA adapter; the
    stack gathers one per block, as the JAX forward does. Returns logits [S,
    vocab] float32 for the ``sel_idx`` tokens only; the pools are updated in
    place."""
    n = tokens.shape[0]
    nb = n // ragged_block
    block_rows = row_ids.reshape(nb, ragged_block)[:, 0]
    ragged = None
    if mesh is None:
        plan = None
        if tokens.is_cuda and ragged_route(params["embed"].dtype, cfg.head_dim,
                                           cfg.n_heads // cfg.n_kv_heads,
                                           ragged_block) == "mma":
            plan = ragged_plan(row_ids, ctx_lens, positions, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, page_tables.shape[1], page_size, ragged_block)
        ragged = RaggedRows(page_tables, ctx_lens, positions, row_ids, ragged_block, plan)
    h = forward_hidden(params, cfg, tokens.reshape(nb, ragged_block),
                       positions.reshape(nb, ragged_block), kv_k, kv_v,
                       page_tables.index_select(0, block_rows),
                       ctx_lens.index_select(0, block_rows), page_size, mesh=mesh,
                       ragged=ragged,
                       adapter_ids=(None if adapter_ids is None
                                    else adapter_ids.index_select(0, block_rows)))
    h_sel = h.reshape(n, h.shape[-1])[sel_idx]
    return lm_head_logits(params, cfg, h_sel, mesh=mesh)


# ----------------------------------------------------------------- training


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                           ) -> torch.Tensor:
    """The training forward's attention, the JAX package's
    ``dense_causal_attention``: q [B, T, n_q, hd] over k, v [B, T, n_kv, hd]
    (GQA groups of ``n_q / n_kv``), the causal softmax materialised over [T,
    T]. q is scaled in float32 before the product, the scores and the softmax
    are float32, masked places hold -1e30, and the weights are cast to v's
    dtype before P V. Plain torch ops, as JAX's is an XLA path."""
    b, t, n_q, hd = q.shape
    n_kv = k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=q.device))
    qg = (q.float() * scale).reshape(b, t, n_kv, n_q // n_kv, hd)
    scores = torch.einsum("btkgd,bskd->btkgs", qg, k.float())
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal[None, :, None, None, :], -1e30)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("btkgs,bskd->btkgd", attn, v).reshape(b, t, n_q, hd)


def _train_layer(h: torch.Tensor, lp: dict, lpl: Optional[dict], cfg: LlamaConfig,
                 cos: torch.Tensor, sin: torch.Tensor,
                 adapter_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """One pre-norm attention + SwiGLU block of :func:`forward_train` (JAX's
    ``transformer_layer``): the serving layer's pieces over dense causal
    attention, every product through :func:`qmm_widened`."""
    b, t = h.shape[:2]
    hd, n_kv, n_q = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = with_lora(qmm_widened(x, lp["wq"]), x, lpl, "wq", adapter_ids)
    k = with_lora(qmm_widened(x, lp["wk"]), x, lpl, "wk", adapter_ids)
    v = with_lora(qmm_widened(x, lp["wv"]), x, lpl, "wv", adapter_ids)
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = rotate(q.reshape(b, t, n_q, hd), cos, sin)
    k = rotate(k.reshape(b, t, n_kv, hd), cos, sin)
    ctx = dense_causal_attention(q, k, v.reshape(b, t, n_kv, hd)).reshape(b, t, n_q * hd)
    h = h + with_lora(qmm_widened(ctx, lp["wo"]), ctx, lpl, "wo", adapter_ids)
    y = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    return h + ffn_block(y, lp, cfg, matmul=qmm_widened)


def forward_train(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  adapter_ids: Optional[torch.Tensor] = None,
                  remat: bool = False) -> torch.Tensor:
    """The training forward under autograd (the JAX package's
    ``forward_train``): logits [B, T, vocab] float32 of ``tokens`` [B, T] at
    ``positions`` [B, T] (default ``0..T-1``), dense causal attention, no KV
    cache. It shares every piece with the serving forward (the norms, rope,
    the FFN or :func:`moe_ffn`, the adapters and the LM head); its products
    widen int8 weights (:func:`qmm_widened`) and never launch the int8
    kernel. With a ``"lora"`` tree in ``params``, row b takes adapter
    ``adapter_ids[b]`` (default 0, the zero adapter). ``remat`` recomputes
    each layer in the backward (``torch.utils.checkpoint``) instead of
    keeping its activations: the same numbers, less memory."""
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device)[None, :]
    positions = positions.expand(b, t)
    lora = params.get("lora")
    if lora is not None and adapter_ids is None:
        adapter_ids = torch.zeros((b,), dtype=torch.long, device=tokens.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    h = params["embed"][tokens]
    for i in range(cfg.n_layers):
        lp = {name: _layer(w, i) for name, w in params["layers"].items()}
        args = (h, lp, layer_lora(lora, i), cfg, cos, sin, adapter_ids)
        h = (torch.utils.checkpoint.checkpoint(_train_layer, *args, use_reentrant=False)
             if remat else _train_layer(*args))
    return lm_head_logits(params, cfg, h)


# ------------------------------------------------------- tensor parallelism


def _embed_sharded(shards: list[Params], cfg: LlamaConfig, tokens: list,
                   mesh: Mesh) -> list[torch.Tensor]:
    """Vocab-split embedding: each shard looks up the tokens in its own rows
    (zeros for the others), and the shards' results are summed."""
    if param_splits(cfg, mesh)["embed"] is None:
        return replicate(shards[0]["embed"][tokens[0]], mesh)
    parts = []
    for rank, shard in enumerate(shards):
        emb = shard["embed"]
        local = tokens[rank] - rank * emb.shape[0]
        inside = (local >= 0) & (local < emb.shape[0])
        rows = emb[local.clamp(0, emb.shape[0] - 1)]
        parts.append(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                      device=rows.device)))
    return all_reduce_sum(parts, mesh)


def _lm_head_sharded(shards: list[Params], cfg: LlamaConfig, hidden: torch.Tensor,
                     mesh: Mesh) -> torch.Tensor:
    home = mesh.devices[0]
    hs = map_replicated(lambda h: rms_norm(h, shards[0]["final_norm"].to(h.device),
                                           cfg.norm_eps), replicate(hidden, mesh))
    split = param_splits(cfg, mesh)["embed" if cfg.tie_embeddings else "lm_head"]
    ranks = range(mesh.tp) if split is not None else range(1)
    parts = []
    for rank in ranks:
        head = shards[rank]["embed"].T if cfg.tie_embeddings else shards[rank]["lm_head"]
        parts.append((hs[rank] @ head).float())
    return all_gather(parts, dim=-1, device=home)


def _ffn_ranks(cfg: LlamaConfig, mesh: Mesh, split) -> tuple[list[int], list[int]]:
    """The ranks whose FFN parts the sum after the FFN adds, and the first
    expert each holds: every rank where the FFN splits over the combined
    axis, one rank a model group where the experts split over ``model``
    (the page shards of a group hold the same experts), else rank 0."""
    if split is None:
        return [0], [0]
    if split[1] == "tp":
        return list(range(mesh.tp)), [0] * mesh.tp
    groups = range(mesh.model)
    per = cfg.n_experts // mesh.model
    return [mesh.rank(m, 0) for m in groups], [m * per for m in groups]


def _forward_hidden_sharded(shards: list[Params], cfg: LlamaConfig,
                            tokens: torch.Tensor, positions: torch.Tensor,
                            kv_k: list, kv_v: list, page_tables: torch.Tensor,
                            ctx_lens: torch.Tensor, page_size: int,
                            mesh: Mesh, adapter_ids: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The forward on a ``model`` x ``seq`` mesh, one shard at a time inside
    the layer loop. Shard r (TP rank ``m * seq + s``) holds query heads
    ``[r, r + 1) * n_q / tp``, kv heads ``[m, m + 1) * n_kv / model`` and
    its own pool ``[L, tokens / seq, n_kv / model, hd]``. Written out are the
    collectives that XLA inserts from the shardings: the vocab-split
    embedding's sum, the sums of the row-parallel partial products after
    ``wo`` and ``w_down``, and the merge of the page shards' attention
    partials. MoE layers split the experts over ``model`` where
    ``param_splits`` does (expert parallelism): every shard routes all
    tokens with the whole router, one shard a model group runs the queues of
    its own experts, and the sum after the FFN adds their parts once;
    replicated experts run on rank 0 alone. Routing follows the JAX forward: page-split attention when
    ``seq`` > 1 (the partial kernels), else the decode and chunk kernels per
    head shard. With adapters (each shard's ``"lora"``, cut by
    ``shard_lora``), a shard adds its own columns of the wq/wk/wv deltas,
    and its rows of wo's A give it a partial of the wo delta that the sum
    after ``wo`` adds exactly once. Returns hidden [B, T, D] on rank 0's
    device."""
    check_mesh(cfg, mesh)
    splits = param_splits(cfg, mesh)
    b, t = tokens.shape
    hd, tp = cfg.head_dim, mesh.tp
    nql, nkvl = cfg.n_heads // tp, cfg.n_kv_heads // mesh.model
    tok, pos, tables, ctx = (replicate(x, mesh) for x in
                             (tokens, positions, page_tables, ctx_lens))
    ids = replicate(adapter_ids, mesh) if adapter_ids is not None else [None] * tp
    rope = map_replicated(
        lambda p: rope_cos_sin(p, hd, cfg.rope_theta, cfg.rope_scaling), pos)
    if mesh.seq > 1:
        # Each page shard keeps only the writes to its own pages; the rows
        # are the same in every layer.
        dests = [kv_split.split_destinations(
            pos[r], tables[r], page_size, mesh.coords(r)[1], kv_k[r].shape[1])
            for r in range(tp)]
    ffn_ranks, firsts = _ffn_ranks(cfg, mesh, splits["layers.w_down"])
    h = _embed_sharded(shards, cfg, tok, mesh)
    for i in range(cfg.n_layers):
        lps = [{name: _layer(w, i) for name, w in shard["layers"].items()}
               for shard in shards]
        lpls = [layer_lora(shard.get("lora"), i) for shard in shards]
        x = map_replicated(lambda a: rms_norm(a, lps[0]["attn_norm"].to(a.device),
                                              cfg.norm_eps), h)
        qs, k_pools, v_pools = [], [], []
        for r, lp in enumerate(lps):
            cos, sin = rope[r]
            q, k, v = qmm(x[r], lp["wq"]), qmm(x[r], lp["wk"]), qmm(x[r], lp["wv"])
            if lpls[r] is not None:
                q = with_lora(q, x[r], lpls[r], "wq", ids[r])
                k = with_lora(k, x[r], lpls[r], "wk", ids[r])
                v = with_lora(v, x[r], lpls[r], "wv", ids[r])
            if cfg.qkv_bias:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
            q = rotate(q.reshape(b, t, nql, hd), cos, sin)
            k = rotate(k.reshape(b, t, nkvl, hd), cos, sin)
            v = v.reshape(b, t, nkvl, hd)
            k_pool, v_pool = _layer(kv_k[r], i), _layer(kv_v[r], i)
            if mesh.seq > 1:
                kv_split.write_rows(k_pool, k, *dests[r])
                kv_split.write_rows(v_pool, v, *dests[r])
            else:
                write_kv_pages_batch(k_pool, k, pos[r], tables[r], page_size)
                write_kv_pages_batch(v_pool, v, pos[r], tables[r], page_size)
            qs.append(q)
            k_pools.append(k_pool)
            v_pools.append(v_pool)
        if mesh.seq > 1 and t == 1:
            attn = [a[:, None] for a in kv_split.paged_decode_attention_kv_split(
                mesh, [q[:, 0] for q in qs], k_pools, v_pools, tables, ctx, page_size)]
        elif mesh.seq > 1:
            attn = kv_split.paged_attention_kv_split(
                mesh, qs, k_pools, v_pools, tables, ctx, pos, page_size)
        elif t == 1:
            attn = [a[:, None] for a in paged_decode_attention_tp(
                [q[:, 0] for q in qs], k_pools, v_pools, tables, ctx, page_size)]
        else:
            attn = paged_chunk_attention_tp(qs, k_pools, v_pools, tables, ctx, pos,
                                            page_size)
        ctxs = [a.reshape(b, t, nql * hd) for a in attn]
        o = all_reduce_sum([with_lora(qmm(c, lp["wo"]), c, lpl, "wo", r_ids)
                            for c, lp, lpl, r_ids in zip(ctxs, lps, lpls, ids)], mesh)
        h = map_replicated(torch.add, h, o)
        y = map_replicated(lambda a: rms_norm(a, lps[0]["mlp_norm"].to(a.device),
                                              cfg.norm_eps), h)
        f = all_reduce_sum([ffn_block(y[r], lps[r], cfg, first)
                            for r, first in zip(ffn_ranks, firsts)], mesh)
        h = map_replicated(torch.add, h, f)
    return h[0]
