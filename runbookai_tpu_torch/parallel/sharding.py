"""Megatron-style tensor-parallel slices of the Llama params and the KV pool.

The counterpart of ``runbookai_tpu/parallel/sharding.py``. Where the JAX
package annotates each leaf with a ``NamedSharding`` and lets XLA place the
slices and insert the collectives, :func:`shard_params` cuts one param dict
per shard, holding the slices that ``param_shardings`` gives that device:

- ``wq``, ``w_gate``, ``w_up`` (and ``bq``): column-split over the combined
  TP axis (model-major ``(model, seq)`` when ``seq`` > 1, else ``model``);
- ``wo``, ``w_down``: row-split over the combined axis;
- ``wk``, ``wv`` (and ``bk``, ``bv``): column-split over ``model`` only,
  since every page shard of a kv group needs that group's K/V projections;
- MoE experts ``[L, E, in, out]``: the expert axis over ``model`` when E
  divides by the full tp (expert parallelism), else replicated; the router
  replicated;
- ``embed`` and ``lm_head``: split over the vocabulary;
- norms replicated; a leaf whose split axis does not divide by its shard
  count is replicated, as the JAX rules replicate it.

:func:`kv_pool_shard_shape` gives each shard's ``[L, tokens, n_kv, hd]``
pool as ``kv_pool_sharding`` places it: kv heads over ``model``, tokens over
``seq``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from runbookai_tpu_torch.parallel.mesh import Mesh

# leaf -> (split dim, "tp" | "model"), or None for a replicated leaf.
Split = Optional[tuple[int, str]]


def param_splits(cfg, mesh: Mesh) -> dict[str, Split]:
    """How each leaf is cut: keys are top-level names and ``layers.<name>``."""
    tp, kv_sh = mesh.tp, mesh.model
    vocab_ok = cfg.vocab_size % tp == 0
    heads_ok = cfg.n_heads % tp == 0
    ffn_ok = cfg.ffn_dim % tp == 0
    kv_ok = cfg.n_kv_heads % kv_sh == 0
    splits: dict[str, Split] = {
        "embed": (0, "tp") if vocab_ok else None,
        "final_norm": None,
        "layers.wq": (2, "tp") if heads_ok else None,
        "layers.wk": (2, "model") if kv_ok else None,
        "layers.wv": (2, "model") if kv_ok else None,
        "layers.wo": (1, "tp") if heads_ok else None,
        "layers.w_gate": (2, "tp") if ffn_ok else None,
        "layers.w_up": (2, "tp") if ffn_ok else None,
        "layers.w_down": (1, "tp") if ffn_ok else None,
        "layers.attn_norm": None,
        "layers.mlp_norm": None,
    }
    if cfg.n_experts:
        # Expert parallelism: the FFN leaves [L, E, in, out] split their
        # expert axis over ``model`` when E divides by the full tp, as the
        # JAX rule does (else every shard holds every expert); the router
        # replicates.
        ep = (1, "model") if cfg.n_experts % tp == 0 else None
        splits.update({"layers.w_gate": ep, "layers.w_up": ep, "layers.w_down": ep,
                       "layers.router": None})
    if cfg.qkv_bias:
        splits["layers.bq"] = (1, "tp") if heads_ok else None
        splits["layers.bk"] = (1, "model") if kv_ok else None
        splits["layers.bv"] = (1, "model") if kv_ok else None
    if not cfg.tie_embeddings:
        splits["lm_head"] = (1, "tp") if vocab_ok else None
    return splits


def check_mesh(cfg, mesh: Mesh) -> None:
    """The tensor-parallel forward splits attention by heads: the query heads
    over every shard, the kv heads over ``model``, and on a page-split mesh
    each kv group's query heads over ``seq`` (``plan_kv_split`` only makes
    such meshes)."""
    if cfg.n_heads % mesh.tp or cfg.n_kv_heads % mesh.model:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} query / {cfg.n_kv_heads} kv "
                         f"heads do not split over model={mesh.model} x "
                         f"seq={mesh.seq}; plan the mesh with plan_kv_split")
    if (cfg.n_heads // cfg.n_kv_heads) % mesh.seq:
        raise ValueError(f"{cfg.name}: GQA group {cfg.n_heads // cfg.n_kv_heads} "
                         f"does not split over seq={mesh.seq}")


def _chunk(split: Split, mesh: Mesh, rank: int) -> tuple[int, int]:
    """(index, count) of the slice that TP rank ``rank`` holds."""
    if split is None:
        return 0, 1
    m, _ = mesh.coords(rank)
    return (rank, mesh.tp) if split[1] == "tp" else (m, mesh.model)


def _cut(leaf: torch.Tensor, split: Split, mesh: Mesh) -> list[torch.Tensor]:
    """One contiguous copy per shard on its device; shards on one device
    that hold the same slice share it."""
    made: dict[tuple, torch.Tensor] = {}
    out = []
    for rank, dev in enumerate(mesh.devices):
        idx, count = _chunk(split, mesh, rank)
        key = (idx, dev)
        if key not in made:
            part = leaf
            if split is not None:
                size = leaf.shape[split[0]] // count
                part = leaf.narrow(split[0], idx * size, size)
            made[key] = torch.empty(part.shape, dtype=part.dtype,
                                    device=dev).copy_(part)
        out.append(made[key])
    return out


def shard_params(params: dict, cfg, mesh: Mesh) -> list[dict]:
    """One param dict per TP rank. CONSUMES ``params``: each leaf is dropped
    from it as soon as it is cut, so the full model and its shards are never
    held together; pass a copy of the dicts to keep the full params."""
    splits = param_splits(cfg, mesh)
    shards: list[dict[str, Any]] = [{"layers": {}} for _ in mesh.devices]
    layers = params.get("layers", {})
    for name in list(layers):
        parts = _cut(layers.pop(name), splits[f"layers.{name}"], mesh)
        for shard, part in zip(shards, parts):
            shard["layers"][name] = part
    for name in [n for n in params if n != "layers"]:
        parts = _cut(params.pop(name), splits[name], mesh)
        for shard, part in zip(shards, parts):
            shard[name] = part
    params.pop("layers", None)
    return shards


# A stacked LoRA leaf's A [L, N, in, r] and B [L, N, r, out] cut as the base
# matrix it adds to: the column-split targets split B's columns, wo (row-split)
# splits A's rows; the other factor is whole on every shard.
_LORA_SPLITS = {"wq": ("B", 3, "tp"), "wk": ("B", 3, "model"), "wv": ("B", 3, "model"),
                "wo": ("A", 2, "tp")}


def shard_lora(tree: dict, cfg, mesh: Mesh) -> list[dict]:
    """One stacked adapter tree (``models/lora.py``) per TP rank, on its
    device: each shard's wq/wk/wv deltas give its own columns, and its rows
    of wo's A a partial of the wo delta, which the forward's sum after
    ``wo`` adds once. Does not consume ``tree``."""
    splits = param_splits(cfg, mesh)
    shards: list[dict] = [{} for _ in mesh.devices]
    for leaf, ab in tree.items():
        which, dim, axis = _LORA_SPLITS[leaf]
        if splits[f"layers.{leaf}"] is None:
            which = None  # the base matrix is whole on every shard
        for name, w in ab.items():
            split = (dim, axis) if name == which else None
            for shard, part in zip(shards, _cut(w, split, mesh)):
                shard.setdefault(leaf, {})[name] = part
    return shards


def kv_pool_shard_shape(n_layers: int, num_pages: int, page_size: int,
                        n_kv_heads: int, head_dim: int,
                        mesh: Mesh) -> tuple[int, int, int, int]:
    """Each shard's ``[L, tokens, n_kv, hd]`` pool: kv heads over ``model``,
    the token axis over ``seq`` in blocks of whole pages (shard s owns
    global pages ``[s * num_pages / seq, (s + 1) * num_pages / seq)``)."""
    if n_kv_heads % mesh.model:
        raise ValueError(
            f"n_kv_heads={n_kv_heads} not divisible by the mesh model axis "
            f"({mesh.model}); factor the extra parallelism onto the seq axis "
            f"via parallel.kv_split.plan_kv_split")
    if num_pages % mesh.seq:
        # A page straddling the shard boundary would be mis-owned.
        raise ValueError(f"num_pages={num_pages} must divide by "
                         f"pg_shards={mesh.seq}")
    return (n_layers, num_pages // mesh.seq * page_size, n_kv_heads // mesh.model,
            head_dim)
