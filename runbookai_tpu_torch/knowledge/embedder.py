"""The knowledge embedder: batched bge encode on the card with caching.

A port of the JAX package's ``knowledge/embedder.py``. Parity target:
reference ``src/knowledge/indexer/embedder.ts`` — the exact API to
reimplement (:57-163): ``embed_text`` (single), ``embed_texts`` (batched
with md5 in-memory cache :49), ``cosine_similarity`` (:168), cost estimation
(:261 — becomes token counts; there is no per-token dollar cost on-device).

Batches are padded to the JAX package's power-of-two length buckets, so both
packages encode the same padded batches. The encoder
(:class:`~runbookai_tpu_torch.models.bge.BertEncoder`) runs on ``device``:
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from runbookai_tpu_torch.utils.tokens import load_tokenizer


class Embedder:
    def __init__(
        self,
        model_name: str = "bge-test",
        model_path: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        max_length: int = 512,
        batch_size: int = 64,
        query_instruction: str = "Represent this sentence for searching relevant passages: ",
        cache_max_entries: int = 4096,
        device="cuda",
    ):
        from runbookai_tpu_torch.model.torch_cuda import resolve_device
        from runbookai_tpu_torch.models import bge

        self.device = resolve_device(device)
        cfg, params = bge.load_or_init(model_name, model_path, device=self.device)
        self.cfg = cfg
        self.encoder = bge.BertEncoder(cfg, params)
        self.tokenizer = load_tokenizer(tokenizer_path or model_path)
        self.max_length = min(max_length, self.cfg.max_positions)
        self.batch_size = batch_size
        self.query_instruction = query_instruction
        self.dim = self.cfg.dim
        # LRU-bounded md5→embedding cache: a days-long process indexing
        # rolling docs must not grow this dict forever.
        # ~dim*4 bytes/entry → the default cap holds ~12 MB for bge-base.
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._cache_max = max(0, cache_max_entries)
        self.stats = {"texts": 0, "tokens": 0, "cache_hits": 0, "batches": 0,
                      "cache_evictions": 0}

    @classmethod
    def from_config(cls, emb_cfg, device="cuda") -> "Embedder":
        """One place maps EmbedderConfig fields to kwargs."""
        return cls(model_name=emb_cfg.model, model_path=emb_cfg.model_path,
                   max_length=emb_cfg.max_length,
                   batch_size=emb_cfg.batch_size,
                   cache_max_entries=getattr(emb_cfg, "cache_max_entries",
                                             4096),
                   device=device)

    @staticmethod
    def _key(text: str) -> str:
        return hashlib.md5(text.encode()).hexdigest()

    def _bucket_len(self, longest: int) -> int:
        """Round up to a power-of-two bucket (the JAX package bounds its
        compilations with it)."""
        n = 16
        while n < longest and n < self.max_length:
            n *= 2
        return min(n, self.max_length)

    def _tokenize(self, text: str) -> list[int]:
        ids = self.tokenizer.encode(text)[: self.max_length - 2]
        # CLS/BOS ... SEP/EOS framing; byte fallback uses bos/eos ids.
        cls = getattr(self.tokenizer, "bos_id", None) or 0
        sep = getattr(self.tokenizer, "eos_id", None) or 0
        return [cls, *ids, sep]

    def embed_texts(self, texts: list[str], is_query: bool = False) -> np.ndarray:
        """Batched embed with cache; returns [N, dim] float32 (L2-normalized)."""
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        pending: list[tuple[int, list[int]]] = []
        for i, text in enumerate(texts):
            rendered = (self.query_instruction + text) if is_query else text
            key = self._key(("q:" if is_query else "d:") + rendered)
            cached = self._cache.get(key)
            if cached is not None:
                self._cache.move_to_end(key)  # LRU recency
                out[i] = cached
                self.stats["cache_hits"] += 1
            else:
                pending.append((i, self._tokenize(rendered)))

        for start in range(0, len(pending), self.batch_size):
            batch = pending[start : start + self.batch_size]
            longest = max(len(ids) for _, ids in batch)
            pad_to = self._bucket_len(longest)
            pad_id = getattr(self.tokenizer, "pad_id", 0) % self.cfg.vocab_size
            tokens = np.full((len(batch), pad_to), pad_id, dtype=np.int64)
            mask = np.zeros((len(batch), pad_to), dtype=np.int64)
            for row, (_, ids) in enumerate(batch):
                ids = [t % self.cfg.vocab_size for t in ids[:pad_to]]
                tokens[row, : len(ids)] = ids
                mask[row, : len(ids)] = 1
                self.stats["tokens"] += len(ids)
            embs = self.encoder.encode(torch.from_numpy(tokens).to(self.device),
                                       torch.from_numpy(mask).to(self.device)).cpu().numpy()
            for row, (i, _) in enumerate(batch):
                out[i] = embs[row]
            self.stats["batches"] += 1

        # Fill cache after computing, evicting least-recently-used entries
        # past the cap (a duplicate within `texts` refreshes recency only).
        for i, text in enumerate(texts):
            rendered = (self.query_instruction + text) if is_query else text
            key = self._key(("q:" if is_query else "d:") + rendered)
            if key in self._cache:
                self._cache.move_to_end(key)
            elif self._cache_max:
                # Copy, don't view: out[i] aliases the whole [N, dim]
                # batch array — a cached view would pin the full batch in
                # memory (defeating the cap) and share mutable memory
                # with the caller's returned rows.
                self._cache[key] = out[i].copy()
                while len(self._cache) > self._cache_max:
                    self._cache.popitem(last=False)
                    self.stats["cache_evictions"] += 1
        self.stats["texts"] += len(texts)
        return out

    def embed_text(self, text: str, is_query: bool = False) -> np.ndarray:
        return self.embed_texts([text], is_query=is_query)[0]

    def estimate_tokens(self, texts: list[str]) -> int:
        """Reference cost estimation analogue: token counts (no dollar cost
        for an in-tree encoder)."""
        return sum(len(self._tokenize(t)) for t in texts)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    denom = float(np.linalg.norm(a) * np.linalg.norm(b)) or 1e-9
    return float(np.dot(a, b) / denom)
