"""Hybrid retrieval: FTS5 + on-device vector search fused by RRF, plus the
retriever facade with incremental sync.

Parity targets: reference ``src/knowledge/retriever/hybrid-search.ts``
(``HybridRetriever`` :22; modes fts/vector/hybrid :54-100; Reciprocal Rank
Fusion :106 with k=60, weights FTS 0.4 / vector 0.6 :17-19; FTS-only fallback
when the embedder is unconfigured :67) and ``retriever/index.ts``
(``KnowledgeRetriever`` :24, ``sync`` :44 with lastSyncTime, ``search`` :85,
grouping into runbooks/postmortems/knownIssues/architecture). A copy of the
JAX package's ``knowledge/retriever.py``; ``create_retriever`` puts the vector
matrix and the encoder on ``device`` (the card unless the caller passes
``device="cpu"``). Hybrid search falls back to FTS alone when no vectors
exist, which is the reference's semantics (hybrid-search.ts:67), not a
device fallback.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Optional

from runbookai_tpu_torch.agent.types import KnowledgeResult, RetrievedKnowledge
from runbookai_tpu_torch.knowledge.chunker import document_from_markdown
from runbookai_tpu_torch.knowledge.store.sqlite_fts import KnowledgeStore
from runbookai_tpu_torch.knowledge.store.vector import VectorStore
from runbookai_tpu_torch.knowledge.types import SearchHit


def reciprocal_rank_fusion(
    ranked_lists: list[tuple[float, list[str]]], k: int = 60
) -> dict[str, float]:
    """RRF over (weight, [ids best-first]) lists (hybrid-search.ts:106)."""
    scores: dict[str, float] = {}
    for weight, ids in ranked_lists:
        for rank, item_id in enumerate(ids):
            scores[item_id] = scores.get(item_id, 0.0) + weight / (k + rank + 1)
    return scores


class HybridRetriever:
    def __init__(
        self,
        store: KnowledgeStore,
        vectors: Optional[VectorStore] = None,
        embedder: Optional[Any] = None,
        rrf_k: int = 60,
        fts_weight: float = 0.4,
        vector_weight: float = 0.6,
    ):
        self.store = store
        self.vectors = vectors
        self.embedder = embedder
        self.rrf_k = rrf_k
        self.fts_weight = fts_weight
        self.vector_weight = vector_weight

    def search(
        self,
        query: str,
        limit: int = 8,
        mode: str = "hybrid",
        knowledge_type: Optional[str] = None,
        service: Optional[str] = None,
    ) -> list[SearchHit]:
        has_vectors = (
            self.embedder is not None and self.vectors is not None
            and self.vectors.count() > 0
        )
        if mode == "hybrid" and not has_vectors:
            mode = "fts"  # fallback (hybrid-search.ts:67)

        fts_hits = self.store.search(query, limit=limit * 3,
                                     knowledge_type=knowledge_type, service=service)
        if mode == "fts":
            return fts_hits[:limit]

        qvec = self.embedder.embed_text(query, is_query=True)
        vec_pairs = self.vectors.search(qvec, limit=limit * 3)
        by_chunk: dict[str, SearchHit] = {h.chunk.chunk_id: h for h in fts_hits}
        # Materialize vector-only hits from the store.
        missing = [cid for cid, _ in vec_pairs if cid not in by_chunk]
        if missing:
            for hit in self._hits_for_chunk_ids(missing, knowledge_type, service):
                by_chunk[hit.chunk.chunk_id] = hit
        if mode == "vector":
            ordered = [cid for cid, _ in vec_pairs if cid in by_chunk]
            return [by_chunk[cid] for cid in ordered[:limit]]

        fused = reciprocal_rank_fusion(
            [
                (self.fts_weight, [h.chunk.chunk_id for h in fts_hits]),
                (self.vector_weight, [cid for cid, _ in vec_pairs]),
            ],
            k=self.rrf_k,
        )
        ranked = sorted(fused.items(), key=lambda kv: kv[1], reverse=True)
        out = []
        for cid, score in ranked:
            hit = by_chunk.get(cid)
            if hit is None:
                continue
            out.append(SearchHit(chunk=hit.chunk, doc=hit.doc, score=score, mode="hybrid"))
            if len(out) >= limit:
                break
        return out

    def _hits_for_chunk_ids(self, chunk_ids, knowledge_type, service) -> list[SearchHit]:
        hits = []
        for cid in chunk_ids:
            row = self.store.db.execute(
                "SELECT * FROM chunks WHERE chunk_id = ?", (cid,)
            ).fetchone()
            if row is None:
                continue
            doc = self.store.get_document(row["doc_id"])
            if doc is None:
                continue
            if knowledge_type and doc.knowledge_type != knowledge_type:
                continue
            if service and service not in doc.services:
                continue
            from runbookai_tpu_torch.knowledge.types import KnowledgeChunk

            chunk = KnowledgeChunk(
                chunk_id=row["chunk_id"], doc_id=row["doc_id"], content=row["content"],
                section=row["section"], chunk_type=row["chunk_type"],
                position=row["position"],
            )
            hits.append(SearchHit(chunk=chunk, doc=doc, score=0.0, mode="vector"))
        return hits


class KnowledgeRetriever:
    """Facade: sync sources → store (+embeddings); search → grouped results."""

    def __init__(self, store: KnowledgeStore, hybrid: HybridRetriever,
                 sources: Optional[list[Any]] = None):
        self.store = store
        self.hybrid = hybrid
        self.sources = sources or []

    # ------------------------------------------------------------------ sync

    def sync(self, force: bool = False) -> dict[str, int]:
        """Incremental sync of all sources; returns per-source doc counts."""
        counts: dict[str, int] = {}
        for source in self.sources:
            name = source.name
            last = None if force else self.store.get_last_sync_time(name)
            docs = source.load(since=last)
            for doc in docs:
                self.store.upsert_document(doc)
                if self.hybrid.embedder is not None and self.hybrid.vectors is not None:
                    texts = [c.content for c in doc.chunks]
                    if texts:
                        self.hybrid.vectors.delete_doc(doc.doc_id)
                        embs = self.hybrid.embedder.embed_texts(texts)
                        self.hybrid.vectors.store_many([
                            (c.chunk_id, doc.doc_id, embs[i])
                            for i, c in enumerate(doc.chunks)
                        ])
            self.store.set_last_sync_time(name)
            counts[name] = len(docs)
        return counts

    # ---------------------------------------------------------------- search

    async def retrieve(self, query: str, services: Optional[list[str]] = None) -> RetrievedKnowledge:
        """Async adapter the Agent consumes (grouped, reference types.ts:281)."""
        return self.search_grouped(query, service=services[0] if services else None)

    def search_grouped(self, query: str, limit: int = 8,
                       service: Optional[str] = None) -> RetrievedKnowledge:
        hits = self.hybrid.search(query, limit=limit, service=service)
        grouped = RetrievedKnowledge()
        buckets = {
            "runbook": grouped.runbooks,
            "procedure": grouped.runbooks,
            "troubleshooting": grouped.runbooks,
            "postmortem": grouped.postmortems,
            "known-issue": grouped.known_issues,
            "architecture": grouped.architecture,
        }
        for hit in hits:
            result = KnowledgeResult(
                doc_id=hit.doc.doc_id, title=hit.doc.title,
                knowledge_type=hit.doc.knowledge_type, content=hit.chunk.content,
                score=hit.score, services=hit.doc.services, source=hit.doc.source,
            )
            buckets.get(hit.doc.knowledge_type, grouped.architecture).append(result)
        return grouped

    def stats(self) -> dict[str, Any]:
        s = self.store.stats()
        if self.hybrid.vectors is not None:
            s["embeddings"] = self.hybrid.vectors.count()
        if self.hybrid.embedder is not None:
            s["embedder"] = dict(self.hybrid.embedder.stats)
        return s


class FilesystemSource:
    """Markdown tree loader (reference sources/filesystem.ts:22)."""

    def __init__(self, path: str | Path, name: str = "filesystem"):
        self.path = Path(path)
        self.name = name

    def load(self, since: Optional[float] = None) -> list[Any]:
        docs = []
        if not self.path.exists():
            return docs
        for file in sorted(self.path.rglob("*.md")):
            mtime = file.stat().st_mtime
            if since is not None and mtime <= since:
                continue
            doc = document_from_markdown(
                str(file.relative_to(self.path)), file.read_text(),
                source=self.name, default_title=file.stem,
            )
            doc.updated_at = mtime
            docs.append(doc)
        return docs


def create_retriever(config, embedder: Optional[Any] = None,
                     device="cuda") -> KnowledgeRetriever:
    """Build the full stack from a Config (reference retriever/index.ts:170),
    its vector matrix and encoder on ``device``. The sources are built first,
    so that an unported one raises before anything is loaded."""
    from runbookai_tpu_torch.knowledge.sources import build_source
    from runbookai_tpu_torch.model.torch_cuda import resolve_device

    kcfg = config.knowledge
    sources = [s for s in (build_source(src) for src in kcfg.sources)
               if s is not None]
    device = resolve_device(device)
    store = KnowledgeStore(kcfg.db_path)
    vectors = VectorStore(store.db, device=device)
    if embedder is None and kcfg.embedder.enabled:
        from runbookai_tpu_torch.knowledge.embedder import Embedder

        embedder = Embedder.from_config(kcfg.embedder, device=device)
    hybrid = HybridRetriever(
        store, vectors=vectors, embedder=embedder,
        rrf_k=kcfg.rrf_k, fts_weight=kcfg.fts_weight, vector_weight=kcfg.vector_weight,
    )
    return KnowledgeRetriever(store, hybrid, sources=sources)
