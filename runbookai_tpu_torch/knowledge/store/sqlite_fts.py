"""SQLite knowledge store with FTS5 full-text search.

Parity target: reference ``src/knowledge/store/sqlite.ts`` (``KnowledgeStore``
:11; schema :19-71 — documents + chunks tables, FTS5 virtual table kept in sync
by triggers; ``search`` :125). The reference uses better-sqlite3 (native C++
bindings); Python's stdlib ``sqlite3`` links the same C library — the FTS5
index and trigger discipline are identical. Embeddings live in a sibling table
(see ``vector.py``) so vector rows share chunk ids with FTS rows.
"""

from __future__ import annotations

import json
import sqlite3
import time
from pathlib import Path
from typing import Any, Optional

from runbookai_tpu_torch.knowledge.types import (
    KnowledgeChunk,
    KnowledgeDocument,
    SearchHit,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    doc_id TEXT PRIMARY KEY,
    title TEXT NOT NULL,
    content TEXT NOT NULL,
    knowledge_type TEXT NOT NULL DEFAULT 'reference',
    source TEXT NOT NULL DEFAULT 'filesystem',
    source_ref TEXT NOT NULL DEFAULT '',
    services TEXT NOT NULL DEFAULT '[]',
    symptoms TEXT NOT NULL DEFAULT '[]',
    severity TEXT,
    tags TEXT NOT NULL DEFAULT '[]',
    updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS chunks (
    chunk_id TEXT PRIMARY KEY,
    doc_id TEXT NOT NULL REFERENCES documents(doc_id) ON DELETE CASCADE,
    content TEXT NOT NULL,
    section TEXT NOT NULL DEFAULT '',
    chunk_type TEXT NOT NULL DEFAULT 'text',
    position INTEGER NOT NULL DEFAULT 0
);

CREATE INDEX IF NOT EXISTS idx_chunks_doc ON chunks(doc_id);

CREATE VIRTUAL TABLE IF NOT EXISTS chunks_fts USING fts5(
    content, section,
    content=chunks, content_rowid=rowid
);

CREATE TRIGGER IF NOT EXISTS chunks_ai AFTER INSERT ON chunks BEGIN
    INSERT INTO chunks_fts(rowid, content, section)
    VALUES (new.rowid, new.content, new.section);
END;
CREATE TRIGGER IF NOT EXISTS chunks_ad AFTER DELETE ON chunks BEGIN
    INSERT INTO chunks_fts(chunks_fts, rowid, content, section)
    VALUES ('delete', old.rowid, old.content, old.section);
END;
CREATE TRIGGER IF NOT EXISTS chunks_au AFTER UPDATE ON chunks BEGIN
    INSERT INTO chunks_fts(chunks_fts, rowid, content, section)
    VALUES ('delete', old.rowid, old.content, old.section);
    INSERT INTO chunks_fts(rowid, content, section)
    VALUES (new.rowid, new.content, new.section);
END;

CREATE TABLE IF NOT EXISTS sync_state (
    source TEXT PRIMARY KEY,
    last_sync_time REAL NOT NULL
);
"""


class KnowledgeStore:
    def __init__(self, db_path: str | Path = ":memory:"):
        if db_path != ":memory:":
            Path(db_path).parent.mkdir(parents=True, exist_ok=True)
        self.db = sqlite3.connect(str(db_path))
        self.db.row_factory = sqlite3.Row
        self.db.execute("PRAGMA foreign_keys = ON")
        self.db.executescript(_SCHEMA)

    # ------------------------------------------------------------------ CRUD

    def upsert_document(self, doc: KnowledgeDocument) -> None:
        with self.db:
            self.db.execute("DELETE FROM chunks WHERE doc_id = ?", (doc.doc_id,))
            self.db.execute(
                """INSERT INTO documents (doc_id, title, content, knowledge_type,
                        source, source_ref, services, symptoms, severity, tags, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)
                   ON CONFLICT(doc_id) DO UPDATE SET
                        title=excluded.title, content=excluded.content,
                        knowledge_type=excluded.knowledge_type, source=excluded.source,
                        source_ref=excluded.source_ref, services=excluded.services,
                        symptoms=excluded.symptoms, severity=excluded.severity,
                        tags=excluded.tags, updated_at=excluded.updated_at""",
                (doc.doc_id, doc.title, doc.content, doc.knowledge_type, doc.source,
                 doc.source_ref, json.dumps(doc.services), json.dumps(doc.symptoms),
                 doc.severity, json.dumps(doc.tags), doc.updated_at),
            )
            for chunk in doc.chunks:
                self.db.execute(
                    """INSERT INTO chunks (chunk_id, doc_id, content, section,
                            chunk_type, position) VALUES (?, ?, ?, ?, ?, ?)""",
                    (chunk.chunk_id, chunk.doc_id, chunk.content, chunk.section,
                     chunk.chunk_type, chunk.position),
                )

    def delete_document(self, doc_id: str) -> None:
        with self.db:
            self.db.execute("DELETE FROM chunks WHERE doc_id = ?", (doc_id,))
            self.db.execute("DELETE FROM documents WHERE doc_id = ?", (doc_id,))

    def get_document(self, doc_id: str) -> Optional[KnowledgeDocument]:
        row = self.db.execute("SELECT * FROM documents WHERE doc_id = ?", (doc_id,)).fetchone()
        return self._doc_from_row(row) if row else None

    def _doc_from_row(self, row: sqlite3.Row) -> KnowledgeDocument:
        return KnowledgeDocument(
            doc_id=row["doc_id"], title=row["title"], content=row["content"],
            knowledge_type=row["knowledge_type"], source=row["source"],
            source_ref=row["source_ref"], services=json.loads(row["services"]),
            symptoms=json.loads(row["symptoms"]), severity=row["severity"],
            tags=json.loads(row["tags"]), updated_at=row["updated_at"],
        )

    def all_chunks(self) -> list[KnowledgeChunk]:
        rows = self.db.execute("SELECT * FROM chunks ORDER BY doc_id, position").fetchall()
        return [KnowledgeChunk(
            chunk_id=r["chunk_id"], doc_id=r["doc_id"], content=r["content"],
            section=r["section"], chunk_type=r["chunk_type"], position=r["position"],
        ) for r in rows]

    def stats(self) -> dict[str, Any]:
        docs = self.db.execute("SELECT COUNT(*) c FROM documents").fetchone()["c"]
        chunks = self.db.execute("SELECT COUNT(*) c FROM chunks").fetchone()["c"]
        by_type = {
            r["knowledge_type"]: r["c"]
            for r in self.db.execute(
                "SELECT knowledge_type, COUNT(*) c FROM documents GROUP BY 1")
        }
        return {"documents": docs, "chunks": chunks, "by_type": by_type}

    # ------------------------------------------------------------------ sync

    def get_last_sync_time(self, source: str) -> Optional[float]:
        row = self.db.execute(
            "SELECT last_sync_time FROM sync_state WHERE source = ?", (source,)
        ).fetchone()
        return row["last_sync_time"] if row else None

    def set_last_sync_time(self, source: str, ts: Optional[float] = None) -> None:
        with self.db:
            self.db.execute(
                """INSERT INTO sync_state (source, last_sync_time) VALUES (?, ?)
                   ON CONFLICT(source) DO UPDATE SET last_sync_time=excluded.last_sync_time""",
                (source, ts if ts is not None else time.time()),
            )

    # ---------------------------------------------------------------- search

    @staticmethod
    def _fts_query(query: str) -> str:
        """Sanitize a natural-language query into FTS5 OR-term syntax."""
        terms = [t for t in "".join(
            c if c.isalnum() or c in "-_" else " " for c in query
        ).split() if len(t) > 1]
        return " OR ".join(f'"{t}"' for t in terms[:16]) or '""'

    def search(
        self,
        query: str,
        limit: int = 10,
        knowledge_type: Optional[str] = None,
        service: Optional[str] = None,
    ) -> list[SearchHit]:
        sql = """
            SELECT c.chunk_id, c.doc_id, c.content AS chunk_content, c.section,
                   c.chunk_type, c.position,
                   d.title, d.content, d.knowledge_type, d.source, d.source_ref,
                   d.services, d.symptoms, d.severity, d.tags, d.updated_at,
                   bm25(chunks_fts) AS rank
            FROM chunks_fts f
            JOIN chunks c ON c.rowid = f.rowid
            JOIN documents d ON d.doc_id = c.doc_id
            WHERE chunks_fts MATCH ?
        """
        params: list[Any] = [self._fts_query(query)]
        if knowledge_type:
            sql += " AND d.knowledge_type = ?"
            params.append(knowledge_type)
        if service:
            sql += " AND d.services LIKE ?"
            params.append(f'%"{service}"%')
        sql += " ORDER BY rank LIMIT ?"
        params.append(limit)
        hits = []
        for r in self.db.execute(sql, params).fetchall():
            chunk = KnowledgeChunk(
                chunk_id=r["chunk_id"], doc_id=r["doc_id"], content=r["chunk_content"],
                section=r["section"], chunk_type=r["chunk_type"], position=r["position"],
            )
            doc = self._doc_from_row(r)
            # bm25 rank: lower is better; convert to a positive score.
            hits.append(SearchHit(chunk=chunk, doc=doc, score=-float(r["rank"]), mode="fts"))
        return hits

    def close(self) -> None:
        self.db.close()
