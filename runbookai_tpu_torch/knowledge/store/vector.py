"""Vector store: embeddings in SQLite, similarity search as one matmul on the card.

A port of the JAX package's ``knowledge/store/vector.py``. Parity target:
reference ``src/knowledge/store/vector-store.ts`` (:24; its ``search``
:188-211 is an O(N) JavaScript cosine loop). Here the normalised corpus
matrix is held on ``device`` as a torch tensor and a query is a single
``[N, D] @ [D]`` matmul there; the top-k of its N scores is chosen on the
host as the JAX package chooses it. The table is the JAX package's, so one
``knowledge.db`` serves both.
"""

from __future__ import annotations

import sqlite3
from typing import Optional

import numpy as np
import torch

_SCHEMA = """
CREATE TABLE IF NOT EXISTS embeddings (
    chunk_id TEXT PRIMARY KEY,
    doc_id TEXT NOT NULL,
    dim INTEGER NOT NULL,
    vector BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_emb_doc ON embeddings(doc_id);
"""


class VectorStore:
    def __init__(self, db: sqlite3.Connection, device="cuda"):
        self.db = db
        self.db.executescript(_SCHEMA)
        self.device = torch.device(device)
        self._matrix: Optional[torch.Tensor] = None  # [N, D] float32 normalized, on device
        self._ids: list[str] = []

    def store(self, chunk_id: str, doc_id: str, vector: np.ndarray) -> None:
        vec = np.asarray(vector, dtype=np.float32)
        with self.db:
            self.db.execute(
                """INSERT INTO embeddings (chunk_id, doc_id, dim, vector)
                   VALUES (?, ?, ?, ?)
                   ON CONFLICT(chunk_id) DO UPDATE SET
                       doc_id=excluded.doc_id, dim=excluded.dim, vector=excluded.vector""",
                (chunk_id, doc_id, vec.shape[0], vec.tobytes()),
            )
        self._invalidate()

    def store_many(self, rows: list[tuple[str, str, np.ndarray]]) -> None:
        with self.db:
            self.db.executemany(
                """INSERT INTO embeddings (chunk_id, doc_id, dim, vector)
                   VALUES (?, ?, ?, ?)
                   ON CONFLICT(chunk_id) DO UPDATE SET
                       doc_id=excluded.doc_id, dim=excluded.dim, vector=excluded.vector""",
                [(cid, did, np.asarray(v, np.float32).shape[0],
                  np.asarray(v, np.float32).tobytes()) for cid, did, v in rows],
            )
        self._invalidate()

    def delete_doc(self, doc_id: str) -> None:
        with self.db:
            self.db.execute("DELETE FROM embeddings WHERE doc_id = ?", (doc_id,))
        self._invalidate()

    def count(self) -> int:
        return self.db.execute("SELECT COUNT(*) FROM embeddings").fetchone()[0]

    def _invalidate(self) -> None:
        self._matrix = None

    def _load_matrix(self) -> None:
        rows = self.db.execute(
            "SELECT chunk_id, dim, vector FROM embeddings ORDER BY chunk_id"
        ).fetchall()
        self._ids = [r[0] for r in rows]
        if not rows:
            self._matrix = torch.zeros((0, 1), dtype=torch.float32, device=self.device)
            return
        mat = np.stack([
            np.frombuffer(r[2], dtype=np.float32, count=r[1]) for r in rows
        ])
        norms = np.linalg.norm(mat, axis=1, keepdims=True)
        self._matrix = torch.from_numpy(mat / np.maximum(norms, 1e-9)).to(self.device)

    def search(self, query_vec: np.ndarray, limit: int = 10) -> list[tuple[str, float]]:
        """Top-k (chunk_id, cosine): one matmul on ``device``."""
        if self._matrix is None:
            self._load_matrix()
        if len(self._ids) == 0:
            return []
        q = np.asarray(query_vec, np.float32)
        q = q / max(float(np.linalg.norm(q)), 1e-9)
        scores = (self._matrix @ torch.from_numpy(q).to(self.device)).cpu().numpy()
        k = min(limit, len(scores))
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        return [(self._ids[i], float(scores[i])) for i in top]
