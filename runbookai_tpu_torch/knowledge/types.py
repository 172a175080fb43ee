"""Knowledge domain types.

Parity target: reference ``src/knowledge/types.ts`` — ``KnowledgeDocument`` /
``KnowledgeChunk`` (:30-71), 8 knowledge types (:8-16), source types and
per-source configs (:83-120).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Optional

KNOWLEDGE_TYPES = (
    "runbook", "postmortem", "known-issue", "architecture", "troubleshooting",
    "procedure", "faq", "reference",
)

CHUNK_TYPES = ("procedure", "context", "command", "table", "list", "text")


@dataclass
class KnowledgeChunk:
    chunk_id: str
    doc_id: str
    content: str
    section: str = ""
    chunk_type: str = "text"
    position: int = 0


@dataclass
class KnowledgeDocument:
    doc_id: str
    title: str
    content: str
    knowledge_type: str = "reference"
    source: str = "filesystem"
    source_ref: str = ""  # path / page id / file id
    services: list[str] = field(default_factory=list)
    symptoms: list[str] = field(default_factory=list)
    severity: Optional[str] = None
    tags: list[str] = field(default_factory=list)
    updated_at: float = field(default_factory=time.time)
    chunks: list[KnowledgeChunk] = field(default_factory=list)

    @staticmethod
    def make_id(source: str, source_ref: str) -> str:
        return hashlib.md5(f"{source}:{source_ref}".encode()).hexdigest()[:16]


@dataclass
class SearchHit:
    chunk: KnowledgeChunk
    doc: KnowledgeDocument
    score: float
    mode: str = "fts"  # fts | vector | hybrid
