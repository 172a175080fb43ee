"""Knowledge context manager: compact doc index in the system prompt.

Parity target: reference ``src/agent/knowledge-context.ts`` (:106) — maintains
a compact index of available runbooks / known issues for the system prompt and
re-queries when new services/symptoms appear mid-investigation.
"""

from __future__ import annotations

from typing import Optional

from runbookai_tpu_torch.agent.types import RetrievedKnowledge


class KnowledgeContextManager:
    def __init__(self, retriever, max_index_entries: int = 12):
        self.retriever = retriever
        self.max_entries = max_index_entries
        self._seen_terms: set[str] = set()
        self._index: dict[str, str] = {}  # doc_id -> "title (type)"

    async def prime(self, query: str) -> RetrievedKnowledge:
        knowledge = await self.retriever.retrieve(query)
        self.absorb(knowledge, query=query)
        return knowledge

    def absorb(self, knowledge: RetrievedKnowledge,
               query: str = "") -> None:
        """Fold an already-retrieved result into the index — callers that
        retrieved themselves (Agent.run does, for the prompt block) use
        this instead of :meth:`prime`, so the search isn't run twice."""
        self._absorb(knowledge)
        if query:
            self._seen_terms.update(query.lower().split())

    def _absorb(self, knowledge: RetrievedKnowledge) -> None:
        for item in knowledge.all():
            if len(self._index) >= self.max_entries:
                break
            self._index.setdefault(
                item.doc_id, f"{item.title} ({item.knowledge_type})")

    async def observe_terms(self, terms: list[str]) -> Optional[RetrievedKnowledge]:
        """Re-query when genuinely new services/symptoms appear."""
        new = [t for t in terms if t and t.lower() not in self._seen_terms]
        if not new:
            return None
        self._seen_terms.update(t.lower() for t in new)
        knowledge = await self.retriever.retrieve(" ".join(new))
        if knowledge.empty:
            return None
        self._absorb(knowledge)
        return knowledge

    def system_prompt_block(self) -> str:
        if not self._index:
            return ""
        lines = ["# Available knowledge (cite as [doc-id])"]
        for doc_id, label in self._index.items():
            lines.append(f"- [{doc_id}] {label}")
        lines.append(
            "Use search_knowledge for details on any of these before "
            "querying live infrastructure for procedural questions.")
        return "\n".join(lines)
