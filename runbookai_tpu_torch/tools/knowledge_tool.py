"""search_knowledge tool (reference ``src/tools/registry.ts:790``)."""

from __future__ import annotations

from runbookai_tpu_torch.tools.registry import ToolRegistry, object_schema


def register(reg: ToolRegistry, retriever) -> None:
    async def search_knowledge(args):
        hits = retriever.hybrid.search(
            str(args.get("query", "")),
            limit=int(args.get("limit", 6)),
            knowledge_type=args.get("type"),
            service=args.get("service"),
        )
        return {
            "results": [
                {
                    "doc_id": h.doc.doc_id,
                    "title": h.doc.title,
                    "type": h.doc.knowledge_type,
                    "section": h.chunk.section,
                    "content": h.chunk.content[:1200],
                    "score": round(h.score, 4),
                    "services": h.doc.services,
                }
                for h in hits
            ]
        }

    reg.define(
        "search_knowledge",
        "Search the knowledge base (runbooks, postmortems, known issues, "
        "architecture docs). Optional filters: type, service.",
        object_schema(
            {"query": {"type": "string"}, "type": {"type": "string"},
             "service": {"type": "string"}, "limit": {"type": "number"}},
            ["query"],
        ),
        search_knowledge, category="knowledge",
    )
