"""Markdown-aware chunking with frontmatter metadata.

Parity target: reference ``src/knowledge/sources/filesystem.ts`` (:22) —
gray-matter frontmatter (type, services, symptoms, severity; README.md:431-451)
and markdown section chunking with chunk-type inference (procedure / context /
command / ...).
"""

from __future__ import annotations

import re
from typing import Any

import yaml

from runbookai_tpu_torch.knowledge.types import KnowledgeChunk, KnowledgeDocument

_FRONTMATTER_RE = re.compile(r"\A---\s*\n(.*?)\n---\s*\n", re.DOTALL)
_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$", re.MULTILINE)


def parse_frontmatter(text: str) -> tuple[dict[str, Any], str]:
    m = _FRONTMATTER_RE.match(text)
    if not m:
        return {}, text
    try:
        meta = yaml.safe_load(m.group(1)) or {}
    except yaml.YAMLError:
        meta = {}
    return (meta if isinstance(meta, dict) else {}), text[m.end():]


def infer_chunk_type(content: str, section: str) -> str:
    body = content.strip()
    section_low = section.lower()
    numbered = len(re.findall(r"^\s*\d+[.)]\s", body, re.MULTILINE))
    if numbered >= 2 or any(w in section_low for w in ("procedure", "steps", "mitigation", "remediation")):
        return "procedure"
    if body.count("```") >= 2 or re.search(r"^\s*\$\s", body, re.MULTILINE):
        return "command"
    if re.search(r"^\|.*\|", body, re.MULTILINE):
        return "table"
    if len(re.findall(r"^\s*[-*]\s", body, re.MULTILINE)) >= 3:
        return "list"
    if any(w in section_low for w in ("background", "context", "overview", "architecture")):
        return "context"
    return "text"


def chunk_markdown(doc_id: str, text: str, max_chunk_chars: int = 2400) -> list[KnowledgeChunk]:
    """Split on headings; oversized sections split on paragraph boundaries."""
    sections: list[tuple[str, str]] = []
    matches = list(_HEADING_RE.finditer(text))
    if not matches:
        sections.append(("", text))
    else:
        if matches[0].start() > 0:
            sections.append(("", text[: matches[0].start()]))
        for i, m in enumerate(matches):
            end = matches[i + 1].start() if i + 1 < len(matches) else len(text)
            sections.append((m.group(2).strip(), text[m.end():end]))

    chunks: list[KnowledgeChunk] = []
    for section, body in sections:
        body = body.strip()
        if not body and not section:
            continue
        pieces = [body] if len(body) <= max_chunk_chars else _split_paragraphs(body, max_chunk_chars)
        for piece in pieces:
            content = f"{section}\n{piece}".strip() if section else piece
            if not content:
                continue
            chunks.append(KnowledgeChunk(
                chunk_id=f"{doc_id}#{len(chunks)}",
                doc_id=doc_id,
                content=content,
                section=section,
                chunk_type=infer_chunk_type(piece, section),
                position=len(chunks),
            ))
    return chunks


def _split_paragraphs(body: str, max_chars: int) -> list[str]:
    pieces: list[str] = []
    current: list[str] = []
    size = 0
    for para in body.split("\n\n"):
        if size + len(para) > max_chars and current:
            pieces.append("\n\n".join(current))
            current, size = [], 0
        current.append(para)
        size += len(para) + 2
    if current:
        pieces.append("\n\n".join(current))
    return pieces


def document_from_markdown(
    path_or_ref: str, text: str, source: str = "filesystem",
    default_title: str = "",
) -> KnowledgeDocument:
    meta, body = parse_frontmatter(text)
    doc_id = KnowledgeDocument.make_id(source, path_or_ref)
    title = str(meta.get("title") or default_title or _first_heading(body) or path_or_ref)
    services = meta.get("services") or []
    symptoms = meta.get("symptoms") or []
    tags = meta.get("tags") or []
    doc = KnowledgeDocument(
        doc_id=doc_id,
        title=title,
        content=body,
        knowledge_type=str(meta.get("type", "reference")),
        source=source,
        source_ref=path_or_ref,
        services=[str(s) for s in services] if isinstance(services, list) else [str(services)],
        symptoms=[str(s) for s in symptoms] if isinstance(symptoms, list) else [str(symptoms)],
        severity=meta.get("severity"),
        tags=[str(t) for t in tags] if isinstance(tags, list) else [str(tags)],
    )
    doc.chunks = chunk_markdown(doc_id, body)
    return doc


def _first_heading(text: str) -> str:
    m = _HEADING_RE.search(text)
    return m.group(2).strip() if m else ""
