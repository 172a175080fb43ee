"""Knowledge source loaders + dispatcher.

A copy of the JAX package's ``knowledge/sources/__init__.py`` for the
filesystem source. Parity target: reference ``src/knowledge/sources/index.ts``
— ``loadFromSource`` (:19) routes a per-source config union to the right
loader (filesystem | confluence | google-drive). Each loader returns
``KnowledgeDocument``s with chunks; incremental sync is expressed by the
``since`` epoch argument (reference ``lastSyncTime``). The Confluence and
Google Drive loaders (HTTP clients, no device work) are not ported: a config
that selects one raises.
"""

from __future__ import annotations

from typing import Any, Optional

from runbookai_tpu_torch.knowledge.types import KnowledgeDocument
from runbookai_tpu_torch.unported import unported


def build_source(src_config: Any) -> Optional[Any]:
    """Config row → source object with a ``load(since)`` method."""
    kind = getattr(src_config, "type", "filesystem")
    if kind == "filesystem" and getattr(src_config, "path", None):
        from runbookai_tpu_torch.knowledge.retriever import FilesystemSource

        return FilesystemSource(src_config.path, name=src_config.name)
    if kind == "confluence" and getattr(src_config, "base_url", None):
        raise unported("The Confluence knowledge source "
                       "(knowledge/sources/confluence.py)", "queue 1 item 10")
    if kind == "google-drive" and getattr(src_config, "folder_id", None):
        raise unported("The Google Drive knowledge source "
                       "(knowledge/sources/google_drive.py, google_auth.py)",
                       "queue 1 item 10")
    return None


def load_from_source(src_config: Any, since: Optional[float] = None) -> list[KnowledgeDocument]:
    source = build_source(src_config)
    return source.load(since) if source is not None else []
