"""The agent contracts the LLM seam returns (a copy of the ``ToolCall`` and
``LLMResponse`` pieces of the JAX package's ``agent/types.py``)."""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ToolCall:
    """A model-requested tool invocation."""

    id: str
    name: str
    args: dict[str, Any]

    @staticmethod
    def new(name: str, args: dict[str, Any]) -> "ToolCall":
        return ToolCall(id=f"call_{uuid.uuid4().hex[:12]}", name=name, args=args)


@dataclass
class LLMResponse:
    """What ``LLMClient.chat`` returns."""

    content: str
    tool_calls: list[ToolCall] = field(default_factory=list)
    thinking: Optional[str] = None
    usage: dict[str, int] = field(default_factory=dict)  # prompt/completion tokens
