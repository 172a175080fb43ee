"""LLM client seam (a copy of the ``LLMClient``/``BaseLLMClient`` pieces of
the JAX package's ``model/client.py``): ``chat(system, user, tools)``, the
orchestrator's ``complete(prompt)``, and a streaming variant."""

from __future__ import annotations

from typing import Any, AsyncIterator, Optional, Protocol, runtime_checkable

from runbookai_tpu_torch.agent.types import LLMResponse


@runtime_checkable
class LLMClient(Protocol):
    """The seam every reasoning path talks through."""

    async def chat(
        self,
        system_prompt: str,
        user_prompt: str,
        tools: Optional[list[dict[str, Any]]] = None,
    ) -> LLMResponse: ...

    async def complete(self, prompt: str) -> str: ...

    def chat_stream(
        self,
        system_prompt: str,
        user_prompt: str,
        tools: Optional[list[dict[str, Any]]] = None,
    ) -> AsyncIterator[dict[str, Any]]: ...


class BaseLLMClient:
    """Default implementations of the derived methods."""

    async def chat(self, system_prompt, user_prompt, tools=None) -> LLMResponse:
        raise NotImplementedError

    async def complete(self, prompt: str) -> str:
        """Plain completion used by the structured orchestrator."""
        resp = await self.chat("", prompt, tools=None)
        return resp.content

    async def chat_stream(self, system_prompt, user_prompt, tools=None):
        """Fallback streaming: chunk a non-streaming response."""
        resp = await self.chat(system_prompt, user_prompt, tools)
        text = resp.content
        step = 64
        for i in range(0, len(text), step):
            yield {"type": "text", "delta": text[i : i + step]}
        for call in resp.tool_calls:
            yield {"type": "tool_call", "call": call}
        yield {"type": "done", "response": resp}
