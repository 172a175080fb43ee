"""Chat templates + tool-calling prompt adapter and output parser (a copy of
the JAX package's ``model/chat_template.py``).

SURVEY.md §7 step 3 "tool-calling adapter": the reference converts its tool
schema into each hosted provider's native tool format
(``src/model/llm.ts:208-235``) and gets structured tool-call blocks back. An
open model served in-tree has no native tool channel, so tools are formatted
into the system prompt and tool calls are parsed from the output with the
same tolerant JSON extraction strategy the reference uses for structured
responses (``src/agent/llm-parser.ts:215``: raw → fenced → brace matching).
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

from runbookai_tpu_torch.agent.types import ToolCall

BEGIN = "<|begin_of_text|>"
H_START = "<|start_header_id|>"
H_END = "<|end_header_id|>"
EOT = "<|eot_id|>"

TOOL_INSTRUCTIONS = """\

# Tool calling

You have access to the following tools, described as JSON schemas:

{tool_schemas}

To call tools, respond with ONLY a JSON object of this exact shape (no prose
before or after it):

{{"tool_calls": [{{"name": "<tool name>", "args": {{<arguments>}}}}]}}

You may request several tool calls in one response. When you have enough
information to answer, respond with plain text instead (no JSON wrapper).\
"""


def render_message(role: str, content: str) -> str:
    return f"{H_START}{role}{H_END}\n\n{content}{EOT}"


_FAMILY_FORMATS = {"llama": "llama3", "qwen2": "chatml", "mistral": "mistral",
                   "mixtral": "mistral"}


def format_for_model(model_name: str, family: str | None = None) -> str:
    """Prompt format by model family: ``llama3`` (default), ``chatml``
    (Qwen2), ``mistral`` ([INST] wrapping).

    ``family`` — the loaded config's authoritative family (from HF
    ``model_type``) — wins; the name sniff is the fallback for bare names
    (e.g. a fine-tune served under an arbitrary name)."""
    if family in _FAMILY_FORMATS:
        return _FAMILY_FORMATS[family]
    n = model_name.lower()
    if "qwen" in n:
        return "chatml"
    if "mistral" in n or "mixtral" in n:
        return "mistral"
    return "llama3"


def _render_llama3(system: str, history, user_prompt: str) -> str:
    parts = [BEGIN, render_message("system", system)]
    for role, content in history or []:
        parts.append(render_message(role, content))
    parts.append(render_message("user", user_prompt))
    parts.append(f"{H_START}assistant{H_END}\n\n")
    return "".join(parts)


def _render_chatml(system: str, history, user_prompt: str) -> str:
    def msg(role, content):
        return f"<|im_start|>{role}\n{content}<|im_end|>\n"

    parts = [msg("system", system)]
    for role, content in history or []:
        parts.append(msg(role, content))
    parts.append(msg("user", user_prompt))
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def _render_mistral(system: str, history, user_prompt: str) -> str:
    # Mistral-instruct: system folded into the first user turn; assistant
    # turns closed with </s>.
    turns = list(history or []) + [("user", user_prompt)]
    out = ["<s>"]
    first_user = True
    for role, content in turns:
        if role == "user":
            if first_user and system:
                content = f"{system}\n\n{content}"
                first_user = False
            out.append(f"[INST] {content} [/INST]")
        else:
            out.append(f" {content}</s>")
    return "".join(out)


_RENDERERS = {"llama3": _render_llama3, "chatml": _render_chatml,
              "mistral": _render_mistral}


def build_chat_prompt(
    system_prompt: str,
    user_prompt: str,
    tools: Optional[list[dict[str, Any]]] = None,
    history: Optional[list[tuple[str, str]]] = None,
    fmt: str = "llama3",
) -> str:
    """Render the full chat prompt ending at the assistant turn opener."""
    system = system_prompt or "You are a helpful assistant."
    if tools:
        schemas = json.dumps(tools, indent=2)
        system += TOOL_INSTRUCTIONS.format(tool_schemas=schemas)
    return _RENDERERS[fmt](system, history, user_prompt)


def build_completion_prompt(prompt: str, fmt: str = "llama3") -> str:
    """The orchestrator's ``complete(prompt)`` path: single user turn."""
    return build_chat_prompt("", prompt, fmt=fmt)


# --------------------------------------------------------------------------- #
# output parsing                                                              #
# --------------------------------------------------------------------------- #

_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


def extract_json(text: str) -> Optional[Any]:
    """Tolerant JSON extraction: raw parse → fenced block → brace matching
    (reference ``llm-parser.ts:215`` strategy)."""
    text = text.strip()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    for match in _FENCE_RE.finditer(text):
        try:
            return json.loads(match.group(1).strip())
        except json.JSONDecodeError:
            continue
    # Brace matching: first balanced {...} or [...] that parses.
    for opener, closer in (("{", "}"), ("[", "]")):
        start = text.find(opener)
        while start != -1:
            depth = 0
            in_str = False
            esc = False
            for i in range(start, len(text)):
                ch = text[i]
                if esc:
                    esc = False
                    continue
                if ch == "\\":
                    esc = in_str
                    continue
                if ch == '"':
                    in_str = not in_str
                    continue
                if in_str:
                    continue
                if ch == opener:
                    depth += 1
                elif ch == closer:
                    depth -= 1
                    if depth == 0:
                        try:
                            return json.loads(text[start : i + 1])
                        except json.JSONDecodeError:
                            break
            start = text.find(opener, start + 1)
    return None


def parse_assistant_output(text: str) -> tuple[str, list[ToolCall], Optional[str]]:
    """Split raw assistant output into (content, tool_calls, thinking).

    ``<thinking>...</thinking>`` blocks (if the prompt elicits them) are
    captured separately, mirroring the reference's thinking-block parsing
    (``src/model/llm.ts:240-274``).
    """
    thinking = None
    m = re.search(r"<thinking>(.*?)</thinking>", text, re.DOTALL)
    if m:
        thinking = m.group(1).strip()
        text = (text[: m.start()] + text[m.end() :]).strip()

    payload = extract_json(text)
    if isinstance(payload, dict) and isinstance(payload.get("tool_calls"), list):
        calls = []
        for item in payload["tool_calls"]:
            if not isinstance(item, dict) or "name" not in item:
                continue
            args = item.get("args") or item.get("arguments") or {}
            if not isinstance(args, dict):
                args = {}
            calls.append(ToolCall.new(str(item["name"]), args))
        if calls:
            content = payload.get("content") or ""
            return str(content), calls, thinking
    return text.strip(), [], thinking
