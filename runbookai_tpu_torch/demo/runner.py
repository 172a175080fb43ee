"""Scripted demo playback (reference ``src/demo/demo-runner.ts:223``).

Replays the canned investigation with timing; ``--fast`` is 3×. Renders
through the same event vocabulary as real runs so the terminal output is
identical in shape to a live investigation.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from runbookai_tpu_torch.demo.data import DEMO_CHART, DEMO_INCIDENT, DEMO_SCRIPT
from runbookai_tpu_torch.agent.types import AgentEvent


def run_demo(
    emit: Optional[Callable[[AgentEvent], None]] = None,
    fast: bool = False,
    sleep=time.sleep,
) -> list[AgentEvent]:
    """Play the demo; returns the event list (also streamed via ``emit``)."""
    speed = 3.0 if fast else 1.0
    events: list[AgentEvent] = []

    def push(kind: str, data: dict) -> None:
        ev = AgentEvent(kind, data)
        events.append(ev)
        if emit:
            emit(ev)

    push("start", {"incident": DEMO_INCIDENT, "demo": True})
    for delay, kind, payload in DEMO_SCRIPT:
        sleep(delay / speed)
        if kind == "conclusion":
            # Attach the latency chart the visualization policy mandates.
            from runbookai_tpu_torch.tools.diagram import line_chart, sparkline

            payload = dict(payload)
            payload["chart"] = line_chart(
                [float(v) for v in DEMO_CHART],
                label="payment-api p99 latency (ms), last 60m")
            payload["sparkline"] = sparkline([float(v) for v in DEMO_CHART])
        push(kind, payload)
    return events


def render_event(ev: AgentEvent) -> str:
    """Terminal line renderer shared by demo and live CLI output."""
    d = ev.data
    k = ev.kind
    if k == "answer":
        from runbookai_tpu_torch.cli.markdown import render_markdown

        import sys

        return "\n" + render_markdown(d.get("text", ""),
                                      color=sys.stdout.isatty())
    if k == "start":
        inc = d.get("incident", {})
        title = inc.get("title") or d.get("query", "")
        return f"▶ {title}" if title else "▶ session started"
    if k == "phase":
        return f"\n== {d.get('name', '').upper()} == {d.get('text', '')}"
    if k == "phase_change":
        return f"\n== {d.get('phase', '').upper()} =="
    if k == "triage":
        return (f"  severity={d.get('severity')} services={', '.join(d.get('services', []))}"
                f"\n  {d.get('summary', '')}")
    if k == "tool_call":
        return f"  → {d.get('name')}({d.get('args', {})})"
    if k == "tool_result":
        return f"    ✓ {d.get('summary') or d.get('result_id') or 'ok'}"
    if k == "hypothesis_created":
        parent = f" (under {d['parent']})" if d.get("parent") else ""
        return f"  + {d.get('id')}: {d.get('statement')}{parent} [p={d.get('priority', '?')}]"
    if k == "hypothesis_updated":
        return (f"  * {d.get('id')} -> {d.get('action')} "
                f"({d.get('reason', d.get('confidence', ''))})")
    if k == "evidence":
        return f"    · evidence via {d.get('tool')} for {d.get('hypothesis')}"
    if k == "conclusion":
        lines = [
            "\n╔═ ROOT CAUSE " + "═" * 50,
            f"║ {d.get('root_cause', '')}",
            f"║ confidence: {d.get('confidence')}  "
            f"services: {', '.join(d.get('services', d.get('affected_services', [])))}",
            "╚" + "═" * 63,
        ]
        if d.get("chart"):
            lines.append(d["chart"])
        return "\n".join(lines)
    if k == "remediation_step":
        return f"  [{d.get('risk', '?').upper():8}] {d.get('description')}"
    if k == "warning":
        return f"  ! {d.get('text')}"
    if k == "thinking":
        return f"  … {d.get('text', '')[:120]}"
    if k == "knowledge_retrieved":
        return f"  ⚲ knowledge retrieved {d.get('counts', d.get('trigger', ''))}"
    if k == "iteration":
        return f"\n-- iteration {d.get('n')} --"
    if k == "done":
        return "\n✔ done"
    if k == "error":
        return f"  ✗ {d}"
    if k == "token":
        # Inline-streaming consumers (cli._print_event) never reach here;
        # line-based consumers get the raw delta without debug wrapping.
        return d.get("delta", "")
    return f"  [{k}] {d}"
