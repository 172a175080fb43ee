"""Service graph context: dependencies + blast radius in prompts.

Parity target: reference ``src/agent/service-context.ts`` (:86) — injects
service-graph context (dependencies, dependents, blast radius) for services
mentioned in the conversation.
"""

from __future__ import annotations


from runbookai_tpu_torch.knowledge.store.graph import ServiceGraph


class ServiceContextManager:
    def __init__(self, graph: ServiceGraph, max_services: int = 5):
        self.graph = graph
        self.max_services = max_services
        self._active: list[str] = []

    def observe_services(self, services: list[str]) -> list[str]:
        """Track mentioned services that exist in the graph; returns new ones."""
        added = []
        for svc in services:
            if svc in self.graph.nodes and svc not in self._active:
                self._active.append(svc)
                added.append(svc)
        self._active = self._active[-self.max_services:]
        return added

    def system_prompt_block(self) -> str:
        if not self._active:
            return ""
        lines = ["# Service topology"]
        for svc in self._active:
            deps = self.graph.dependencies_of(svc)
            blast = self.graph.downstream_impact(svc, max_depth=3)
            node = self.graph.nodes[svc]
            detail = []
            if node.team:
                detail.append(f"team {node.team}")
            if node.tier is not None:
                detail.append(f"tier {node.tier}")
            suffix = f" ({', '.join(detail)})" if detail else ""
            lines.append(f"- {svc}{suffix}")
            if deps:
                lines.append(f"  depends on: {', '.join(deps[:6])}")
            if blast:
                lines.append(f"  blast radius if degraded: {', '.join(blast[:6])}")
        return "\n".join(lines)

    def blast_radius(self, service: str) -> list[str]:
        return self.graph.downstream_impact(service)
