"""Service dependency graph.

Parity target: reference ``src/knowledge/store/graph-store.ts``
(``ServiceGraph`` :76 — addService :85, addDependency :184, upstream/downstream
impact :342/:383, team/type/tag/tier filters :296-322, path finding + cycle
detection + stats :430-600; persisted as ``.runbook/service-graph.json``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional


@dataclass
class ServiceNode:
    name: str
    type: str = "service"
    team: Optional[str] = None
    tier: Optional[int] = None
    tags: list[str] = field(default_factory=list)
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class DependencyEdge:
    source: str  # depends on target
    target: str
    kind: str = "sync"  # sync | async | data
    description: str = ""


class ServiceGraph:
    def __init__(self) -> None:
        self.nodes: dict[str, ServiceNode] = {}
        self.edges: list[DependencyEdge] = []

    # ------------------------------------------------------------------ build

    def add_service(self, name: str, **kw) -> ServiceNode:
        node = self.nodes.get(name)
        if node is None:
            node = ServiceNode(name=name, **kw)
            self.nodes[name] = node
        else:
            for k, v in kw.items():
                if v is not None:
                    setattr(node, k, v)
        return node

    def add_dependency(self, source: str, target: str, kind: str = "sync",
                       description: str = "") -> DependencyEdge:
        self.add_service(source)
        self.add_service(target)
        for e in self.edges:
            if e.source == source and e.target == target:
                return e
        edge = DependencyEdge(source=source, target=target, kind=kind,
                              description=description)
        self.edges.append(edge)
        return edge

    # ---------------------------------------------------------------- queries

    def dependencies_of(self, name: str) -> list[str]:
        return [e.target for e in self.edges if e.source == name]

    def dependents_of(self, name: str) -> list[str]:
        return [e.source for e in self.edges if e.target == name]

    def downstream_impact(self, name: str, max_depth: int = 10) -> list[str]:
        """Services affected if ``name`` degrades (transitive dependents —
        the blast radius)."""
        return self._walk(name, self.dependents_of, max_depth)

    def upstream_impact(self, name: str, max_depth: int = 10) -> list[str]:
        """Services whose failure could explain ``name`` degrading."""
        return self._walk(name, self.dependencies_of, max_depth)

    def _walk(self, start: str, neighbors, max_depth: int) -> list[str]:
        seen: list[str] = []
        frontier = [(start, 0)]
        visited = {start}
        while frontier:
            cur, depth = frontier.pop(0)
            if depth >= max_depth:
                continue
            for nxt in neighbors(cur):
                if nxt not in visited:
                    visited.add(nxt)
                    seen.append(nxt)
                    frontier.append((nxt, depth + 1))
        return seen

    def find_path(self, source: str, target: str) -> Optional[list[str]]:
        frontier = [[source]]
        visited = {source}
        while frontier:
            path = frontier.pop(0)
            if path[-1] == target:
                return path
            for nxt in self.dependencies_of(path[-1]):
                if nxt not in visited:
                    visited.add(nxt)
                    frontier.append(path + [nxt])
        return None

    def find_cycles(self) -> list[list[str]]:
        cycles = []
        state: dict[str, int] = {}
        stack: list[str] = []

        def dfs(node: str) -> None:
            state[node] = 1
            stack.append(node)
            for nxt in self.dependencies_of(node):
                if state.get(nxt, 0) == 0:
                    dfs(nxt)
                elif state.get(nxt) == 1 and nxt in stack:
                    cycles.append(stack[stack.index(nxt):] + [nxt])
            stack.pop()
            state[node] = 2

        for name in self.nodes:
            if state.get(name, 0) == 0:
                dfs(name)
        return cycles

    def filter(self, team: Optional[str] = None, type: Optional[str] = None,
               tag: Optional[str] = None, tier: Optional[int] = None) -> list[ServiceNode]:
        out = []
        for node in self.nodes.values():
            if team and node.team != team:
                continue
            if type and node.type != type:
                continue
            if tag and tag not in node.tags:
                continue
            if tier is not None and node.tier != tier:
                continue
            out.append(node)
        return out

    def stats(self) -> dict[str, Any]:
        indegree: dict[str, int] = {n: 0 for n in self.nodes}
        for e in self.edges:
            indegree[e.target] = indegree.get(e.target, 0) + 1
        most_depended = sorted(indegree.items(), key=lambda kv: kv[1], reverse=True)[:5]
        return {
            "services": len(self.nodes),
            "dependencies": len(self.edges),
            "cycles": len(self.find_cycles()),
            "most_depended_on": most_depended,
        }

    # ------------------------------------------------------------ persistence

    def save(self, path: str | Path = ".runbook/service-graph.json") -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({
            "nodes": [vars(n) for n in self.nodes.values()],
            "edges": [vars(e) for e in self.edges],
        }, indent=2))

    @classmethod
    def load(cls, path: str | Path = ".runbook/service-graph.json") -> "ServiceGraph":
        graph = cls()
        p = Path(path)
        if p.is_file():
            data = json.loads(p.read_text())
            for raw in data.get("nodes", []):
                graph.nodes[raw["name"]] = ServiceNode(**raw)
            for raw in data.get("edges", []):
                graph.edges.append(DependencyEdge(**raw))
        return graph

    @classmethod
    def from_services_config(cls, services_cfg) -> "ServiceGraph":
        """Build from ``.runbook/services.yaml`` (config ServicesConfig)."""
        graph = cls()
        for svc in services_cfg.services:
            graph.add_service(svc.name, type=svc.type, team=svc.team,
                              tier=svc.tier, tags=list(svc.tags))
            for dep in svc.depends_on:
                graph.add_dependency(svc.name, dep)
        return graph
