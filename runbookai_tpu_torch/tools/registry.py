"""Tool registry: categories, definition helper, runtime config gating.

Parity target: reference ``src/tools/registry.ts`` (``ToolRegistry`` +
``defineTool`` :109-212; category registration :2067-3685) and
``src/cli/runtime-tools.ts:19-69`` (config toggles select which categories/
tools an agent run exposes). The registry itself is dependency-free; tool
factories live in sibling modules and register on demand.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Optional

from runbookai_tpu_torch.agent.types import RiskLevel, Tool
from runbookai_tpu_torch.unported import unported

CATEGORIES = (
    "aws", "kubernetes", "code", "observability", "knowledge", "incident",
    "skills", "context", "diagram", "general",
)


class ToolRegistry:
    def __init__(self) -> None:
        self._tools: dict[str, Tool] = {}
        self._categories: dict[str, list[str]] = {c: [] for c in CATEGORIES}

    def register(self, tool: Tool) -> Tool:
        if tool.name in self._tools:
            raise ValueError(f"tool {tool.name!r} already registered")
        self._tools[tool.name] = tool
        self._categories.setdefault(tool.category, []).append(tool.name)
        return tool

    def define(
        self,
        name: str,
        description: str,
        parameters: dict[str, Any],
        execute: Callable[[dict[str, Any]], Awaitable[Any]],
        category: str = "general",
        risk: RiskLevel = RiskLevel.READ,
        call_limit: Optional[int] = None,
    ) -> Tool:
        """``defineTool`` equivalent (reference registry.ts:198-212)."""
        return self.register(Tool(
            name=name, description=description, parameters=parameters,
            execute=execute, category=category, risk=risk, call_limit=call_limit,
        ))

    def get(self, name: str) -> Optional[Tool]:
        return self._tools.get(name)

    def all(self) -> list[Tool]:
        return list(self._tools.values())

    def by_category(self, category: str) -> list[Tool]:
        return [self._tools[n] for n in self._categories.get(category, [])]

    def names(self) -> list[str]:
        return sorted(self._tools)


def object_schema(properties: dict[str, Any], required: Optional[list[str]] = None) -> dict[str, Any]:
    schema: dict[str, Any] = {"type": "object", "properties": properties}
    if required:
        schema["required"] = required
    return schema


def get_runtime_tools(config, registry: Optional[ToolRegistry] = None,
                      knowledge=None, safety=None, llm=None) -> list[Tool]:
    """Build the gated tool list for one agent run from config.

    Mirrors ``getRuntimeTools`` (runtime-tools.ts:19): each provider block's
    ``enabled``/``simulated`` flags select real or fixture-backed tools;
    context + diagram tools are always on.
    """
    reg = registry or ToolRegistry()

    from runbookai_tpu_torch.tools import context as context_tools
    from runbookai_tpu_torch.tools import diagram as diagram_tools
    from runbookai_tpu_torch.tools import simulated as simulated_tools

    context_tools.register(reg)
    diagram_tools.register(reg)

    sim = simulated_tools.SimulatedCloud.from_config(config)
    aws_cfg = config.providers.aws
    if aws_cfg.enabled:
        if aws_cfg.simulated:
            simulated_tools.register_aws(reg, sim)
            # Deterministic cross-modality analysis over the same
            # fixtures (agent/signal_triage.py) — the stale/decoy/
            # dropout-aware layer the adversarial eval exercises.
            simulated_tools.register_triage(reg, sim)
        else:
            raise unported("The real AWS tools (tools/aws.py)", "queue 1 item 10")
    k8s_cfg = config.providers.kubernetes
    if k8s_cfg.enabled:
        if k8s_cfg.simulated:
            simulated_tools.register_kubernetes(reg, sim)
        else:
            raise unported("The real Kubernetes tools (tools/kubernetes.py)", "queue 1 item 10")
    obs = config.observability
    if obs.datadog.enabled or obs.prometheus.enabled:
        if (obs.datadog.enabled and obs.datadog.simulated) or (
            obs.prometheus.enabled and obs.prometheus.simulated
        ):
            simulated_tools.register_observability(reg, sim, obs)
        else:
            raise unported("The real observability tools (tools/observability.py)",
                           "queue 1 item 10")
    inc = config.incident
    if inc.pagerduty.enabled or inc.opsgenie.enabled or inc.slack.enabled:
        if (inc.pagerduty.enabled and inc.pagerduty.simulated) or (
            inc.opsgenie.enabled and inc.opsgenie.simulated
        ):
            simulated_tools.register_incident(reg, sim, inc)
        else:
            raise unported("The real incident tools (tools/incident.py)", "queue 1 item 10")
    if config.providers.github.enabled or config.providers.gitlab.enabled:
        if config.providers.github.enabled and config.providers.github.simulated:
            simulated_tools.register_code(reg, sim)
        else:
            raise unported("The real code tools (tools/code.py)", "queue 1 item 10")
    if knowledge is not None:
        from runbookai_tpu_torch.tools import knowledge_tool

        knowledge_tool.register(reg, knowledge)

    # Skills last: the executor closes over the fully-populated tool set.
    from runbookai_tpu_torch.skills.executor import SkillExecutor
    from runbookai_tpu_torch.skills.registry import SkillRegistry, register_skill_tool

    skills = SkillRegistry()
    skills.load_user_skills(f"{getattr(config, 'runbook_dir', '.runbook')}/skills")
    tool_map = {t.name: t for t in reg.all()}

    approval = None
    if safety is not None:
        from runbookai_tpu_torch.agent.safety import ApprovalRequest, RiskLevel
        from runbookai_tpu_torch.agent.safety import classify_risk as _classify

        async def approval(step, params):  # noqa: F811 — skill approval seam
            decision = await safety.gate(ApprovalRequest(
                operation=step.action or step.id,
                risk=_classify(step.action or step.id, default=RiskLevel.HIGH),
                description=step.description or f"skill step {step.id}",
                params=params,
            ))
            return decision.approved

    executor = SkillExecutor(tool_map, llm=llm, approval_callback=approval)
    register_skill_tool(reg, skills, executor)
    return reg.all()
