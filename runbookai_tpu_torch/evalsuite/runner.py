"""Investigation benchmark runner: offline scoring or live batched runs
(a copy of the JAX package's ``evalsuite/runner.py``).

Parity target: reference ``src/eval/investigation-benchmark.ts`` (offline mode
:184-210 scores fixture ``mock_result`` without any model; live mode builds the
real runtime per case :121-187) and ``run-all-benchmarks.ts`` (:133-344 —
per-benchmark reports + ``summary.json``, skipped/failed statuses).

Cases are independent, so live mode runs N investigations **concurrently**
against the continuous-batching engine (asyncio gather over the engine's
batch slots): their guided calls share decode steps, and cases join and
leave the batch at different times. ``run_live`` keeps the JAX package's
duck-typed fleet hooks (``engine.dp``, ``begin_case``, ``set_case_model``,
``replica_models``); the port's engine has none of them (the data-parallel
fleet is ROADMAP.md queue 1 item 9), so the single-engine path runs, as it
does in the JAX package without a fleet.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from runbookai_tpu_torch.agent.orchestrator import InvestigationOrchestrator, ToolExecutor
from runbookai_tpu_torch.agent.state_machine import InvestigationStateMachine
from runbookai_tpu_torch.evalsuite.scoring import EvalCase, score_investigation_result
from runbookai_tpu_torch.tools import simulated as sim_tools
from runbookai_tpu_torch.tools.registry import ToolRegistry


@dataclass
class BenchmarkReport:
    name: str
    cases: list[dict[str, Any]] = field(default_factory=list)
    started_at: float = field(default_factory=time.time)
    elapsed_s: float = 0.0

    @property
    def passed(self) -> int:
        return sum(1 for c in self.cases if c["passed"])

    @property
    def pass_rate(self) -> float:
        return self.passed / len(self.cases) if self.cases else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "benchmark": self.name,
            "total": len(self.cases),
            "passed": self.passed,
            "pass_rate": round(self.pass_rate, 4),
            "elapsed_s": round(self.elapsed_s, 2),
            "cases": self.cases,
        }


def load_fixtures_file(path: str | Path) -> list[EvalCase]:
    raw = json.loads(Path(path).read_text())
    cases = raw["cases"] if isinstance(raw, dict) else raw
    default_threshold = raw.get("pass_threshold", 0.7) if isinstance(raw, dict) else 0.7
    out = []
    for c in cases:
        c.setdefault("pass_threshold", default_threshold)
        out.append(EvalCase.from_dict(c))
    return out


def run_offline(cases: list[EvalCase], name: str = "offline") -> BenchmarkReport:
    """Score fixture mock_results without any model (regression harness)."""
    report = BenchmarkReport(name=name)
    t0 = time.perf_counter()
    for case in cases:
        if case.mock_result is None:
            report.cases.append({"case_id": case.case_id, "status": "skipped",
                                 "passed": False, "reason": "no mock_result"})
            continue
        score = score_investigation_result(case, case.mock_result)
        report.cases.append({
            "case_id": case.case_id, "status": "scored", "passed": score.passed,
            "score": score.total, "dimensions": score.dimensions,
            "notes": score.notes,
        })
    report.elapsed_s = time.perf_counter() - t0
    return report


def _executor_for_case(case: EvalCase) -> ToolExecutor:
    reg = ToolRegistry()
    sim = sim_tools.SimulatedCloud(case.fixtures)
    sim_tools.register_aws(reg, sim)
    sim_tools.register_kubernetes(reg, sim)
    sim_tools.register_incident(reg, sim, None)
    return ToolExecutor({t.name: t for t in reg.all()})


async def run_live(
    cases: list[EvalCase],
    llm_factory: Callable[[], Any],
    name: str = "live",
    concurrency: int = 4,
    knowledge=None,
    max_iterations: int = 20,
    scale_concurrency_with_fleet: bool = True,
) -> BenchmarkReport:
    """Run full investigations concurrently against a shared engine.

    ``llm_factory`` returns the (shared) client exposing ``complete``; the
    continuous-batching engine interleaves all cases' decodes (DP batching).
    With an engine fleet behind the client, ``concurrency`` is the
    PER-REPLICA budget: the semaphore widens by the replica count (the
    router keeps per-replica load at roughly the configured level), and
    each case row gains ``replica_requests`` — how many engine calls each
    replica served for it.
    """
    report = BenchmarkReport(name=name)
    llm = llm_factory()
    engine = getattr(llm, "engine", None)
    dp = getattr(engine, "dp", 1)
    eff_concurrency = (concurrency * dp if scale_concurrency_with_fleet
                       else concurrency)
    # Fleet attribution (duck-typed so mock LLM clients need nothing):
    # begin_case tags the asyncio task; every routed request inside it is
    # credited to the case, however deep in the agent stack it happens.
    begin_case = getattr(engine, "begin_case", None)
    # Multi-model fleets: a case carrying a `model` pins every engine
    # call it makes (however deep in the agent stack) to that served
    # group via the fleet's CURRENT_MODEL contextvar — the eval suite is
    # then a real multi-model load generator, not a single-group one.
    set_model = getattr(engine, "set_case_model", None)
    replica_models = getattr(engine, "replica_models", None)
    if set_model is None and any(c.model for c in cases):
        # Say so LOUDLY: a per-model breakdown printed over cases that
        # all silently ran on one default engine would read as a
        # multi-model result that never happened.
        import logging

        logging.getLogger(__name__).warning(
            "eval cases carry a `model` but the engine has no model "
            "routing (llm.models not configured) — every case runs on "
            "the default model")
    sem = asyncio.Semaphore(eff_concurrency)
    t0 = time.perf_counter()

    async def run_case(case: EvalCase) -> dict[str, Any]:
        async with sem:
            token = begin_case(case.case_id) if begin_case else None
            model_token = None
            try:
                # Inside the try: a case naming an unserved model is a
                # FAILED case row, never a crashed eval run.
                if set_model and case.model:
                    model_token = set_model(case.model)
                orch = InvestigationOrchestrator(
                    llm, _executor_for_case(case),
                    machine=InvestigationStateMachine(
                        incident_id=case.incident_id or case.case_id,
                        max_iterations=max_iterations),
                    knowledge=knowledge,
                )
                result = await orch.investigate(case.incident_id, case.description)
                payload = {
                    "root_cause": result.root_cause,
                    "confidence": result.confidence,
                    "affected_services": result.affected_services,
                    "summary": result.conclusion_summary,
                }
                score = score_investigation_result(case, payload)
                out = {
                    "case_id": case.case_id, "status": "completed",
                    "passed": score.passed, "score": score.total,
                    "dimensions": score.dimensions,
                    "result": payload,
                    "event_counts": _count_events(result.events),
                    "iterations": result.summary["iterations"],
                }
            except Exception as exc:  # noqa: BLE001 — a case failure is a result
                out = {"case_id": case.case_id, "status": "failed",
                       "passed": False,
                       "error": f"{type(exc).__name__}: {exc}"}
            finally:
                if model_token is not None:
                    engine.reset_case_model(model_token)
                if token is not None:
                    engine.end_case(token)
            if begin_case:
                routes = engine.case_routes(case.case_id)
                out["replica_requests"] = {
                    f"r{i}": n for i, n in sorted(routes.items())}
                if replica_models:
                    # Per-model attribution (multi-model fleets): how
                    # many engine calls each served group handled for
                    # this case — summed into summary.json next to the
                    # per-replica totals.
                    per_model: dict[str, int] = {}
                    for i, n in routes.items():
                        name = replica_models.get(i, "unknown")
                        per_model[name] = per_model.get(name, 0) + n
                    out["model_requests"] = dict(sorted(per_model.items()))
            return out

    report.cases = list(await asyncio.gather(*(run_case(c) for c in cases)))
    report.elapsed_s = time.perf_counter() - t0
    return report


def _count_events(events) -> dict[str, int]:
    counts: dict[str, int] = {}
    for ev in events:
        counts[ev.kind] = counts.get(ev.kind, 0) + 1
    return counts


def write_reports(reports: list[BenchmarkReport], out_dir: str | Path) -> Path:
    """Per-benchmark JSONs + aggregate summary.json (run-all-benchmarks.ts)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for report in reports:
        (out / f"{report.name}.json").write_text(json.dumps(report.to_dict(), indent=2))
    from runbookai_tpu_torch.utils.weights import discover_weights, quality_marker

    summary = {
        "generated_at": time.time(),
        "quality": quality_marker(discover_weights()),
        "benchmarks": [
            {"name": r.name, "total": len(r.cases), "passed": r.passed,
             "pass_rate": round(r.pass_rate, 4), "elapsed_s": round(r.elapsed_s, 2)}
            for r in reports
        ],
        "overall_pass_rate": round(
            sum(r.passed for r in reports) / max(1, sum(len(r.cases) for r in reports)), 4),
    }
    # Fleet runs: total engine requests each replica served, summed from
    # the per-case attribution run_live recorded.
    replica_totals: dict[str, int] = {}
    model_totals: dict[str, int] = {}
    for report in reports:
        for c in report.cases:
            for rep, n in (c.get("replica_requests") or {}).items():
                replica_totals[rep] = replica_totals.get(rep, 0) + n
            for name, n in (c.get("model_requests") or {}).items():
                model_totals[name] = model_totals.get(name, 0) + n
    if replica_totals:
        summary["replica_attribution"] = dict(sorted(replica_totals.items()))
    if model_totals:
        # Multi-model fleets: the same totals grouped by served model —
        # which group actually absorbed the eval load.
        summary["model_attribution"] = dict(sorted(model_totals.items()))
    path = out / "summary.json"
    path.write_text(json.dumps(summary, indent=2))
    return path
