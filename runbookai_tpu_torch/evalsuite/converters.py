"""Dataset converters: public RCA datasets → fixture JSON
(a copy of the JAX package's ``evalsuite/converters.py``).

Parity target: reference ``src/eval/rcaeval-to-fixtures.ts`` /
``rootly-logs-to-fixtures.ts`` / ``tracerca-to-fixtures.ts`` (json / jsonl /
csv / tsv inputs). Formats are inferred from extension; each converter maps a
dataset row onto the shared fixture schema (``scoring.EvalCase``).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any


def _read_rows(path: str | Path) -> list[dict[str, Any]]:
    p = Path(path)
    suffix = p.suffix.lower()
    text = p.read_text()
    if suffix == ".json":
        data = json.loads(text)
        return data if isinstance(data, list) else data.get("cases", data.get("data", []))
    if suffix == ".jsonl":
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    if suffix in (".csv", ".tsv"):
        delim = "\t" if suffix == ".tsv" else ","
        return list(csv.DictReader(text.splitlines(), delimiter=delim))
    raise ValueError(f"unsupported dataset format: {suffix}")


def _keywords(text: str, max_n: int = 6) -> list[str]:
    words = [w.strip(".,;:()[]") for w in text.split()]
    return [w for w in words if len(w) > 4][:max_n]


def rcaeval_to_fixtures(path: str | Path) -> list[dict[str, Any]]:
    """RCAEval rows: {case, system, root_cause_service, root_cause_metric/fault}."""
    fixtures = []
    for i, row in enumerate(_read_rows(path)):
        service = str(row.get("root_cause_service") or row.get("service") or "")
        fault = str(row.get("fault_type") or row.get("root_cause_metric")
                    or row.get("root_cause") or "")
        desc = str(row.get("description") or
                   f"Anomaly detected in {row.get('system', 'system')}: "
                   f"degradation around {service}")
        fixtures.append({
            "case_id": str(row.get("case") or row.get("id") or f"rcaeval-{i}"),
            "description": desc,
            "expected_root_cause": f"{fault} in {service}".strip(),
            "root_cause_keywords": [k for k in [service, *_keywords(fault)] if k],
            "expected_services": [service] if service else [],
            "expected_confidence": "medium",
        })
    return fixtures


def rootly_to_fixtures(path: str | Path) -> list[dict[str, Any]]:
    """Rootly incident rows: {title, summary, cause, services, severity}."""
    fixtures = []
    for i, row in enumerate(_read_rows(path)):
        services = row.get("services") or row.get("affected_services") or []
        if isinstance(services, str):
            services = [s.strip() for s in services.split(",") if s.strip()]
        cause = str(row.get("cause") or row.get("root_cause") or "")
        fixtures.append({
            "case_id": str(row.get("id") or f"rootly-{i}"),
            "description": str(row.get("title") or row.get("summary") or ""),
            "expected_root_cause": cause,
            "root_cause_keywords": _keywords(cause),
            "expected_services": list(services),
            "expected_confidence": "medium",
        })
    return fixtures


def tracerca_to_fixtures(path: str | Path) -> list[dict[str, Any]]:
    """TraceRCA rows: {trace_id/case, root_cause (service), anomaly_type}."""
    fixtures = []
    for i, row in enumerate(_read_rows(path)):
        service = str(row.get("root_cause") or row.get("root_cause_service") or "")
        anomaly = str(row.get("anomaly_type") or row.get("fault") or "latency anomaly")
        fixtures.append({
            "case_id": str(row.get("trace_id") or row.get("case") or f"tracerca-{i}"),
            "description": f"Trace anomaly ({anomaly}) in microservice system",
            "expected_root_cause": f"{anomaly} caused by {service}",
            "root_cause_keywords": [k for k in [service, *_keywords(anomaly)] if k],
            "expected_services": [service] if service else [],
            "expected_confidence": "medium",
        })
    return fixtures


CONVERTERS = {
    "rcaeval": rcaeval_to_fixtures,
    "rootly": rootly_to_fixtures,
    "tracerca": tracerca_to_fixtures,
}


def convert(benchmark: str, src: str | Path, dst: str | Path) -> int:
    fixtures = CONVERTERS[benchmark](src)
    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    Path(dst).write_text(json.dumps({"pass_threshold": 0.7, "cases": fixtures}, indent=2))
    return len(fixtures)
