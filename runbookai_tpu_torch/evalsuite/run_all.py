"""Unified multi-benchmark eval driver (a copy of the JAX package's
``evalsuite/run_all.py``).

Parity target: reference ``src/eval/run-all-benchmarks.ts`` (:133-435 —
per-benchmark pipeline: locate dataset input → convert to fixtures → run the
investigation benchmark → collect report; statuses passed|failed|skipped;
aggregate ``summary.json``) and ``setup-datasets.ts`` (:86-151 — shallow
git-clone of the public dataset repos under ``examples/evals/datasets/``).

Zero-egress note: ``setup_datasets`` shells out to ``git clone`` and reports
a per-dataset skipped/failed status instead of raising, so in an egress-less
environment the driver degrades to "skipped: input not found" exactly like
the reference does when a dataset is absent (:158).
"""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

from runbookai_tpu_torch.evalsuite.converters import CONVERTERS
from runbookai_tpu_torch.evalsuite.runner import (
    BenchmarkReport,
    load_fixtures_file,
    run_offline,
    write_reports,
)
from runbookai_tpu_torch.unported import unported

DATASET_REPOS = {
    "rcaeval": "https://github.com/phamquiluan/RCAEval.git",
    "rootly": "https://github.com/Rootly-AI-Labs/logs-dataset.git",
    "tracerca": "https://github.com/NetManAIOps/TraceRCA.git",
}

# Candidate input files inside each dataset checkout (first match wins);
# a bare file drop (e.g. hand-placed jsonl/csv) is also accepted.
INPUT_CANDIDATES = {
    "rcaeval": ["cases.json", "cases.jsonl", "data/cases.json", "rcaeval.csv"],
    "rootly": ["incidents.jsonl", "incidents.json", "data/incidents.jsonl",
               "rootly.csv"],
    "tracerca": ["labels.csv", "cases.csv", "data/labels.tsv",
                 "tracerca.jsonl"],
}


def parse_shard(spec: str) -> tuple[int, int]:
    """``"i/n"`` → (index, count), 0-based index. ``"auto"``, this
    process's rank in the JAX package's multihost runtime, is refused:
    the port has no multihost runtime yet."""
    if spec == "auto":
        raise unported("`--shard auto` (parallel/multihost.py::shard_for_host)",
                       "queue 1 item 6")
    try:
        idx_s, _, n_s = spec.partition("/")
        idx, n = int(idx_s), int(n_s)
    except ValueError:
        raise ValueError(f"shard must look like 'i/n' or 'auto', got {spec!r}")
    if n < 1 or not 0 <= idx < n:
        raise ValueError(f"shard index must satisfy 0 <= i < n, got {spec!r}")
    return idx, n


@dataclass
class BenchmarkRun:
    benchmark: str
    status: str  # passed | failed | skipped
    reason: str = ""
    report: Optional[BenchmarkReport] = None
    fixtures_path: str = ""
    case_count: int = 0

    def to_dict(self) -> dict[str, Any]:
        out = {"benchmark": self.benchmark, "status": self.status,
               "case_count": self.case_count}
        if self.reason:
            out["reason"] = self.reason
        if self.report is not None:
            out["pass_rate"] = round(self.report.pass_rate, 4)
        return out


def setup_datasets(root: str | Path,
                   benchmarks: Optional[list[str]] = None) -> dict[str, str]:
    """Shallow-clone missing dataset repos; returns {name: status-string}."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    statuses: dict[str, str] = {}
    for name in benchmarks or list(DATASET_REPOS):
        dest = root / name
        if (dest / ".git").exists() or _find_input(root, name) is not None:
            statuses[name] = "present"
            continue
        if dest.exists() and any(dest.iterdir()):
            # Partial checkout (e.g. interrupted clone): git refuses to clone
            # into a non-empty dir, so surface it instead of looping forever.
            statuses[name] = f"stale: remove {dest} to re-clone"
            continue
        try:
            proc = subprocess.run(
                ["git", "clone", "--depth", "1", DATASET_REPOS[name], str(dest)],
                capture_output=True, text=True, timeout=300)
            statuses[name] = ("cloned" if proc.returncode == 0
                              else f"failed: {proc.stderr.strip()[:160]}")
        except (OSError, subprocess.TimeoutExpired) as exc:
            statuses[name] = f"failed: {exc}"
    return statuses


def _find_input(root: Path, name: str) -> Optional[Path]:
    dataset_dir = root / name
    for candidate in INPUT_CANDIDATES[name]:
        path = dataset_dir / candidate
        if path.exists():
            return path
    # any loose data file at the dataset root
    if dataset_dir.exists():
        for path in sorted(dataset_dir.iterdir()):
            if path.suffix.lower() in (".json", ".jsonl", ".csv", ".tsv"):
                return path
    return None


def run_single_benchmark(
    name: str,
    datasets_root: str | Path,
    out_dir: str | Path,
    runner: Optional[Callable[[list], BenchmarkReport]] = None,
    input_path: Optional[str | Path] = None,
    min_pass_rate: float = 0.0,
    shard: Optional[tuple[int, int]] = None,
) -> BenchmarkRun:
    """Locate input → convert → run → report (run-all-benchmarks.ts:133).

    ``shard=(i, n)`` keeps only ``cases[i::n]`` — the static per-host split
    of a pod-wide run; each host's engine fleet balances its own share
    dynamically after this cut."""
    source = Path(input_path) if input_path else _find_input(Path(datasets_root), name)
    if source is None:
        return BenchmarkRun(name, "skipped",
                            reason=f"input not found under {datasets_root}/{name}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fixtures_path = out / f"{name}-fixtures.json"
    try:
        fixtures = CONVERTERS[name](source)
        fixtures_path.write_text(json.dumps(
            {"pass_threshold": 0.7, "cases": fixtures}, indent=2))
        cases = load_fixtures_file(fixtures_path)
    except Exception as exc:  # noqa: BLE001 — converter failure is a status
        return BenchmarkRun(name, "failed", reason=f"convert: {exc}")
    if shard is not None:
        idx, n = shard
        cases = cases[idx::n]
        if not cases:
            return BenchmarkRun(name, "skipped",
                                reason=f"no cases in shard {idx}/{n}")
    if not cases:
        return BenchmarkRun(name, "skipped", reason="no cases after conversion")
    try:
        report = (runner or (lambda cs: run_offline(cs, name=name)))(cases)
        report.name = name
    except Exception as exc:  # noqa: BLE001
        return BenchmarkRun(name, "failed", reason=f"run: {exc}",
                            fixtures_path=str(fixtures_path),
                            case_count=len(cases))
    status = "passed" if report.pass_rate >= min_pass_rate else "failed"
    return BenchmarkRun(name, status, report=report,
                        fixtures_path=str(fixtures_path), case_count=len(cases))


def run_all_benchmarks(
    datasets_root: str | Path = "examples/evals/datasets",
    out_dir: str | Path = ".runbook/eval-reports",
    benchmarks: Optional[list[str]] = None,
    runner: Optional[Callable[[list], BenchmarkReport]] = None,
    min_pass_rate: float = 0.0,
    setup: bool = False,
    shard: Optional[tuple[int, int]] = None,
) -> dict[str, Any]:
    """All benchmarks → per-report JSONs + aggregate summary (ts:344-435)."""
    names = benchmarks or list(CONVERTERS)
    if setup:
        setup_datasets(datasets_root, names)
    runs = [run_single_benchmark(n, datasets_root, out_dir, runner=runner,
                                 min_pass_rate=min_pass_rate, shard=shard)
            for n in names]
    reports = [r.report for r in runs if r.report is not None]
    out = Path(out_dir)
    summary_path = write_reports(reports, out) if reports else None
    from runbookai_tpu_torch.utils.weights import discover_weights, quality_marker

    aggregate = {
        "generated_at": time.time(),
        # Quality-axis honesty (VERDICT r4 #3): offline scoring exercises
        # the harness; pass@1 means investigation quality only once real
        # weights are in play — every artifact says which it was.
        "quality": quality_marker(discover_weights()),
        **({"shard": f"{shard[0]}/{shard[1]}"} if shard is not None else {}),
        "results": [r.to_dict() for r in runs],
        "passed": sum(1 for r in runs if r.status == "passed"),
        "failed": sum(1 for r in runs if r.status == "failed"),
        "skipped": sum(1 for r in runs if r.status == "skipped"),
    }
    out.mkdir(parents=True, exist_ok=True)
    (out / "run-all.json").write_text(json.dumps(aggregate, indent=2))
    # None when every benchmark was skipped and no summary file was written.
    aggregate["summary_path"] = None if summary_path is None else str(summary_path)
    return aggregate
