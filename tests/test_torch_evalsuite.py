"""The port's eval suite (``runbookai_tpu_torch/evalsuite``) against the
JAX package's, on the CPU.

Scoring, the dataset converters, the offline runner, the report files, the
multi-benchmark driver and ``run_live`` give what the JAX package gives on
the same inputs; clock fields (``elapsed_s``, ``generated_at``) and
temporary paths are masked, nothing else. ``run_live`` runs under the
cycling mock LLM of ``tests/test_evalsuite.py`` and on ``llama3-test``
with the JAX client's params, concurrency 1 and 4, each package's
orchestrator over its own client. At concurrency 4 both engines step in
lockstep with the event loop (:func:`lockstep_loop`): a step runs only
once every case that can reach the engine has submitted its request, so
which requests share a step no longer follows host timing.
"""

import asyncio
import dataclasses
import itertools
import json
import os
import random
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import runbookai_tpu.engine.async_engine as j_async
import runbookai_tpu.evalsuite.converters as j_conv
import runbookai_tpu.evalsuite.run_all as j_all
import runbookai_tpu.evalsuite.runner as j_runner
import runbookai_tpu.evalsuite.scoring as j_scoring
import runbookai_tpu_torch.engine.async_engine as t_async
import runbookai_tpu_torch.evalsuite.converters as t_conv
import runbookai_tpu_torch.evalsuite.run_all as t_all
import runbookai_tpu_torch.evalsuite.runner as t_runner
import runbookai_tpu_torch.evalsuite.scoring as t_scoring
from runbookai_tpu.model.jax_tpu import JaxTpuClient
from runbookai_tpu.model.schema_guided import SchemaLimits as JSchemaLimits
from runbookai_tpu_torch.model.schema_guided import SchemaLimits
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.models.convert import params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "examples" / "evals" / "investigation-fixtures.sample.json"
DATASETS = ROOT / "examples" / "evals" / "datasets"
MINI = {"rcaeval": "rcaeval-mini.csv", "rootly": "rootly-mini.jsonl",
        "tracerca": "tracerca-mini.tsv"}
FROZEN_NOW = 1_790_000_000.0
CLOCKS = {"elapsed_s", "generated_at", "started_at"}
# The live cases: what a case row of each package must agree on.
ROW_KEYS = ("case_id", "status", "passed", "score", "dimensions", "result",
            "event_counts", "iterations", "error")
# llama3-test's clients: phase 15's kind of schema limits, so that random
# documents close and the investigation cycles run.
ENGINE = dict(max_new_tokens=96, max_seq_len=4096, num_pages=1024, prefill_chunk=64)
LIMITS = dict(max_str_len=16, max_array_items=2, max_num_len=8, max_any_bytes=64)
# run_live's iteration budget in the llama3-test runs (its default, 20,
# runs on the card): the payment case reaches it either way.
MAX_ITERATIONS = 6


def masked(obj, root=None):
    """``obj`` with clock fields masked and ``root`` (a temporary dir)
    written as ``<tmp>``."""
    if isinstance(obj, dict):
        return {k: "<clock>" if k in CLOCKS else masked(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [masked(v, root) for v in obj]
    if isinstance(obj, str) and root is not None:
        return obj.replace(str(root), "<tmp>")
    return obj


def files(root: Path) -> dict:
    """Every JSON file under ``root``, parsed and masked, by relative path."""
    return {str(p.relative_to(root)): masked(json.loads(p.read_text()), root)
            for p in sorted(root.rglob("*.json"))}


async def lockstep_loop(self) -> None:
    """``AsyncEngine._loop`` that steps the core in the event loop's own
    thread, and only once the loop has nothing else ready: every coroutine
    that can reach the engine has submitted before the step. The schedule
    then follows the program, not the host's timing."""
    loop = asyncio.get_running_loop()
    while not self._stopped:
        await asyncio.sleep(0)
        while loop._ready:  # other callbacks first
            await asyncio.sleep(0)
        if self._stopped:
            break
        if not self.core.has_work:
            self._wake.clear()
            await self._wake.wait()
            continue
        self._locked_step()


@pytest.fixture()
def lockstep(monkeypatch):
    for mod in (j_async, t_async):
        monkeypatch.setattr(mod.AsyncEngine, "_loop", lockstep_loop)


# ---------------------------------------------------------------- scoring

_WORDS = ("pool", "connection", "deploy", "payment-api", "payments-db", "dns", "kafka",
          "lag", "partition", "exhausted", "cdn", "misconfig", "latency", "the", "a",
          "High", "LOW", "medium", "banana", "  ", "\t", "rds payments", "disk")


def random_text(rng: random.Random, n: int) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n))


def random_case(rng: random.Random) -> dict:
    return {
        "case_id": f"c{rng.randrange(100)}", "description": random_text(rng, 4),
        "expected_root_cause": random_text(rng, rng.randrange(0, 5)),
        "root_cause_keywords": [rng.choice(_WORDS) for _ in range(rng.randrange(0, 4))],
        "expected_services": [rng.choice(_WORDS) for _ in range(rng.randrange(0, 3))],
        "service_aliases": {rng.choice(_WORDS): [rng.choice(_WORDS)]},
        "expected_confidence": rng.choice(["low", "medium", "high", "HIGH", "x"]),
        "required_phrases": [rng.choice(_WORDS) for _ in range(rng.randrange(0, 3))],
        "forbidden_phrases": [rng.choice(_WORDS) for _ in range(rng.randrange(0, 2))],
        "pass_threshold": rng.choice([0.0, 0.3, 0.7, 1.0]),
    }


def random_result(rng: random.Random) -> dict:
    return {"root_cause": random_text(rng, rng.randrange(0, 8)),
            "confidence": rng.choice(["low", "medium", "high", "", "banana"]),
            "affected_services": [rng.choice(_WORDS) for _ in range(rng.randrange(0, 3))],
            "summary": random_text(rng, rng.randrange(0, 6)),
            "conclusion_summary": random_text(rng, rng.randrange(0, 3))}


# test_evalsuite.py's inputs, each function's arguments.
SCORING_CASES = [
    ("score_root_cause", ("pool exhausted", [], "The pool exhausted after deploy")),
    ("score_root_cause", ("x", ["pool", "deploy", "kafka"], "pool shrank after deploy")),
    ("score_root_cause", ("pool", [], "")),
    ("score_root_cause", ("", [], "anything")),
    ("score_root_cause", ("db pool exhausted", [], "the pool is gone")),
    ("score_services", (["payments-db", "payment-api"],
                        {"payments-db": ["payments database"]}, ["payment-api"],
                        "the payments database was saturated")),
    ("score_services", (["a", "b"], {}, ["a"], "")),
    ("score_services", ([], {}, ["a"], "")),
    ("score_confidence", ("high", "high")),
    ("score_confidence", ("high", "medium")),
    ("score_confidence", ("high", "low")),
    ("score_confidence", ("high", "banana")),
    ("score_phrases", (["pool"], ["dns"], "dns failure maybe pool exhausted")),
    ("score_phrases", ([], ["dns"], "dns dns")),
]


@pytest.mark.parametrize("fn, args", SCORING_CASES,
                         ids=[f"{fn}-{i}" for i, (fn, _) in enumerate(SCORING_CASES)])
def test_scoring_functions_equal_jax(fn, args):
    assert getattr(t_scoring, fn)(*args) == getattr(j_scoring, fn)(*args)


def test_score_full_case_equal_jax():
    """test_evalsuite.py's forbidden-phrase case, good and bad results."""
    kw = dict(case_id="c", description="", expected_root_cause="pool exhausted",
              expected_services=["svc-a"], expected_confidence="high",
              required_phrases=["pool"], forbidden_phrases=["dns"])
    for result in ({"root_cause": "pool exhausted", "confidence": "high",
                    "affected_services": ["svc-a"], "summary": "the pool was exhausted"},
                   {"root_cause": "dns failure maybe pool exhausted", "confidence": "low",
                    "affected_services": [], "summary": "dns problems"}):
        got = t_scoring.score_investigation_result(t_scoring.EvalCase(**kw), result)
        want = j_scoring.score_investigation_result(j_scoring.EvalCase(**kw), result)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", range(4))
def test_scoring_equal_jax_on_random_inputs(seed):
    """``EvalCase.from_dict`` and every score on seeded random cases and
    results, with and without weights."""
    rng = random.Random(seed)
    weights = {"root_cause": 0.25, "services": 0.25, "confidence": 0.25, "phrases": 0.25}
    for _ in range(50):
        raw, result = random_case(rng), random_result(rng)
        got_case, want_case = t_scoring.EvalCase.from_dict(raw), j_scoring.EvalCase.from_dict(raw)
        assert dataclasses.asdict(got_case) == dataclasses.asdict(want_case)
        for w in (None, weights):
            got = t_scoring.score_investigation_result(got_case, result, w)
            want = j_scoring.score_investigation_result(want_case, result, w)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for fn, args in (
                ("score_root_cause", (raw["expected_root_cause"], raw["root_cause_keywords"],
                                      result["root_cause"])),
                ("score_services", (raw["expected_services"], raw["service_aliases"],
                                    result["affected_services"], result["summary"])),
                ("score_confidence", (raw["expected_confidence"], result["confidence"])),
                ("score_phrases", (raw["required_phrases"], raw["forbidden_phrases"],
                                   result["summary"]))):
            assert getattr(t_scoring, fn)(*args) == getattr(j_scoring, fn)(*args)


# ------------------------------------------------------------- converters


@pytest.mark.parametrize("bench", sorted(MINI))
def test_converters_equal_jax_on_mini_datasets(bench, tmp_path):
    """Each converter on its checked-in mini dataset: equal fixtures, and
    ``convert`` writes the same file, which both packages load the same."""
    src = DATASETS / MINI[bench]
    got = t_conv.CONVERTERS[bench](src)
    assert got == j_conv.CONVERTERS[bench](src) and got
    assert t_conv.convert(bench, src, tmp_path / "t" / "f.json") == \
        j_conv.convert(bench, src, tmp_path / "j" / "f.json") == len(got)
    text = (tmp_path / "t" / "f.json").read_text()
    assert text == (tmp_path / "j" / "f.json").read_text()
    assert [dataclasses.asdict(c) for c in t_runner.load_fixtures_file(tmp_path / "t" / "f.json")] \
        == [dataclasses.asdict(c) for c in j_runner.load_fixtures_file(tmp_path / "j" / "f.json")]


def test_converters_equal_jax_on_other_formats(tmp_path):
    """test_evalsuite.py's json/jsonl/csv rows, and an unknown suffix."""
    rows = [{"case": "c1", "system": "online-boutique", "root_cause_service": "cartservice",
             "fault_type": "cpu stress"}, {"id": "x", "root_cause_metric": "latency"}]
    (tmp_path / "a.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    (tmp_path / "b.json").write_text(json.dumps({"cases": rows}))
    (tmp_path / "c.csv").write_text("id,title,cause,services\n1,API down,expired "
                                    "certificate,edge-proxy\n")
    for name in ("a.jsonl", "b.json", "c.csv"):
        for bench in sorted(MINI):
            assert t_conv.CONVERTERS[bench](tmp_path / name) == \
                j_conv.CONVERTERS[bench](tmp_path / name)
    (tmp_path / "d.txt").write_text("")
    with pytest.raises(ValueError, match="unsupported dataset format"):
        t_conv.rcaeval_to_fixtures(tmp_path / "d.txt")


# --------------------------------------------------------- offline runner


def test_run_offline_and_write_reports_equal_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    got = t_runner.run_offline(t_runner.load_fixtures_file(FIXTURES), name="sample")
    want = j_runner.run_offline(j_runner.load_fixtures_file(FIXTURES), name="sample")
    assert masked(got.to_dict()) == masked(want.to_dict())
    assert 0 < got.pass_rate < 1 and got.passed == want.passed
    t_summary = t_runner.write_reports([got], tmp_path / "t")
    j_summary = j_runner.write_reports([want], tmp_path / "j")
    assert t_summary.name == j_summary.name == "summary.json"
    assert files(tmp_path / "t") == files(tmp_path / "j")
    assert json.loads(t_summary.read_text())["quality"] == "unmeasured (random weights)"


# ------------------------------------------------------------- run_all


def datasets_tree(root: Path) -> Path:
    """rcaeval as a loose ``cases.json`` (2 rows), tracerca as ``cases.csv``,
    rootly absent."""
    (root / "rcaeval").mkdir(parents=True)
    (root / "rcaeval" / "cases.json").write_text(json.dumps([
        {"case": "c1", "system": "online-boutique", "root_cause_service": "cartservice",
         "fault_type": "cpu hog"},
        {"case": "c2", "system": "trainticket", "root_cause_service": "ts-order-service",
         "fault_type": "network delay"}]))
    (root / "tracerca").mkdir()
    (root / "tracerca" / "cases.csv").write_text(
        "trace_id,root_cause,anomaly_type\nt1,payments,latency\n")
    return root


def failing_runner(report_cls):
    def run(cases):
        report = report_cls(name="x")
        report.cases = [{"case_id": c.case_id, "passed": False} for c in cases]
        return report
    return run


@pytest.mark.parametrize("how", ["offline", "custom_runner", "threshold", "shard"])
def test_run_all_benchmarks_equal_jax(how, tmp_path, monkeypatch):
    """Skips (rootly has no input), the offline runner, a custom runner, a
    pass-rate threshold and ``shard=(1, 2)``: equal aggregates and files."""
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    datasets = datasets_tree(tmp_path / "datasets")
    results = {}
    for pkg, mod, runner in (("t", t_all, t_runner), ("j", j_all, j_runner)):
        kw = {"datasets_root": datasets, "out_dir": tmp_path / pkg}
        if how == "custom_runner":
            kw["runner"] = failing_runner(runner.BenchmarkReport)
        if how == "threshold":
            kw["min_pass_rate"] = 0.5
        if how == "shard":
            kw["shard"] = mod.parse_shard("1/2")
        aggregate = mod.run_all_benchmarks(**kw)
        results[pkg] = (masked(aggregate, tmp_path / pkg), files(tmp_path / pkg))
    assert results["t"] == results["j"]
    statuses = {r["benchmark"]: r["status"] for r in results["t"][0]["results"]}
    assert statuses["rootly"] == "skipped"
    if how == "shard":
        assert results["t"][0]["shard"] == "1/2"
        assert statuses["tracerca"] == "skipped"  # one case: none in shard 1 of 2


def test_parse_shard_equal_jax_and_auto_unported():
    for spec in ("0/1", "1/2", "3/4"):
        assert t_all.parse_shard(spec) == j_all.parse_shard(spec)
    for spec in ("2/2", "x", "1/0", "-1/3"):
        with pytest.raises(ValueError) as got:
            t_all.parse_shard(spec)
        with pytest.raises(ValueError) as want:
            j_all.parse_shard(spec)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 6"):
        t_all.parse_shard("auto")


def test_setup_datasets_fails_offline_as_jax(tmp_path, monkeypatch):
    """``git clone`` refused (``subprocess.run`` stubbed): a ``failed``
    status a dataset, as in the JAX package; a present one is kept."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)

        class Proc:
            returncode = 128
            stderr = "could not resolve host"
        return Proc()

    monkeypatch.setattr(t_all.subprocess, "run", fake_run)
    monkeypatch.setattr(j_all.subprocess, "run", fake_run)
    datasets_tree(tmp_path / "t")
    datasets_tree(tmp_path / "j")
    got = t_all.setup_datasets(tmp_path / "t")
    assert got == j_all.setup_datasets(tmp_path / "j")
    assert got["rootly"].startswith("failed") and got["rcaeval"] == "present"
    assert len(calls) == 2 and calls[0][:2] == ["git", "clone"]


# -------------------------------------------------------------- run_live

TRIAGE = json.dumps({"severity": "high", "summary": "latency",
                     "affected_services": ["payment-api"], "symptoms": ["latency"],
                     "signals": []})
HYPS = json.dumps({"hypotheses": [
    {"statement": "db connection pool exhaustion after deploy", "priority": 0.9}]})
CONFIRM = json.dumps({"action": "confirm", "confidence": 0.9, "supports": True,
                      "strength": "strong", "reasoning": "r"})
CONCL = json.dumps({"root_cause": "db connection pool exhausted after deploy",
                    "confidence": "high", "affected_services": ["payment-api", "payments-db"],
                    "summary": "pool exhausted."})
REMED = json.dumps({"steps": [], "rollback": "", "notes": ""})


class CyclingLLM:
    """test_evalsuite.py's canned completions, in turn."""

    def __init__(self):
        self.cycle = itertools.cycle([TRIAGE, HYPS, CONFIRM, CONCL, REMED])

    async def complete(self, prompt):
        return next(self.cycle)


def rows(report) -> list:
    return [{k: c.get(k) for k in ROW_KEYS} for c in report.cases]


@pytest.mark.parametrize("concurrency", [1, 3])
def test_run_live_under_mock_equal_jax(concurrency, frozen_clock):
    """Three concurrent copies of the sample's first case: every row
    completed, passed, and equal to the JAX package's."""
    reports = {}
    for pkg, runner in (("t", t_runner), ("j", j_runner)):
        cases = [c for c in runner.load_fixtures_file(FIXTURES)
                 if c.case_id == "payment-db-pool"] * 3
        reports[pkg] = asyncio.run(runner.run_live(cases, CyclingLLM, name="live",
                                                   concurrency=concurrency))
    assert masked(reports["t"].to_dict()) == masked(reports["j"].to_dict())
    assert all(c["status"] == "completed" and c["passed"] for c in reports["t"].cases)
    assert all(c["event_counts"]["phase_change"] >= 5 for c in reports["t"].cases)


async def test_run_live_failed_case_is_a_row():
    """An LLM that raises: a ``failed`` row with the error, as in JAX."""
    class Broken:
        async def complete(self, prompt):
            raise RuntimeError("engine down")

    got = await t_runner.run_live(t_runner.load_fixtures_file(FIXTURES)[:1], Broken)
    want = await j_runner.run_live(j_runner.load_fixtures_file(FIXTURES)[:1], Broken)
    assert got.cases == want.cases
    assert got.cases[0]["status"] == "failed" and "engine down" in got.cases[0]["error"]


@pytest.fixture()
def frozen_clock(monkeypatch):
    """A fixed ``time.time``: the simulated fixtures stamp their records
    with it, and those stamps reach the prompts."""
    monkeypatch.setattr(time, "time", lambda: FROZEN_NOW)


@pytest.fixture(scope="module")
def live_clients():
    """The JAX client of ``llama3-test`` and a port client over its params."""
    jclient = JaxTpuClient.for_testing(schema_limits=JSchemaLimits(**LIMITS), **ENGINE)
    params = params_from_jax(jax.tree.map(np.asarray, jclient.core.params), device="cpu")
    client = TorchCudaClient.for_testing(params=params, device="cpu",
                                         schema_limits=SchemaLimits(**LIMITS), **ENGINE)
    return {"j": jclient, "t": client}


async def serve_live(runner, client, case_ids, concurrency):
    cases = [c for c in runner.load_fixtures_file(FIXTURES) if c.case_id in case_ids]
    try:
        return await runner.run_live(cases, lambda: client, name="live",
                                     concurrency=concurrency,
                                     max_iterations=MAX_ITERATIONS)
    finally:
        await client.shutdown()


@pytest.mark.parametrize("concurrency, case_ids", [
    (1, ("payment-db-pool",)), (4, ("payment-db-pool", "cdn-misconfig"))])
def test_run_live_on_llama3_test_equal_jax(concurrency, case_ids, live_clients, lockstep,
                                           frozen_clock):
    """``run_live`` (``MAX_ITERATIONS``, the state machine's defaults) on
    ``llama3-test`` with the JAX params: each case's result payload,
    score, dimensions, event counts and iterations equal to the JAX
    package's ``run_live`` over ``JaxTpuClient.for_testing()``. The
    payment case's one hypothesis runs the cycles to the iteration cap; at
    concurrency 4 both cases share the engine's steps."""
    got = asyncio.run(serve_live(t_runner, live_clients["t"], case_ids, concurrency))
    want = asyncio.run(serve_live(j_runner, live_clients["j"], case_ids, concurrency))
    assert rows(got) == rows(want)
    assert all(c["status"] == "completed" for c in got.cases)
    by_id = {c["case_id"]: c for c in got.cases}
    assert by_id["payment-db-pool"]["iterations"] == MAX_ITERATIONS
    assert by_id["payment-db-pool"]["event_counts"]["evidence"] > 0
