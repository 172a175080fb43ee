"""The serving path's observability in the PyTorch port against the JAX
package, on the CPU (float32): the engine flight recorder, the tracer and
request ids in the engine's trace, the Prometheus metrics the server
exposes, and the serving memory plan. After the scenarios of
``tests/test_observability.py``, ``tests/test_metrics.py``,
``tests/test_checkpoint_trace.py`` and ``tests/test_long_context.py``.
"""

import dataclasses
import json
import os
import re
import threading
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.engine.engine import EngineConfig as JEngineConfig
from runbookai_tpu.engine.engine import EngineCore as JEngineCore
from runbookai_tpu.engine.flight_recorder import FlightRecorder as JFlightRecorder
from runbookai_tpu.engine.memory_plan import plan_serving as jplan_serving
from runbookai_tpu.engine.request import EngineRequest as JRequest
from runbookai_tpu.engine.request import SamplingParams as JSampling
from runbookai_tpu.models.llama import CONFIGS as JCONFIGS
from runbookai_tpu.models.llama import init_params as jinit
from runbookai_tpu.utils import trace as jtrace
from runbookai_tpu.utils.tokens import ByteTokenizer as JByteTokenizer
from runbookai_tpu_torch.engine.engine import EngineConfig, EngineCore
from runbookai_tpu_torch.engine.flight_recorder import STEP_RECORD_FIELDS, FlightRecorder
from runbookai_tpu_torch.engine.memory_plan import GiB, plan_serving
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.models.convert import params_from_jax
from runbookai_tpu_torch.models.llama import CONFIGS
from runbookai_tpu_torch.server.openai_api import OpenAIServer
from runbookai_tpu_torch.utils import metrics as metrics_mod
from runbookai_tpu_torch.utils import trace
from runbookai_tpu_torch.utils.metrics import METRIC_NAME_RE, Histogram, get_registry
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

NAME = "llama3-test"
TIMEOUT = 30
BURST = 128  # clients that connect at once
TOK = ByteTokenizer()
KINDS = {"prefill", "decode", "prefill+decode", "mixed", "idle"}


@pytest.fixture(scope="module")
def weights():
    jparams = jinit(jax.random.PRNGKey(0), JCONFIGS[NAME], dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


# ------------------------------------------------------- flight recorder


def rec(i, kind="decode", **kw):
    base = {"ts": float(i), "kind": kind, "classes": {}, "tokens": 2,
            "batch": 1, "occupancy": 0.25, "queue_depth": 0,
            "kv_free_pages": 10, "kv_utilization": 0.1,
            "dispatch_s": 0.001, "host_s": 0.0005, "overlap_s": 0.0,
            "wall_s": 0.002, "preemptions": 0, "kv_imported": 0,
            "kv_exported": 0}
    base.update(kw)
    return base


def test_ring_bounds_overwrite_oldest():
    fr = FlightRecorder(4)
    for i in range(11):
        fr.append(rec(i))
    assert len(fr) == 4 and fr.capacity == 4
    assert fr.total_steps == 11
    snap = fr.snapshot()
    assert [r["step"] for r in snap] == [7, 8, 9, 10]
    assert [r["ts"] for r in snap] == [7.0, 8.0, 9.0, 10.0]


def test_ring_snapshot_last_n_and_copies():
    fr = FlightRecorder(8)
    for i in range(5):
        fr.append(rec(i))
    snap = fr.snapshot(2)
    assert [r["step"] for r in snap] == [3, 4]
    snap[0]["kind"] = "mutated"  # copies: the ring is untouched
    assert fr.snapshot(2)[0]["kind"] == "decode"
    assert fr.snapshot(0) == []


def test_ring_zero_capacity_disables():
    fr = FlightRecorder(0)
    assert not fr.enabled
    fr.append(rec(0))  # no-op, no raise
    assert len(fr) == 0 and fr.snapshot() == [] and fr.total_steps == 0
    assert fr.summary()["steps_recorded"] == 0


def test_ring_reset_restarts_cursor():
    fr = FlightRecorder(4)
    for i in range(6):
        fr.append(rec(i))
    fr.reset()
    assert len(fr) == 0 and fr.total_steps == 0
    fr.append(rec(99))
    assert fr.snapshot()[0]["step"] == 0


def test_ring_concurrent_append_and_snapshot():
    """The writer never locks; a concurrent reader may tear by a record but
    never crashes or sees a partly written dict."""
    fr = FlightRecorder(16)
    stop = threading.Event()
    errors: list[BaseException] = []

    def reader():
        try:
            while not stop.is_set():
                for r in fr.snapshot():
                    assert r["kind"] in ("decode", "prefill")
                    assert "occupancy" in r
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    for i in range(3000):
        fr.append(rec(i, kind="prefill" if i % 3 else "decode"))
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert not errors, errors
    assert len(fr) == 16 and fr.total_steps == 3000


def test_summary_percentiles_and_kinds():
    fr = FlightRecorder(64)
    for i in range(10):
        fr.append(rec(i, kind="mixed" if i < 3 else "decode",
                      occupancy=(i + 1) / 10.0, kv_utilization=0.05 * i,
                      queue_depth=i, tokens=3))
    s = fr.summary()
    assert s["dispatch_kinds"] == {"decode": 7, "mixed": 3}
    assert s["tokens"] == 30
    assert s["occupancy_p50"] == pytest.approx(0.55, abs=1e-6)
    assert s["occupancy_p95"] == pytest.approx(0.955, abs=1e-6)
    assert s["kv_utilization_peak"] == pytest.approx(0.45)
    assert s["queue_depth_peak"] == 9
    assert s["steps_recorded"] == 10 and s["capacity"] == 64


def test_dump_jsonl_round_trips(tmp_path):
    fr = FlightRecorder(8)
    for i in range(3):
        fr.append(rec(i))
    out = tmp_path / "flight" / "steps.jsonl"
    assert fr.dump_jsonl(out) == 3
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert set(STEP_RECORD_FIELDS) - {"replica"} <= set(lines[0])


@pytest.mark.parametrize("capacity", [0, 5, 64])
def test_recorder_matches_jax(capacity):
    """Snapshot and summary equal to the JAX package's on the same seeded
    records."""
    rng = np.random.default_rng(capacity)
    port, ref = FlightRecorder(capacity), JFlightRecorder(capacity)
    for i in range(40):
        kw = dict(kind=str(rng.choice(sorted(KINDS))), tokens=int(rng.integers(0, 9)),
                  occupancy=float(rng.random()), kv_utilization=float(rng.random()),
                  queue_depth=int(rng.integers(0, 5)),
                  classes={"interactive": int(rng.integers(0, 3))})
        port.append(rec(i, **kw))
        ref.append(rec(i, **kw))
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot(7) == ref.snapshot(7)
    assert port.summary() == ref.summary()
    assert STEP_RECORD_FIELDS == __import__(
        "runbookai_tpu.engine.flight_recorder", fromlist=["x"]).STEP_RECORD_FIELDS


# ----------------------------------------------- live engine: step records


LIVE = dict(page_size=4, num_pages=64, max_batch_slots=4, prefill_chunk=8, max_seq_len=128)


def _core(weights, **kw):
    return EngineCore(CONFIGS[NAME], weights[1], TOK,
                      EngineConfig(kv_dtype=torch.float32, **{**LIVE, **kw}))


def _jcore(weights, **kw):
    return JEngineCore(JCONFIGS[NAME], weights[0], JByteTokenizer(),
                       JEngineConfig(block_pages=4, kv_dtype=jnp.float32, **{**LIVE, **kw}))


def _submit_pair(core, make_req, make_sampling, max_new: int = 6, **req_kw):
    reqs = [make_req(prompt_ids=list(text), sampling=make_sampling(
        temperature=0.0, max_new_tokens=max_new, stop_token_ids=()),
        **{k: v[i] for k, v in req_kw.items()})
        for i, text in enumerate((b"hello flight", b"recorder test"))]
    for r in reqs:
        core.submit(r)
    return reqs


def _run(core) -> int:
    steps = 0
    while core.has_work:
        core.step()
        steps += 1
    return steps


def test_live_engine_appends_one_record_per_step(weights):
    core = _core(weights, flight_recorder_steps=32)
    _submit_pair(core, EngineRequest, SamplingParams)
    steps = _run(core)
    assert core.flight.total_steps == steps
    snap = core.flight.snapshot()
    assert [r["step"] for r in snap] == list(range(steps))
    kinds = {r["kind"] for r in snap}
    assert kinds <= KINDS
    assert kinds & {"prefill", "prefill+decode", "mixed"}  # prompts ran
    for r in snap:
        assert set(STEP_RECORD_FIELDS) - {"replica"} <= set(r)
        assert 0.0 <= r["occupancy"] <= 1.0
        assert r["kv_free_pages"] >= 0 and 0.0 <= r["kv_utilization"] <= 1.0
        assert r["wall_s"] >= 0.0
    # Tokens booked across the run cover every generated token.
    assert sum(r["tokens"] for r in snap) >= 12
    s = core.flight.summary()
    assert s["steps_recorded"] == steps
    assert sum(s["dispatch_kinds"].values()) == steps


@pytest.mark.parametrize("engine", [{}, {"overlap_decode": False},
                                    {"mixed_dispatch": True}, {"step_graphs": True}],
                         ids=["overlap", "overlap_off", "mixed", "graphs"])
def test_records_match_jax_engine(weights, engine):
    """Step for step, the same dispatch kind, tokens, batch, occupancy, queue
    depth, free pages and preemptions as the JAX engine's records. (With
    ``step_graphs`` the port emulates each replay and its capture refuses a
    host read: the record reads none inside a step program.)"""
    core = _core(weights, flight_recorder_steps=64, **engine)
    jcore = _jcore(weights, flight_recorder_steps=64,
                   **{k: v for k, v in engine.items() if k != "step_graphs"})
    _submit_pair(core, EngineRequest, SamplingParams, max_new=9)
    _submit_pair(jcore, JRequest, JSampling, max_new=9)
    assert _run(core) == _run(jcore)
    keys = ("kind", "classes", "tokens", "batch", "occupancy", "queue_depth",
            "kv_free_pages", "kv_utilization", "preemptions", "kv_imported", "kv_exported",
            "step")
    got = [{k: r[k] for k in keys} for r in core.flight.snapshot()]
    want = [{k: r[k] for k in keys} for r in jcore.flight.snapshot()]
    assert got == want


@pytest.mark.parametrize("engine", [{}, {"step_graphs": True}], ids=["eager", "graphs"])
def test_flight_recorder_can_be_disabled(weights, engine):
    """``flight_recorder_steps=0``: nothing recorded, and the engine serves
    the same tokens as with the recorder on."""
    outs = []
    for steps in (0, 512):
        core = _core(weights, flight_recorder_steps=steps, **engine)
        reqs = _submit_pair(core, EngineRequest, SamplingParams, max_new=8)
        core.run_until_idle()
        outs.append([r.all_out_ids for r in reqs])
        if not steps:
            assert not core.flight.enabled
            assert core.flight.snapshot() == [] and core.flight.total_steps == 0
    assert outs[0] == outs[1]
    assert EngineConfig().flight_recorder_steps == JEngineConfig().flight_recorder_steps == 512


# ------------------------------------------------------------------ tracer


def test_tracer_spans_nested(tmp_path):
    path = tmp_path / "t.jsonl"
    tr = trace.Tracer(path)
    with tr.span("outer", phase="x"):
        with tr.span("inner"):
            pass
    tr.event("marker", note="hi")
    tr.close()
    spans = trace.read_spans(path)
    assert [s["name"] for s in spans] == ["inner", "outer", "marker"]
    by_name = {s["name"]: s for s in spans}
    assert by_name["inner"]["depth"] == 2 and by_name["outer"]["depth"] == 1
    assert by_name["outer"]["meta"] == {"phase": "x"}
    assert by_name["marker"]["ms"] == 0.0


def test_tracer_thread_safety(tmp_path):
    """Depth is per thread and lines never interleave."""
    path = tmp_path / "mt.jsonl"
    tr = trace.Tracer(path)

    def work(tag):
        for _ in range(50):
            with tr.span(f"outer-{tag}"):
                with tr.span(f"inner-{tag}"):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    tr.close()
    spans = trace.read_spans(path)
    assert len(spans) == 4 * 50 * 2
    for s in spans:
        assert s["depth"] == (2 if s["name"].startswith("inner") else 1), s


def test_tracer_disabled_is_noop():
    tr = trace.Tracer(None, enabled=False)
    with tr.span("nothing"):
        pass
    tr.event("nothing")
    assert not tr.enabled


def test_tracer_disable_warns_once(tmp_path):
    tr = trace.Tracer(tmp_path / "t.jsonl")
    with tr.span("ok"):
        pass
    tr._fh.close()  # the handle goes away mid-flight
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with tr.span("lost"):
            pass
        with tr.span("lost2"):
            pass
    assert tr.enabled is False
    assert len([w for w in caught if "tracing disabled" in str(w.message)]) == 1


def test_tracer_close_is_silent_and_flushes(tmp_path):
    tr = trace.Tracer(tmp_path / "t.jsonl")
    with tr.span("before"):
        pass
    tr.close()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr.event("after")
    assert not [w for w in caught if "tracing disabled" in str(w.message)]
    assert [s["name"] for s in trace.read_spans(tmp_path / "t.jsonl")] == ["before"]


def test_tracer_thread_context(tmp_path):
    tr = trace.Tracer(tmp_path / "t.jsonl")
    tr.set_context(request_id="corr-1")
    with tr.span("with-ctx"):
        tr.event("inner")
    tr.clear_context()
    with tr.span("no-ctx"):
        pass
    tr.close()
    spans = {s["name"]: s for s in trace.read_spans(tmp_path / "t.jsonl")}
    assert spans["with-ctx"]["ctx"] == {"request_id": "corr-1"}
    assert spans["inner"]["ctx"] == {"request_id": "corr-1"}
    assert "ctx" not in spans["no-ctx"]


def test_trace_rotates_at_byte_cap(tmp_path):
    path = tmp_path / "trace.jsonl"
    t = trace.Tracer(path, max_bytes=400)
    counter = lambda: metrics_mod.get_registry().counter(  # noqa: E731
        "runbook_trace_rotations_total", "Trace JSONL rotations at the byte cap").value
    before = counter()
    for i in range(40):
        t.event("soak", n=i, pad="x" * 30)
    t.close()
    rotated = tmp_path / "trace.jsonl.1"
    assert rotated.exists()
    assert path.stat().st_size <= 400 and rotated.stat().st_size <= 400
    assert t._rotations > 0 and counter() - before == t._rotations
    for f in (path, rotated):
        for line in f.read_text().splitlines():
            json.loads(line)


def test_trace_unbounded_when_cap_disabled(tmp_path):
    path = tmp_path / "t.jsonl"
    t = trace.Tracer(path, max_bytes=None)
    for _ in range(50):
        t.event("e", pad="y" * 100)
    t.close()
    assert not (tmp_path / "t.jsonl.1").exists()
    assert len(path.read_text().splitlines()) == 50


def test_get_tracer_reads_runbook_trace(tmp_path, monkeypatch):
    """``RUNBOOK_TRACE`` configures the process-wide tracer on first use, as
    in the JAX package; ``set_tracer(None)`` restores the null tracer."""
    monkeypatch.setattr(trace, "_global", None)
    monkeypatch.setenv("RUNBOOK_TRACE", str(tmp_path / "env.jsonl"))
    monkeypatch.setenv("RUNBOOK_TRACE_MAX_MB", "1")
    tr = trace.get_tracer()
    try:
        assert tr.enabled and tr.path == tmp_path / "env.jsonl"
        assert tr.max_bytes == 1024 * 1024 and trace.get_tracer() is tr
    finally:
        tr.close()
        trace.set_tracer(None)
    assert not trace.get_tracer().enabled
    monkeypatch.setattr(trace, "_global", None)
    monkeypatch.delenv("RUNBOOK_TRACE")
    assert trace.get_tracer() is trace._NULL


def test_summaries_match_jax():
    """``summarize_spans`` and ``dispatch_counters`` give the JAX package's
    results on the same seeded spans."""
    rng = np.random.default_rng(0)
    names = ["engine.decode", "engine.prefill", "engine.mixed", "engine.decode_spec",
             "server.request", "engine.request"]
    spans = [{"name": str(rng.choice(names)), "ms": float(rng.random() * 50)}
             for _ in range(300)]
    assert trace.summarize_spans(spans) == jtrace.summarize_spans(spans)
    assert trace.dispatch_counters(spans) == jtrace.dispatch_counters(spans)


@pytest.mark.parametrize("engine", [{}, {"mixed_dispatch": True}], ids=["split", "mixed"])
def test_engine_trace_records(weights, tmp_path, engine):
    """The engine's spans and lifecycle events: one ``engine.enqueue``,
    ``engine.admit`` and ``engine.request`` per request, each carrying the
    request's ``trace_id``; the dispatch spans recount the engine's dispatch
    counters; the record names equal the JAX engine's on the same run."""
    names = []
    for pkg, (make_core, make_req, make_sampling) in {
            "port": (_core, EngineRequest, SamplingParams),
            "jax": (_jcore, JRequest, JSampling)}.items():
        tr = (trace.Tracer if pkg == "port" else jtrace.Tracer)(tmp_path / f"{pkg}.jsonl")
        core = make_core(weights, **engine)
        core.tracer = tr
        _submit_pair(core, make_req, make_sampling, max_new=7, trace_id=["corr-0", "corr-1"])
        core.run_until_idle()
        tr.close()
        spans = trace.read_spans(tmp_path / f"{pkg}.jsonl")
        names.append(sorted(s["name"] for s in spans))
        if pkg == "port":
            for event in ("engine.enqueue", "engine.admit", "engine.request"):
                got = sorted(s["meta"]["trace_id"] for s in spans if s["name"] == event)
                assert got == ["corr-0", "corr-1"], event
            counted = trace.dispatch_counters(spans)
            assert counted == {k: core.metrics[k] for k in counted}
            done = [s["meta"] for s in spans if s["name"] == "engine.request"]
            assert all(m["generated"] == 7 and m["reason"] == "max_tokens" for m in done)
    assert names[0] == names[1]


# --------------------------------------- /metrics, /healthz, /debug/steps


@pytest.fixture(scope="module")
def server(weights):
    client = TorchCudaClient.for_testing(NAME, params=weights[1], device="cpu",
                                         max_new_tokens=6)
    srv = OpenAIServer(client, model_name=NAME, port=0)
    srv.start_background()
    try:
        yield srv
    finally:
        srv.shutdown()


def _post(srv, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _get(srv, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=TIMEOUT)


_SAMPLE_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (NaN|[+-]?Inf|[-+0-9.eE]+)$")


def test_metrics_endpoint_scrapes_cleanly(server):
    with _post(server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello"}], "max_tokens": 4}) as r:
        json.loads(r.read())
    with _get(server, "/metrics") as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE runbook_ttft_seconds histogram" in text
    assert "runbook_ttft_seconds_bucket" in text
    assert "# TYPE runbook_kv_pages_in_use gauge" in text
    assert "# TYPE runbook_requests_total counter" in text
    assert 'route="/v1/chat/completions"' in text
    count_line = [ln for ln in text.splitlines()
                  if ln.startswith("runbook_ttft_seconds_count")][0]
    assert float(count_line.split()[-1]) >= 1
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert _SAMPLE_LINE.match(line), line


def test_healthz_keeps_contract_and_adds_pressure(server):
    with _get(server, "/healthz") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok"
    for key in ("decode_tokens", "decode_steps", "prefill_tokens", "preemptions",
                "decode_time_s", "prefill_time_s", "cached_prefix_tokens",
                "spec_drafted", "spec_accepted"):
        assert key in health["metrics"], key
    assert health["uptime_s"] >= 0
    assert health["kv"]["pages_total"] > 0
    assert 0.0 <= health["kv"]["utilization"] <= 1.0


def test_request_id_echoed_and_generated(server):
    with _post(server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "id"}], "max_tokens": 3},
            headers={"x-request-id": "corr-echo-1"}) as r:
        assert r.headers["x-request-id"] == "corr-echo-1"
        json.loads(r.read())
    with _post(server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "id2"}], "max_tokens": 3}) as r:
        assert r.headers["x-request-id"].startswith("req-")
    with _post(server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "s"}], "max_tokens": 3, "stream": True},
            headers={"x-request-id": "corr-sse-2"}) as r:
        assert r.headers["x-request-id"] == "corr-sse-2"
        assert r.read().decode().rstrip().endswith("[DONE]")
    # Errors echo it too.
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/v1/chat/completions", {"messages": []},
              headers={"x-request-id": "corr-err-3"})
    assert e.value.headers["x-request-id"] == "corr-err-3"


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_request_id_propagates_to_trace_jsonl(weights, tmp_path, stream):
    """One HTTP request's x-request-id appears in the server span's ctx and in
    the engine's enqueue, admit and finish events."""
    tracer = trace.Tracer(tmp_path / "trace.jsonl")
    trace.set_tracer(tracer)
    try:
        client = TorchCudaClient.for_testing(NAME, params=weights[1], device="cpu",
                                             max_new_tokens=4)
        srv = OpenAIServer(client, model_name=NAME, port=0)
        srv.start_background()
        try:
            with _post(srv, "/v1/chat/completions", {
                    "messages": [{"role": "user", "content": "trace me"}], "max_tokens": 3,
                    "stream": stream}, headers={"x-request-id": "corr-trace-9"}) as r:
                r.read()
        finally:
            srv.shutdown()
    finally:
        trace.set_tracer(None)
        tracer.close()
    spans = trace.read_spans(tmp_path / "trace.jsonl")
    server_spans = [s for s in spans if s["name"] == "server.request"
                    and s.get("ctx", {}).get("request_id") == "corr-trace-9"]
    assert server_spans and server_spans[0]["meta"]["route"] == "/v1/chat/completions"
    for event in ("engine.enqueue", "engine.admit", "engine.request"):
        assert [s for s in spans if s["name"] == event
                and s.get("meta", {}).get("trace_id") == "corr-trace-9"], event
    done = [s for s in spans if s["name"] == "engine.request"]
    assert done[0]["meta"]["generated"] >= 1


def test_connection_burst_is_queued_not_reset(server):
    """Clients that connect all at once wait in the listen queue: none is
    reset. ``http.server``'s default queue of 5 resets part of such a burst
    while the accept loop shares the interpreter with busy threads, as it
    does with the engine's; two threads that spin stand in for it here."""
    barrier = threading.Barrier(BURST)
    busy = threading.Event()
    errors: list = []

    def spin():
        while not busy.is_set():
            sum(range(100_000))

    def post():
        barrier.wait()
        try:  # an empty conversation: the server reads the body, answers 400
            _post(server, "/v1/chat/completions", {"messages": [], "pad": "x" * 2048})
        except urllib.error.HTTPError as e:
            if e.code != 400:
                errors.append(repr(e))
        except OSError as e:
            errors.append(repr(e))

    spinners = [threading.Thread(target=spin) for _ in range(2)]
    threads = [threading.Thread(target=post) for _ in range(BURST)]
    for t in spinners + threads:
        t.start()
    for t in threads:
        t.join()
    busy.set()
    for t in spinners:
        t.join()
    assert not errors, (len(errors), errors[:3])
    assert server.httpd.request_queue_size >= BURST


def test_metric_name_and_bucket_contract(server):
    import runbookai_tpu_torch.agent.agent  # noqa: F401
    import runbookai_tpu_torch.agent.parallel_executor  # noqa: F401

    metrics = list(get_registry())
    names = [m.name for m in metrics]
    for name in ("runbook_ttft_seconds", "runbook_requests_total",
                 "runbook_agent_tool_latency_seconds", "runbook_kv_pages_in_use"):
        assert name in names
    for m in metrics:
        assert METRIC_NAME_RE.match(m.name), m.name
        assert m.type in ("counter", "gauge", "histogram"), m.name
        if isinstance(m, Histogram):
            assert m.buckets, f"{m.name} must declare explicit buckets"
            assert list(m.buckets) == sorted(m.buckets), m.name


def test_metric_gauges_release_the_engine(weights):
    """The registry's scrape callbacks hold the engine weakly: a dropped
    engine's weights and pool are freed, and its gauges read 0."""
    import gc
    import weakref

    core = _core(weights)
    ref = weakref.ref(core)
    gauge = get_registry().get("runbook_kv_pages_total")
    assert gauge.value == LIVE["num_pages"]
    del core
    gc.collect()
    assert ref() is None and gauge.value == 0


def test_debug_steps_scrape_shape(server):
    with _post(server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}) as r:
        r.read()
    with _get(server, "/debug/steps") as r:
        body = json.loads(r.read())
    assert set(body) == {"capacity", "steps_total", "steps"}
    assert body["capacity"] == 512 and body["steps_total"] > 0
    assert body["steps"], "no step records after a served request"
    for r in body["steps"]:
        assert r["kind"] in KINDS
        assert "occupancy" in r and "kv_utilization" in r
        assert "kv_free_pages" in r and "queue_depth" in r
    total = len(body["steps"])
    with _get(server, "/debug/steps?n=2") as r:
        bounded = json.loads(r.read())
    assert len(bounded["steps"]) == min(2, total)
    assert bounded["steps"][-1]["step"] >= body["steps"][-1]["step"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server, "/debug/steps?n=bogus")
    assert exc.value.code == 400
    with _get(server, "/metrics") as r:
        assert 'route="/debug/steps"' in r.read().decode()


# ------------------------------------------------------------ memory plan


PLANS = [
    # (model, max_seq_len, batch, tp, weights, kv bytes, kv scale bytes)
    ("llama3.1-8b-instruct", 32_768, 1, 1, "int8", 1, 0),
    ("llama3.1-8b-instruct", 131_072, 1, 1, "int8", 1, 0),
    ("llama3.1-8b-instruct", 131_072, 1, 4, "int8", 1, 0),
    ("llama3-70b-instruct", 131_072, 1, 16, "int8", 2, 0),
    ("llama3-70b-instruct", 8192, 1, 1, "int8", 2, 0),
    ("llama3.1-8b-instruct", 8192, 8, 1, "int8", 1, 0),
    ("llama3-8b-instruct", 8192, 8, 1, "bf16", 2, 0),
    ("llama3-8b-instruct", 8192, 8, 1, "int8", 1, 4),
]


def jax_scale_overcount(cfg, tp: int) -> int:
    """Bytes by which the JAX package's int8 plan over-counts the weight
    scales a device: it counts ``layer_matmul / dim`` of them a layer, which
    takes w_down's input width (ffn_dim) for its output width (dim); the
    port counts one an output channel, as the tree holds them."""
    return cfg.n_layers * (cfg.n_heads * cfg.head_dim + cfg.ffn_dim - 2 * cfg.dim) * 4 // tp


def jax_plan_with_exact_scales(want, cfg, tp: int, weights: str):
    """The JAX package's plan with the int8 scales counted as the tree holds
    them (:func:`jax_scale_overcount`), the pool budget grown by the same
    bytes; unchanged for bf16 weights."""
    if weights != "int8":
        return want
    w = want.weight_bytes_per_chip - jax_scale_overcount(cfg, tp)
    return dataclasses.replace(want, weight_bytes_per_chip=w, pool_budget_bytes=max(
        0, want.hbm_bytes - w - int(1.5 * GiB)))


@pytest.mark.parametrize("hbm_gib", [16, 80])
@pytest.mark.parametrize("case", PLANS, ids=[f"{m}-{s}-tp{t}-{w}-kv{k}{'s' if sc else ''}"
                                             for m, s, _, t, w, k, sc in PLANS])
def test_plan_matches_jax(case, hbm_gib):
    """Every field and the explanation equal to the JAX package's, with the
    device's memory passed to both, but for int8 weights' scales: the port
    counts one an output channel (the tree's bytes), the JAX package more
    (:func:`jax_scale_overcount`), and the pool budget differs by as much."""
    model, seq, batch, tp, wts, kvb, scale = case
    kw = dict(max_seq_len=seq, batch=batch, tp=tp, weights=wts, kv_dtype_bytes=kvb,
              kv_scale_bytes=scale, hbm_bytes=hbm_gib * GiB)
    got = plan_serving(CONFIGS[model], **kw)
    want = jax_plan_with_exact_scales(jplan_serving(JCONFIGS[model], **kw), CONFIGS[model],
                                      tp, wts)
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                       if k != "host_spill_bytes"}
    assert (got.fits, got.max_concurrent_contexts, got.context_bytes_per_chip) == (
        want.fits, want.max_concurrent_contexts, want.context_bytes_per_chip)
    assert got.explain() == want.explain()


def test_plan_scenarios_of_the_jax_tests():
    """test_long_context.py's plans, at the 16 GiB those tests assume."""
    hbm = 16 * GiB
    p = plan_serving(CONFIGS["llama3.1-8b-instruct"], max_seq_len=32_768, batch=1, tp=1,
                     weights="int8", kv_dtype_bytes=1, hbm_bytes=hbm)
    assert p.fits and p.max_concurrent_contexts >= 2, p.explain()
    assert p.kv_bytes_per_token_per_chip == 32 * 2 * 8 * 128
    solo = plan_serving(CONFIGS["llama3.1-8b-instruct"], max_seq_len=131_072, tp=1,
                        weights="int8", kv_dtype_bytes=1, hbm_bytes=hbm)
    tp4 = plan_serving(CONFIGS["llama3.1-8b-instruct"], max_seq_len=131_072, tp=4,
                       weights="int8", kv_dtype_bytes=1, hbm_bytes=hbm)
    assert not solo.fits and tp4.fits
    p70 = plan_serving(CONFIGS["llama3-70b-instruct"], max_seq_len=131_072, tp=16,
                       weights="int8", kv_dtype_bytes=2, hbm_bytes=hbm)
    assert (p70.kv_shards, p70.pg_shards) == (8, 2) and p70.fits
    assert p70.weight_bytes_per_chip < 6 * GiB
    assert plan_serving(CONFIGS["llama3-70b-instruct"], max_seq_len=8192, tp=1,
                        weights="int8", hbm_bytes=hbm).pool_budget_bytes == 0
    p8k = plan_serving(CONFIGS["llama3.1-8b-instruct"], max_seq_len=8192, batch=8, tp=1,
                       weights="int8", kv_dtype_bytes=1, hbm_bytes=hbm)
    assert p8k.fits and p8k.max_concurrent_contexts >= 8


def test_plan_needs_the_device_memory():
    """No default: the caller states the device's memory (``serve`` passes
    the card's ``total_memory``)."""
    with pytest.raises(TypeError):
        plan_serving(CONFIGS["llama3-8b-instruct"], max_seq_len=8192)
    # The 8B in bf16 on an 80 GB card: its 8,192-token contexts at batch 8.
    p = plan_serving(CONFIGS["llama3-8b-instruct"], max_seq_len=8192, batch=8,
                     weights="bf16", hbm_bytes=80 * 10**9)
    assert p.fits and p.weight_bytes_per_chip > 14 * GiB
