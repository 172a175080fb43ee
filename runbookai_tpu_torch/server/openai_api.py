"""OpenAI-compatible HTTP serving surface over the continuous-batching engine.

A port of the JAX package's ``server/openai_api.py``: ``runbook serve``
exposes the serving engine the way the ecosystem expects a model server to
look (vLLM/TGI-style), so OpenAI-client tooling can point at it unchanged.

- ``POST /v1/chat/completions``: non-streaming and ``stream: true`` (SSE
  ``data:`` chunks, ``[DONE]`` terminator, ``stream_options.include_usage``).
- ``POST /v1/completions``: the legacy raw-prompt endpoint.
- ``POST /v1/embeddings``: the bge encoder the knowledge index uses.
- ``GET /v1/models``: the served model, and each LoRA adapter as a model
  parented to it (vLLM-style adapter-as-model: a request whose ``model`` is
  an adapter's name is served with that adapter).
- ``POST /v1/adapters {"name", "path"}``: hot-loads a PEFT adapter directory
  into the running engine (403 unless ``allow_runtime_adapters``, the
  ``serve --allow-adapter-loading`` flag).
- ``GET /healthz``: liveness, the engine's metrics dict and KV-pool pressure
  (taken under the engine's step lock), uptime.
- ``GET /metrics``: Prometheus text exposition of the process registry
  (``utils/metrics.py``): requests and latency per route, the engine's
  TTFT/TPOT histograms, KV gauges, agent tool counters.
- ``GET /debug/steps?n=N``: the engine flight recorder's last N per-step
  records (``engine/flight_recorder.py``).
- ``GET /debug/workload``, ``/debug/incidents``, ``/debug/query`` and
  ``/tenants`` answer as the JAX server does with no monitor, store or
  tenant governor configured: the surface reports itself disabled.

Not ported (ROADMAP.md queue 1): multi-model routing and the fleet (item 9;
``llm.models`` with its adapters is refused when the client is built), and
tenant admission (item 9; every request is served under the interactive
class, or the class an ``x-priority`` header demotes it to).

Every response carries an ``x-request-id`` header (the client's value
echoed, else generated); the id is attached to the handler thread's tracer
context and carried through the async engine into its trace records, so a
trace JSONL line joins back to the request that produced it.

Architecture: a ``ThreadingHTTPServer`` with a dedicated asyncio loop thread
that owns the :class:`~runbookai_tpu_torch.engine.async_engine.AsyncEngine`.
Request handlers bridge with ``run_coroutine_threadsafe``, so concurrent
HTTP requests batch together inside the engine exactly as concurrent agent
investigations do. Embeddings run in the handler's thread, one request at a
time; every step graph is captured before the server starts (the client's
build captures them), so no capture is open while the encoder runs.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import TimeoutError as _FutTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from runbookai_tpu_torch.engine.request import FinishReason, FleetSaturated, SamplingParams
from runbookai_tpu_torch.model.chat_template import build_chat_prompt
from runbookai_tpu_torch.model.torch_cuda import stream_text
from runbookai_tpu_torch.sched import CLASS_NAMES, PRIORITY_INTERACTIVE, class_priority
from runbookai_tpu_torch.utils.metrics import REQUEST_LATENCY_BUCKETS, get_registry
from runbookai_tpu_torch.utils.trace import get_tracer

# Bounded route-label cardinality: anything else is scraped as "other".
_KNOWN_ROUTES = frozenset((
    "/v1/chat/completions", "/v1/completions", "/v1/embeddings",
    "/v1/adapters", "/v1/models", "/healthz", "/metrics", "/debug/steps",
    "/debug/workload", "/debug/incidents", "/debug/query", "/tenants",
))

# Every status the JAX server emits; anything novel scrapes as "other" so
# the status label stays a statically bounded set.
_KNOWN_STATUSES = frozenset((
    "200", "400", "403", "404", "429", "500", "503", "504",
))

# Retry-After for engine pool-pressure 503s: the backlog drains in
# engine-step time, so "about a second" is the honest hint.
_SHED_RETRY_AFTER_S = 1


def messages_to_prompt_parts(messages: list[dict[str, Any]]):
    """OpenAI messages -> (system, history, user) for build_chat_prompt."""
    system = ""
    turns: list[tuple[str, str]] = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content") or ""
        if isinstance(content, list):  # content-part arrays
            content = "".join(p.get("text", "") for p in content
                              if isinstance(p, dict))
        if role in ("system", "developer"):
            # 'developer' is OpenAI's successor to 'system': same slot.
            system = content if not system else f"{system}\n{content}"
        elif role in ("user", "assistant"):
            turns.append((role, content))
        elif role == "tool":
            # Tool results fold into the transcript as a user-visible
            # observation (the chat template has no separate tool role).
            tool_id = m.get("tool_call_id") or m.get("name") or "tool"
            turns.append(("user", f"[tool result {tool_id}]\n{content}"))
        else:
            raise ValueError(f"unsupported message role {role!r}")
    if turns and turns[-1][0] == "assistant":
        # Assistant prefill is not supported by the chat template; an empty
        # user turn would degrade the prompt silently (HTTP 400).
        raise ValueError(
            "the last non-system message must be a user or tool message; "
            "assistant prefill is not supported")
    user = turns.pop()[1] if turns else ""
    return system, turns, user


class _EngineBridge:
    """Owns the asyncio loop thread the AsyncEngine lives on."""

    def __init__(self, client):
        self.client = client  # TorchCudaClient
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, name="serve-loop", daemon=True)
        self._thread.start()

    def run(self, coro, timeout: Optional[float] = None):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stream(self, agen, timeout: Optional[float] = None):
        """Drain an async generator from a plain thread, yielding items.

        On a per-item timeout the pending ``__anext__`` task is cancelled on
        the loop first (that unwinds the generator's suspended await so its
        ``finally``, the engine-abort path, runs), and only then is
        ``aclose`` awaited: closing a still-running generator would raise
        RuntimeError and leak the engine request."""
        sentinel = object()

        async def _next():
            try:
                return await agen.__anext__()
            except StopAsyncIteration:
                return sentinel

        while True:
            fut = asyncio.run_coroutine_threadsafe(_next(), self.loop)
            try:
                item = fut.result(timeout)
            except _FutTimeout:
                fut.cancel()

                async def _close():
                    try:
                        await agen.aclose()
                    except RuntimeError:
                        pass  # cancellation still unwinding

                try:
                    asyncio.run_coroutine_threadsafe(_close(), self.loop).result(10)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                raise TimeoutError("stream item timed out")
            if item is sentinel:
                return
            yield item

    def shutdown(self) -> None:
        try:
            self.run(self.client.shutdown(), timeout=10)
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
        if not self._thread.is_alive():
            self.loop.close()


def _logprob_entry(tokenizer, e: dict, top_n: int) -> dict:
    """Engine logprob record -> OpenAI chat-completions schema entry."""

    def token_fields(tid: int) -> dict:
        # id_to_bytes round-trips tokens that are partial UTF-8 sequences
        # (decode([tid]) would turn them into U+FFFD); the bytes field lets
        # clients reassemble exactly these splits.
        raw = tokenizer.id_to_bytes(tid)
        return {"token": raw.decode("utf-8", errors="replace"), "bytes": list(raw)}

    out = token_fields(e["token_id"]) | {"logprob": e["logprob"]}
    out["top_logprobs"] = ([token_fields(t) | {"logprob": lp} for t, lp in e["top"][:top_n]]
                           if top_n else [])
    return out


def parse_openai_sampling(body: dict, client) -> tuple[SamplingParams, int, int]:
    """Shared OpenAI sampling-field parsing for the chat and legacy
    completions endpoints: stop, n, logprobs, penalties, seed, logit_bias,
    max_tokens (and its max_completion_tokens alias); temperature, top_p,
    top_k and max_new_tokens fall back to the client's. Returns (sampling,
    n, top_logprobs); raises ValueError on invalid input (HTTP 400)."""
    tokenizer = client.tokenizer
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    if not all(isinstance(s, str) for s in stop):
        raise ValueError("stop must be a string or list of strings")
    if len(stop) > 4:
        raise ValueError("at most 4 stop sequences")
    n = int(body.get("n", 1))
    if not 1 <= n <= 8:
        raise ValueError("n must be in [1, 8]")
    want_logprobs = bool(body.get("logprobs"))
    top_logprobs = int(body.get("top_logprobs") or 0)
    if top_logprobs and not want_logprobs:
        raise ValueError("top_logprobs requires logprobs: true")
    if not 0 <= top_logprobs <= 20:
        raise ValueError("top_logprobs must be 0..20")
    # `or 0.0`: OpenAI marks these nullable (null == default).
    presence = float(body.get("presence_penalty") or 0.0)
    frequency = float(body.get("frequency_penalty") or 0.0)
    if not -2.0 <= presence <= 2.0:
        raise ValueError("presence_penalty must be in [-2, 2]")
    if not -2.0 <= frequency <= 2.0:
        raise ValueError("frequency_penalty must be in [-2, 2]")
    seed = body.get("seed")
    if seed is not None:
        seed = int(seed)
    lb = body.get("logit_bias") or {}
    if not isinstance(lb, dict):
        raise ValueError("logit_bias must be an object of token_id -> bias")
    logit_bias = []
    for tok_id, b_val in lb.items():
        b_val = float(b_val)
        if not -100.0 <= b_val <= 100.0:
            raise ValueError("logit_bias values must be in [-100, 100]")
        tid = int(tok_id)
        if not 0 <= tid < tokenizer.vocab_size:
            raise ValueError(f"logit_bias token id {tid} out of vocab range")
        logit_bias.append((tid, b_val))
    sampling = SamplingParams(
        temperature=float(body.get("temperature", client.temperature)),
        top_p=float(body.get("top_p", client.top_p)),
        top_k=int(body.get("top_k", client.top_k)),
        max_new_tokens=int(body.get("max_tokens")
                           or body.get("max_completion_tokens")
                           or client.max_new_tokens),
        stop_token_ids=(tokenizer.eot_id, tokenizer.eos_id),
        stop_strings=tuple(stop),
        logprobs=((top_logprobs or 1) if want_logprobs else 0),
        presence_penalty=presence,
        frequency_penalty=frequency,
        seed=seed,
        logit_bias=tuple(logit_bias),
    )
    return sampling, n, top_logprobs


def _choice_samplings(sampling: SamplingParams, n: int) -> list[SamplingParams]:
    """The n choices' sampling: a fixed seed must still give n distinct
    choices, so choice i samples under seed + i (choice 0 reproduces the
    n = 1 output for that seed)."""
    if sampling.seed is None:
        return [sampling] * n
    return [sampling] + [dataclasses.replace(sampling, seed=sampling.seed + i)
                         for i in range(1, n)]


def _finish_reason(o) -> str:
    return "length" if o.finish_reason.value == "max_tokens" else "stop"


def _completion_payload(model: str, content: str, usage: dict,
                        finish: str = "stop") -> dict:
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": content},
            "finish_reason": finish,
        }],
        "usage": {
            "prompt_tokens": usage.get("prompt_tokens", 0),
            "completion_tokens": usage.get("completion_tokens", 0),
            "total_tokens": (usage.get("prompt_tokens", 0)
                             + usage.get("completion_tokens", 0)),
        },
    }


def _chunk_payload(model: str, delta: dict, finish: Optional[str],
                   chunk_id: str) -> dict:
    return {
        "id": chunk_id,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
    }


def make_handler(bridge: _EngineBridge, model_name: str, request_timeout: float,
                 allow_runtime_adapters: bool = False, embedder=None):
    client = bridge.client
    _embed_mutex = threading.Lock()
    started_at = time.time()
    registry = get_registry()
    requests_total = registry.counter(
        "runbook_requests_total", "HTTP requests served",
        labels=("route", "method", "status"))
    request_latency = registry.histogram(
        "runbook_request_latency_seconds", "HTTP request handling latency",
        labels=("route", "method"), buckets=REQUEST_LATENCY_BUCKETS)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet; metrics via /metrics
            pass

        def send_response(self, code: int, message=None) -> None:
            # Every response (JSON, SSE, errors) echoes the correlation id;
            # the hook also records the status for the route metrics.
            super().send_response(code, message)
            self._status = code
            rid = getattr(self, "_request_id", None)
            if rid:
                self.send_header("x-request-id", rid)

        def _dispatch(self, method: str, fn) -> None:
            """Route wrapper: request-id propagation, tracer context, and
            per-route request/latency instrumentation."""
            self._request_id = (self.headers.get("x-request-id")
                                or f"req-{uuid.uuid4().hex[:16]}")
            self._status = 0
            # Route label from the bare path (a query string must neither
            # split the label cardinality nor 404 a known route).
            bare = self.path.partition("?")[0]
            route = bare if bare in _KNOWN_ROUTES else "other"
            tracer = get_tracer()
            tracer.set_context(request_id=self._request_id)
            t0 = time.perf_counter()
            try:
                with tracer.span("server.request", route=route, method=method):
                    fn()
            finally:
                tracer.clear_context()
                status = str(self._status or 500)
                requests_total.labels(
                    route=route, method=method,
                    status=status if status in _KNOWN_STATUSES else "other").inc()
                request_latency.labels(route=route, method=method).observe(
                    time.perf_counter() - t0)

        def _json(self, code: int, payload: dict,
                  headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, str(value))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str,
                   retry_after: Optional[float] = None,
                   err_type: str = "invalid_request_error") -> None:
            headers = None
            if retry_after is not None:
                # Integer seconds, never 0 (a zero reads as "retry now").
                headers = {"Retry-After": max(1, math.ceil(retry_after))}
            self._json(code, {"error": {"message": message, "type": err_type}},
                       headers=headers)

        def _priority(self) -> int:
            """The request's priority class: interactive (a human usually
            waits on an HTTP response), or the class an ``x-priority`` header
            names, which may demote the request but never promote it. Only
            the canonical class names are accepted from the network.
            Raises ValueError on anything else (HTTP 400)."""
            hdr = self.headers.get("x-priority")
            if hdr is None:
                return PRIORITY_INTERACTIVE
            priority = class_priority(hdr)
            if priority not in CLASS_NAMES:
                raise ValueError(
                    f"x-priority must be one of {sorted(CLASS_NAMES.values())}, "
                    f"got {hdr!r}")
            return min(priority, PRIORITY_INTERACTIVE)

        def _resolve_model(self, requested) -> Optional[tuple[str, Optional[str]]]:
            """``(model_out, adapter)`` for the request's ``model`` field: the
            served model's name, or an adapter's name selecting that adapter
            (adapter-as-model); None with a 404 sent: unknown names are
            errors, never silent base-model serving."""
            adapter = None
            if requested and requested != model_name:
                names = client.core.lora.names if client.core.lora is not None else []
                if requested not in names:
                    self._error(404, f"model {requested!r} not found; "
                                     f"served: {[model_name] + names}")
                    return None
                adapter = requested
            return requested or model_name, adapter

        def _read_json(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            return body

        def do_GET(self) -> None:  # noqa: N802 — http.server API
            self._dispatch("GET", self._route_get)

        def do_POST(self) -> None:  # noqa: N802
            self._dispatch("POST", self._route_post)

        def _route_get(self) -> None:
            # Every route matches on the bare path.
            path, _, query = self.path.partition("?")
            if path == "/debug/steps":
                self._debug_steps(query)
            elif path == "/debug/workload":
                # No workload monitor: the surface reports itself disabled
                # (not 404: a client tells "off" from "no server").
                self._json(200, {"enabled": False, "models": {}})
            elif path == "/debug/query":
                # No metric history store: disabled, echoing the expression.
                expr = (urllib.parse.parse_qs(query).get("expr") or [""])[0]
                self._json(200, {"enabled": False, "expr": expr, "result": []})
            elif path == "/debug/incidents":
                self._json(200, {"enabled": False, "open": []})
            elif path == "/v1/models":
                models = [{"id": model_name, "object": "model", "owned_by": "runbookai-tpu"}]
                if client.core.lora is not None:
                    # vLLM-style: LoRA adapters are served as model names.
                    models += [{"id": n, "object": "model", "owned_by": "runbookai-tpu",
                                "parent": model_name} for n in client.core.lora.names]
                self._json(200, {"object": "list", "data": models})
            elif path == "/healthz":
                self._json(200, {"status": "ok", "model": model_name,
                                 "uptime_s": round(time.time() - started_at, 3),
                                 **client.health_snapshot()})
            elif path == "/tenants":
                # No tenant governor: disabled, as /debug/workload.
                self._json(200, {"enabled": False, "tenants": {}})
            elif path == "/metrics":
                body = registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._error(404, f"no route {self.path}")

        def _debug_steps(self, query: str) -> None:
            """``GET /debug/steps[?n=N]``: the flight recorder's last N
            per-step records (dispatch kind, tokens, occupancy, queue depth,
            KV pressure, wall split)."""
            n = 128
            for part in query.split("&"):
                if part.startswith("n="):
                    try:
                        n = max(0, int(part[2:]))
                    except ValueError:
                        self._error(400, f"bad n value {part[2:]!r}")
                        return
            self._json(200, client.engine.debug_steps(n))

        def _route_post(self) -> None:
            if self.path == "/v1/adapters":
                self._load_adapter()
                return
            if self.path == "/v1/embeddings":
                self._embeddings()
                return
            if self.path == "/v1/completions":
                self._legacy_completions()
                return
            if self.path != "/v1/chat/completions":
                self._error(404, f"no route {self.path}")
                return
            try:
                body = self._read_json()
                messages = body.get("messages") or []
                if not messages:
                    raise ValueError("messages is required")
                system, history, user = messages_to_prompt_parts(messages)
                resolved = self._resolve_model(body.get("model"))
                if resolved is None:
                    return  # 404 already sent
                model_out, adapter = resolved
                sampling, n, top_logprobs = parse_openai_sampling(body, client)
                # response_format json_object -> grammar-constrained decoding
                # (the engine's guided JSON automaton): a valid JSON prefix
                # by construction, a complete document unless max_tokens cut.
                rf = body.get("response_format") or {}
                if not isinstance(rf, dict):
                    raise ValueError("response_format must be an object "
                                     "like {\"type\": \"json_object\"}")
                rf_type = rf.get("type", "text")
                if rf_type not in ("text", "json_object"):
                    raise ValueError("response_format.type must be text or json_object")
                sampling.guided = "json" if rf_type == "json_object" else None
                priority = self._priority()
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._error(400, str(e))
                return

            ids = client.tokenizer.encode(build_chat_prompt(
                system, user, history=history, fmt=client.chat_format))
            try:
                if body.get("stream"):
                    if n != 1:
                        self._error(400, "stream with n > 1 is unsupported")
                        return
                    so = body.get("stream_options") or {}
                    self._stream_response(ids, sampling, top_logprobs=top_logprobs,
                                          include_usage=bool(so.get("include_usage")),
                                          priority=priority, model=model_out,
                                          adapter=adapter)
                    return
                outs = self._generate([ids], sampling, n, priority, adapter)
                if outs is None:
                    return  # error already sent
                tok = client.tokenizer

                def choice(i, o):
                    c = {"index": i,
                         "message": {"role": "assistant", "content": o.text},
                         "finish_reason": _finish_reason(o)}
                    if o.logprobs is not None:
                        c["logprobs"] = {"content": [
                            _logprob_entry(tok, e, top_logprobs) for e in o.logprobs]}
                    return c

                payload = _completion_payload(
                    model_out, "",
                    {"prompt_tokens": len(ids),
                     "completion_tokens": sum(o.decode_tokens for o in outs)})
                # prompt_tokens counts the shared prompt once for n > 1, so
                # cached_tokens stays a subset of it: the most any choice
                # was served from the cache.
                payload["usage"]["prompt_tokens_details"] = {
                    "cached_tokens": max(o.cached_tokens for o in outs)}
                payload["choices"] = [choice(i, o) for i, o in enumerate(outs)]
                self._json(200, payload)
            except (TimeoutError, _FutTimeout):
                self._error(504, "generation timed out")
            except BrokenPipeError:
                pass  # the client went away

        def _generate(self, all_ids: list[list[int]], sampling: SamplingParams, n: int,
                      priority: int, adapter: Optional[str] = None):
            """n choices of each prompt, all submitted at once so the engine
            batches them (prompt-major order). Returns the outputs, or None
            with the error already sent: 504 on a timeout, 503 when the
            engine aborted a request (it can never fit the pool). Each
            request's engine-side timeout aborts it before raising; the
            bridge timeout is only a belt over a wedged loop thread."""

            async def _gen_all():
                # return_exceptions: every sibling runs to its own terminal
                # state, so nothing keeps decoding unobserved after an error.
                return await asyncio.gather(*[
                    client.engine.generate(ids, sp, timeout_s=request_timeout,
                                           priority=priority, adapter=adapter,
                                           request_id=self._request_id)
                    for ids in all_ids for sp in _choice_samplings(sampling, n)],
                    return_exceptions=True)

            outs = bridge.run(_gen_all(), timeout=request_timeout + 60)
            err = next((o for o in outs if isinstance(o, BaseException)), None)
            if err is not None:
                if isinstance(err, (TimeoutError, _FutTimeout)):
                    self._error(504, "generation timed out")
                    return None
                raise err
            if any(o.finish_reason.value == "aborted" for o in outs):
                self._error(503, "request aborted by the engine "
                                 "(insufficient KV capacity)",
                            retry_after=_SHED_RETRY_AFTER_S)
                return None
            return outs

        def _legacy_completions(self) -> None:
            """Legacy ``/v1/completions``: raw-prompt text completion, no chat
            template. ``prompt`` may be a string or a list of strings
            (len(prompt) * n choices, prompt-major); the shared sampling
            fields apply and ``logprobs`` is the classic int (top-N per
            sampled token). Not streamed: use ``/v1/chat/completions``."""
            try:
                body = self._read_json()
                if body.get("stream"):
                    raise ValueError("stream is not supported on /v1/completions; "
                                     "use /v1/chat/completions")
                prompts = body.get("prompt")
                if isinstance(prompts, str):
                    prompts = [prompts]
                if (not prompts or not isinstance(prompts, list)
                        or not all(isinstance(p, str) for p in prompts)):
                    raise ValueError("prompt must be a string or list of strings")
                if len(prompts) > 8:
                    raise ValueError("at most 8 prompts per request")
                resolved = self._resolve_model(body.get("model"))
                if resolved is None:
                    return  # 404 already sent
                model_out, adapter = resolved
                sampling, n, _ = parse_openai_sampling(body, client)
                lp_n = int(body.get("logprobs") or 0)
                if not 0 <= lp_n <= 5:
                    raise ValueError("logprobs must be 0..5")
                sampling.logprobs = lp_n
                echo = bool(body.get("echo"))
                priority = self._priority()
                tok = client.tokenizer
                # Tokenize each prompt once: the same ids feed the engine and
                # the usage count.
                all_ids = [tok.encode(p) for p in prompts]
                outs = self._generate(all_ids, sampling, n, priority, adapter)
                if outs is None:
                    return  # error already sent

                def legacy_lp(o, text_start: int):
                    if not lp_n or not o.logprobs:
                        return None
                    tokens, tlps, tops, offsets = [], [], [], []
                    off = text_start
                    for e in o.logprobs:
                        raw = tok.id_to_bytes(e["token_id"]).decode("utf-8", "replace")
                        tokens.append(raw)
                        tlps.append(e["logprob"])
                        tops.append({tok.id_to_bytes(t).decode("utf-8", "replace"): lp
                                     for t, lp in e["top"][:lp_n]})
                        offsets.append(off)
                        off += len(raw)
                    return {"tokens": tokens, "token_logprobs": tlps,
                            "top_logprobs": tops, "text_offset": offsets}

                choices = []
                for pi, p in enumerate(prompts):
                    for i in range(n):
                        o = outs[pi * n + i]
                        choices.append({
                            "index": pi * n + i,
                            "text": (p + o.text) if echo else o.text,
                            "logprobs": legacy_lp(o, len(p) if echo else 0),
                            "finish_reason": _finish_reason(o),
                        })
                prompt_tokens = sum(len(ids) for ids in all_ids)
                completion_tokens = sum(o.decode_tokens for o in outs)
                self._json(200, {
                    "id": f"cmpl-{uuid.uuid4().hex[:12]}",
                    "object": "text_completion",
                    "created": int(time.time()),
                    "model": model_out,
                    "choices": choices,
                    "usage": {
                        "prompt_tokens": prompt_tokens,
                        "completion_tokens": completion_tokens,
                        "total_tokens": prompt_tokens + completion_tokens,
                    },
                })
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._error(400, str(e))
            except (TimeoutError, _FutTimeout):
                self._error(504, "generation timed out")
            except BrokenPipeError:
                pass  # the client went away

        def _embeddings(self) -> None:
            """OpenAI embeddings API over the bge encoder (the same encoder
            the knowledge index uses)."""
            if embedder is None:
                self._error(400, "no embedder configured "
                                 "(knowledge.embedder.enabled + model_path)")
                return
            emb_model = getattr(embedder.cfg, "name", "bge")
            try:
                body = self._read_json()
                requested = body.get("model")
                if requested and requested != emb_model:
                    # Same policy as chat: no silent model substitution.
                    self._error(404, f"model {requested!r} not found; "
                                     f"embeddings model: {emb_model}")
                    return
                texts = body.get("input")
                if isinstance(texts, str):
                    texts = [texts]
                if (not isinstance(texts, list) or not texts
                        or not all(isinstance(t, str) for t in texts)):
                    raise ValueError("input must be a string or list of strings")
                if len(texts) > 256:
                    raise ValueError("at most 256 inputs per request")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._error(400, str(e))
                return
            try:
                # One request at a time: the Embedder's cache and stats are
                # not thread-safe across handler threads.
                with _embed_mutex:
                    vecs = embedder.embed_texts(texts)
                n_tokens = embedder.estimate_tokens(texts)
                self._json(200, {
                    "object": "list",
                    "model": emb_model,
                    "data": [{"object": "embedding", "index": i,
                              "embedding": [float(x) for x in v]}
                             for i, v in enumerate(vecs)],
                    "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
                })
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001 — compute failures -> 500
                self._error(500, f"embedding failed ({type(e).__name__})")

        def _load_adapter(self) -> None:
            """Hot-load a LoRA adapter into the running engine: ``POST
            /v1/adapters {"name": ..., "path": <PEFT dir>}``. The registry
            loads the directory in this thread; the engine's refresh then
            runs on its own thread under the step lock (a new row drains the
            in-flight window and captures the step graphs again), so the next
            dispatch serves the new adapter."""
            if not allow_runtime_adapters:
                # Loading arbitrary server-side paths is an operator action;
                # gate it (vLLM gates its equivalent the same way).
                self._error(403, "runtime adapter loading is disabled; "
                                 "start with --allow-adapter-loading")
                return
            if client.core.lora is None:
                self._error(400, "engine has no LoRA registry (configure "
                                 "llm.lora_rank/lora_targets)")
                return
            try:
                body = self._read_json()
                name, path = body["name"], body["path"]
                if not isinstance(name, str) or not isinstance(path, str):
                    raise ValueError("name and path must be strings")
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
                self._error(400, f"expected {{name, path}}: {e}")
                return
            try:
                client.core.lora.load_peft_dir(name, path)
            except (OSError, TypeError, ValueError, KeyError) as e:
                # No raw OS error text: it would leak filesystem detail.
                import logging

                logging.getLogger(__name__).warning("adapter load %r failed: %s", name, e)
                self._error(400, f"could not load adapter {name!r} ({type(e).__name__})")
                return
            try:
                bridge.run(client.engine.refresh_lora(), timeout=60)
            except (TimeoutError, _FutTimeout):
                self._error(504, f"adapter {name!r} registered but the engine refresh "
                                 f"timed out; it activates on the next request")
                return
            self._json(200, {"loaded": name, "adapters": client.core.lora.names})

        def _stream_response(self, ids, sampling, top_logprobs: int,
                             include_usage: bool, priority: int, model: str,
                             adapter: Optional[str] = None) -> None:
            tokenizer = client.tokenizer
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(payload: dict) -> None:
                data = f"data: {json.dumps(payload)}\n\n".encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def send_terminator(extra: bytes = b"") -> None:
                done = extra + b"data: [DONE]\n\n"
                self.wfile.write(f"{len(done):x}\r\n".encode() + done + b"\r\n0\r\n\r\n")
                self.wfile.flush()

            chunk_id = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            send_chunk(_chunk_payload(model, {"role": "assistant"}, None, chunk_id))
            state: dict = {}
            # With logprobs, the live EngineRequest rides along (entries
            # accumulate on the engine thread; list reads are safe) and each
            # chunk carries the entries of the tokens consumed since the last.
            req_sink: list = []
            agen = stream_text(client.engine, tokenizer, ids, sampling, state=state,
                               priority=priority, request_sink=req_sink,
                               request_id=self._request_id, adapter=adapter)
            lp_sent = 0

            def chunk_logprobs() -> Optional[dict]:
                nonlocal lp_sent
                if not sampling.logprobs or not req_sink:
                    return None
                entries = req_sink[0].out_logprobs
                upto = min(len(entries),
                           state.get("n_tokens", 0) - (1 if state.get("saw_stop") else 0))
                if upto <= lp_sent:
                    return None
                out = {"content": [_logprob_entry(tokenizer, e, top_logprobs)
                                   for e in entries[lp_sent:upto]]}
                lp_sent = upto
                return out

            try:
                for piece in bridge.stream(agen, timeout=request_timeout):
                    payload = _chunk_payload(model, {"content": piece}, None, chunk_id)
                    lp = chunk_logprobs()
                    if lp is not None:
                        payload["choices"][0]["logprobs"] = lp
                    send_chunk(payload)
                # A stream the engine aborted ends with an explicit error
                # event: never a silent "stop" truncation, never a hang.
                if req_sink and req_sink[-1].finish_reason is FinishReason.ABORTED:
                    send_terminator(b'data: {"error": {"message": "stream aborted '
                                    b'by the engine (replica failure or shed)"}}\n\n')
                    return
                # max_tokens truncation reports "length", like non-stream.
                finish = ("length" if not state.get("saw_stop")
                          and state.get("n_tokens", 0) >= sampling.max_new_tokens
                          else "stop")
                final = _chunk_payload(model, {}, finish, chunk_id)
                lp_tail = chunk_logprobs()  # entries past the last piece
                if lp_tail is not None:
                    final["choices"][0]["logprobs"] = lp_tail
                send_chunk(final)
                if include_usage:
                    # One extra chunk after the finish chunk, with empty
                    # choices (OpenAI's shape).
                    n_out = state.get("n_tokens", 0)
                    send_chunk({
                        "id": chunk_id,
                        "object": "chat.completion.chunk",
                        "created": int(time.time()),
                        "model": model,
                        "choices": [],
                        "usage": {"prompt_tokens": len(ids),
                                  "completion_tokens": n_out,
                                  "total_tokens": len(ids) + n_out},
                    })
                send_terminator()
            except (BrokenPipeError, ConnectionResetError):
                # The client disconnected mid-stream: close the generator so
                # the AsyncEngine aborts the request and frees its slot and
                # pages.
                try:
                    bridge.run(agen.aclose(), timeout=10)
                except Exception:  # noqa: BLE001 — the socket is gone anyway
                    pass
            except (TimeoutError, _FutTimeout):
                # bridge.stream already cancelled and closed the generator
                # (the engine abort ran). Headers are out, so end the body
                # well-formed with an error event, never a 504.
                try:
                    send_terminator(b'data: {"error": {"message": '
                                    b'"generation timed out"}}\n\n')
                except OSError:
                    pass
            except FleetSaturated:
                # Kept from the JAX server's contract; the port has no fleet
                # and never sheds.
                try:
                    send_terminator(b'data: {"error": {"message": '
                                    b'"all fleet replicas are saturated '
                                    b'(request shed)"}}\n\n')
                except OSError:
                    pass

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen queue for bursts: the default of
    5 resets part of a burst of connections while the accept loop waits on
    the interpreter beside the engine's thread."""

    request_queue_size = 1024


class OpenAIServer:
    """Lifecycle wrapper: build, serve_forever (or background), shutdown."""

    def __init__(self, client, model_name: str, host: str = "127.0.0.1",
                 port: int = 8000, request_timeout: float = 600.0,
                 allow_runtime_adapters: bool = False, embedder=None):
        self.bridge = _EngineBridge(client)
        try:
            self.httpd = _HTTPServer(
                (host, port), make_handler(self.bridge, model_name, request_timeout,
                                           allow_runtime_adapters, embedder))
        except OSError:
            self.bridge.shutdown()
            raise
        self.model_name = model_name
        self.embedder = embedder
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def client(self):
        return self.bridge.client

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        self._thread = threading.Thread(target=self.serve_forever, name="openai-http",
                                        daemon=True)
        self._thread.start()
        return self._thread

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.bridge.shutdown()
