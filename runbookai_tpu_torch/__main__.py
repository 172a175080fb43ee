"""``python -m runbookai_tpu_torch <command>``: chat, complete, ask, investigate,
knowledge, eval, simulate, serve, deploy, demo, status, init, config,
checkpoint, weights.

``chat``/``complete "<prompt>"`` serve one turn. ``chat`` without a prompt
is the JAX CLI's interactive conversation over the agent loop (``--raw``:
its direct streaming chat with the model), on ``--config``'s runtime.

Builds the client (the HF weights directory of ``--model-path`` or
``$RUNBOOK_WEIGHTS`` when there is one, else random weights from ``--seed``;
the tokenizer of ``--tokenizer-path`` or of the weights directory, else the
byte tokenizer), serves the prompt through the engine, prints the reply,
then one JSON line of stats. ``chat`` serves a chat turn; ``complete`` a
completion under guided JSON decoding (the generic JSON automaton, or
``--schema NAME``, one of the six orchestrator schemas; ``--no-guided``
serves it unguided). ``--dtype int8`` serves int8 layer weights with
bfloat16 activations; ``--kv-cache-dtype int8`` an int8 KV pool,
``--kv-cache-dtype fp8`` an fp8 (e4m3) one. ``--tp N``
serves on a tensor-parallel mesh of N shards (KV page-split past the
kv-head count); with ``--device cpu`` every shard runs on the CPU.

``ask "<question>"`` runs the free-form agent loop and ``investigate
<incident id>`` the structured investigation, as the JAX package's
``runbook ask``/``runbook investigate`` do: the runtime comes from
``--config`` (else ``.runbook/config.yaml``, else the defaults: the mock
provider), ``llm.provider: jax-tpu`` serving through
``TorchCudaClient.from_config`` on ``--device`` (default: the card). They
print the agent's events; ``investigate`` then the hypothesis tree, its
summary and the root cause, and saves the final checkpoint under
``<runbook_dir>/checkpoints``. Where ``knowledge.sources`` are configured or
``knowledge.db`` exists, both run over the knowledge base: the hybrid
retriever, the ``search_knowledge`` tool and, with
``<runbook_dir>/service-graph.json``, the service topology.

``knowledge sync|search <query>|stats|add <file>|validate`` run the JAX
package's ``runbook knowledge`` on the same config and ``knowledge.db``: the
bge encoder and the vector matrix on ``--device`` (default: the card).

``eval`` and ``simulate generate|faults|investigate|eval|provision`` are the
JAX package's ``runbook eval`` and ``runbook simulate``, with its flags and
defaults: ``eval --offline`` scores fixture results without a model, ``eval``
runs each fixture case as a live investigation (``evalsuite/runner.py::
run_live``, ``--concurrency`` at a time on one engine) and ``eval --all`` the
public benchmarks' converted datasets; ``simulate`` generates seeded fault
scenarios, investigates one, or runs N of them through ``run_live`` with a
per-family and adversarial breakdown. The commands that serve the model
build it from ``--config`` on ``--device`` (default: the card). ``eval
--shard auto`` and ``simulate provision --apply`` are not ported.

``serve`` is the JAX package's ``runbook serve``: the OpenAI-compatible HTTP
server (``server/openai_api.py``) over ``TorchCudaClient.from_config`` on
``--device`` (default: the card), at ``--host``/``--port``. It requires
``llm.provider: jax-tpu``, prints the memory plan (on the card) and the URL
line, serves ``/v1/embeddings`` on ``knowledge.embedder`` when it names real
weights (``model_path``) or a test model, and stops on an interrupt.
``llm.lora_adapters`` serves each adapter by name and ``llm.draft_model``
drafts the engine's speculation; ``--allow-adapter-loading`` opens ``POST
/v1/adapters``, which hot-loads a PEFT directory into the running engine.

``deploy``, ``demo``, ``status``, ``init``, ``config`` and ``checkpoint
list|show|delete`` are the JAX CLI's commands of those names. ``weights
convert <hf dir> <out>`` writes the port's weight checkpoint
(``models/checkpoint.py``; ``--int8``, ``--random-init``), which
``--model-path`` and ``llm.model_path`` then load, and ``weights info``
prints its config.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from runbookai_tpu_torch.agent.llm_parser import SCHEMA_MODELS
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.ops import paged_attention, qmm
from runbookai_tpu_torch.unported import unported
from runbookai_tpu_torch.utils.config import (
    Config,
    load_config,
    save_config,
    set_config_value,
    validate_config,
)


_token_line_open = False


def _print_event(ev) -> None:
    from runbookai_tpu_torch.demo.runner import render_event

    global _token_line_open
    if ev.kind == "token":
        # Live token deltas paint inline (raw model output — tool-call
        # markup included); the parsed answer still renders afterwards.
        print(ev.data.get("delta", ""), end="", flush=True)
        _token_line_open = True
        return
    if _token_line_open:
        print(flush=True)  # close the streamed line before a normal event
        _token_line_open = False
    print(render_event(ev), flush=True)


async def _serving(llm, coro):
    """Await ``coro``, then stop ``llm``'s engine in the same event loop."""
    try:
        return await coro
    finally:
        if hasattr(llm, "shutdown"):
            await llm.shutdown()


def cmd_ask(args) -> int:
    from runbookai_tpu_torch.cli.runtime import build_agent, build_runtime

    config = load_config(path=args.config)
    runtime = build_runtime(config, interactive=not args.yes, device=args.device)
    agent = build_agent(runtime)

    async def run() -> None:
        async for ev in agent.run(args.query, session_id=args.session):
            _print_event(ev)

    asyncio.run(_serving(runtime.llm, run()))
    return 0


def cmd_investigate(args) -> int:
    from runbookai_tpu_torch.cli.hypothesis_view import render_summary, render_tree
    from runbookai_tpu_torch.cli.live_view import LiveTreeSink
    from runbookai_tpu_torch.cli.runtime import build_orchestrator, build_runtime
    from runbookai_tpu_torch.session.checkpoint import CheckpointStore

    config = load_config(path=args.config)
    runtime = build_runtime(config, interactive=not args.yes, device=args.device)
    orch = build_orchestrator(runtime, incident_id=args.incident_id,
                              execute_remediation=args.execute)
    # Live hypothesis tree repaints under the event stream on TTYs; pipes
    # get plain line events.
    live = LiveTreeSink(orch.machine, fallback=_print_event)
    orch.event_sink = live
    result = asyncio.run(_serving(runtime.llm, orch.investigate(
        args.incident_id, args.description or "")))
    live.finish()
    store = CheckpointStore(f"{config.runbook_dir}/checkpoints")
    store.save_machine(orch.machine, label="final")
    hypotheses = list(orch.machine.hypotheses.values())
    if hypotheses:
        color = sys.stdout.isatty()
        print("\n" + render_tree(hypotheses, color=color))
        print(render_summary(hypotheses, color=color))
    print(f"\nroot cause: {result.root_cause}")
    print(f"confidence: {result.confidence}")
    print(f"services:   {', '.join(result.affected_services)}")
    return 0


def cmd_deploy(args) -> int:
    """Deploy via the deploy-service skill through the agent loop:
    pre-deployment checks first; mutations route through the safety and
    approval gate like any other remediation."""
    from runbookai_tpu_torch.cli.runtime import build_agent, build_runtime

    config = load_config(path=args.config)
    runtime = build_runtime(config, interactive=not args.yes, device=args.device)
    agent = build_agent(runtime)
    version = f" version {args.version}" if args.version else ""
    if args.dry_run:
        query = (f"Show me what would happen if I deploy {args.service} to "
                 f"{args.environment}{version}. Do not execute, just explain "
                 "the steps.")
    else:
        query = (f"Deploy {args.service} to {args.environment}{version} using "
                 "the deploy-service skill. Perform all pre-deployment checks "
                 "first.")
    print(f"Deploying {args.service} to {args.environment}..."
          + (" (dry run)" if args.dry_run else ""))

    async def run() -> None:
        async for ev in agent.run(query):
            _print_event(ev)

    asyncio.run(_serving(runtime.llm, run()))
    return 0


def _read_turns(prompt: str):
    """The lines typed at ``prompt`` until an empty line, ``exit``/``quit``,
    end of input or an interrupt."""
    while True:
        try:
            line = input(prompt).strip()
        except (EOFError, KeyboardInterrupt):
            return
        if not line or line in ("exit", "quit"):
            return
        yield line


def cmd_chat(args) -> int:
    """``chat "<prompt>"`` serves one turn (:func:`cmd_turn`); ``chat``
    alone is the JAX CLI's interactive conversation over the agent loop,
    with a ``ConversationMemory`` carrying the earlier turns, and ``chat
    --raw`` its direct streaming chat with the model."""
    if args.prompt is not None:
        return cmd_turn(args)
    from runbookai_tpu_torch.agent.memory import ConversationMemory
    from runbookai_tpu_torch.cli.runtime import build_agent, build_runtime

    config = load_config(path=args.config)
    runtime = build_runtime(config, device=args.device)
    if args.raw:
        return _chat_raw(runtime)
    agent = build_agent(runtime)
    memory = ConversationMemory(summarize_after_messages=16)
    print("runbook chat — empty line or 'exit' to quit")

    async def turn(text: str) -> None:
        memory.add("user", text)
        answer = ""
        query = text
        context = memory.context_block()
        if context:
            query = f"{context}\n\n# Current question\n{text}"
        async for ev in agent.run(query):
            if ev.kind == "answer":
                answer = ev.data["text"]
            _print_event(ev)
        memory.add("assistant", answer)
        if memory.needs_summarization:
            await memory.summarize(runtime.llm)

    for line in _read_turns("\nyou> "):
        asyncio.run(turn(line))
    if hasattr(runtime.llm, "shutdown"):
        asyncio.run(runtime.llm.shutdown())
    return 0


def _chat_raw(runtime) -> int:
    """Direct model chat (no agent loop): tokens print as they stream."""
    history: list[tuple[str, str]] = []
    llm = runtime.llm
    print("runbook chat --raw — streaming model chat; empty line to quit")

    async def turn(text: str) -> None:
        pieces = []
        # Earlier turns ride in the prompt (this path has no
        # ConversationMemory; without them every turn would be stateless).
        if history:
            transcript = "\n".join(f"{role}: {msg}" for role, msg in history)
            prompt = (f"# Conversation so far\n{transcript}\n\n"
                      f"# Current message\n{text}")
        else:
            prompt = text
        async for ev in llm.chat_stream("You are a concise SRE assistant.", prompt):
            if ev.get("type") == "text":
                pieces.append(ev["delta"])
                print(ev["delta"], end="", flush=True)
        print()
        history.append(("user", text))
        history.append(("assistant", "".join(pieces)))

    for line in _read_turns("\nyou> "):
        asyncio.run(turn(line))
    if hasattr(llm, "shutdown"):
        asyncio.run(llm.shutdown())
    return 0


def cmd_demo(args) -> int:
    from runbookai_tpu_torch.demo.runner import run_demo

    run_demo(emit=_print_event, fast=args.fast)
    return 0


def cmd_status(args) -> int:
    config = load_config(path=args.config)
    problems = validate_config(config)
    print(f"llm provider: {config.llm.provider} ({config.llm.model})")
    enabled = []
    if config.providers.aws.enabled:
        enabled.append("aws" + (" (simulated)" if config.providers.aws.simulated else ""))
    if config.providers.kubernetes.enabled:
        enabled.append("kubernetes"
                       + (" (simulated)" if config.providers.kubernetes.simulated else ""))
    for name, c in (("datadog", config.observability.datadog),
                    ("prometheus", config.observability.prometheus),
                    ("pagerduty", config.incident.pagerduty),
                    ("opsgenie", config.incident.opsgenie),
                    ("slack", config.incident.slack)):
        if c.enabled:
            enabled.append(name)
    print(f"providers: {', '.join(enabled) or '(none enabled)'}")
    db = Path(config.knowledge.db_path)
    if db.is_file():
        from runbookai_tpu_torch.knowledge.store.sqlite_fts import KnowledgeStore

        stats = KnowledgeStore(db).stats()
        print(f"knowledge: {stats['documents']} docs / {stats['chunks']} chunks")
    else:
        print("knowledge: (no database — run `runbook knowledge sync`)")
    if problems:
        print("config problems:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print("config: ok")
    return 0


def cmd_init(args) -> int:
    target = Path(args.dir or ".") / ".runbook" / "config.yaml"
    if target.exists() and not args.force and not args.interactive:
        print(f"{target} already exists (use --force to overwrite)")
        return 1
    if args.interactive:
        from runbookai_tpu_torch.cli.wizard import (
            hydrate_answers,
            run_wizard,
            save_wizard_configs,
        )

        base = hydrate_answers(target.parent) if target.exists() else None
        answers = run_wizard(base=base)
        config_path, services_path = save_wizard_configs(answers, config_dir=target.parent)
        print(f"wrote {config_path} and {services_path}")
        return 0
    config = Config()
    if args.template == "simulated":
        config = Config.model_validate({
            "llm": {"provider": "mock"},
            "providers": {"aws": {"enabled": True, "simulated": True},
                          "kubernetes": {"enabled": True, "simulated": True}},
            "observability": {"datadog": {"enabled": True, "simulated": True},
                              "prometheus": {"enabled": True, "simulated": True}},
            "incident": {"pagerduty": {"enabled": True, "simulated": True}},
        })
    elif args.template == "tpu":
        config = Config.model_validate({
            "llm": {"provider": "jax-tpu", "model": "llama3-8b-instruct",
                    "dtype": "bfloat16"},
            "providers": {"aws": {"enabled": True, "simulated": True},
                          "kubernetes": {"enabled": True, "simulated": True}},
            "incident": {"pagerduty": {"enabled": True, "simulated": True}},
        })
    save_config(config, target)
    print(f"wrote {target} (template: {args.template})")
    return 0


def cmd_config(args) -> int:
    config = load_config(path=args.config)
    if args.set:
        for assignment in args.set:
            if "=" not in assignment:
                print(f"expected key=value, got {assignment!r}")
                return 1
            key, value = assignment.split("=", 1)
            config = set_config_value(config, key.strip(), value.strip())
        path = args.config or Path(".runbook") / "config.yaml"
        save_config(config, path)
        print(f"updated {path}")
    if args.show or not args.set:
        print(json.dumps(config.model_dump(mode="json"), indent=2))
    return 0


def cmd_checkpoint(args) -> int:
    from runbookai_tpu_torch.session.checkpoint import CheckpointStore

    config = load_config(path=args.config)
    store = CheckpointStore(f"{config.runbook_dir}/checkpoints")
    if args.checkpoint_cmd == "list":
        metas = store.list(args.investigation)
        for m in metas:
            print(f"{m.checkpoint_id}  {m.investigation_id:14} {m.phase:12} {m.label}")
        if not metas:
            print("(no checkpoints)")
        return 0
    if args.checkpoint_cmd == "show":
        data = store.show(args.checkpoint_id)
        if data is None:
            print("not found")
            return 1
        print(json.dumps(data, indent=2, default=str))
        return 0
    ok = store.delete(args.checkpoint_id)  # delete
    print("deleted" if ok else "not found")
    return 0 if ok else 1


def cmd_weights(args) -> int:
    """``weights convert`` writes the port's checkpoint of an HF directory
    (``models/checkpoint.py``), through ``--device``; ``weights info``
    prints a checkpoint's config."""
    from runbookai_tpu_torch.models.checkpoint import (
        checkpoint_config,
        convert_hf_to_checkpoint,
        is_checkpoint,
    )

    if args.weights_cmd == "convert":
        try:
            out = convert_hf_to_checkpoint(
                args.model_path, args.out, model_name=args.name,
                quantize_int8=args.int8, allow_random_init=args.random_init,
                device=args.device)
        except FileNotFoundError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        print(f"wrote checkpoint: {out} (int8={args.int8})")
        return 0
    if not is_checkpoint(args.path):
        print(f"not a checkpoint: {args.path}")
        return 1
    cfg = checkpoint_config(args.path)
    print(json.dumps(cfg.__dict__, indent=2))
    return 0


def cmd_knowledge(args) -> int:
    """The JAX CLI's ``cmd_knowledge`` with the retriever on ``--device``."""
    config = load_config(path=args.config)
    if args.knowledge_cmd == "auth":
        raise unported("`knowledge auth` (the Google OAuth flow, "
                       "knowledge/sources/google_auth.py)", "queue 1 item 10")

    from runbookai_tpu_torch.knowledge.retriever import create_retriever

    retriever = create_retriever(config, device=args.device)
    if args.knowledge_cmd == "sync":
        if not config.knowledge.sources:
            # Silent zero-document syncs are a config-location trap
            # (config lives at .runbook/config.yaml, not ./runbook.yaml).
            print("warning: no knowledge sources configured — add "
                  "knowledge.sources entries to .runbook/config.yaml "
                  "(see docs/CONFIG.md)", file=sys.stderr)
        counts = retriever.sync(force=args.force)
        for name, n in counts.items():
            print(f"{name}: {n} documents synced")
        print(json.dumps(retriever.stats(), indent=2, default=str))
        return 0
    if args.knowledge_cmd == "search":
        hits = retriever.hybrid.search(args.query, limit=args.limit,
                                       knowledge_type=args.type,
                                       service=args.service)
        for h in hits:
            print(f"[{h.score:.4f}] ({h.doc.knowledge_type}) {h.doc.title} "
                  f"§{h.chunk.section or '-'}")
            print(f"    {h.chunk.content[:180]}")
        if not hits:
            print("(no results)")
        return 0
    if args.knowledge_cmd == "stats":
        print(json.dumps(retriever.stats(), indent=2, default=str))
        return 0
    if args.knowledge_cmd == "add":
        from runbookai_tpu_torch.knowledge.chunker import document_from_markdown

        path = Path(args.file)
        doc = document_from_markdown(str(path), path.read_text(),
                                     default_title=path.stem)
        retriever.store.upsert_document(doc)
        if retriever.hybrid.embedder and retriever.hybrid.vectors is not None:
            embs = retriever.hybrid.embedder.embed_texts(
                [c.content for c in doc.chunks])
            retriever.hybrid.vectors.store_many([
                (c.chunk_id, doc.doc_id, embs[i]) for i, c in enumerate(doc.chunks)])
        print(f"added {doc.doc_id}: {doc.title} ({len(doc.chunks)} chunks)")
        return 0
    problems = validate_config(config)  # validate
    for p in problems:
        print(f"- {p}")
    print("ok" if not problems else f"{len(problems)} problem(s)")
    return 0 if not problems else 1


def _live_eval_report(args, cases, name: str,
                      case_labels: Optional[dict] = None) -> int:
    """Shared run-live-and-report tail for eval and simulate eval.

    ``case_labels`` (case_id -> {label: value}) adds grouped pass rates —
    simulate eval reports per-fault-family and per-adversarial-split
    accuracy with it."""
    from runbookai_tpu_torch.cli.runtime import build_runtime
    from runbookai_tpu_torch.evalsuite.runner import run_live, write_reports

    runtime = build_runtime(load_config(path=args.config), interactive=False,
                            device=args.device)
    report = asyncio.run(_serving(runtime.llm, run_live(
        cases, lambda: runtime.llm, name=name, concurrency=args.concurrency)))
    out = report.to_dict()
    if case_labels:
        out["breakdown"] = _pass_rate_breakdown(report.cases, case_labels)
    summary_path = write_reports([report], args.out)
    out_path = Path(args.out) / f"{name}.json"
    if case_labels and out_path.exists():
        # The per-case file write_reports produced, plus the breakdown.
        out_path.write_text(json.dumps(out, indent=2, default=str))
    print(json.dumps(out | {"summary_path": str(summary_path)},
                     indent=2, default=str))
    return 0 if report.pass_rate >= getattr(args, "min_pass_rate", 0.0) else 1


def _pass_rate_breakdown(case_results: list, case_labels: dict) -> dict:
    """{label_kind: {label_value: {passed, total, pass_rate}}}."""
    out: dict = {}
    for c in case_results:
        labels = case_labels.get(c.get("case_id"), {})
        for kind, value in labels.items():
            bucket = out.setdefault(kind, {}).setdefault(
                str(value), {"passed": 0, "total": 0})
            bucket["total"] += 1
            bucket["passed"] += bool(c.get("passed"))
    for kind in out.values():
        for bucket in kind.values():
            bucket["pass_rate"] = round(
                bucket["passed"] / max(1, bucket["total"]), 4)
    return out


def cmd_eval(args) -> int:
    from runbookai_tpu_torch.evalsuite.runner import (
        load_fixtures_file,
        run_live,
        run_offline,
        write_reports,
    )

    if args.run_all:
        from runbookai_tpu_torch.evalsuite.run_all import parse_shard, run_all_benchmarks

        try:
            shard = (parse_shard(args.shard)
                     if getattr(args, "shard", None) else None)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        runner = None
        if not args.offline:
            from runbookai_tpu_torch.cli.runtime import build_runtime

            runtime = build_runtime(load_config(path=args.config), interactive=False,
                                    device=args.device)
            runner = lambda cases: asyncio.run(_serving(runtime.llm, run_live(  # noqa: E731
                cases, lambda: runtime.llm, concurrency=args.concurrency)))
        aggregate = run_all_benchmarks(
            datasets_root=args.datasets_root, out_dir=args.out,
            runner=runner, min_pass_rate=args.min_pass_rate,
            setup=args.setup_datasets, shard=shard)
        print(json.dumps(aggregate, indent=2, default=str))
        return 0 if aggregate["failed"] == 0 else 1

    cases = load_fixtures_file(args.fixtures)
    if args.offline:
        report = run_offline(cases, name=args.name)
        summary_path = write_reports([report], args.out)
        print(json.dumps(report.to_dict()
                         | {"summary_path": str(summary_path)},
                         indent=2, default=str))
        return 0 if report.pass_rate >= args.min_pass_rate else 1
    return _live_eval_report(args, cases, name=args.name)


def cmd_simulate(args) -> int:
    """Incident simulator: generated fault scenarios against the fixture
    providers (seeded novel topologies + faults with ground truth)."""
    from runbookai_tpu_torch.simulate import (
        FAULT_TYPES,
        Scenario,
        generate_scenarios,
        to_eval_case,
        write_scenarios,
    )

    if args.sim_cmd == "faults":
        for name in sorted(FAULT_TYPES):
            print(name)
        return 0

    if getattr(args, "fault", None) and args.fault not in FAULT_TYPES:
        print(f"unknown fault type {args.fault!r}; valid: "
              f"{', '.join(sorted(FAULT_TYPES))}", file=sys.stderr)
        return 1

    models = [m for m in (getattr(args, "models", None) or "").split(",")
              if m] or None

    if args.sim_cmd == "generate":
        scenarios = generate_scenarios(
            args.n, seed=args.seed, fault_type=args.fault,
            adversarial=getattr(args, "adversarial", None), models=models)
        paths = write_scenarios(scenarios, args.out)
        for s, p in zip(scenarios, paths):
            line = f"{s.scenario_id}  {s.truth['fault_type']:22s}  {p}"
            if s.model:
                line += f"  model={s.model}"
            if args.reveal:
                line += f"\n    truth: {s.truth['root_cause']}"
            print(line)
        return 0

    if args.sim_cmd == "investigate":
        import tempfile

        from runbookai_tpu_torch.cli.runtime import build_agent, build_runtime

        s = Scenario.from_json(Path(args.scenario).read_text())
        config = load_config(path=args.config)
        # The scenario only exists in its fixtures: force every provider
        # into simulated mode (a real-cloud config here would query live
        # infrastructure while the CLI claims the generated fault is the
        # answer) and route the fixtures through the standard injection
        # seam (providers.aws.fixtures_path -> SimulatedCloud).
        for block in (config.providers.aws, config.providers.kubernetes,
                      config.observability.datadog,
                      config.observability.prometheus,
                      config.incident.pagerduty,
                      config.providers.github):
            block.enabled = True
            block.simulated = True
        # No simulated gitlab twin: a real client here would query live
        # infra for a synthetic incident.
        config.providers.gitlab.enabled = False
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump(s.fixtures, f)
            config.providers.aws.fixtures_path = f.name
        try:
            # SimulatedCloud reads the file eagerly inside build_runtime.
            runtime = build_runtime(config, interactive=not args.yes, device=args.device)
        finally:
            Path(f.name).unlink(missing_ok=True)
        agent = build_agent(runtime)

        async def run() -> None:
            async for ev in agent.run(s.query, incident_id=s.scenario_id):
                _print_event(ev)

        asyncio.run(_serving(runtime.llm, run()))
        print(f"\n── ground truth ({s.scenario_id}) ──")
        print(f"  fault:      {s.truth['fault_type']}")
        print(f"  root cause: {s.truth['root_cause']}")
        return 0

    if args.sim_cmd == "eval":
        scenarios = generate_scenarios(
            args.n, seed=args.seed, fault_type=args.fault,
            adversarial=getattr(args, "adversarial", None), models=models)
        cases = [to_eval_case(s) for s in scenarios]
        # Per-family + adversarial-split accuracy: the breakdown is what
        # separates reasoning from keyword overlap. Multi-model runs add a
        # per-served-model split next to them.
        labels = {s.scenario_id: {
            "fault_family": s.truth["fault_type"],
            "adversarial": s.truth.get("adversarial", "none"),
            **({"model": s.model} if s.model else {}),
        } for s in scenarios}
        print(json.dumps(triage_baseline(scenarios)), file=sys.stderr)
        return _live_eval_report(args, cases, name="simulated-incidents",
                                 case_labels=labels)

    if args.sim_cmd == "provision":
        # Real-infrastructure mode: the plan — teardown first — is printed
        # before --apply, which the port refuses.
        from runbookai_tpu_torch.simulate.provision import apply_plan, provision_plan

        s = Scenario.from_json(Path(args.scenario).read_text())
        plan = provision_plan(s)
        print(plan.render())
        if not args.apply:
            print("dry-run (pass --apply with AWS credentials to execute)")
            return 0
        status = apply_plan(plan)
        print(status)
        return 0 if status.startswith("applied") else 1

    print("unknown simulate subcommand", file=sys.stderr)
    return 1


def triage_baseline(scenarios) -> dict:
    """The deterministic triage baseline: what timeline + topology analysis
    alone (``agent/signal_triage.py``) scores on root-cause service
    identification, the floor any LLM-led investigation should beat."""
    from runbookai_tpu_torch.agent.signal_triage import triage_signals

    hits = 0
    for s in scenarios:
        fx = s.fixtures
        rep = triage_signals(
            alarms=fx["cloudwatch_alarms"], logs=fx["cloudwatch_logs"],
            dd_events=fx["datadog"]["events"],
            pods=fx["kubernetes"]["pods"],
            prom_alerts=fx["prometheus"]["alerts"],
            incident=fx["pagerduty"][0] if fx["pagerduty"] else {},
            known_services=[e["service"] for e in fx["aws"]["ecs"]])
        top = rep.candidates[0]["service"] if rep.candidates else None
        hits += top == s.truth["root_cause_service"]
    return {"triage_baseline_top1_service_accuracy": round(hits / max(1, len(scenarios)), 4),
            "cases": len(scenarios)}


def _runtime_options(parser) -> None:
    parser.add_argument("--config", help="explicit config.yaml path")
    parser.add_argument("--device", default="cuda",
                        help="where llm.provider jax-tpu serves (default: the card)")


def _eval_parsers(sub) -> None:
    """``simulate`` and ``eval`` with the JAX CLI's flags and defaults; the
    commands that serve the model also take ``--config`` and ``--device``."""
    adversarial = ["misleading_symptom", "two_fault", "signal_dropout", "mix"]
    sim = sub.add_parser("simulate",
                         help="generated fault scenarios (incident simulator)")
    sim_sub = sim.add_subparsers(dest="sim_cmd", required=True)
    sim_gen = sim_sub.add_parser("generate", help="write N scenario files")
    sim_gen.add_argument("--n", type=int, default=5)
    sim_gen.add_argument("--seed", type=int, default=0)
    sim_gen.add_argument("--fault", default=None,
                         help="pin a fault type (see: simulate faults)")
    sim_gen.add_argument("--out", default=".runbook/simulate")
    sim_gen.add_argument("--reveal", action="store_true",
                         help="print ground truth with each scenario")
    sim_gen.add_argument(
        "--adversarial", default=None, choices=adversarial,
        help="harden scenarios: stale red-herring signals on a non-culprit "
             "service, a concurrent second fault, or a dropped telemetry "
             "modality")
    sim_gen.add_argument(
        "--models", default=None, metavar="A,B",
        help="assign served model groups round-robin (multi-model "
             "fleets, llm.models) so eval load exercises model routing")
    sim_sub.add_parser("faults", help="list fault types")
    sim_inv = sim_sub.add_parser("investigate",
                                 help="run the agent against a scenario")
    sim_inv.add_argument("--scenario", required=True)
    sim_inv.add_argument("--yes", action="store_true")
    _runtime_options(sim_inv)
    sim_eval = sim_sub.add_parser("eval",
                                  help="run + score N generated scenarios")
    sim_eval.add_argument("--n", type=int, default=5)
    sim_eval.add_argument("--seed", type=int, default=0)
    sim_eval.add_argument("--fault", default=None)
    sim_eval.add_argument("--concurrency", type=int, default=4)
    sim_eval.add_argument("--min-pass-rate", type=float, default=0.0)
    sim_eval.add_argument("--out", default=".runbook/eval-reports")
    sim_eval.add_argument(
        "--adversarial", default=None, choices=adversarial,
        help="run the hardened split (reported separately in breakdown)")
    sim_eval.add_argument(
        "--models", default=None, metavar="A,B",
        help="round-robin cases across served model groups (llm.models); "
             "per-model pass rates land in the breakdown and "
             "summary.json gains model_attribution")
    _runtime_options(sim_eval)
    sim_prov = sim_sub.add_parser(
        "provision",
        help="real-infra mode: map a scenario onto actual AWS breakage "
             "(dry-run plan; --apply is not ported)")
    sim_prov.add_argument("scenario", help="scenario JSON file")
    sim_prov.add_argument("--apply", action="store_true",
                          help="execute the break steps (tagged, reversible)")
    sim.set_defaults(fn=cmd_simulate)

    ev = sub.add_parser("eval", help="run the investigation benchmark")
    ev.add_argument("--fixtures",
                    default="examples/evals/investigation-fixtures.sample.json")
    ev.add_argument("--offline", action="store_true",
                    help="score fixture mock_results without a model")
    ev.add_argument("--name", default="investigation")
    ev.add_argument("--out", default=".runbook/eval-reports")
    ev.add_argument("--concurrency", type=int, default=4)
    ev.add_argument("--min-pass-rate", type=float, default=0.0)
    ev.add_argument("--all", action="store_true", dest="run_all",
                    help="run every public benchmark (rcaeval/rootly/tracerca)")
    ev.add_argument("--datasets-root", default="examples/evals/datasets")
    ev.add_argument("--setup-datasets", action="store_true",
                    help="git-clone missing dataset repos first")
    ev.add_argument("--shard", default=None, metavar="I/N",
                    help="with --all: statically take cases i::n on this "
                         "host ('auto', the multihost rank, is not ported)")
    _runtime_options(ev)
    ev.set_defaults(fn=cmd_eval)


def _knowledge_parser(sub) -> None:
    """``knowledge`` and its sub-commands, as the JAX CLI parses them, each
    with ``--config`` and ``--device``."""
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", help="explicit config.yaml path")
    common.add_argument("--device", default="cuda",
                        help="where the encoder and the vectors run (default: the card)")
    kn = sub.add_parser("knowledge", help="knowledge base management")
    kn_sub = kn.add_subparsers(dest="knowledge_cmd", required=True)
    kn_sync = kn_sub.add_parser("sync", parents=[common])
    kn_sync.add_argument("--force", action="store_true")
    kn_search = kn_sub.add_parser("search", parents=[common])
    kn_search.add_argument("query")
    kn_search.add_argument("--type", default=None)
    kn_search.add_argument("--service", default=None)
    kn_search.add_argument("--limit", type=int, default=8)
    kn_sub.add_parser("stats", parents=[common])
    kn_add = kn_sub.add_parser("add", parents=[common])
    kn_add.add_argument("file")
    kn_sub.add_parser("validate", parents=[common])
    kn_auth = kn_sub.add_parser("auth", parents=[common])
    kn_auth.add_argument("provider", choices=["google"])
    kn.set_defaults(fn=cmd_knowledge)


def _session_parsers(sub) -> None:
    """``deploy``, ``demo``, ``status``, ``init``, ``config``, ``checkpoint``
    and ``weights``, with the JAX CLI's flags and defaults; each that reads
    the config takes ``--config``, and those that serve the model or touch
    weights ``--device``."""
    dep = sub.add_parser("deploy", help="deploy a service via the deploy-service skill")
    dep.add_argument("service")
    dep.add_argument("-e", "--environment", default="production")
    dep.add_argument("--version", default=None)
    dep.add_argument("--dry-run", action="store_true")
    dep.add_argument("--yes", action="store_true",
                     help="non-interactive: no CLI prompts; mutations are denied "
                          "unless Slack approvals are configured")
    _runtime_options(dep)
    dep.set_defaults(fn=cmd_deploy)

    demo = sub.add_parser("demo", help="scripted demo investigation (no model)")
    demo.add_argument("--fast", action="store_true", help="3x speed")
    demo.set_defaults(fn=cmd_demo)

    status = sub.add_parser("status", help="config + provider status")
    status.add_argument("--config", help="explicit config.yaml path")
    status.set_defaults(fn=cmd_status)

    init = sub.add_parser("init", help="write a starter config")
    init.add_argument("--template", choices=["minimal", "simulated", "tpu"],
                      default="simulated")
    init.add_argument("--dir", default=".")
    init.add_argument("--force", action="store_true")
    init.add_argument("--interactive", "-i", action="store_true",
                      help="guided setup wizard (hydrates an existing config)")
    init.set_defaults(fn=cmd_init)

    cfg = sub.add_parser("config", help="show or set config values")
    cfg.add_argument("--set", action="append", metavar="a.b.c=value")
    cfg.add_argument("--show", action="store_true")
    cfg.add_argument("--config", help="explicit config.yaml path")
    cfg.set_defaults(fn=cmd_config)

    cp = sub.add_parser("checkpoint", help="investigation checkpoints")
    cp.add_argument("--config", help="explicit config.yaml path")
    cp_sub = cp.add_subparsers(dest="checkpoint_cmd", required=True)
    cp_list = cp_sub.add_parser("list")
    cp_list.add_argument("--investigation", default=None)
    cp_show = cp_sub.add_parser("show")
    cp_show.add_argument("checkpoint_id")
    cp_del = cp_sub.add_parser("delete")
    cp_del.add_argument("checkpoint_id")
    cp.set_defaults(fn=cmd_checkpoint)

    w = sub.add_parser("weights", help="model weight checkpoints")
    w_sub = w.add_subparsers(dest="weights_cmd", required=True)
    conv = w_sub.add_parser(
        "convert", help="HF safetensors -> the port's checkpoint (optionally int8)")
    conv.add_argument("model_path", help="HF model dir (safetensors + config)")
    conv.add_argument("out", help="output checkpoint dir")
    conv.add_argument("--int8", action="store_true",
                      help="quantize layer weights to int8 during conversion")
    conv.add_argument("--name", default="hf-model")
    conv.add_argument("--random-init", action="store_true",
                      help="allow a missing model_path (random weights; CI only)")
    conv.add_argument("--device", default="cuda",
                      help="where the weights are loaded or drawn (default: the card)")
    info = w_sub.add_parser("info", help="describe a checkpoint")
    info.add_argument("path")
    w.set_defaults(fn=cmd_weights)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m runbookai_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ask = sub.add_parser("ask", help="one-shot question through the agent loop")
    ask.add_argument("query")
    ask.add_argument("--session", default=None)
    inv = sub.add_parser("investigate", help="structured incident investigation")
    inv.add_argument("incident_id")
    inv.add_argument("--description", default="")
    inv.add_argument("--execute", action="store_true",
                     help="execute the remediation plan (approval-gated)")
    for cmd in (ask, inv):
        cmd.add_argument("--yes", action="store_true", help="non-interactive approvals")
        _runtime_options(cmd)
    ask.set_defaults(fn=cmd_ask)
    inv.set_defaults(fn=cmd_investigate)
    _knowledge_parser(sub)
    _eval_parsers(sub)
    serve = sub.add_parser("serve", help="OpenAI-compatible HTTP endpoint over the engine")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8000)
    serve.add_argument("--allow-adapter-loading", action="store_true",
                       help="enable POST /v1/adapters (operator action)")
    _runtime_options(serve)
    serve.set_defaults(fn=cmd_serve)
    _session_parsers(sub)
    chat = sub.add_parser("chat", help="serve one chat turn, or without a prompt an "
                                       "interactive conversation")
    chat.add_argument("prompt", nargs="?", default=None)
    chat.add_argument("--raw", action="store_true",
                      help="without a prompt: direct streaming model chat (no agent loop)")
    chat.add_argument("--config", help="without a prompt: explicit config.yaml path")
    chat.set_defaults(fn=cmd_chat)
    complete = sub.add_parser("complete", help="serve one guided-JSON completion")
    complete.add_argument("prompt")
    complete.add_argument("--schema", choices=sorted(SCHEMA_MODELS),
                          help="an orchestrator schema (default: any JSON document)")
    complete.add_argument("--no-guided", dest="guided", action="store_false",
                          help="serve the completion without grammar masks")
    complete.set_defaults(fn=cmd_turn)
    for cmd in (chat, complete):
        cmd.add_argument("--model", default="llama3-8b-instruct")
        cmd.add_argument("--model-path", default=None,
                         help="HF weights directory (default: $RUNBOOK_WEIGHTS, "
                              "else random weights)")
        cmd.add_argument("--tokenizer-path", default=None,
                         help="tokenizer.json or its directory (default: the "
                              "weights directory's, else the byte tokenizer)")
        cmd.add_argument("--device", default="cuda")
        cmd.add_argument("--max-new-tokens", type=int, default=128)
        cmd.add_argument("--seed", type=int, default=0)
        cmd.add_argument("--dtype", choices=("auto", "int8"), default="auto",
                         help="auto: float32 on cpu, bfloat16 on cuda; int8: int8 "
                              "layer weights with bfloat16 activations")
        cmd.add_argument("--kv-cache-dtype", choices=("auto", "bf16", "fp8", "int8"),
                         default="auto", help="KV pool (auto: the activation dtype)")
        cmd.add_argument("--tp", type=int, default=1,
                         help="tensor-parallel shards, one CUDA card each (on "
                              "--device cpu, all on the CPU)")
    return p


async def _turn(args) -> dict:
    dtype = args.dtype
    if dtype == "auto":
        dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    client = TorchCudaClient.build(args.model, device=args.device, dtype=dtype,
                                   kv_cache_dtype=args.kv_cache_dtype,
                                   seed=args.seed, tp=args.tp,
                                   model_path=args.model_path,
                                   tokenizer_path=args.tokenizer_path,
                                   max_new_tokens=args.max_new_tokens)
    t0 = time.perf_counter()
    try:
        if args.cmd == "chat":
            resp = await client.chat("", args.prompt)
            text, n, ttft = (resp.content, resp.usage["completion_tokens"],
                             resp.usage["ttft_ms"])
            prompt_tokens = resp.usage["prompt_tokens"]
        else:
            text = await client.complete(args.prompt, guided=args.guided,
                                         schema=args.schema)
            req = client.core.finished[-1]
            # A fold (preemption, fast-forward) moves output into the prompt.
            n, ttft = req.num_generated, req.ttft_ms
            prompt_tokens = len(req.prompt_ids) - len(req.folded_out_ids)
    finally:
        await client.shutdown()
    elapsed = time.perf_counter() - t0
    print(text)
    mesh = client.core.mesh
    stats = {"model": args.model, "device": str(client.core.device),
             "mesh": mesh.shape if mesh is not None else None,
             "prompt_tokens": prompt_tokens, "completion_tokens": n, "ttft_ms": ttft,
             "elapsed_s": elapsed, "tokens_per_s": n / elapsed if elapsed else 0.0,
             "kernel_launches": {**paged_attention.launches, **qmm.launches}}
    if args.cmd == "complete":
        stats.update(guided=(args.schema or "json") if args.guided else None,
                     grammar_forced_tokens=client.core.metrics["grammar_forced_tokens"])
    return stats


def cmd_turn(args) -> int:
    stats = asyncio.run(_turn(args))
    print(json.dumps(stats))
    return 0


def build_server(config, host: str = "127.0.0.1", port: int = 8000, device="cuda",
                 allow_adapter_loading: bool = False, embedder=None):
    """The ``serve`` command's server: ``TorchCudaClient.from_config(config.llm)``
    on ``device`` (every step graph captured while it is built, so none is
    captured under traffic), the memory plan printed to standard error (on
    the card: the plan for its ``total_memory``, then the bytes allocated),
    and the embedder for ``/v1/embeddings``: ``embedder`` when given, else
    ``knowledge.embedder``'s when it names real weights or a test model (a
    random-weight bge would serve noise labelled as bge embeddings).
    ``allow_adapter_loading`` enables ``POST /v1/adapters`` (hot-loading a
    PEFT directory into ``llm.lora_adapters``' registry). Returns
    ``(server, plan)``; ``plan`` is None off the card or for a model without
    a built-in config. The caller starts and shuts down the server."""
    from runbookai_tpu_torch.engine.memory_plan import plan_serving
    from runbookai_tpu_torch.models.llama import CONFIGS
    from runbookai_tpu_torch.server.openai_api import OpenAIServer

    llm = config.llm
    client = TorchCudaClient.from_config(llm, device=device)
    plan = None
    dev = client.core.device
    if dev.type == "cuda" and llm.model in CONFIGS:
        cfg = CONFIGS[llm.model]
        plan = plan_serving(
            cfg, max_seq_len=min(llm.max_seq_len, cfg.max_seq_len),
            hbm_bytes=torch.cuda.get_device_properties(dev).total_memory,
            batch=llm.max_batch_slots, tp=max(1, llm.mesh.model),
            weights="int8" if llm.dtype == "int8" else "bf16",
            # fp8/int8 pools store 1 byte per value; int8 adds one f32
            # absmax scale per (token, kv head).
            kv_dtype_bytes=1 if llm.kv_cache_dtype in ("fp8", "int8") else 2,
            kv_scale_bytes=4 if llm.kv_cache_dtype == "int8" else 0)
        print(f"memory plan: {plan.explain()}", file=sys.stderr)
        print(f"allocated: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
              f"(weights, KV pool {client.core.kv.pool.nbytes() / 2**30:.2f} GiB, "
              f"step graphs)", file=sys.stderr)
    if embedder is None:
        emb_cfg = config.knowledge.embedder
        if emb_cfg.enabled and (emb_cfg.model_path or "test" in emb_cfg.model):
            from runbookai_tpu_torch.knowledge.embedder import Embedder

            embedder = Embedder.from_config(emb_cfg, device=device)
        elif emb_cfg.enabled:
            print("note: /v1/embeddings disabled — set knowledge.embedder."
                  "model_path to serve real bge embeddings", file=sys.stderr)
    try:
        server = OpenAIServer(client, model_name=llm.model, host=host, port=port,
                              allow_runtime_adapters=allow_adapter_loading,
                              embedder=embedder)
    except OSError:
        asyncio.run(client.shutdown())
        raise
    return server, plan


def cmd_serve(args) -> int:
    """OpenAI-compatible HTTP endpoint over the serving engine."""
    config = load_config(path=args.config)
    if config.llm.provider != "jax-tpu":
        print("serve requires llm.provider: jax-tpu (a real engine to serve)",
              file=sys.stderr)
        return 1
    problems = [p for p in validate_config(config) if "llm." in p]
    if problems:
        for p in problems:
            print(f"config error: {p}", file=sys.stderr)
        return 1
    server, _ = build_server(config, host=args.host, port=args.port, device=args.device,
                             allow_adapter_loading=args.allow_adapter_loading)
    print(f"serving {server.model_name} at http://{args.host}:{server.port}/v1 "
          f"(POST /v1/chat/completions"
          + (", /v1/embeddings" if server.embedder is not None else "")
          + ", GET /v1/models, /healthz, /metrics, /debug/steps)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
