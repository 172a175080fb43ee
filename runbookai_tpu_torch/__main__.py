"""``python -m runbookai_tpu_torch chat|complete|ask|investigate|knowledge``.

``chat``/``complete "<prompt>"`` serve one turn.

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
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import torch

from runbookai_tpu_torch.agent.llm_parser import SCHEMA_MODELS
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.ops import paged_attention, qmm
from runbookai_tpu_torch.unported import unported
from runbookai_tpu_torch.utils.config import load_config, validate_config


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


def cmd_knowledge(args) -> int:
    """The JAX CLI's ``cmd_knowledge`` with the retriever on ``--device``."""
    from pathlib import Path

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
        cmd.add_argument("--config", help="explicit config.yaml path")
        cmd.add_argument("--yes", action="store_true", help="non-interactive approvals")
        cmd.add_argument("--device", default="cuda",
                         help="where llm.provider jax-tpu serves (default: the card)")
    ask.set_defaults(fn=cmd_ask)
    inv.set_defaults(fn=cmd_investigate)
    _knowledge_parser(sub)
    chat = sub.add_parser("chat", help="serve one chat turn")
    complete = sub.add_parser("complete", help="serve one guided-JSON completion")
    complete.add_argument("--schema", choices=sorted(SCHEMA_MODELS),
                          help="an orchestrator schema (default: any JSON document)")
    complete.add_argument("--no-guided", dest="guided", action="store_false",
                          help="serve the completion without grammar masks")
    for cmd in (chat, complete):
        cmd.set_defaults(fn=cmd_serve)
        cmd.add_argument("prompt")
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


async def _serve(args) -> dict:
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


def cmd_serve(args) -> int:
    stats = asyncio.run(_serve(args))
    print(json.dumps(stats))
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
