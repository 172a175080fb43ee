"""``python -m runbookai_tpu_torch chat "<prompt>"``: serve one chat turn.

Builds the client (random weights from ``--seed``, byte tokenizer), serves
the prompt through the engine, prints the reply, then one JSON line of
stats. ``--dtype int8`` serves int8 layer weights with bfloat16 activations;
``--kv-cache-dtype int8`` an int8 KV pool. ``--tp N`` serves on a
tensor-parallel mesh of N shards (KV page-split past the kv-head count);
with ``--device cpu`` every shard runs on the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import torch

from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.ops import paged_attention, qmm


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m runbookai_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    chat = sub.add_parser("chat", help="serve one chat turn")
    chat.add_argument("prompt")
    chat.add_argument("--model", default="llama3-8b-instruct")
    chat.add_argument("--device", default="cuda")
    chat.add_argument("--max-new-tokens", type=int, default=128)
    chat.add_argument("--seed", type=int, default=0)
    chat.add_argument("--dtype", choices=("auto", "int8"), default="auto",
                      help="auto: float32 on cpu, bfloat16 on cuda; int8: int8 "
                           "layer weights with bfloat16 activations")
    chat.add_argument("--kv-cache-dtype", choices=("auto", "bf16", "int8"),
                      default="auto", help="KV pool (auto: the activation dtype)")
    chat.add_argument("--tp", type=int, default=1,
                      help="tensor-parallel shards, one CUDA card each (on "
                           "--device cpu, all on the CPU)")
    return p


async def _chat(args) -> dict:
    dtype = args.dtype
    if dtype == "auto":
        dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    client = TorchCudaClient.build(args.model, device=args.device, dtype=dtype,
                                   kv_cache_dtype=args.kv_cache_dtype,
                                   seed=args.seed, tp=args.tp,
                                   max_new_tokens=args.max_new_tokens)
    t0 = time.perf_counter()
    try:
        resp = await client.chat("", args.prompt)
    finally:
        await client.shutdown()
    elapsed = time.perf_counter() - t0
    print(resp.content)
    n = resp.usage["completion_tokens"]
    mesh = client.core.mesh
    return {"model": args.model, "device": str(client.core.device),
            "mesh": mesh.shape if mesh is not None else None,
            "prompt_tokens": resp.usage["prompt_tokens"],
            "completion_tokens": n, "ttft_ms": resp.usage["ttft_ms"],
            "elapsed_s": elapsed, "tokens_per_s": n / elapsed if elapsed else 0.0,
            "kernel_launches": {**paged_attention.launches, **qmm.launches}}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    stats = asyncio.run(_chat(args))
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
