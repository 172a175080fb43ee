#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure exits non-zero; one JSON object per phase on stdout):

1. build every kernel from ``runbookai_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source (ptxas report in ``OUT_DIR/ptxas.txt``);
2. hold the decode kernel against its plain version at the serving shapes
   (B=8, 32 query / 8 kv heads, head_dim 128, 16-token pages, 513-wide
   tables, ctx 0..8191) for bf16 and f32 pools, and time it;
3. hold the chunk kernels against their plain version on a 4 x 512 prefill
   at offsets 0 and 512, a T=8 verify from ctx-1, and a chunk with a pad
   tail: bf16 queries take the tensor-core kernel (``chunk_attention.cu``),
   also on a one-row 512-token prefill at offset 4096 (64-row tiles, split
   in two), a T=8 verify at the served contexts (at most 950 tokens) and
   the tp=8 head shard's shape (4 query heads over 1 kv head), each input
   with its split count, and each split input once more unsplit; f32
   queries take the CUDA-core kernel. The merge of a split call is held
   against ``merge_partials``. The prefill and verify inputs are timed;
   both kernel phases show that the tolerance rejects a result with the
   last page dropped;
4. the same two checks over int8 pools (values + one f32 scale per token
   and kv head, quantized from random bf16) with bf16 and f32 queries: the
   int8 decode kernel (K3) and the chunk kernels over int8 pools;
5. hold the int8 weight matmul kernel (K5) against its plain version at
   the 8B's four (K, N) shapes and M = 5, 8, 64, 256, show that the
   tolerance rejects a result with the last K slice dropped, and time it
   rotating over 32 layer slices so that no call finds its weight in L2;
6. check the forward on the card (both kernels) against the checked-in HF
   golden logits and against the same forward on the CPU, then the same
   forward with int8 weights over an int8 pool against the CPU;
7. serve llama3-8b-instruct at full width (random weights from a seed)
   through ``TorchCudaClient.chat``: 5 concurrent greedy requests of 64 to
   1024 prompt tokens, 32 new tokens each. Kernel launch counts are zeroed
   just before and read just after; both must rise;
8. serve the same requests once more under torch.profiler: device time by
   kernel class and the device's idle share; it fails unless the bf16
   chunk calls ran the tensor-core kernel and never the CUDA-core kernel's
   bf16-query instantiation. Both serving phases fail if the engine loop
   crashed or a request was aborted, and the first if no split chunk call
   was merged;
9. phases 7 and 8 again with int8 weights and an int8 KV pool
   (``TorchCudaClient.build(dtype="int8", kv_cache_dtype="int8")``): the
   int8 kernels' counts must rise and the bf16 attention counts stay 0;
   then, for both configurations, the requests served twice more with every
   chunk call of the forward held against its plain version on the same
   inputs (fails beyond TOL), once serving the kernel's result and once the
   plain version's, and where their greedy streams part from phase 7's;
10. the page-split partial kernels (K4 for decode, the chunk partial for
   T > 1) on phase 2's and phase 3's inputs cut into two page shards of
   1024 pages, at the shape of one call of phase 12's path (one model
   group's 4 query heads over its kv head) and over all heads: each
   shard's (acc, m, l) against its plain version, the merge of both shards
   against K1/K2 on the unsplit pool, the rejection of a result with the
   last page dropped, and per-call times beside the memory-efficient SDPA
   call that returns the same partial normalised (out, log-sum-exp);
11. the tensor-parallel forward of llama3-8b-instruct at full width, depth
   cut to 2 layers, f32 weights and pool, on a model=8 x seq=2 and a
   model=8 x seq=1 mesh of 16 and 8 shards on the one card, against the
   unsharded forward: a prefill chunk, a decode step and a T=8 verify;
12. the requests of phase 7 served at full depth through
   ``TorchCudaClient.build(tp=16, devices=["cuda:0"] * 16)`` (model=8 x
   seq=2) over a 256-page pool: pages of both page shards must be
   allocated, the partial kernels' counts must rise and K1's and K2's
   stay 0; then once more under torch.profiler, as phase 8.

Then it prints the kernels' line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --serve-ab DIR

runs instead a same-card A/B of phases 7 to 9 (bf16 and int8 serving, each
after an unrecorded warm-up run, and their profiled reruns) between DIR,
another checkout of the repository (for example a parent commit unpacked
with ``git archive``), and this one, each by its own ``chip_smoke.py`` in a
fresh process, in the order DIR, this, this, DIR; every line goes to
``OUT_DIR/serve_ab.jsonl``. It lives here because a checkout's serving
phases are reached only through its own ``chip_smoke.py``, and it is the
committed source of PERF.md's same-card serving comparisons.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
DEVICE = "cuda"
ENGINE_MODEL = "llama3-8b-instruct"

# Decode-kernel shapes: the llama3-8b-instruct serving geometry.
B, N_Q, N_KV, HD, PS = 8, 32, 8, 128, 16
MAX_PAGES = 8192 // PS  # + 1 trash column
NUM_PAGES = 2048
DECODE_CTX = [0, 1, 16, 17, 1000, 8191, 300, 4097]
# |kernel - plain| <= ATOL + RTOL * |plain|. f32: summation order only.
# bf16: both versions compute in f32 and round the output once to bf16, so
# they may differ by one bf16 ulp (at most 2**-7 relative, under RTOL).
# Each kernel phase also shows that a result with the last page of every
# sequence dropped lies outside these limits.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 1e-2)}
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
PEAK_BYTES_S = 3.35e12
# int8 weight matmul: llama3-8b-instruct's (K, N) per layer matrix, and the
# rows of a decode step (8 slots), of a T=8 verify (64) and two edges.
QMM_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
              "wo": (4096, 4096), "w_gate": (4096, 14336), "w_up": (4096, 14336),
              "w_down": (14336, 4096)}
QMM_ROWS = (8, 64, 5, 256)
QMM_LAYERS = 32
# Page-split checks: the pool of phases 2 and 3 cut into PG page shards.
PG = 2
# forward_tp: f32 logits of the sharded forward against the unsharded one on
# the card. The row-parallel products sum 8 or 16 partial products over a
# slice of the contraction each, in another order than one cuBLAS call, and
# the page-split attention merges two flash partials: f32 rounding only.
FORWARD_TP_TOL = 1e-3
FORWARD_TP_LAYERS = 2
TP_PAGES = 256  # engine_kv_split: about 190 pages in use cross 128 per shard


_LOG = OUT_DIR / "chip_smoke.jsonl"  # every line of a run, beyond the tool's 24 KB
_since = [time.perf_counter()]


def emit(obj: dict) -> None:
    """Print one JSON line and keep it in ``_LOG``; a phase's line gains the
    seconds since the previous phase line (``phase_s``)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_s": now - _since[0]}
        _since[0] = now
    line = json.dumps(obj)
    print(line, flush=True)
    with _LOG.open("a") as f:
        f.write(line + "\n")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn``: the kernels it launches, summed by
    torch.profiler over ``iters`` calls, without the host's gaps between
    them (for calls short enough that the host's launch rate sets the
    CUDA-event time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / iters / 1e3


def host_ms(fn, iters: int = 50) -> float:
    """Host time per call of ``fn`` (checks, allocations, launches), calls
    back to back without a sync: what a serving step pays on the CPU."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def bound(n_bytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def excess(got, want, dtype_name: str):
    """|got - want| beyond the tolerance (> 0 where it fails), and |got - want|."""
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    return diff - (atol + rtol * want.float().abs()), diff


def compare(got, want, dtype_name: str, what: str) -> float:
    over, diff = excess(got, want, dtype_name)
    if not bool(diff.isfinite().all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    if float(over.max()) > 0:
        atol, rtol = TOL[dtype_name]
        raise AssertionError(f"{what}: max |err| {float(diff.max()):.3e} beyond "
                             f"atol {atol} rtol {rtol}")
    return float(diff.max())


def cut_last_page(ctx):
    """Context lengths with the last (partial or full) page cut off."""
    return ((ctx - 1).clamp_min(0) // PS * PS).to(ctx.dtype)


def drop_last_page(pa, q, k, v, tables, ctx, q_start, ref, dtype_name: str,
                   gate: bool = True) -> dict:
    """What the tolerance makes of a wrong kernel: the plain version with
    the last page of every sequence dropped, held against the sound result.
    With ``gate``, fails unless the check rejects it in every sequence that
    had keys."""
    short = cut_last_page(ctx)
    wrong = pa.plain_paged_attention(q, k, v, tables, short, q_start, PS)
    over, diff = excess(wrong, ref, dtype_name)
    live = [i for i, c in enumerate(ctx.tolist()) if c > 0]
    per_row = [float(diff[i].max()) for i in live]
    rejected = [bool(over[i].max() > 0) for i in live]
    if gate and not all(rejected):
        raise AssertionError(f"{dtype_name}: the tolerance accepts a result with the "
                             f"last page dropped (rows {live}, rejected {rejected})")
    return {"max_abs_err_by_row": per_row, "rows_rejected": sum(rejected),
            "rows": len(live)}


def make_pool(gen, dtype, ctx_lens, device):
    """Random pools, and tables whose live pages are distinct per sequence;
    entries past ctx point at random pages, the trash column at page 0."""
    import torch

    k = torch.randn((NUM_PAGES * PS, N_KV, HD), generator=gen, device=device).to(dtype)
    v = torch.randn((NUM_PAGES * PS, N_KV, HD), generator=gen, device=device).to(dtype)
    tables = torch.randint(1, NUM_PAGES, (len(ctx_lens), MAX_PAGES + 1),
                           generator=gen, device=device, dtype=torch.int32)
    tables[:, MAX_PAGES] = 0
    perm = torch.randperm(NUM_PAGES - 1, generator=gen, device=device) + 1
    nxt = 0
    for i, ctx in enumerate(ctx_lens):
        need = -(-ctx // PS)
        tables[i, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    return k, v, tables


def dequantized(pool, dtype):
    """A pool as one tensor of ``dtype`` (an int8 pool dequantized)."""
    if isinstance(pool, tuple):
        return (pool[0].float() * pool[1][..., None]).to(dtype)
    return pool


def token_bytes(pool) -> int:
    """Bytes of one cached token's K (or V) over the pool's kv heads."""
    if isinstance(pool, tuple):
        vals, scales = pool
        return vals.shape[1] * (HD * vals.element_size() + scales.element_size())
    return pool.shape[1] * HD * pool.element_size()


def gather_for_library(q4, k, v, tables, ctx_lens, kv_len):
    """[B, n_q, *, hd] operands for scaled_dot_product_attention (K/V
    dequantized, gathered through the tables and repeated over the GQA
    group)."""
    import torch

    k, v = dequantized(k, q4.dtype), dequantized(v, q4.dtype)
    n_pages = -(-kv_len // PS)
    rows = (tables[:, :n_pages].long()[:, :, None] * PS
            + torch.arange(PS, device=k.device)).reshape(len(ctx_lens), -1)
    group = q4.shape[2] // k.shape[1]
    kk = k[rows].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    vv = v[rows].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    return q4.permute(0, 2, 1, 3).contiguous(), kk, vv


def phase_build() -> dict:
    from runbookai_tpu_torch.ops import build

    t0 = time.perf_counter()
    path, report = build.build()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text(report)
    return {"phase": "build", "library": str(path.relative_to(ROOT)),
            "seconds": time.perf_counter() - t0}


def decode_case(pa, torch, q, k, v, tables, ctx, name: str) -> dict:
    """Decode kernel against its plain version on one pool (a tensor or an
    int8 tuple), the dropped-last-page check, and its times and bound."""
    import torch.nn.functional as F

    dev = q.device
    out = pa.paged_decode_attention(q, k, v, tables, ctx, PS)
    ref = pa.plain_paged_attention(q[:, None], k, v, tables, ctx, None, PS)[:, 0]
    torch.cuda.synchronize()
    err = compare(out, ref, name, f"decode {name}")
    if bool(out[0].abs().max() != 0):
        raise AssertionError("decode: a ctx-0 row must be zeros")
    wrong = drop_last_page(pa, q[:, None], k, v, tables, ctx, None,
                           ref[:, None], name)
    ms = time_ms(lambda: pa.paged_decode_attention(q, k, v, tables, ctx, PS))
    plain_ms = time_ms(lambda: pa.plain_paged_attention(
        q[:, None], k, v, tables, ctx, None, PS), iters=3, warmup=1)
    q4, kk, vv = gather_for_library(q[:, None], k, v, tables, DECODE_CTX,
                                    max(DECODE_CTX))
    mask = (torch.arange(kk.shape[2], device=dev)[None, :] < ctx[:, None].long()
            )[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), iters=5, warmup=1)
    del kk, vv
    tokens = sum(DECODE_CTX)
    n_bytes = (2 * q.numel() * q.element_size() + tokens * 2 * token_bytes(k)
               + sum(-(-c // PS) for c in DECODE_CTX) * 4 + B * 4)
    bound_ms, bound_by = bound(n_bytes, 4.0 * tokens * N_Q * HD, name)
    return {"max_abs_err": err, "tol": TOL[name], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "drop_last_page": wrong}


def phase_decode(pa, torch, int8: bool = False) -> dict:
    """K1 over bf16 and f32 pools or, with ``int8``, K3 over int8 pools
    quantized from them, with queries of the same two types."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3 if int8 else 1)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    result: dict = {"phase": "decode_int8_kernel" if int8 else "decode_kernel",
                    "ctx_lens": DECODE_CTX}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        k, v, tables = make_pool(gen, dtype, DECODE_CTX, dev)
        if int8:
            k, v = quantize_kv(k), quantize_kv(v)
        q = torch.randn((B, N_Q, HD), generator=gen, device=dev).to(dtype)
        result[name] = decode_case(pa, torch, q, k, v, tables, ctx, name)
        del k, v
    return result


# Served contexts before a T=8 verify: the serving phases' prompts (83 to
# 918 tokens) plus their completions; every ctx at most 950.
SERVED_CTX = [83, 150, 266, 397, 512, 640, 800, 942]


def chunk_inputs(torch, dev, gen, dtype, kind):
    """(q, k, v, tables, ctx, positions, real tokens per row). ``tp8_shard``
    is the verify input cut to one head shard of tp=8: 4 query heads over
    1 kv head. ``prefill_one_row`` is the engine's prefill of a single row
    (padded to 512 tokens): 256 blocks of 64 rows, so ``chunk_plan`` splits
    it in two; at offset 4096 both splits hold keys, and causal rows."""
    trash = MAX_PAGES * PS
    if kind == "prefill":  # 4 x 512 tokens at offsets 0 and 512
        t, starts, real = 512, [0, 512, 0, 512], [512] * 4
    elif kind == "prefill_one_row":  # 512 tokens at offset 4096: ctx 4608, 288 columns
        t, starts, real = 512, [4096], [512]
    elif kind in ("verify", "tp8_shard", "verify_served"):  # T=8 from ctx-1
        t = 8
        before = (SERVED_CTX if kind == "verify_served"
                  else [1, 16, 17, 1000, 8100, 300, 4097, 64])
        starts, real = [c - 1 for c in before], [8] * 8
    else:  # pad tail: 100 real tokens, a full chunk, a pad row, 37 tokens
        t, starts, real = 512, [0, 512, trash, 1024], [100, 512, 0, 37]
    ctx_lens = [s + n if n else 1 for s, n in zip(starts, real)]
    k, v, tables = make_pool(gen, dtype, ctx_lens, dev)
    pos = torch.full((len(starts), t), trash, dtype=torch.int32, device=dev)
    for i, (s, n) in enumerate(zip(starts, real)):
        if n:
            pos[i, :n] = torch.arange(s, s + n, dtype=torch.int32, device=dev)
        else:
            tables[i] = 0  # the engine's pad row: null table, ctx 1
    q = torch.randn((len(starts), t, N_Q, HD), generator=gen, device=dev).to(dtype)
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device=dev)
    if kind == "tp8_shard":
        n_q = N_Q // N_KV
        q, k, v = q[..., :n_q, :].contiguous(), k[:, :1].contiguous(), v[:, :1].contiguous()
    return q, k, v, tables, ctx, pos, real


def time_chunk(pa, torch, q, k, v, tables, ctx, pos, dtype_name: str) -> dict:
    """Kernel, plain-version and SDPA times of one chunk call, and its bound."""
    import torch.nn.functional as F

    dev = q.device
    q_start = pos[:, 0].contiguous()

    def call():
        return pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)

    ms = time_ms(call)
    plain_ms = time_ms(lambda: pa.plain_paged_attention(
        q, k, v, tables, ctx, q_start, PS), iters=3, warmup=1)
    t = q.shape[1]
    q4, kk, vv = gather_for_library(q, k, v, tables, ctx.tolist(), int(ctx.max()))
    kpos = torch.arange(kk.shape[2], device=dev)
    qpos = pos[:, :1].long() + torch.arange(t, device=dev)
    mask = ((kpos[None, None, :] < ctx[:, None, None].long())
            & (kpos[None, None, :] <= qpos[:, :, None]))[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), iters=5, warmup=1)
    del kk, vv
    ctx_l, start_l = ctx.tolist(), q_start.tolist()
    pairs = sum(min(c, s + i + 1) for c, s in zip(ctx_l, start_l) for i in range(t))
    n_bytes = (2 * q.numel() * q.element_size() + sum(ctx_l) * 2 * token_bytes(k)
               + sum(-(-c // PS) for c in ctx_l) * 4 + 2 * len(ctx_l) * 4)
    bound_ms, bound_by = bound(n_bytes, 4.0 * pairs * q.shape[2] * HD, dtype_name)
    return {"ms": ms, "device_ms": device_ms(call, iters=10), "host_ms": host_ms(call),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def unsplit_case(pa, torch, q, k, v, tables, ctx, pos, ref, dtype_name: str) -> dict:
    """The tensor-core kernel on a split input run unsplit (one block per
    sequence, kv head and row tile walks every column, no merge), held
    against the plain version, with its times: what the split buys, or
    costs, at this input."""
    import dataclasses

    ks = vs = None
    if isinstance(k, tuple):
        (k, ks), (v, vs) = k, v
    b, t, n_q, hd = q.shape
    plan = pa.chunk_plan(b, t, n_q, k.shape[1], hd, tables.shape[1])
    whole = dataclasses.replace(plan, splits=1, cols=tables.shape[1], workspace_bytes=0)
    q_start = pos[:, 0].contiguous()

    def call():
        return pa._chunk_mma(q, k, v, ks, vs, tables, ctx, q_start, PS, whole)

    err = compare(call(), ref, dtype_name, f"chunk unsplit {dtype_name}")
    return {"max_abs_err": err, "ms": time_ms(call), "device_ms": device_ms(call, iters=10)}


# Inputs of the chunk phases: f32 queries (the CUDA-core kernel) on the first
# three, bf16 queries (the tensor-core kernel) on all six. The prefill and the
# verify inputs are timed for both, the last three for bf16; a split bf16
# input is also timed unsplit.
CHUNK_KINDS = ("prefill", "verify", "pad_tail")
MMA_KINDS = CHUNK_KINDS + ("prefill_one_row", "verify_served", "tp8_shard")


def chunk_plan_of(pa, q, k, tables):
    """``chunk_plan`` of a chunk call on these inputs (k a pool or an int8
    tuple)."""
    b, t, n_q, hd = q.shape
    n_kv = (k[0] if isinstance(k, tuple) else k).shape[1]
    return pa.chunk_plan(b, t, n_q, n_kv, hd, tables.shape[1])


def merge_case(pa, torch, q, k, v, tables, ctx, q_start) -> dict:
    """The merge kernel against ``merge_partials`` and the cast, in bf16 and
    f32, on the plain partials of the splits ``chunk_plan`` gives these
    inputs; its times, and its bound (the partials read once, the output
    written once)."""
    plan = chunk_plan_of(pa, q, k, tables)
    acc, m, l = pa.plain_chunk_partials(q, k, v, tables, ctx, q_start, PS, plan.cols)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        got = pa.chunk_merge(acc, m, l, dtype)
        want = pa.merge_partials(list(zip(acc, m, l)), q.device).to(dtype)
        torch.cuda.synchronize()
        errs[name] = compare(got, want, name, f"chunk merge of {plan.splits} splits ({name})")
    n_bytes = 4 * (acc.numel() + m.numel() + l.numel()) + 2 * acc[0].numel()
    bound_ms, bound_by = bound(n_bytes, 3.0 * acc.numel(), "float32")
    return {"splits": plan.splits, "max_abs_err": errs["bfloat16"], "errs": errs,
            "ms": time_ms(lambda: pa.chunk_merge(acc, m, l, torch.bfloat16)),
            "plain_ms": time_ms(lambda: pa.merge_partials(list(zip(acc, m, l)), q.device)
                                .to(torch.bfloat16), iters=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_chunk(pa, torch, int8: bool = False) -> dict:
    """The chunk kernels over bf16 and f32 pools or, with ``int8``, over int8
    pools quantized from them: bf16 queries on the tensor-core kernel with
    its split count per input, f32 queries on the CUDA-core kernel; the
    merge kernel on the verify input's splits."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4 if int8 else 2)
    result: dict = {"phase": "chunk_int8_kernel" if int8 else "chunk_kernel"}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        mma = dtype == torch.bfloat16
        errs, wrong, timed, splits = {}, {}, {}, {}
        for kind in (MMA_KINDS if mma else CHUNK_KINDS):
            q, k, v, tables, ctx, pos, real = chunk_inputs(torch, dev, gen, dtype, kind)
            if int8:
                k, v = quantize_kv(k), quantize_kv(v)
            q_start = pos[:, 0].contiguous()
            splits[kind] = chunk_plan_of(pa, q, k, tables).splits
            out = pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)
            ref = pa.plain_paged_attention(q, k, v, tables, ctx, q_start, PS)
            torch.cuda.synchronize()
            errs[kind] = compare(out, ref, name, f"chunk {kind} {name}")
            # The engine's pad row has ctx 1 on the null page: not a sequence.
            live = [i for i, n in enumerate(real) if n]
            sel = torch.tensor(live, device=dev)
            wrong[kind] = drop_last_page(pa, q[sel], k, v, tables[sel], ctx[sel],
                                         q_start[sel], ref[sel], name)
            # Time the prefill input (the heaviest chunk call), the T=8
            # verify (most of the main path's chunk launches) and, in bf16,
            # the one-row prefill, the verify at the served contexts and on
            # one tp=8 head shard.
            if kind != "pad_tail":
                timed[kind] = time_chunk(pa, torch, q, k, v, tables, ctx, pos, name)
                if mma and splits[kind] > 1:
                    timed[kind]["unsplit"] = unsplit_case(pa, torch, q, k, v, tables, ctx,
                                                          pos, ref, name)
            if mma and kind == "verify":
                timed["merge"] = merge_case(pa, torch, q, k, v, tables, ctx, q_start)
            del q, k, v, out, ref
        result[name] = {"route": "mma" if mma else "cuda_core",
                        "max_abs_err": max(errs.values()), "errs": errs, "splits": splits,
                        "tol": TOL[name], **timed.pop("prefill"), **timed,
                        "drop_last_page": wrong}
    return result


def owned_work(tables, ctx, q_start, t: int, shard: int, pages_local: int):
    """What page shard ``shard`` must do for these inputs: (keys on its pages
    below ctx, causal (query, key) pairs over them, page-table entries read)."""
    import numpy as np

    tab = tables.cpu().numpy()
    starts = None if q_start is None else q_start.tolist()
    keys = pairs = entries = 0
    for i, c in enumerate(ctx.tolist()):
        n_pages = -(-c // PS)
        if starts is not None:
            last = starts[i] + t - 1
            n_pages = min(n_pages, last // PS + 1) if last >= 0 else 0
        entries += n_pages
        owned = np.repeat(tab[i, :n_pages] // pages_local == shard, PS)[:c]
        keys += int(owned.sum())
        if starts is None:
            pairs += int(owned.sum())
        else:
            cum = np.concatenate([[0], np.cumsum(owned)])
            lim = np.clip(np.minimum(len(owned), starts[i] + np.arange(t) + 1), 0, None)
            pairs += int(cum[lim].sum())
    return keys, pairs, entries


def library_partial(torch, q4, k_local, v_local, tables, ctx, q_start, shard: int,
                    pages_local: int):
    """One PyTorch call that computes page shard ``shard``'s flash partial in
    normalised form: memory-efficient SDPA with its log-sum-exp (out = acc /
    l, lse = m + log l) over the keys the shard owns, gathered through the
    tables beforehand and repeated over the GQA group, with ctx and
    causality in an additive bias. Returns the call (timed here, never made
    by the port) and a check of its result against the kernel's (acc, m,
    l): max |err| of out and of lse over the rows that saw a key."""
    import numpy as np

    b, t, n_q, _ = q4.shape
    dev = q4.device
    tab = tables.cpu().numpy().astype(np.int64)
    rows, kpos = [], []
    for i, c in enumerate(ctx.tolist()):
        n_pages = -(-c // PS)
        pages, pos = tab[i, :n_pages], np.arange(n_pages * PS)
        keep = np.repeat(pages // pages_local == shard, PS) & (pos < c)
        local = np.repeat(pages - shard * pages_local, PS) * PS + pos % PS
        rows.append(local[keep])
        kpos.append(pos[keep])
    s = max(16, -(-max(map(len, rows)) // 16) * 16)  # bias rows 16-aligned
    row_t = np.zeros((b, s), np.int64)
    pos_t = np.full((b, s), -1, np.int64)  # -1: a pad key
    for i, (r, p) in enumerate(zip(rows, kpos)):
        row_t[i, :len(r)], pos_t[i, :len(p)] = r, p
    row_t, pos_t = torch.from_numpy(row_t).to(dev), torch.from_numpy(pos_t).to(dev)
    group = n_q // k_local.shape[1]
    kk = k_local[row_t].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    vv = v_local[row_t].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    qq = q4.permute(0, 2, 1, 3).contiguous()
    allowed = (pos_t >= 0)[:, None, :].expand(b, t, s)
    if q_start is not None:
        qpos = q_start[:, None].long() + torch.arange(t, device=dev)
        allowed = allowed & (pos_t[:, None, :] <= qpos[:, :, None])
    bias = torch.zeros((b, n_q, t, s), dtype=q4.dtype, device=dev)
    bias.masked_fill_(~allowed[:, None], float("-inf"))

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(qq, kk, vv, bias, True)

    def check(acc, m, l) -> dict:  # [B, T, n_q, hd], [B, T, n_q], [B, T, n_q]
        out, lse = call()[:2]
        seen = l > 0
        want = acc / l.clamp_min(1e-30)[..., None]
        err = (out.permute(0, 2, 1, 3).float() - want).abs()[seen]
        lse_err = (lse[:, :, :t].permute(0, 2, 1).float() - (m + l.log())).abs()[seen]
        return {"out": float(err.max()), "lse": float(lse_err.max())}

    return call, check


def shard_case(pa, torch, q, k, v, tables, ctx, q_pos, name: str,
               gate_drop: bool = True) -> dict:
    """The partial kernel on each of PG page shards of (k, v) against its
    plain version (acc, m and l); the merge of all shards against K1 (decode,
    ``q_pos`` None) or K2 on the unsplit pool; the dropped-last-page check on
    the merged result (gated with ``gate_drop``); per call, that is per page
    shard: kernel, plain and library times and bounds (the owned pages'
    bytes, or the operations on them), and their means over the shards'
    calls."""
    from runbookai_tpu_torch.parallel.kv_split import merge_partials

    decode = q_pos is None
    pages_local = k.shape[0] // PS // PG
    ks, vs = k.chunk(PG), v.chunk(PG)  # page shard s: global pages [s, s + 1) * pages_local
    q_start = None if decode else q_pos[:, 0].contiguous()
    q4 = q[:, None] if decode else q
    what = "decode partial" if decode else "chunk partial"

    def kernel(s):
        if decode:
            return pa.paged_decode_attention_partial(q, ks[s], vs[s], tables, ctx, s, PS,
                                                     pages_local)
        return pa.paged_chunk_attention_partial(q, ks[s], vs[s], tables, ctx, q_pos, s, PS,
                                                pages_local)

    def plain(s):
        acc, m, l = pa.plain_paged_attention_partial(q4, ks[s], vs[s], tables, ctx, q_start,
                                                     PS, s, pages_local)
        return (acc[:, 0], m[:, 0], l[:, 0]) if decode else (acc, m, l)

    parts, errs = [], []
    for s in range(PG):
        got, want = kernel(s), plain(s)
        torch.cuda.synchronize()
        errs.append(max(compare(g, w, name, f"{what} {name} shard {s} {field}")
                        for g, w, field in zip(got, want, ("acc", "m", "l"))))
        parts.append(got)
    merged = merge_partials(parts, q.device).to(q.dtype)
    if decode:
        whole = pa.paged_decode_attention(q, k, v, tables, ctx, PS)
    else:
        whole = pa.paged_chunk_attention(q, k, v, tables, ctx, q_pos, PS)
    torch.cuda.synchronize()
    merge_err = compare(merged, whole, name, f"{what} {name}: merge vs the unsplit kernel")
    wrong = drop_last_page(pa, q4, k, v, tables, ctx, q_start,
                           merged[:, None] if decode else merged, name, gate=gate_drop)
    shards = []
    for s in range(PG):
        keys, pairs, entries = owned_work(tables, ctx, q_start, q4.shape[1], s, pages_local)
        rows = q.numel() // HD
        n_bytes = (q.numel() * q.element_size() + keys * 2 * token_bytes(k)
                   + q.numel() * 4 + 2 * rows * 4 + entries * 4
                   + q.shape[0] * 4 * (1 if decode else 2))
        bound_ms, bound_by = bound(n_bytes, 4.0 * pairs * q.shape[-2] * HD, name)
        lib_call, lib_check = library_partial(torch, q4, ks[s], vs[s], tables, ctx,
                                              q_start, s, pages_local)
        acc, m, l = parts[s]
        shards.append({"ms": time_ms(lambda: kernel(s)),
                       "plain_ms": time_ms(lambda: plain(s), iters=3, warmup=1),
                       "library_ms": time_ms(lib_call, iters=5, warmup=1),
                       "library_max_abs_err": lib_check(
                           *((acc[:, None], m[:, None], l[:, None]) if decode
                             else (acc, m, l))),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "keys": keys, "max_abs_err": errs[s]})
        del lib_call, lib_check
    mean = {f: sum(x[f] for x in shards) / PG
            for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"max_abs_err": max(errs), "merge_max_abs_err": merge_err, "tol": TOL[name],
            "q": list(q.shape), "kv_local": list(ks[0].shape),
            **mean, "bound_by": ("bytes" if all(x["bound_by"] == "bytes" for x in shards)
                                 else "operations"),
            "shards": shards, "drop_last_page": wrong}


def plan_heads(torch) -> tuple[int, int]:
    """(query heads, kv heads) of one page-shard call on the tp=16 mesh that
    ``plan_kv_split`` plans for ENGINE_MODEL: each model group's query heads
    (gathered over its page shards) over its kv heads."""
    from runbookai_tpu_torch.models.llama import get_config
    from runbookai_tpu_torch.parallel.kv_split import plan_kv_split

    cfg = get_config(ENGINE_MODEL)
    plan = plan_kv_split(cfg, 16)
    if plan.pg_shards != PG or (cfg.n_heads, cfg.n_kv_heads) != (N_Q, N_KV):
        raise AssertionError(f"plan {plan} does not cut the {N_Q}/{N_KV}-head pools "
                             f"into PG={PG} page shards")
    return N_Q // plan.kv_shards, N_KV // plan.kv_shards


def partial_cases(pa, torch, q, k, v, tables, ctx, q_pos, name: str) -> dict:
    """``shard_case`` at the shape one call of the served tp=16 path has
    (``served``: one model group's query and kv heads) and over every head
    (``all_heads``). The dropped-last-page check is gated over every head,
    and at the served shape in f32 only: in bf16 a one-token last page of
    a 4097-token row moves 4 heads by less than the tolerance (it is
    recorded)."""
    nq, nkv = plan_heads(torch)
    served = shard_case(pa, torch, q[..., :nq, :].contiguous(), k[:, :nkv].contiguous(),
                        v[:, :nkv].contiguous(), tables, ctx, q_pos, name,
                        gate_drop=name == "float32")
    every = shard_case(pa, torch, q, k, v, tables, ctx, q_pos, name)
    return {"served": served, "all_heads": every,
            "max_abs_err": max(served["max_abs_err"], every["max_abs_err"])}


def phase_decode_partial(pa, torch) -> dict:
    """K4 on phase 2's decode inputs, whose live pages are drawn over the
    whole pool, cut into PG page shards of NUM_PAGES / PG pages: at the
    served shape (B=8, 4 query heads over 1 kv head) and over all heads."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    result: dict = {"phase": "decode_partial_kernel", "page_shards": PG,
                    "ctx_lens": DECODE_CTX}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        k, v, tables = make_pool(gen, dtype, DECODE_CTX, dev)
        q = torch.randn((B, N_Q, HD), generator=gen, device=dev).to(dtype)
        result[name] = partial_cases(pa, torch, q, k, v, tables, ctx, None, name)
        del k, v
    return result


def phase_chunk_partial(pa, torch) -> dict:
    """The chunk partial on phase 3's 4 x 512 prefill and T=8 verify inputs,
    cut into PG page shards, at the served shape and over all heads."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    result: dict = {"phase": "chunk_partial_kernel", "page_shards": PG}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        cases = {}
        for kind in ("prefill", "verify"):
            q, k, v, tables, ctx, pos, _ = chunk_inputs(torch, dev, gen, dtype, kind)
            cases[kind] = partial_cases(pa, torch, q, k, v, tables, ctx, pos, name)
            del q, k, v
        result[name] = {**cases["prefill"], "verify": cases["verify"],
                        "max_abs_err": max(c["max_abs_err"] for c in cases.values())}
    return result


def phase_forward_tp(torch) -> dict:
    """The 8B at full width, depth cut to FORWARD_TP_LAYERS layers, f32
    weights and pool: the forward on the model=8 x seq=2 (tp=16) and
    model=8 x seq=1 (tp=8) meshes, every shard on the one card, against the
    unsharded forward, over a prefill chunk, a decode step and a T=8 verify
    whose pages lie on both page shards."""
    import dataclasses

    from runbookai_tpu_torch.engine.kv_cache import PagePool
    from runbookai_tpu_torch.models.llama import forward_impl, get_config, init_params
    from runbookai_tpu_torch.parallel.kv_split import plan_kv_split
    from runbookai_tpu_torch.parallel.mesh import build_mesh
    from runbookai_tpu_torch.parallel.sharding import shard_params

    free_device(torch)
    cfg = dataclasses.replace(get_config(ENGINE_MODEL), n_layers=FORWARD_TP_LAYERS)
    dev = torch.device(f"{DEVICE}:0")
    gen = torch.Generator(device=dev).manual_seed(6)
    params = init_params(cfg, dtype=torch.float32, device=dev, generator=gen)
    num_pages, max_pages, prompt = 64, 16, 100
    tables = torch.zeros((2, max_pages + 1), dtype=torch.int32, device=dev)
    tables[0, :7] = torch.tensor([33, 2, 40, 5, 60, 7, 50])  # pages on both shards
    tables[1, :7] = torch.tensor([3, 34, 12, 45, 14, 63, 16])

    def step(start, t):
        tok = torch.randint(0, cfg.vocab_size, (2, t), generator=gen, device=dev)
        pos = (start + torch.arange(t, device=dev, dtype=torch.int32)).expand(2, t)
        ctx = torch.full((2,), start + t, dtype=torch.int32, device=dev)
        return tok, pos.contiguous(), ctx

    steps = [step(0, prompt), step(prompt, 1), step(prompt + 1, 8)]
    pool_args = (cfg.n_layers, num_pages, PS, cfg.n_kv_heads, cfg.head_dim, torch.float32)
    ref_pool = PagePool.create(*pool_args, device=dev)
    want = [forward_impl(params, cfg, tok, pos, ref_pool.kv_k, ref_pool.kv_v, tables, ctx,
                         PS) for tok, pos, ctx in steps]
    out: dict = {"phase": "forward_tp", "model": ENGINE_MODEL,
                 "reduced": {"n_layers": [get_config(ENGINE_MODEL).n_layers,
                                          FORWARD_TP_LAYERS]},
                 "dtype": "float32", "tol": [FORWARD_TP_TOL, FORWARD_TP_TOL],
                 "steps": ["prefill T=100", "decode", "verify T=8"]}
    for tp, must, never in ((16, PARTIALS, ("paged_decode_attention",
                                            "paged_chunk_attention")),
                            (8, ("paged_decode_attention", "paged_chunk_attention"),
                             PARTIALS)):
        plan = plan_kv_split(cfg, tp)
        mesh = build_mesh(plan.kv_shards, plan.pg_shards, [dev] * tp)
        shards = shard_params({**params, "layers": dict(params["layers"])}, cfg, mesh)
        pool = PagePool.create(*pool_args, device=dev, mesh=mesh)
        reset_counts()
        t0 = time.perf_counter()
        got = [forward_impl(shards, cfg, tok, pos, pool.kv_k, pool.kv_v, tables, ctx, PS,
                            mesh=mesh) for tok, pos, ctx in steps]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        if any(launched[k] == 0 for k in must) or any(launched[k] for k in never):
            raise AssertionError(f"forward_tp tp={tp}: kernel routing {launched}")
        errs = []
        for g, w, what in zip(got, want, out["steps"]):
            diff = (g - w).abs()
            if not bool(g.isfinite().all()):
                raise AssertionError(f"forward_tp tp={tp} {what}: non-finite logits")
            if bool((diff > FORWARD_TP_TOL + FORWARD_TP_TOL * w.abs()).any()):
                raise AssertionError(f"forward_tp tp={tp} {what}: max |err| "
                                     f"{float(diff.max()):.3e} beyond atol/rtol "
                                     f"{FORWARD_TP_TOL}")
            errs.append(float(diff.max()))
        out[f"model{plan.kv_shards}_seq{plan.pg_shards}"] = {
            "max_abs_err": errs, "wall_s": wall,
            "launches": {k: v for k, v in launched.items() if v}}
        del shards, pool, got
    return out


def qmm_case(qm, torch, x, q, s, deq, name: str) -> dict:
    """K5 against its plain version on layer 0 of a stacked weight, the
    dropped-K-slice check, and kernel, plain and library (``torch.matmul``
    by ``deq``, the weights dequantized to bf16) device times, each call on
    the next of the 32 layer slices; ``events_ms`` is the kernel's CUDA-event
    time over back-to-back calls, which the host's launch rate can set."""
    m, k = x.shape
    n = q.shape[2]
    out = qm.qmm_int8(x, q[0], s[0])
    ref = qm.plain_qmm_int8(x, q[0], s[0])
    torch.cuda.synchronize()
    err = compare(out, ref, name, f"qmm [{m}, {k}] @ [{k}, {n}]")
    # A wrong kernel: the plain version with the last bk slice of K dropped.
    bk = qm._pick(qm._BK_CANDIDATES, k)
    wrong = qm.plain_qmm_int8(x[:, :k - bk].contiguous(), q[0, :k - bk], s[0])
    over, diff = excess(wrong, ref, name)
    if not all(bool(over[i].max() > 0) for i in range(m)):
        raise AssertionError(f"qmm [{m}, {k}] @ [{k}, {n}]: the tolerance accepts a "
                             f"result with the last {bk} rows of K dropped")

    def rotating(fn, *stacked):
        layer = [0]

        def call():
            i = layer[0] = (layer[0] + 1) % QMM_LAYERS
            return fn(x, *(w[i] for w in stacked))
        return call

    bound_ms, bound_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2,
                               2.0 * m * k * n, name)
    return {"max_abs_err": err,
            "ms": device_ms(rotating(qm.qmm_int8, q, s), iters=2 * QMM_LAYERS),
            "events_ms": time_ms(rotating(qm.qmm_int8, q, s), iters=4 * QMM_LAYERS,
                                 warmup=QMM_LAYERS),
            "plain_ms": device_ms(rotating(qm.plain_qmm_int8, q, s), iters=8),
            "library_ms": device_ms(rotating(torch.matmul, deq), iters=2 * QMM_LAYERS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "wrong_min_abs_err": min(float(diff[i].max()) for i in range(m)),
            "splits": qm.qmm_splits(m, k, n)}


def gpu_clocks() -> str:
    """SM clock, power draw and temperature, read beside a timed phase."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_qmm(torch) -> dict:
    """K5 at the 8B's four (K, N) shapes and QMM_ROWS rows, bf16 x, each
    weight stacked over 32 layers (int8 with f32 scales) so that timed calls
    rotate through 32 distinct matrices, as the decode forward does; the
    library yardstick moves twice the weight bytes. The bf16 tolerance
    holds because both versions sum in f32 and round once to bf16."""
    from runbookai_tpu_torch.ops import qmm as qm

    clocks_before = gpu_clocks()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    name = "bfloat16"
    cases: dict = {}
    for k, n in sorted(set(QMM_SHAPES.values())):
        q = torch.empty((QMM_LAYERS, k, n), dtype=torch.int8, device=dev)
        for part in q:
            part.random_(-127, 128, generator=gen)
        s = (torch.rand((QMM_LAYERS, 1, n), generator=gen, device=dev) + 0.5) \
            * (3 ** 0.5 / (127 * k ** 0.5))
        deq = q.to(torch.bfloat16) * s.to(torch.bfloat16)
        for m in QMM_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            cases[f"{m}x{k}x{n}"] = qmm_case(qm, torch, x, q, s, deq, name)
        del q, s, deq
    per_layer = {}
    for m, key in ((8, "decode"), (64, "verify")):  # one layer's seven products
        rows = [cases[f"{m}x{k}x{n}"] for k, n in QMM_SHAPES.values()]
        per_layer[key] = {f: sum(r[f] for r in rows)
                          for f in ("ms", "events_ms", "plain_ms", "library_ms",
                                    "bound_ms")}
        per_layer[key]["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                                      else "operations")
    return {"phase": "qmm_kernel", "tol": TOL[name], "layers_rotated": QMM_LAYERS,
            "clocks_before_after": [clocks_before, gpu_clocks()],
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "per_layer": per_layer, "cases": cases}


def phase_forward(torch) -> dict:
    """The forward on the card (kernels) against the HF golden logits, and a
    decode step against the same forward on the CPU (plain versions)."""
    import numpy as np

    from runbookai_tpu_torch.models.hf_loader import config_from_hf, load_params
    from runbookai_tpu_torch.models.llama import forward_impl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"phase": "forward_vs_golden"}
    for name in ("hf-tiny-untied", "hf-tiny-qwen2", "hf-tiny-rope31"):
        d = ROOT / "tests" / "fixtures" / name
        blob = np.load(d / "expected_logits.npz")
        ids = torch.from_numpy(blob["input_ids"]).long()
        b, t = ids.shape
        ps, max_pages = 4, 16
        tables = torch.zeros((b, max_pages + 1), dtype=torch.int32)
        for i in range(b):
            tables[i, : max_pages] = torch.arange(1 + i * max_pages, 1 + (i + 1) * max_pages)
        logits = {}
        for dev in (DEVICE, "cpu"):
            cfg, params = load_params(d, config_from_hf(d, name=name),
                                      dtype=torch.float32, device=dev)
            shape = (cfg.n_layers, (1 + b * max_pages) * ps, cfg.n_kv_heads, cfg.head_dim)
            kv_k = torch.zeros(shape, device=dev)
            kv_v = torch.zeros(shape, device=dev)
            tab = tables.to(dev)
            pos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t).contiguous()
            pre = forward_impl(params, cfg, ids.to(dev), pos, kv_k, kv_v, tab,
                               torch.full((b,), t, dtype=torch.int32, device=dev), ps)
            nxt = pre[:, -1].argmax(-1)[:, None]
            dec = forward_impl(params, cfg, nxt, torch.full((b, 1), t, dtype=torch.int32,
                                                          device=dev),
                               kv_k, kv_v, tab,
                               torch.full((b,), t + 1, dtype=torch.int32, device=dev), ps)
            logits[dev] = (pre.cpu(), dec.cpu())
        golden = float((logits[DEVICE][0] - torch.from_numpy(blob["logits"])).abs().max())
        np.testing.assert_allclose(logits[DEVICE][0].numpy(), blob["logits"],
                                   atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(logits[DEVICE][1].numpy(), logits["cpu"][1].numpy(),
                                   atol=1e-4, rtol=1e-4)
        out[name] = {"golden_max_abs_err": golden,
                     "decode_vs_cpu_max_abs_err":
                         float((logits[DEVICE][1] - logits["cpu"][1]).abs().max())}
    return out


def prompts() -> list[str]:
    """User turns for 64..1024-token prompts (byte tokenizer, chat template
    included); the fourth repeats itself so prompt-lookup can draft."""
    words = ("checkout latency alarm fired at 09:14 for the payments api; "
             "p99 rose from 180ms to 2.4s after deploy 4411. ")
    return ["why is checkout slow?",
            words * 3,
            words * 6,
            "restart the checkout service. " * 24,
            words * 8]


def phase_forward_int8(torch) -> dict:
    """hf-tiny fixtures loaded with int8 weights, prefill then decode over an
    int8 pool in f32: the card (qmm, int8 chunk and decode kernels) against
    the same forward on the CPU (plain versions)."""
    import numpy as np

    from runbookai_tpu_torch.engine.kv_cache import PagePool
    from runbookai_tpu_torch.models.hf_loader import config_from_hf, load_params
    from runbookai_tpu_torch.models.llama import forward_impl

    out: dict = {"phase": "forward_int8"}
    for name in ("hf-tiny-untied", "hf-tiny-qwen2"):
        d = ROOT / "tests" / "fixtures" / name
        ids = torch.from_numpy(np.load(d / "expected_logits.npz")["input_ids"]).long()
        b, t = ids.shape
        ps, max_pages = 4, 16
        tables = torch.zeros((b, max_pages + 1), dtype=torch.int32)
        for i in range(b):
            tables[i, : max_pages] = torch.arange(1 + i * max_pages, 1 + (i + 1) * max_pages)
        logits, pools = {}, {}
        reset_counts()
        for dev in (DEVICE, "cpu"):
            cfg, params = load_params(d, config_from_hf(d, name=name), dtype=torch.float32,
                                      device=dev, quantize_int8=True)
            pool = PagePool.create(cfg.n_layers, 1 + b * max_pages, ps, cfg.n_kv_heads,
                                   cfg.head_dim, dtype=torch.int8, device=dev)
            tab = tables.to(dev)
            pos = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t).contiguous()
            pre = forward_impl(params, cfg, ids.to(dev), pos, pool.kv_k, pool.kv_v, tab,
                               torch.full((b,), t, dtype=torch.int32, device=dev), ps)
            nxt = pre[:, -1].argmax(-1)[:, None]
            dec = forward_impl(params, cfg, nxt, torch.full((b, 1), t, dtype=torch.int32,
                                                          device=dev),
                               pool.kv_k, pool.kv_v, tab,
                               torch.full((b,), t + 1, dtype=torch.int32, device=dev), ps)
            logits[dev] = (pre.cpu(), dec.cpu())
            pools[dev] = pool.kv_k[0].cpu()
        launched = counts()
        for kernel in ("paged_chunk_attention_int8", "paged_decode_attention_int8",
                       "qmm_int8"):
            if not launched[kernel]:
                raise AssertionError(f"{name}: the int8 forward skipped {kernel}")
        flips = int((pools[DEVICE] != pools["cpu"]).sum())
        err = float((logits[DEVICE][1] - logits["cpu"][1]).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{name}: int8 decode logits card vs cpu {err:.3e} > "
                                 f"1e-4 ({flips} int8 K values rounded apart)")
        out[name] = {"decode_vs_cpu_max_abs_err": err,
                     "prefill_vs_cpu_max_abs_err":
                         float((logits[DEVICE][0] - logits["cpu"][0]).abs().max()),
                     "k_values_rounded_apart": flips, "launches": launched}
    return out


async def serve(client, texts):
    t0 = time.perf_counter()
    resps = await asyncio.gather(*(client.chat("", u) for u in texts))
    return resps, time.perf_counter() - t0


# The kernels each serving configuration (weights; KV pool of the same
# type) must launch, and those it must not.
PARTIALS = ("paged_decode_attention_partial", "paged_chunk_attention_partial")
SERVING = {
    "bfloat16": dict(must=("paged_decode_attention", "paged_chunk_attention"),
                     never=PARTIALS),
    "int8": dict(must=("paged_decode_attention_int8", "paged_chunk_attention_int8",
                       "qmm_int8"),
                 never=("paged_decode_attention", "paged_chunk_attention", *PARTIALS)),
    "kv_split": dict(must=PARTIALS,
                     never=("paged_decode_attention", "paged_chunk_attention")),
}


def build_client(torch, weights: str):
    """bf16 weights and pool, int8 weights (bf16 activations) and pool, or
    bf16 on the tp=16 page-split mesh (model=8 x seq=2, every shard on the
    one card, a TP_PAGES-page pool), through the entry point a user calls."""
    import dataclasses

    from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient, serving_engine_config
    from runbookai_tpu_torch.models.llama import get_config

    if weights == "int8":
        kw = dict(dtype="int8", kv_cache_dtype="int8")
    elif weights == "kv_split":
        ecfg = serving_engine_config(get_config(ENGINE_MODEL), torch.bfloat16)
        kw = dict(dtype=torch.bfloat16, tp=16, devices=[f"{DEVICE}:0"] * 16,
                  engine_cfg=dataclasses.replace(ecfg, num_pages=TP_PAGES))
    else:
        kw = dict(dtype=torch.bfloat16)
    return TorchCudaClient.build(ENGINE_MODEL, device=DEVICE, seed=0, max_new_tokens=32,
                                 **kw)


def reset_counts() -> None:
    from runbookai_tpu_torch.ops import paged_attention as pa
    from runbookai_tpu_torch.ops import qmm as qm

    pa.reset_launches()
    qm.launches["qmm_int8"] = 0


def counts() -> dict:
    from runbookai_tpu_torch.ops import paged_attention as pa
    from runbookai_tpu_torch.ops import qmm as qm

    return {**pa.launches, **pa.merge_launches, **qm.launches}


def free_device(torch) -> None:
    """Release the previous phase's client before the next one builds."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


ENGINE_PHASES = {"bfloat16": "engine", "int8": "engine_int8", "kv_split": "engine_kv_split"}


def phase_engine(torch, weights: str = "bfloat16") -> dict:
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = build_client(torch, weights)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    core = client.core
    texts = prompts()
    prompt_ids = [client._prompt_ids("", u, None) for u in texts]
    prompt_tokens = [len(p) for p in prompt_ids]
    if min(prompt_tokens) < 64 or max(prompt_tokens) > 1024:
        raise AssertionError(f"prompt lengths {prompt_tokens} outside 64..1024")
    pages: set[int] = set()
    alloc = core.kv.allocator.alloc

    def recording_alloc(n):
        got = alloc(n)
        pages.update(got)
        return got

    core.kv.allocator.alloc = recording_alloc

    reset_counts()
    resps, wall = asyncio.run(_serve_and_stop(client, texts))
    launched = counts()

    done, finished = check_served(client, resps, len(texts))
    spec = SERVING[weights]
    if (any(launched[k] == 0 for k in spec["must"])
            or any(launched[k] for k in spec["never"])):
        raise AssertionError(f"main path ({weights}) skipped a kernel or ran one of "
                             f"the other configuration: {launched}")
    # Every T=8 verify call of 8 slots has fewer blocks than two per SM, so
    # chunk_plan splits it and the merge kernel runs.
    if weights != "kv_split" and not launched["paged_chunk_merge"]:
        raise AssertionError(f"main path ({weights}) merged no split chunk call")
    ttft = [r.usage["ttft_ms"] for r in resps]
    result = {"phase": ENGINE_PHASES[weights],
              "model": ENGINE_MODEL, "dtype": "bfloat16" if weights == "kv_split" else weights,
              "kv_dtype": str(core.ecfg.kv_dtype).split(".")[1],
              "requests": len(texts), "prompt_tokens": prompt_tokens,
              "completion_tokens": done,
              "finish_reasons": [r.finish_reason.value for r in finished],
              "wall_s": wall, "tokens_per_s": sum(done) / wall,
              "ttft_ms": ttft, "build_s": build_s, "launches": launched,
              "engine_metrics": core.metrics,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "greedy_tokens": [streams_by_prompt(finished, p) for p in prompt_ids]}
    if core.mesh is not None:
        local = core.ecfg.num_pages // core.mesh.seq
        by_shard = [sum(1 for p in pages if p // local == s) for s in range(core.mesh.seq)]
        if not all(by_shard):
            raise AssertionError(f"pages allocated per page shard {by_shard}: the run "
                                 f"left a page shard unused")
        result.update(mesh=core.mesh.shape, num_pages=core.ecfg.num_pages,
                      pages_allocated_by_shard=by_shard,
                      # one attention call per shard and layer
                      calls_per_forward=core.cfg.n_layers * core.mesh.tp)
    return result


def streams_by_prompt(finished, prompt: list[int]) -> list[int]:
    """The tokens generated for the request whose prompt starts with
    ``prompt`` (preemption folds output into the prompt)."""
    for req in finished:
        if req.prompt_ids[:len(prompt)] == prompt:
            return list(req.all_out_ids)
    raise AssertionError("no finished request for a prompt")


def same_token_share(a: list[list[int]], b: list[list[int]]) -> float:
    """Share of greedy positions where two runs emitted the same token."""
    pairs = [(x, y) for s, t in zip(a, b) for x, y in zip(s, t)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def check_served(client, resps, n_requests: int):
    """Every request of a serving run finished without a crash or an abort,
    with 1..32 completion tokens inside the vocabulary. Returns (completion
    token counts, finished requests)."""
    core = client.core
    if client.engine.crash_count:
        raise AssertionError(f"the engine loop crashed {client.engine.crash_count} "
                             f"time(s); its requests were aborted")
    done = [r.usage["completion_tokens"] for r in resps]
    finished = list(core.finished)
    if len(finished) != n_requests or any(r.finish_reason is None for r in finished):
        raise AssertionError("not every request finished")
    if any(r.finish_reason.value == "aborted" for r in finished):
        raise AssertionError("a request was aborted")
    if any(not 1 <= n <= 32 for n in done):
        raise AssertionError(f"completion token counts {done}")
    vocab = core.cfg.vocab_size
    if any(not 0 <= t < vocab for r in finished for t in r.all_out_ids):
        raise AssertionError("a sampled id lies outside the vocabulary")
    return done, finished


INT8_ARGS = ("signed char", "int8_t")


def template_args(name: str, kernel: str):
    """The template arguments of a profiled ``kernel<...>``, or None."""
    if kernel + "<" not in name:
        return None
    return name.split(kernel + "<", 1)[1].split(">", 1)[0].split(", ")


def old_bf16_chunk(name: str) -> bool:
    """The CUDA-core kernel's bf16-query causal non-partial instantiation,
    which bf16 chunk calls no longer reach."""
    args = template_args(name, "paged_attention_kernel")  # <TQ, TKV, kCausal, kPartial>
    return bool(args) and args[0] == "__nv_bfloat16" and args[2:4] == ["true", "false"]


def kernel_class(name: str, int8_pools: bool = False) -> str:
    """A profiled kernel's class; the merge of a split chunk call counts with
    the chunk class of the run's pool type (``int8_pools``)."""
    args = template_args(name, "paged_attention_kernel")  # <TQ, TKV, kCausal, kPartial>
    if args:
        cls = "chunk_attention" if args[2] == "true" else "decode_attention"
        cls += "_partial" if args[3] == "true" else ""
        return cls + ("_int8" if args[1] in INT8_ARGS else "")
    args = template_args(name, "chunk_attention_mma_kernel")  # <TKV, HD, WARPS>
    if args:
        return "chunk_attention" + ("_int8" if args[0] in INT8_ARGS else "")
    if "chunk_merge_kernel<" in name:
        return "chunk_attention" + ("_int8" if int8_pools else "")
    if "qmm" in name:  # before the matmul test: the int8 weight kernel
        return "qmm"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def phase_profile(torch, weights: str = "bfloat16") -> dict:
    """The engine phase's workload again, on a fresh client with the same
    seed, under torch.profiler: device time by kernel class, and the
    device's idle share of the serving wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    free_device(torch)
    client = build_client(torch, weights)
    torch.cuda.synchronize()
    texts = prompts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        resps, wall = asyncio.run(_serve_and_stop(client, texts))
        torch.cuda.synchronize()
    check_served(client, resps, len(texts))
    classes: dict[str, list] = {}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name, ms = e.name, e.time_range.elapsed_us() / 1e3
        acc = classes.setdefault(kernel_class(name, weights == "int8"), [0.0, 0])
        acc[0] += ms
        acc[1] += 1
        by_name[name] = by_name.get(name, 0.0) + ms
    if weights != "kv_split":  # the chunk calls' route
        old = [n for n in by_name if old_bf16_chunk(n)]
        if old or not any("chunk_attention_mma_kernel<" in n for n in by_name):
            raise AssertionError(f"{weights} profile: bf16 chunk calls missed the "
                                 f"tensor-core kernel or ran {old[:1]}")
    busy = sum(v[0] for v in classes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": ENGINE_PHASES[weights] + "_profile",
            "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
            "by_class_ms": {k: v[0] for k, v in sorted(classes.items())},
            "kernels_by_class": {k: v[1] for k, v in sorted(classes.items())},
            "top_kernels_ms": {n[:120]: ms for n, ms in top}}


def first_divergence(a: list[list[int]], b: list[list[int]]):
    """(request, position) of the first greedy token where two runs differ,
    or None."""
    for i, (s, t) in enumerate(zip(a, b)):
        for j, (x, y) in enumerate(zip(s, t)):
            if x != y:
                return [i, j]
        if len(s) != len(t):
            return [i, min(len(s), len(t))]
    return None


def phase_witness(torch, pa, weights: str, served: dict) -> dict:
    """The serving phase's requests twice more, with every chunk attention
    call of the forward made twice: the kernel, and its plain version on the
    same inputs (f32 throughout, rounded once), each call's result held
    against the other at TOL (fails beyond it). The first run serves the
    kernel's result, as the serving phase did; the second serves the plain
    version's, which shows how far the greedy streams of random weights
    move under the kernel's rounding alone. Each run records where its
    streams first differ from the serving phase's."""
    from runbookai_tpu_torch.models import llama

    kernel = llama.paged_chunk_attention
    seen = {"calls": 0, "calls_beyond_tol": 0, "max_abs_err": 0.0, "finite": True}
    serve_plain = [False]

    def checked(q, k, v, tables, ctx, pos, ps):
        out = kernel(q, k, v, tables, ctx, pos, ps)
        ref = pa.plain_paged_attention(q, k, v, tables, ctx, pos[:, 0].contiguous(), ps)
        over, diff = excess(out, ref, "bfloat16")
        seen["calls"] += 1
        seen["calls_beyond_tol"] += int(float(over.max()) > 0)
        seen["max_abs_err"] = max(seen["max_abs_err"], float(diff.max()))
        seen["finite"] &= bool(out.isfinite().all())
        return ref if serve_plain[0] else out

    runs = {}
    llama.paged_chunk_attention = checked
    try:
        for mode in ("kernel", "plain"):
            serve_plain[0] = mode == "plain"
            res = phase_engine(torch, weights)
            metrics = res["engine_metrics"]
            runs[mode] = {"spec_drafted": metrics.get("spec_drafted"),
                          "spec_accepted": metrics.get("spec_accepted"),
                          "completion_tokens": res["completion_tokens"],
                          "same_greedy_tokens_as_serving": same_token_share(
                              res["greedy_tokens"], served["greedy_tokens"]),
                          "first_divergence": first_divergence(
                              res["greedy_tokens"], served["greedy_tokens"])}
    finally:
        llama.paged_chunk_attention = kernel
    if not seen["finite"] or seen["calls_beyond_tol"]:
        raise AssertionError(f"{weights} serving: {seen['calls_beyond_tol']} of "
                             f"{seen['calls']} chunk calls beyond TOL of the plain "
                             f"version (max |err| {seen['max_abs_err']:.3e})")
    return {"phase": ENGINE_PHASES[weights] + "_witness", "tol": TOL["bfloat16"],
            **seen, "served": {"spec_drafted": served["engine_metrics"].get("spec_drafted"),
                               "spec_accepted": served["engine_metrics"].get(
                                   "spec_accepted")},
            **runs}


async def _serve_and_stop(client, texts):
    try:
        return await serve(client, texts)
    finally:
        await client.shutdown()


# Phases 7 to 9 of the tree in the working directory, by its own
# chip_smoke.py, one JSON line each (--serve-ab); a first serving run of
# each configuration, not recorded, builds the kernels and warms the
# process.
_SERVE_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
for w in ("bfloat16", "int8"):
    cs.phase_engine(torch, weights=w)
    e = cs.phase_engine(torch, weights=w)
    e.pop("greedy_tokens")
    print(json.dumps(e), flush=True)
    print(json.dumps(cs.phase_profile(torch, weights=w)), flush=True)
"""


def serve_ab(other: Path) -> int:
    """Phases 7 to 9 of ``other`` and of this tree, in the order other,
    this, this, other, each round in a fresh process; a summary line per
    phase on stdout, every line in ``OUT_DIR/serve_ab.jsonl``."""
    log = OUT_DIR / "serve_ab.jsonl"
    log.write_text("")
    for rnd, (tag, tree) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                       ("other", other))):
        proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"chip_smoke: serving in {tree} failed:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            d = {"tree": tag, "round": rnd, **json.loads(line)}
            with log.open("a") as f:
                f.write(json.dumps(d) + "\n")
            keys = ("tokens_per_s", "ttft_ms", "wall_ms", "device_busy_ms", "idle_share",
                    "by_class_ms")
            print(json.dumps({k: d[k] for k in ("tree", "round", "phase", *keys) if k in d}),
                  flush=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from runbookai_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    OUT_DIR.mkdir(exist_ok=True)
    if sys.argv[1:2] == ["--serve-ab"]:
        return serve_ab(Path(sys.argv[2]).resolve())
    _LOG.write_text("")
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    emit(phase_build())
    dec = phase_decode(pa, torch)
    emit(dec)
    chk = phase_chunk(pa, torch)
    emit(chk)
    dec8 = phase_decode(pa, torch, int8=True)
    emit(dec8)
    chk8 = phase_chunk(pa, torch, int8=True)
    emit(chk8)
    qmm = phase_qmm(torch)
    emit(qmm)
    emit(phase_forward(torch))
    emit(phase_forward_int8(torch))
    eng = phase_engine(torch)
    emit(eng)
    emit(phase_profile(torch))
    eng8 = phase_engine(torch, weights="int8")
    emit(eng8)
    emit(phase_profile(torch, weights="int8"))
    emit(phase_witness(torch, pa, "bfloat16", eng))
    emit(phase_witness(torch, pa, "int8", eng8))
    decp = phase_decode_partial(pa, torch)
    emit(decp)
    chkp = phase_chunk_partial(pa, torch)
    emit(chkp)
    emit(phase_forward_tp(torch))
    split = phase_engine(torch, weights="kv_split")
    # Not gated: the sharded forward sums bf16 partial products in another
    # order, so greedy choices between near-equal logits can flip.
    split["same_greedy_tokens_as_engine"] = same_token_share(
        split["greedy_tokens"], eng["greedy_tokens"])
    emit(split)
    emit(phase_profile(torch, weights="kv_split"))

    src = "runbookai_tpu_torch/csrc/paged_attention.cu"
    mma_src = "runbookai_tpu_torch/csrc/chunk_attention.cu"
    pallas = "runbookai_tpu/ops/paged_attention_pallas.py"
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, res, line, served in (
            ("paged_decode_attention", dec, 188, eng),
            ("paged_decode_attention_int8", dec8, 240, eng8)):
        main_path = res["bfloat16"]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"{pallas}:{line}",
                        "launches": served["launches"][name],
                        "max_abs_err": max(res["bfloat16"]["max_abs_err"],
                                           res["float32"]["max_abs_err"]),
                        **{f: main_path[f] for f in fields}})
    # K2 for bf16 queries: the tensor-core kernel, over bf16 pools and over
    # int8 pools (whose T > 1 calls the JAX package serves on its XLA gather
    # path).
    for name, res, served in (("paged_chunk_attention", chk, eng),
                              ("paged_chunk_attention_int8", chk8, eng8)):
        main_path = res["bfloat16"]
        kernels.append({"name": name, "route": "cuda", "source": mma_src,
                        "replaces": f"{pallas}:397", "launches": served["launches"][name],
                        "max_abs_err": main_path["max_abs_err"],
                        "f32_cuda_core_max_abs_err": res["float32"]["max_abs_err"],
                        **{f: main_path[f] for f in fields},
                        "splits": main_path["splits"],
                        **{kind: main_path[kind] for kind in MMA_KINDS
                           if kind in main_path and kind != "prefill"}})
    # The second pass of a split K2 call, on the verify input's partials.
    merge = chk["bfloat16"]["merge"]
    kernels.append({"name": "paged_chunk_merge", "route": "cuda", "source": mma_src,
                    "replaces": f"{pallas}:397", "launches": eng["launches"]["paged_chunk_merge"],
                    "launches_int8": eng8["launches"]["paged_chunk_merge"],
                    "max_abs_err": max(merge["max_abs_err"],
                                       chk8["bfloat16"]["merge"]["max_abs_err"]),
                    **{f: merge[f] for f in fields}, "splits": merge["splits"]})
    # The page-split partial kernels per call as the tp=16 path makes them
    # (one model group's heads over one page shard), the mean over both page
    # shards' calls; launches from engine_kv_split, one call per shard and
    # layer in every forward. library_ms: memory-efficient SDPA with its
    # log-sum-exp over the shard's keys gathered beforehand.
    for name, res, replaces in (
            ("paged_decode_attention_partial", decp, f"{pallas}:567"),
            # The JAX package runs T > 1 page-split attention on XLA.
            ("paged_chunk_attention_partial", chkp,
             "runbookai_tpu/parallel/kv_split.py:104")):
        main_path = res["bfloat16"]["served"]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": split["launches"][name],
               "calls_per_forward": split["calls_per_forward"],
               "max_abs_err": max(res["bfloat16"]["max_abs_err"],
                                  res["float32"]["max_abs_err"]),
               **{f: main_path[f] for f in fields}, "q": main_path["q"],
               "kv_local": main_path["kv_local"]}
        if "verify" in res["bfloat16"]:
            verify = res["bfloat16"]["verify"]["served"]
            row["verify"] = {**{f: verify[f] for f in fields}, "q": verify["q"]}
        kernels.append(row)
    # K5 per decode layer: the sum over its seven products at M=8 (and, under
    # "verify", at M=64), each timed on rotating layer slices.
    kernels.append({"name": "qmm_int8", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/qmm.cu",
                    "replaces": "runbookai_tpu/ops/qmm_pallas.py:83",
                    "launches": eng8["launches"]["qmm_int8"],
                    "max_abs_err": qmm["max_abs_err"], **qmm["per_layer"]["decode"],
                    "verify": qmm["per_layer"]["verify"]})
    emit({"kernels": kernels})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
