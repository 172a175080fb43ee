#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure exits non-zero; one JSON object per phase on stdout):

1. build every kernel from ``runbookai_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source (ptxas report in ``OUT_DIR/ptxas.txt``);
2. hold the decode kernel against its plain version at the serving shapes
   (B=8, 32 query / 8 kv heads, head_dim 128, 16-token pages, 513-wide
   tables, ctx 0..8191) for bf16 and f32 pools, and time it (CUDA events
   over back-to-back calls and, L2 cold, one call at a time; profiler
   device time; host time a call): bf16 queries take the tensor-core kernel
   (``decode_attention.cu``, with its split count), also on the served
   contexts (at most 950 tokens) and at head_dim 64 (32 query / 8 kv
   heads); f32 queries the CUDA-core kernel;
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
   int8 decode kernel (K3: bf16 queries on the tensor-core kernel of
   ``decode_attention.cu``, also at head_dim 64; f32 queries on the
   CUDA-core kernel) and the chunk kernels over int8 pools;
5. hold the int8 weight matmul kernel (K5) against its plain version at
   the 8B's four (K, N) shapes and M = 5, 8, 64, 256 (the mma.sync route
   for M <= 8 and M > 64, wgmma for 8 < M <= 64) with each call's split
   count, each one launch and no allocation but the output a call (split
   partials merged in the launch), f32 x on the CUDA-core kernel, show
   that the tolerance rejects a result with the last K slice dropped, and
   time it rotating over 32 layer slices so that no call finds its weight
   in L2 (its cold time);
6. check the forward on the card (both kernels) against the checked-in HF
   golden logits and against the same forward on the CPU, then the same
   forward with int8 weights over an int8 pool against the CPU;
7. serve llama3-8b-instruct at full width (random weights from a seed)
   through ``TorchCudaClient.chat``: 5 concurrent greedy requests of 64 to
   1024 prompt tokens, 32 new tokens each. Kernel launch counts are zeroed
   just before and read just after; both must rise;
8. serve the same requests once more under torch.profiler: device time by
   kernel class and the device's idle share; it fails unless the bf16
   chunk and decode calls ran the tensor-core kernels (over int8 pools in
   phase 9) and never a removed bf16-query instantiation of the CUDA-core
   kernel (with int8 weights also K5's mma.sync and wgmma kernels, never
   its removed CUDA-core bf16 kernel or second-launch merge). Both serving
   phases fail if the engine loop crashed or a request was aborted, and
   the first if no split chunk call was merged;
9. phases 7 and 8 again with int8 weights and an int8 KV pool
   (``TorchCudaClient.build(dtype="int8", kv_cache_dtype="int8")``): the
   int8 kernels' counts must rise and the bf16 attention counts stay 0;
   then, for both configurations, the requests served twice more with every
   chunk and decode call of the forward (and, with int8 weights, every K5
   call) held against its plain version on the same inputs (fails beyond
   TOL), once serving the
   kernel's result and once the plain version's, and where their greedy
   streams part from phase 7's;
10. the page-split partial kernels (K4 for decode, the chunk partial for
   T > 1) on phase 2's and phase 3's inputs cut into two page shards of
   1024 pages (the chunk partial on the prefill, the verify, and the verify
   with each sequence's pages on one shard), at the shape of one call of
   phase 12's path (one model group's 4 query heads over its kv head) and
   over all heads: each shard's (acc, m, l) against its plain version, the
   same result with the other shard's pages set to NaN (no foreign page is
   loaded), the merge of both shards against K1/K2 on the unsplit pool,
   the rejection of a result with the last page dropped, and per-call
   times (events, device, host) beside the memory-efficient SDPA call that
   returns the same partial normalised (out, log-sum-exp); bf16 partials
   take the tensor-core kernels (K4 ``decode_attention.cu``'s, the chunk
   partial ``chunk_attention.cu``'s), with their split counts, and K4 runs
   also at head_dim 64;
11. the tensor-parallel forward of llama3-8b-instruct at full width, depth
   cut to 2 layers, f32 weights and pool, on a model=8 x seq=2 and a
   model=8 x seq=1 mesh of 16 and 8 shards on the one card, against the
   unsharded forward: a prefill chunk, a decode step and a T=8 verify;
12. the requests of phase 7 served at full depth through
   ``TorchCudaClient.build(tp=16, devices=["cuda:0"] * 16)`` (model=8 x
   seq=2) over a 256-page pool: pages of both page shards must be
   allocated, the partial kernels' counts must rise and K1's and K2's
   stay 0; then once more under torch.profiler, as phase 8 (it fails
   unless the chunk and decode partials ran the tensor-core kernels); then
   twice more with every chunk- and decode-partial call held against its
   plain version, as the witness of phase 9;
13. W1 (``paged_ragged_attention``, run after phase 4) on the serving
   configuration's mixed batch (N = 576 tokens in 72 blocks of 8, 13
   rows): 8 decode rows at the served contexts with a 512-token prefill
   at offset 4096, and 7 decode rows up to 8191 tokens with a free slot
   and a 500-token prefill ending in a pad block, the latter also over an
   int8 pool and at a GQA group of 7 and at head_dim 64; each through its
   per-layer launch on a tile list built beforehand (the ragged kernel of
   ``ragged_attention.cu``), against its plain version, pad blocks exactly
   zero, one kernel and no allocation but the output a call, timed (also
   L2-cold) beside its bound and SDPA on each block's gathered K/V, with
   its tile count and modeled key visits, and the whole call; the tile
   list's kernel (``ragged_plan.cu``, one launch) against its plain
   version record for record, timed beside it; a batch of 18 long decode
   rows, of which the first 16 split and the last two do not, against the
   plain version; K2's one-row prefill at offset 4096 is timed beside them;
14. (after phase 9) the requests served with mixed dispatch on
   (``engine={"mixed_dispatch": True}``): it fails unless mixed steps ran
   and W1 and its tile list launched; its profiled rerun (the ragged kernel
   once per W1 call, the list's kernel once per list, K2's kernel once per
   K2 call); its witness (W1's calls, its lists exactly, chunk and decode
   calls each held against the plain version); then bf16 serving
   with the overlapped pipeline off, whose greedy streams must equal phase
   7's wherever both runs issued the same forwards (the serving phases log
   each forward's entry point and token shape), and its profiled rerun
   beside phase 8's idle share.

Then it prints the kernels' line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --serve-ab DIR [bfloat16] [int8] [mixed]

runs instead a same-card A/B of serving phases (by default phases 7 to 9:
bf16 and int8 serving; ``mixed``: phase 14's mixed dispatch; each after an
unrecorded warm-up run, and their profiled reruns) between DIR,
another checkout of the repository (for example a parent commit unpacked
with ``git archive``), and this one, each by its own ``chip_smoke.py`` in a
fresh process, in the order DIR, this, this, DIR; every line goes to
``OUT_DIR/serve_ab.jsonl``. It lives here because a checkout's serving
phases are reached only through its own ``chip_smoke.py``, and it is the
committed source of PERF.md's same-card serving comparisons.

    python3 chip_smoke.py --kernel-ab DIR

runs instead the attention kernel phases (2, 3 and 13) of DIR and of this
checkout, each by its own ``chip_smoke.py`` in a fresh process, in the
order DIR, this, this, DIR, and writes their device times (K1 on the
decode input; K2 on the 4 x 512 prefill, the T=8 verify and the one-row
prefill; W1 in its five cases) and this checkout's mean over DIR's to
``OUT_DIR/kernel_ab.jsonl``.

    python3 chip_smoke.py --forward-ab DIR

times one mixed forward of the 8B at full depth on phase 13's served batch
(events over back-to-back forwards, device time, host time to issue one)
with DIR's package and with this one's, each in a fresh process, in the
order DIR, this, this, DIR, measured by this file's code; lines in
``OUT_DIR/forward_ab.jsonl``. The mixed path's A/B apart from the
greedy streams, which change the serving phases' dispatches.

    python3 chip_smoke.py --overlap-ab

profiles each serving configuration (bf16, int8, page split) with the
overlapped pipeline on, off, off, on, after an unrecorded warm-up run, in
one process: idle share and wall of each run, in
``OUT_DIR/overlap_ab.jsonl``.
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
    for _ in range(3):  # a window in which the profiler recorded nothing is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us:
            break
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


def cold_ms(fn, iters: int = 10) -> float:
    """Time of one call of ``fn`` that finds the 50 MB L2 cold, as a serving
    step finds the pool (CUDA events, mean over ``iters`` calls): before each
    call a 256 MB write evicts the L2, and a spin kernel first keeps the
    device busy while the host enqueues the write, the events and the call,
    so that the call alone lies between the events."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # about 1 ms of device time
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    del flush
    return total / iters


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


def one_launch(what: str) -> int:
    """The kernel launches counted since ``reset_counts``: one wrapper call
    must have made exactly one (no separate merge)."""
    n = sum(counts().values())
    if n != 1:
        raise AssertionError(f"{what}: {counts()} launches for one call")
    return n


def not_slower(ms: float, library_ms: float, what: str) -> None:
    """A tensor-core decode kernel must not take longer (CUDA events) than
    the library call that computes the same function on the same inputs."""
    if ms > library_ms:
        raise AssertionError(f"{what}: {ms:.4f} ms, slower than the library's "
                             f"{library_ms:.4f} ms")


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


def make_pool(gen, dtype, ctx_lens, device, n_kv: int = N_KV, hd: int = HD):
    """Random pools, and tables whose live pages are distinct per sequence;
    entries past ctx point at random pages, the trash column at page 0."""
    import torch

    k = torch.randn((NUM_PAGES * PS, n_kv, hd), generator=gen, device=device).to(dtype)
    v = torch.randn((NUM_PAGES * PS, n_kv, hd), generator=gen, device=device).to(dtype)
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
        return vals.shape[1] * (vals.shape[2] * vals.element_size() + scales.element_size())
    return pool.shape[1] * pool.shape[2] * pool.element_size()


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
    int8 tuple), the dropped-last-page check, and its times (CUDA events
    over back-to-back calls and, L2 cold, one call at a time; profiler
    device time; host time a call), its route and split count, and its
    bound."""
    import torch.nn.functional as F

    dev = q.device
    ctx_l = ctx.tolist()
    pool = k[0] if isinstance(k, tuple) else k
    n_q, hd = q.shape[1:]

    def call():
        return pa.paged_decode_attention(q, k, v, tables, ctx, PS)

    reset_counts()
    out = call()
    per_call = one_launch(f"decode {name} {list(q.shape)}")
    ref = pa.plain_paged_attention(q[:, None], k, v, tables, ctx, None, PS)[:, 0]
    torch.cuda.synchronize()
    err = compare(out, ref, name, f"decode {name}")
    if any(bool(out[i].abs().max() != 0) for i, c in enumerate(ctx_l) if c == 0):
        raise AssertionError("decode: a ctx-0 row must be zeros")
    wrong = drop_last_page(pa, q[:, None], k, v, tables, ctx, None,
                           ref[:, None], name)
    ms = time_ms(call)
    plain_ms = time_ms(lambda: pa.plain_paged_attention(
        q[:, None], k, v, tables, ctx, None, PS), iters=3, warmup=1)
    q4, kk, vv = gather_for_library(q[:, None], k, v, tables, ctx_l, max(ctx_l))
    mask = (torch.arange(kk.shape[2], device=dev)[None, :] < ctx[:, None].long()
            )[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), iters=5, warmup=1)
    del kk, vv
    tokens = sum(ctx_l)
    n_bytes = (2 * q.numel() * q.element_size() + tokens * 2 * token_bytes(k)
               + sum(-(-c // PS) for c in ctx_l) * 4 + len(ctx_l) * 4)
    bound_ms, bound_by = bound(n_bytes, 4.0 * tokens * n_q * hd, name)
    route = pa.decode_route(q.dtype, hd, pool.dtype)
    if route == "mma":
        not_slower(ms, library_ms, f"decode {name} {list(q.shape)}")
    plan = pa.decode_plan(q.shape[0], n_q, pool.shape[1], hd, tables.shape[1])
    return {"route": route, "splits": plan.splits if route == "mma" else 1,
            "heads": [n_q, pool.shape[1]], "head_dim": hd, "launches_per_call": per_call,
            "max_abs_err": err, "tol": TOL[name], "ms": ms, "cold_ms": cold_ms(call),
            "device_ms": device_ms(call, iters=20), "host_ms": host_ms(call),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ctx_lens": ctx_l,
            "drop_last_page": wrong}


# A second geometry for the tensor-core decode kernels: the catalogue's
# head_dim-64 model (llama3.2-1b-instruct: 32 query heads over 8 kv heads).
HD64 = (32, 8, 64)


def phase_decode(pa, torch, int8: bool = False) -> dict:
    """K1 over bf16 and f32 pools or, with ``int8``, K3 over int8 pools
    quantized from them, with queries of the same two types, on the decode
    input (ctx 0..8191); bf16 queries (the tensor-core kernel) also at
    head_dim 64 (``hd64``) and, for K1, on the served contexts (at most 950
    tokens)."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3 if int8 else 1)
    result: dict = {"phase": "decode_int8_kernel" if int8 else "decode_kernel",
                    "ctx_lens": DECODE_CTX}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        inputs = [("decode", DECODE_CTX, (N_Q, N_KV, HD))]
        if dtype == torch.bfloat16:
            inputs.append(("hd64", DECODE_CTX, HD64))
            if not int8:
                inputs.append(("served", SERVED_CTX, (N_Q, N_KV, HD)))
        for kind, ctx_l, (n_q, n_kv, hd) in inputs:
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
            k, v, tables = make_pool(gen, dtype, ctx_l, dev, n_kv, hd)
            if int8:
                k, v = quantize_kv(k), quantize_kv(v)
            q = torch.randn((B, n_q, hd), generator=gen, device=dev).to(dtype)
            case = decode_case(pa, torch, q, k, v, tables, ctx, name)
            if kind == "decode":
                result[name] = case
            else:
                result[name][kind] = case
            del k, v
    return result


# Served contexts before a T=8 verify: the serving phases' prompts (83 to
# 918 tokens) plus their completions; every ctx at most 950.
SERVED_CTX = [83, 150, 266, 397, 512, 640, 800, 942]


def chunk_inputs(torch, dev, gen, dtype, kind, geo=(N_Q, N_KV, HD)):
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
    n_q, n_kv, hd = geo  # query heads, kv heads, head_dim
    k, v, tables = make_pool(gen, dtype, ctx_lens, dev, n_kv, hd)
    pos = torch.full((len(starts), t), trash, dtype=torch.int32, device=dev)
    for i, (s, n) in enumerate(zip(starts, real)):
        if n:
            pos[i, :n] = torch.arange(s, s + n, dtype=torch.int32, device=dev)
        else:
            tables[i] = 0  # the engine's pad row: null table, ctx 1
    q = torch.randn((len(starts), t, n_q, hd), generator=gen, device=dev).to(dtype)
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
    return {"ms": ms, "device_ms": device_ms(call, iters=10), "cold_ms": cold_ms(call),
            "host_ms": host_ms(call), "plain_ms": plain_ms, "library_ms": library_ms,
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
            "cold_ms": cold_ms(lambda: pa.chunk_merge(acc, m, l, torch.bfloat16)),
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


# The serving configuration's mixed batch (EngineCore._run_mixed): one
# 8-token block per decode slot, then the 512-token prefill budget; rows =
# 8 slots + 4 prefill rows + the null row. N = 576 tokens in 72 blocks.
RQ = 8
MIX_PF_TOKENS = 512
MIX_PF_START = 4096  # the prefill row's offset in the ragged inputs
MIX_ROWS = B + 4 + 1
# Ragged inputs: decode contexts per slot (None = a free slot, whose block is
# a pad block of the null row) and the prefill row's tokens at offset 4096.
# "long" ends its prefill region with a pad block (500 tokens in 63 blocks).
RAGGED_KINDS = {"served": (SERVED_CTX, 512),
                "long": ([1, 16, 17, 1000, 8191, 300, 4097, None], 500)}
# Geometries beyond the 8B's (query heads, kv heads, head_dim):
# qwen2-7b-instruct's group of 7, llama3.2-1b-instruct's head_dim 64.
RAGGED_GEOMETRIES = {"group7": (28, 4, 128), "hd64": HD64}


def ragged_inputs(torch, dev, gen, dtype, kind, n_q=N_Q, n_kv=N_KV, hd=HD):
    """A flat mixed batch in the engine's layout: (q [N, n_q, hd], k, v,
    tables [R, P + 1], ctx [R], positions [N], row_ids [N], the indices of
    the tokens of pad blocks)."""
    dec_ctx, pf_len = RAGGED_KINDS[kind]
    trash, null, pf_start = MAX_PAGES * PS, MIX_ROWS - 1, MIX_PF_START
    ctx_rows = [c or 0 for c in dec_ctx] + [pf_start + pf_len] + [0] * (MIX_ROWS - B - 1)
    k, v, tables = make_pool(gen, dtype, ctx_rows, dev, n_kv, hd)
    n = B * RQ + MIX_PF_TOKENS
    pos = torch.full((n,), trash, dtype=torch.int32, device=dev)
    rows = torch.full((n,), null, dtype=torch.int32, device=dev)
    for s, c in enumerate(dec_ctx):
        if c:
            pos[s * RQ] = c - 1
            rows[s * RQ:(s + 1) * RQ] = s
    off = B * RQ
    pos[off:off + pf_len] = torch.arange(pf_start, pf_start + pf_len, dtype=torch.int32,
                                         device=dev)
    rows[off:off + -(-pf_len // RQ) * RQ] = B
    for r, c in enumerate(ctx_rows):
        if not c:
            tables[r] = 0  # the engine's null rows
    ctx = torch.tensor(ctx_rows, dtype=torch.int32, device=dev)
    q = torch.randn((n, n_q, hd), generator=gen, device=dev).to(dtype)
    pads = [i for i, r in enumerate(rows.tolist()) if ctx_rows[r] == 0]
    return q, k, v, tables, ctx, pos, rows, pads


def modeled_kv_bytes(pa, plan, k) -> dict:
    """A model, not a measurement: the key visits of the ragged kernel's
    live tiles (``ragged_plan``; each tile loads its keys for its kv head,
    from L2 or device memory) and those visits times the K and V bytes of a
    key and kv head. No byte counter of the card is read."""
    pool = k[0] if isinstance(k, tuple) else k
    per_key = 2 * token_bytes(k) // pool.shape[1]  # K and V of one kv head
    live = int(plan.live)
    visits = int(plan.weight[:live].sum())
    return {"tiles": live, "modeled_key_visits": visits,
            "modeled_kv_bytes": visits * per_key}


def modeled_k2_block_bytes(k, block_ctx, block_start) -> int:
    """The same model for K2's kernel at ``[N / 8, 8]`` on the same batch, as
    W1 ran before: each block visits the keys below min(ctx, its last
    position + 1), every kv head."""
    return sum(max(0, min(c, s + RQ)) for c, s in zip(block_ctx, block_start)) * 2 * \
        token_bytes(k)


def plan_case(pa, torch, rows, ctx, pos, n_q: int, n_kv: int, hd: int, p: int) -> dict:
    """W1's tile list: the kernel (``ragged_plan``, one launch a call)
    against its plain version (``plain_ragged_plan``, tensor ops on the
    card), record for record; their times, and the bound of the kernel's
    bytes (the blocks' row ids and positions and the rows' contexts read
    once, the records, weights and live count written once)."""
    def kernel():
        return pa.ragged_plan(rows, ctx, pos, n_q, n_kv, hd, p, PS, RQ)

    def plain():
        return pa.plain_ragged_plan(rows, ctx, pos, n_q, n_kv, hd, p, PS, RQ)

    reset_counts()
    got = kernel()
    torch.cuda.synchronize()
    launched = counts()
    if launched["ragged_plan"] != 1 or sum(launched.values()) != 1:
        raise AssertionError(f"ragged_plan: {launched} launches for one call")
    want = plain()
    diff = max(int((got.tiles - want.tiles).abs().max()),
               int((got.weight - want.weight).abs().max()), abs(int(got.live) - int(want.live)))
    if diff:
        raise AssertionError(f"ragged_plan: the kernel's list differs from the plain "
                             f"version's by up to {diff}")
    names = kernel_names(torch, kernel, 2)
    if len(names) != 2 or not all(PLAN_KERNEL in nm for nm in names):
        raise AssertionError(f"ragged_plan: 2 calls ran {names}, not 2 x {PLAN_KERNEL}")
    n_bytes = (2 * (rows.numel() // RQ) * 4 + ctx.numel() * 4
               + got.tiles.numel() * 4 + got.weight.numel() * 4 + 4)
    bound_ms, bound_by = bound(n_bytes, 0.0, "bfloat16")
    return {"max_abs_err": diff, "records": got.tiles.shape[0], "live": int(got.live),
            "ms": time_ms(kernel), "device_ms": device_ms(kernel, iters=10),
            "cold_ms": cold_ms(kernel), "host_ms": host_ms(kernel),
            "plain_ms": time_ms(plain), "plain_device_ms": device_ms(plain, iters=10),
            "plain_host_ms": host_ms(plain), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


RAGGED_KERNEL = "ragged_attention_kernel<"
PLAN_KERNEL = "ragged_plan_kernel"


def ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, name: str) -> dict:
    """W1 against its plain version (the blocks' tables gathered, then the
    plain chunk attention), pad blocks exactly zero; the per-layer launch on
    a tile list built beforehand (``ragged_tile_attention``, as the ragged
    forward makes it): one ragged kernel a call, no merge launch and no
    allocation but the output after the first call; its times (events,
    device, L2-cold, host) beside its bound and SDPA on each block's gathered
    K/V with its causal mask; the list's kernel against its plain version
    (:func:`plan_case`) and the whole call (``paged_ragged_attention``: list,
    then launch); the tile count, and the modeled key visits and K/V bytes
    a call beside K2's at ``[N / 8, 8]`` (a model, not a measurement)."""
    import torch.nn.functional as F

    n, n_q, hd = q.shape
    nb = n // RQ
    pool = k[0] if isinstance(k, tuple) else k
    name_w1 = "paged_ragged_attention" + ("_int8" if isinstance(k, tuple) else "")

    plan_res = plan_case(pa, torch, rows, ctx, pos, n_q, pool.shape[1], hd, tables.shape[1])
    plan = pa.ragged_plan(rows, ctx, pos, n_q, pool.shape[1], hd, tables.shape[1], PS, RQ)

    def call():
        return pa.ragged_tile_attention(q, k, v, tables, ctx, pos, rows, plan, PS)

    def whole():
        return pa.paged_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, ragged_block=RQ)

    reset_counts()
    out = call()
    torch.cuda.synchronize()
    launched = counts()
    per_call = sum(launched.values())
    if per_call != 1 or launched[name_w1] != 1:
        raise AssertionError(f"ragged {name}: {launched} launches for one call")
    names = kernel_names(torch, call, 4)
    if len(names) != 4 or not all(RAGGED_KERNEL in nm for nm in names):
        raise AssertionError(f"ragged {name}: 4 calls ran {names}, not 4 x {RAGGED_KERNEL}")
    before = torch.cuda.memory_allocated()
    again = call()
    grew = torch.cuda.memory_allocated() - before
    del again
    if grew != out.numel() * out.element_size():
        raise AssertionError(f"ragged {name}: a call allocated {grew} bytes, its output "
                             f"{out.numel() * out.element_size()}")

    def plain():
        return pa.plain_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, RQ)

    ref = plain()
    torch.cuda.synchronize()
    err = compare(out, ref, "bfloat16", f"ragged {name}")
    err_whole = compare(whole(), ref, "bfloat16", f"ragged {name} (whole call)")
    if pads and bool((out[pads] != 0).any()):
        raise AssertionError(f"ragged {name}: a pad block is not exactly zero")
    block_rows = rows.view(nb, RQ)[:, 0].long()
    bt, bc = tables[block_rows], ctx[block_rows]
    qb, pb = q.view(nb, RQ, n_q, hd), pos.view(nb, RQ)
    q_start = pb[:, 0].contiguous()
    ctx_l, start_l = bc.tolist(), q_start.tolist()
    q4, kk, vv = gather_for_library(qb, k, v, bt, ctx_l, int(ctx.max()))
    kpos = torch.arange(kk.shape[2], device=q.device)
    qpos = q_start[:, None].long() + torch.arange(RQ, device=q.device)
    mask = ((kpos[None, None, :] < bc[:, None, None].long())
            & (kpos[None, None, :] <= qpos[:, :, None]))[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), iters=5, warmup=1)
    del q4, kk, vv, mask
    # Work the kernel does on these inputs: every query of a block (a decode
    # block's seven pads included) over its row's causal keys; bytes: q in,
    # out, each row's context of K and V once, the tables' live entries.
    pairs = sum(min(c, s + t + 1) for c, s in zip(ctx_l, start_l) for t in range(RQ))
    row_ctx = ctx.tolist()
    n_bytes = (2 * q.numel() * q.element_size() + sum(row_ctx) * 2 * token_bytes(k)
               + sum(-(-c // PS) for c in row_ctx) * 4 + 2 * n * 4)
    bound_ms, bound_by = bound(n_bytes, 4.0 * pairs * n_q * hd, "bfloat16")
    return {"max_abs_err": err, "max_abs_err_whole_call": err_whole, "tol": TOL["bfloat16"],
            "pad_tokens": len(pads),
            "pad_max_abs": float(out[pads].abs().max()) if pads else None,
            "launches_per_call": per_call, "kernel": names[0][:80], "allocated_per_call": grew,
            "ctas": plan.shape.ctas, "capacity": plan.shape.capacity,
            "keys_per_split": plan.shape.keys_per_split,
            "splits": max(1, int(plan.tiles[:int(plan.live), 7].max())),
            **modeled_kv_bytes(pa, plan, k),
            "modeled_kv_bytes_k2_blocks": modeled_k2_block_bytes(k, ctx_l, start_l),
            "ms": time_ms(call), "device_ms": device_ms(call, iters=10),
            "cold_ms": cold_ms(call), "host_ms": host_ms(call), "plan": plan_res,
            "call_device_ms": device_ms(whole, iters=10),
            "plain_ms": time_ms(plain, iters=2, warmup=1),
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "decode_ctx": ctx_l[:B], "q": list(q.shape)}


def wide_runs_case(pa, torch, dev, gen) -> dict:
    """W1 on more long decode rows than split: 18 one-block rows of 1,100
    to 1,440 keys (two splits of 1,088 each), a 64-token prefill at offset
    512 and two pad blocks. The first 16 rows split in their workspace
    slots, the last two walk their keys in one tile; against the plain
    version (whole call: list, then launch), pad blocks exactly zero."""
    slots, pf_len, pf_start = 18, 64, 512
    ctx_rows = [1100 + 20 * s for s in range(slots)] + [pf_start + pf_len, 0]
    null = len(ctx_rows) - 1
    k, v, tables = make_pool(gen, torch.bfloat16, ctx_rows, dev)
    tables[null] = 0
    n = slots * RQ + pf_len + 2 * RQ
    pos = torch.full((n,), MAX_PAGES * PS, dtype=torch.int32, device=dev)
    rows = torch.full((n,), null, dtype=torch.int32, device=dev)
    for s_ in range(slots):
        pos[s_ * RQ] = ctx_rows[s_] - 1
        rows[s_ * RQ:(s_ + 1) * RQ] = s_
    off = slots * RQ
    pos[off:off + pf_len] = torch.arange(pf_start, pf_start + pf_len, dtype=torch.int32,
                                         device=dev)
    rows[off:off + pf_len] = slots
    ctx = torch.tensor(ctx_rows, dtype=torch.int32, device=dev)
    q = torch.randn((n, N_Q, HD), generator=gen, device=dev).to(torch.bfloat16)
    plan = pa.ragged_plan(rows, ctx, pos, N_Q, N_KV, HD, tables.shape[1], PS, RQ)
    want = pa.plain_ragged_plan(rows, ctx, pos, N_Q, N_KV, HD, tables.shape[1], PS, RQ)
    if not all(torch.equal(getattr(plan, f), getattr(want, f))
               for f in ("tiles", "live", "weight")):
        raise AssertionError("wide runs: the tile list kernel differs from its plain version")
    live = plan.tiles[:int(plan.live)]
    split_rows = sorted({int(t[1]) // RQ for t in live if int(t[7]) > 1})
    if split_rows != list(range(pa.RAGGED_SPLIT_RUNS)):
        raise AssertionError(f"wide runs: rows {split_rows} split, not the first "
                             f"{pa.RAGGED_SPLIT_RUNS}")
    out = pa.paged_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, ragged_block=RQ)
    ref = pa.plain_ragged_attention(q, k, v, tables, ctx, pos, rows, PS, RQ)
    err = compare(out, ref, "bfloat16", "ragged wide runs")
    pads = list(range(n - 2 * RQ, n))
    if bool((out[pads] != 0).any()):
        raise AssertionError("ragged wide runs: a pad block is not exactly zero")
    return {"max_abs_err": err, "split_rows": len(split_rows),
            "unsplit_wide_rows": slots - len(split_rows), "tiles": int(plan.live),
            "q": list(q.shape)}


def phase_ragged(pa, torch) -> dict:
    """W1 (``paged_ragged_attention``; its per-layer launch
    ``ragged_tile_attention``) on the card at the serving configuration's
    mixed shape (N = 576, R = 13): 8 decode rows at the served contexts with
    a 512-token prefill at offset 4096; 7 decode rows up to 8191 tokens, a
    free slot and a 500-token prefill ending in a pad block; the latter over
    an int8 pool and at two more geometries (a GQA group of 7, head_dim 64).
    Then more long decode rows than split (:func:`wide_runs_case`). Beside
    them, in the same phase, K2 on its one-row prefill of 512 tokens at
    offset 4096 (the served case's prefill row alone)."""
    from runbookai_tpu_torch.ops.attention import quantize_kv

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(12)
    result: dict = {"phase": "ragged_kernel", "rows": MIX_ROWS, "tokens": B * RQ + MIX_PF_TOKENS}
    for kind in RAGGED_KINDS:
        q, k, v, tables, ctx, pos, rows, pads = ragged_inputs(torch, dev, gen,
                                                              torch.bfloat16, kind)
        result[kind] = ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, kind)
        if kind == "long":
            k8, v8 = quantize_kv(k), quantize_kv(v)
            result["int8"] = ragged_case(pa, torch, q, k8, v8, tables, ctx, pos, rows, pads,
                                         "long int8")
            del k8, v8
        del q, k, v
    for geo, (n_q, n_kv, hd) in RAGGED_GEOMETRIES.items():
        q, k, v, tables, ctx, pos, rows, pads = ragged_inputs(
            torch, dev, gen, torch.bfloat16, "long", n_q, n_kv, hd)
        result[geo] = {"heads": [n_q, n_kv], "head_dim": hd,
                       **ragged_case(pa, torch, q, k, v, tables, ctx, pos, rows, pads, geo)}
        del q, k, v
    q, k, v, tables, ctx, pos, _ = chunk_inputs(torch, dev, gen, torch.bfloat16,
                                                "prefill_one_row")

    def k2_call():
        return pa.paged_chunk_attention(q, k, v, tables, ctx, pos, PS)

    result["k2_one_row_prefill"] = {"device_ms": device_ms(k2_call, iters=10),
                                    "cold_ms": cold_ms(k2_call), "ms": time_ms(k2_call)}
    del q, k, v
    result["wide_runs"] = wide_runs_case(pa, torch, dev, gen)
    result["max_abs_err"] = max(result[x]["max_abs_err"]
                                for x in (*RAGGED_KINDS, "int8", *RAGGED_GEOMETRIES,
                                          "wide_runs"))
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

    def guarded(s):
        """The kernel on shard s's slice set between pages of NaN that
        stand for every other shard's pages (local ids below 0 and past
        pages_local): a foreign page loaded would turn the result NaN."""
        slices = []
        for x in (ks[s], vs[s]):
            nan = torch.full_like(x, float("nan"))
            slices.append(torch.cat([nan, x, nan])[x.shape[0]:2 * x.shape[0]])
        if decode:
            return pa.paged_decode_attention_partial(q, *slices, tables, ctx, s, PS,
                                                     pages_local)
        return pa.paged_chunk_attention_partial(q, *slices, tables, ctx, q_pos, s, PS,
                                                pages_local)

    parts, errs = [], []
    for s in range(PG):
        reset_counts()
        got = kernel(s)
        per_call = one_launch(f"{what} {name} shard {s}")
        want = plain(s)
        torch.cuda.synchronize()
        errs.append(max(compare(g, w, name, f"{what} {name} shard {s} {field}")
                        for g, w, field in zip(got, want, ("acc", "m", "l"))))
        if not all(torch.equal(g, x) for g, x in zip(got, guarded(s))):
            raise AssertionError(f"{what} {name} shard {s}: the result moved with the "
                                 f"other shards' pages set to NaN")
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
    hd = q.shape[-1]
    shards = []
    for s in range(PG):
        keys, pairs, entries = owned_work(tables, ctx, q_start, q4.shape[1], s, pages_local)
        rows = q.numel() // hd
        n_bytes = (q.numel() * q.element_size() + keys * 2 * token_bytes(k)
                   + q.numel() * 4 + 2 * rows * 4 + entries * 4
                   + q.shape[0] * 4 * (1 if decode else 2))
        bound_ms, bound_by = bound(n_bytes, 4.0 * pairs * q.shape[-2] * hd, name)
        lib_call, lib_check = library_partial(torch, q4, ks[s], vs[s], tables, ctx,
                                              q_start, s, pages_local)
        acc, m, l = parts[s]
        shards.append({"ms": time_ms(lambda: kernel(s)), "cold_ms": cold_ms(lambda: kernel(s)),
                       "device_ms": device_ms(lambda: kernel(s), iters=10),
                       "host_ms": host_ms(lambda: kernel(s)),
                       "plain_ms": time_ms(lambda: plain(s), iters=3, warmup=1),
                       "library_ms": time_ms(lib_call, iters=5, warmup=1),
                       "library_max_abs_err": lib_check(
                           *((acc[:, None], m[:, None], l[:, None]) if decode
                             else (acc, m, l))),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "keys": keys, "max_abs_err": errs[s]})
        del lib_call, lib_check
    mean = {f: sum(x[f] for x in shards) / PG
            for f in ("ms", "cold_ms", "device_ms", "host_ms", "plain_ms", "library_ms",
                      "bound_ms")}
    b, n_q = q.shape[0], q.shape[-2]
    t, n_kv = q4.shape[1], ks[0].shape[1]
    route = pa.decode_route(q.dtype, hd, k.dtype, partial=True)
    if decode and route == "mma":
        not_slower(mean["ms"], mean["library_ms"], f"{what} {name} {list(q.shape)}")
    splits = (pa.decode_plan(b, n_q, n_kv, hd, tables.shape[1]) if decode
              else pa.chunk_plan(b, t, n_q, n_kv, hd, tables.shape[1])).splits
    return {"route": route, "splits": splits if route == "mma" else 1,
            "launches_per_call": per_call,
            "max_abs_err": max(errs), "merge_max_abs_err": merge_err, "tol": TOL[name],
            "q": list(q.shape), "kv_local": list(ks[0].shape),
            "foreign_pages_loaded": False,
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
    served shape (B=8, 4 query heads over 1 kv head) and over all heads;
    bf16 queries (the tensor-core kernel) also at head_dim 64 (``hd64``)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    result: dict = {"phase": "decode_partial_kernel", "page_shards": PG,
                    "ctx_lens": DECODE_CTX}
    for dtype, geo in ((torch.float32, None), (torch.bfloat16, None),
                       (torch.bfloat16, "hd64")):
        name = str(dtype).split(".")[1]
        n_q, n_kv, hd = HD64 if geo else (N_Q, N_KV, HD)
        k, v, tables = make_pool(gen, dtype, DECODE_CTX, dev, n_kv, hd)
        q = torch.randn((B, n_q, hd), generator=gen, device=dev).to(dtype)
        case = partial_cases(pa, torch, q, k, v, tables, ctx, None, name)
        if geo:
            result[name][geo] = {"heads": [n_q, n_kv], "head_dim": hd, **case}
            result[name]["max_abs_err"] = max(result[name]["max_abs_err"],
                                              case["max_abs_err"])
        else:
            result[name] = case
        del k, v
    return result


def one_shard_tables(tables, ctx):
    """The tables with sequence i's live pages drawn in ascending order from
    page shard i % PG alone, as the engine's allocator hands out long runs
    (entries past ctx unchanged)."""
    import torch

    tables = tables.clone()
    local = NUM_PAGES // PG
    nxt = [max(1, s * local) for s in range(PG)]  # page 0 is the null page
    for i, c in enumerate(ctx.tolist()):
        need, s = -(-c // PS), i % PG
        if nxt[s] + need > (s + 1) * local:
            raise AssertionError(f"page shard {s} cannot hold sequence {i}")
        tables[i, :need] = torch.arange(nxt[s], nxt[s] + need, dtype=torch.int32)
        nxt[s] += need
    return tables


def phase_chunk_partial(pa, torch) -> dict:
    """The chunk partial on phase 3's 4 x 512 prefill and T=8 verify inputs,
    cut into PG page shards (their pages drawn over the whole pool, so
    ownership interleaves page by page), and on the verify input with each
    sequence's pages on one shard; at the served shape and over all heads.
    bf16 queries take the tensor-core kernel, f32 queries the CUDA-core
    kernel; bf16 also on the verify input at head_dim 64 (``verify_hd64``)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    result: dict = {"phase": "chunk_partial_kernel", "page_shards": PG}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        cases = {}
        kinds = ("prefill", "verify", "verify_one_shard")
        for kind in kinds + (("verify_hd64",) if dtype == torch.bfloat16 else ()):
            geo = HD64 if kind.endswith("_hd64") else (N_Q, N_KV, HD)
            q, k, v, tables, ctx, pos, _ = chunk_inputs(
                torch, dev, gen, dtype, kind.split("_")[0], geo)
            if kind.endswith("_one_shard"):
                tables = one_shard_tables(tables, ctx)
            cases[kind] = partial_cases(pa, torch, q, k, v, tables, ctx, pos, name)
            del q, k, v
        worst = max(c["max_abs_err"] for c in cases.values())
        result[name] = {**cases.pop("prefill"), **cases, "max_abs_err": worst}
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


def kernel_names(torch, fn, calls: int) -> list[str]:
    """The device kernels (and copies) that ``calls`` calls of ``fn`` run,
    by torch.profiler, after one call outside it. Every caller's ``fn``
    launches at least one kernel a call, so a profile that recorded fewer
    device events than ``calls`` (the profiler here sometimes drops a whole
    window, or some of its events) is taken again, up to five times; the
    callers then check the names and their count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= calls:
            break
    return names


QMM_KERNELS = {"mma": "qmm_mma_kernel(", "wgmma": "qmm_wgmma_kernel<", "f32": "qmm_f32_kernel("}


def qmm_one_launch(qm, torch, x, q, s, what: str) -> dict:
    """One device kernel per call, the route's (``qmm_route``: mma.sync or
    wgmma for bf16 x, the CUDA-core kernel for f32), never a second-launch
    merge; and after the first call no allocation but the output's (the
    split workspace is cached per stream)."""
    want = QMM_KERNELS[qm.qmm_route(x.shape[0], x.dtype == torch.float32)]
    names = kernel_names(torch, lambda: qm.qmm_int8(x, q, s), 4)
    if len(names) != 4 or not all(want in nm for nm in names):
        raise AssertionError(f"{what}: 4 calls ran {names}, not 4 x {want}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = qm.qmm_int8(x, q, s)
    grew = torch.cuda.memory_allocated() - before
    del out
    probe = torch.empty((x.shape[0], q.shape[1]), dtype=x.dtype, device=x.device)
    out_bytes = torch.cuda.memory_allocated() - before
    del probe
    if grew != out_bytes:
        raise AssertionError(f"{what}: a call allocated {grew} bytes, its output "
                             f"{out_bytes}")
    return {"kernels_per_call": len(names) // 4, "kernel": names[0][:80],
            "allocated_per_call": grew}


def qmm_case(qm, torch, x, q, s, deq, name: str) -> dict:
    """K5 against its plain version on layer 0 of a stacked weight, the
    dropped-K-slice check, one launch and no allocation but the output per
    call, and kernel, plain and library (``torch.matmul`` by ``deq``, the
    weights dequantized to bf16) device times, each call on the next of the
    32 layer slices, so that every timed call reads its weights from outside
    the 50 MB L2 (its cold time); ``events_ms`` is the kernel's CUDA-event
    time over back-to-back calls, which the host's launch rate can set."""
    m, k = x.shape
    n = q.shape[2]
    out = qm.qmm_int8(x, q[0], s[0])
    ref = qm.plain_qmm_int8(x, q[0], s[0])
    torch.cuda.synchronize()
    err = compare(out, ref, name, f"qmm [{m}, {k}] @ [{k}, {n}]")
    launch = qmm_one_launch(qm, torch, x, q[0], s[0], f"qmm [{m}, {k}] @ [{k}, {n}]")
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
    plan = qm.qmm_plan(m, k, n)
    return {"max_abs_err": err,
            "ms": device_ms(rotating(qm.qmm_int8, q, s), iters=2 * QMM_LAYERS),
            "events_ms": time_ms(rotating(qm.qmm_int8, q, s), iters=4 * QMM_LAYERS,
                                 warmup=QMM_LAYERS),
            "plain_ms": device_ms(rotating(qm.plain_qmm_int8, q, s), iters=8),
            "library_ms": device_ms(rotating(torch.matmul, deq), iters=2 * QMM_LAYERS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "wrong_min_abs_err": min(float(diff[i].max()) for i in range(m)),
            "splits": plan.splits, "k_slice": plan.k_slice, "tile_n": plan.tile_n, **launch}


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
    holds because both versions sum in f32 and round once to bf16. Every
    case also checks one launch and no allocation but the output per call,
    and, once per (K, N), f32 x on the CUDA-core kernel."""
    from runbookai_tpu_torch.ops import qmm as qm

    clocks_before = gpu_clocks()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    name = "bfloat16"
    cases: dict = {}
    f32_err = 0.0
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
        # f32 x: the CUDA-core kernel, on the same workspace and merge.
        x = torch.randn((QMM_ROWS[0], k), generator=gen, device=dev)
        f32_err = max(f32_err, compare(qm.qmm_int8(x, q[0], s[0]),
                                       qm.plain_qmm_int8(x, q[0], s[0]), "float32",
                                       f"qmm f32 [{x.shape[0]}, {k}] @ [{k}, {n}]"))
        qmm_one_launch(qm, torch, x, q[0], s[0], f"qmm f32 [{x.shape[0]}, {k}] @ [{k}, {n}]")
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
            "f32_cuda_core_max_abs_err": f32_err,
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
    # bf16 with mixed dispatch: the first prefill (nothing decodes yet) and
    # the verifies stay on K2, the mixed steps run W1's ragged kernel.
    "mixed": dict(must=("ragged_plan", "paged_ragged_attention", "paged_decode_attention",
                        "paged_chunk_attention"), never=PARTIALS),
}


def build_client(torch, weights: str, overlap: bool = True):
    """bf16 weights and pool, int8 weights (bf16 activations) and pool, bf16
    on the tp=16 page-split mesh (model=8 x seq=2, every shard on the one
    card, a TP_PAGES-page pool), or bf16 with mixed dispatch on, through the
    entry point a user calls; ``overlap`` False turns the overlapped decode
    pipeline off (the engine block of a serving plan)."""
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
    engine = {"mixed_dispatch": True} if weights == "mixed" else {}
    if not overlap:
        engine["overlap_decode"] = False
    return TorchCudaClient.build(ENGINE_MODEL, device=DEVICE, seed=0, max_new_tokens=32,
                                 engine=engine, **kw)


def reset_counts() -> None:
    from runbookai_tpu_torch.ops import paged_attention as pa
    from runbookai_tpu_torch.ops import qmm as qm

    pa.reset_launches()
    qm.launches["qmm_int8"] = 0


def counts() -> dict:
    from runbookai_tpu_torch.ops import paged_attention as pa
    from runbookai_tpu_torch.ops import qmm as qm

    return {**pa.launches, **pa.merge_launches, **pa.plan_launches, **qm.launches}


def free_device(torch) -> None:
    """Release the previous phase's client before the next one builds."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


ENGINE_PHASES = {"bfloat16": "engine", "int8": "engine_int8", "kv_split": "engine_kv_split",
                 "mixed": "engine_mixed"}


def phase_name(weights: str, overlap: bool) -> str:
    return ENGINE_PHASES[weights] + ("" if overlap else "_overlap_off")


def recording_forwards(log: list):
    """Wrap the engine's forward entry points so that each dispatch appends
    (entry, token shape) to ``log``; returns the restore function."""
    from runbookai_tpu_torch.engine import engine as eng

    names = ("forward_impl", "forward_hidden", "forward_ragged_impl")
    originals = {n: getattr(eng, n) for n in names}

    def wrap(name, fn):
        def call(params, cfg, tokens, *args, **kwargs):
            log.append([name, list(tokens.shape)])
            return fn(params, cfg, tokens, *args, **kwargs)
        return call

    for n in names:
        setattr(eng, n, wrap(n, originals[n]))

    def restore():
        for n, fn in originals.items():
            setattr(eng, n, fn)
    return restore


def phase_engine(torch, weights: str = "bfloat16", overlap: bool = True) -> dict:
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    client = build_client(torch, weights, overlap)
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

    dispatches: list = []
    restore = recording_forwards(dispatches)
    reset_counts()
    try:
        resps, wall = asyncio.run(_serve_and_stop(client, texts))
    finally:
        restore()
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
    if weights == "mixed" and not core.metrics["mixed_steps"]:
        raise AssertionError("mixed dispatch on, but no mixed step ran")
    ttft = [r.usage["ttft_ms"] for r in resps]
    result = {"phase": phase_name(weights, overlap), "overlap_decode": core.ecfg.overlap_decode,
              "mixed_dispatch": core.ecfg.mixed_dispatch,
              "model": ENGINE_MODEL, "dtype": "int8" if weights == "int8" else "bfloat16",
              "kv_dtype": str(core.ecfg.kv_dtype).split(".")[1],
              "requests": len(texts), "prompt_tokens": prompt_tokens,
              "completion_tokens": done,
              "finish_reasons": [r.finish_reason.value for r in finished],
              "wall_s": wall, "tokens_per_s": sum(done) / wall,
              "ttft_ms": ttft, "build_s": build_s, "launches": launched,
              "engine_metrics": core.metrics,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "greedy_tokens": [streams_by_prompt(finished, p) for p in prompt_ids],
              "dispatches": dispatches}
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


# The CUDA-core kernel's instantiations for bf16 queries that the
# tensor-core kernels replaced, by (kCausal, kPartial): chunk calls over
# every pool type; decode calls (K1, and K3 over int8 pools), decode
# partials (K4) and chunk partials over bf16 and int8 pools. Only bf16
# queries over an f32 pool stay on the CUDA cores, outside chunk calls.
REMOVED_BF16 = {("true", "false"): "chunk", ("false", "false"): "decode",
                ("true", "true"): "chunk_partial", ("false", "true"): "decode_partial"}


def removed_bf16(name: str):
    """Which removed instantiation a profiled kernel is ("chunk", "decode",
    "decode_int8", "decode_partial", "chunk_partial", or "qmm": K5's
    CUDA-core bf16 kernel or its second-launch merge), or None."""
    if "qmm_kernel<__nv_bfloat16>" in name or "qmm_finish_kernel<" in name:
        return "qmm"
    args = template_args(name, "paged_attention_kernel")  # <TQ, TKV, kCausal, kPartial>
    if not args or args[0] != "__nv_bfloat16":
        return None
    kind = REMOVED_BF16.get(tuple(args[2:4]))
    if kind == "chunk":
        return kind
    if args[1] == "float":
        return None
    return kind + ("_int8" if args[1] in INT8_ARGS else "")


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
    if "chunk_partial_mma_kernel<" in name:
        return "chunk_attention_partial"
    args = template_args(name, "ragged_attention_kernel")  # <TKV, HD>
    if args:
        return "ragged_attention" + ("_int8" if args[0] in INT8_ARGS else "")
    if PLAN_KERNEL in name:
        return "ragged_plan"
    args = template_args(name, "decode_attention_mma_kernel")  # <TKV, HD, kPartial, Args>
    if args:
        return "decode_attention" + ("_partial" if args[2:3] == ["true"] else "") + (
            "_int8" if args[0] in INT8_ARGS else "")
    if "chunk_merge_kernel<" in name:
        return "chunk_attention" + ("_int8" if int8_pools else "")
    if "qmm" in name:  # before the matmul test: the int8 weight kernel
        return "qmm"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def phase_profile(torch, weights: str = "bfloat16", overlap: bool = True) -> dict:
    """The engine phase's workload again, on a fresh client with the same
    seed, under torch.profiler: device time by kernel class, and the
    device's idle share of the serving wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    free_device(torch)
    client = build_client(torch, weights, overlap)
    torch.cuda.synchronize()
    texts = prompts()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        resps, wall = asyncio.run(_serve_and_stop(client, texts))
        torch.cuda.synchronize()
    launched = counts()
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
    # The routes: bf16 chunk and decode calls on the tensor-core kernels,
    # over bf16 and int8 pools, and K5 on its tensor-core kernels; page-split
    # chunk and decode partials too; no call on a removed CUDA-core
    # instantiation.
    old = [n for n in by_name if removed_bf16(n)]
    if weights == "kv_split":
        want = [("chunk_partial_mma_kernel<", "chunk_attention_partial"),
                ("decode_attention_mma_kernel<", "decode_attention_partial")]
    else:
        int8 = "_int8" if weights == "int8" else ""
        want = [("chunk_attention_mma_kernel<", "chunk_attention" + int8),
                ("decode_attention_mma_kernel<", "decode_attention" + int8)]
        if weights == "int8":  # K5: decode rows on mma.sync, verify and prefill rows on wgmma
            want += [("qmm_mma_kernel(", "qmm"), ("qmm_wgmma_kernel<", "qmm")]
        if weights == "mixed":  # W1 and its tile list on the mixed steps
            want += [(RAGGED_KERNEL, "ragged_attention"), (PLAN_KERNEL, "ragged_plan")]
    missed = [cls for pat, cls in want
              if not any(pat in n and kernel_class(n, weights == "int8") == cls
                         for n in by_name)]
    if old or missed:
        raise AssertionError(f"{weights} profile: no tensor-core kernel for {missed}, "
                             f"or a removed instantiation ran: {old[:1]}")
    launches_by_kernel = {}
    if weights == "mixed":
        # Each W1 call is one ragged kernel, each mixed forward one tile list
        # kernel, and K2's tensor-core kernel runs once per K2 call: only the
        # split path's chunk calls (prefill before any decode, verify), none
        # for the mixed steps.
        launches_by_kernel = {
            pat: sum(1 for e in prof.events() if e.device_type ==
                     torch.autograd.DeviceType.CUDA and pat in e.name)
            for pat in (RAGGED_KERNEL, PLAN_KERNEL, "chunk_attention_mma_kernel<")}
        if (launches_by_kernel[RAGGED_KERNEL] != launched["paged_ragged_attention"]
                or launches_by_kernel[PLAN_KERNEL] != launched["ragged_plan"]
                or launches_by_kernel["chunk_attention_mma_kernel<"]
                != launched["paged_chunk_attention"]):
            raise AssertionError(f"mixed profile: kernels {launches_by_kernel} against the "
                                 f"wrappers' counts {launched}")
    busy = sum(v[0] for v in classes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": phase_name(weights, overlap) + "_profile",
            **({"launches_by_kernel": launches_by_kernel,
                "wrapper_launches": {x: launched[x] for x in (
                    "ragged_plan", "paged_ragged_attention", "paged_chunk_attention")}}
               if launches_by_kernel else {}),
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
    """The serving phase's requests twice more, with every call of the
    forward to the kernels under test made twice: the kernel, and its plain
    version on the same inputs (f32 throughout, rounded once), each call's
    result held against the other at TOL (fails beyond it). The calls: chunk
    and decode attention (``models.llama``), with int8 weights also K5
    (``qmm_int8``), with mixed dispatch also W1's launch and its tile list
    (the list exactly, record for record); on the page-split mesh the
    chunk and decode partials (``parallel.kv_split``), their (acc, m, l)
    each. The first run serves the kernel's result, as the serving phase
    did; the second serves the plain version's, which shows how far the
    greedy streams of random weights move under the kernel's rounding
    alone. Each run records where its streams first differ from the
    serving phase's."""
    from runbookai_tpu_torch.models import llama
    from runbookai_tpu_torch.ops import qmm
    from runbookai_tpu_torch.parallel import kv_split

    def plain_chunk(q, k, v, tables, ctx, pos, ps):
        return pa.plain_paged_attention(q, k, v, tables, ctx, pos[:, 0].contiguous(), ps)

    def plain_ragged(q, k, v, tables, ctx, pos, rows, plan, ps, rq):
        return pa.plain_ragged_attention(q, k, v, tables, ctx, pos, rows, ps, rq)

    def plain_decode(q, k, v, tables, ctx, ps):
        return pa.plain_paged_attention(q[:, None], k, v, tables, ctx, None, ps)[:, 0]

    def plain_partial(q, k, v, tables, ctx, pos, shard, ps, pages_local):
        return pa.plain_paged_attention_partial(q, k, v, tables, ctx, pos[:, 0].contiguous(),
                                                ps, shard, pages_local)

    def plain_decode_partial(q, k, v, tables, ctx, shard, ps, pages_local):
        acc, m, l = pa.plain_paged_attention_partial(q[:, None], k, v, tables, ctx, None, ps,
                                                     shard, pages_local)
        return acc[:, 0], m[:, 0], l[:, 0]

    if weights == "kv_split":
        targets = [(kv_split, "paged_chunk_attention_partial", plain_partial),
                   (kv_split, "paged_decode_attention_partial", plain_decode_partial)]
    else:
        targets = [(llama, "paged_chunk_attention", plain_chunk),
                   (llama, "paged_decode_attention", plain_decode)]
        if weights == "mixed":  # W1's tile list and its launch on the rows' tables
            targets += [(llama, "ragged_plan", pa.plain_ragged_plan),
                        (llama, "ragged_tile_attention", plain_ragged)]
        if weights == "int8":  # K5: every int8 weight product of M <= 256
            targets.append((llama, "qmm_int8", qmm.plain_qmm_int8))
    seen = {attr: {"calls": 0, "calls_beyond_tol": 0, "max_abs_err": 0.0, "finite": True}
            for _, attr, _ in targets}
    serve_plain = [False]

    def checked(attr, kernel, plain):
        def call(*args):
            out, ref = kernel(*args), plain(*args)
            exact = isinstance(out, pa.RaggedPlan)  # a tile list: record for record
            if exact:
                outs, refs = (out.tiles, out.live, out.weight), (ref.tiles, ref.live, ref.weight)
            else:
                outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            rec = seen[attr]
            rec["calls"] += 1
            beyond = False
            for o, r in zip(outs, refs):
                over, diff = excess(o, r, "bfloat16")
                beyond |= float((diff if exact else over).max()) > 0
                rec["max_abs_err"] = max(rec["max_abs_err"], float(diff.max()))
                rec["finite"] &= bool(o.isfinite().all())
            rec["calls_beyond_tol"] += int(beyond)
            return ref if serve_plain[0] else out
        return call

    runs = {}
    kernels = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for (mod, attr, kernel), (_, _, plain) in zip(kernels, targets):
        setattr(mod, attr, checked(attr, kernel, plain))
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
        for mod, attr, kernel in kernels:
            setattr(mod, attr, kernel)
    for attr, rec in seen.items():
        if not rec["finite"] or rec["calls_beyond_tol"] or not rec["calls"]:
            raise AssertionError(f"{weights} serving: {rec['calls_beyond_tol']} of "
                                 f"{rec['calls']} {attr} calls beyond TOL of the plain "
                                 f"version (max |err| {rec['max_abs_err']:.3e}), or "
                                 f"non-finite")
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


# The serving phases of the configurations in argv (phase_engine's
# weights) of the tree in the working directory, by its own chip_smoke.py,
# one JSON line each (--serve-ab); a first serving run of each
# configuration, not recorded, builds the kernels and warms the process.
_SERVE_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
for w in sys.argv[1:]:
    cs.phase_engine(torch, weights=w)
    e = cs.phase_engine(torch, weights=w)
    e.pop("greedy_tokens")
    e.pop("dispatches")
    print(json.dumps(e), flush=True)
    print(json.dumps(cs.phase_profile(torch, weights=w)), flush=True)
"""


def serve_ab(other: Path, weights: list[str]) -> int:
    """The serving phases of ``weights`` (``phase_engine``'s configurations)
    of ``other`` and of this tree, in the order other, this, this, other,
    each round in a fresh process; a summary line per phase on stdout, every
    line in ``OUT_DIR/serve_ab.jsonl``."""
    log = OUT_DIR / "serve_ab.jsonl"
    log.write_text("")
    for rnd, (tag, tree) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                       ("other", other))):
        proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD, *weights], cwd=tree,
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
            keys = ("tokens_per_s", "ttft_ms", "wall_s", "wall_ms", "device_busy_ms",
                    "idle_share", "by_class_ms", "max_memory_allocated")
            print(json.dumps({k: d[k] for k in ("tree", "round", "phase", *keys) if k in d}),
                  flush=True)
    return 0


# The attention kernel phases of the tree in the working directory, by its
# own chip_smoke.py (--kernel-ab): device ms of K1 (decode input), K2 (4 x 512
# prefill, T=8 verify, one-row prefill at 4096) and W1's five ragged cases
# (each tree's "device_ms" of its ragged case: K2's kernel at [N / 8, 8] with
# the two block gathers before this tree, the ragged kernel's per-layer
# launch here).
_KERNEL_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from runbookai_tpu_torch.ops import paged_attention as pa
cs.phase_build()
dec = cs.phase_decode(pa, torch)["bfloat16"]
chk = cs.phase_chunk(pa, torch)["bfloat16"]
rag = cs.phase_ragged(pa, torch)
row = {"K1_decode": dec["device_ms"], "K2_prefill": chk["device_ms"],
       "K2_verify": chk["verify"]["device_ms"],
       "K2_one_row_prefill": chk["prefill_one_row"]["device_ms"]}
row.update({"W1_" + k: rag[k]["device_ms"] for k in ("served", "long", "int8", "group7", "hd64")})
print(json.dumps(row), flush=True)
"""


def kernel_ab(other: Path) -> int:
    """The attention kernel phases of ``other`` and of this tree, in the
    order other, this, this, other, each in a fresh process; each run's
    device times and, per key, this tree's mean over the other's, in
    ``OUT_DIR/kernel_ab.jsonl``."""
    out = OUT_DIR / "kernel_ab.jsonl"
    out.write_text("")
    runs: dict[str, list] = {"other": [], "this": []}
    for tree, which in ((other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")):
        proc = subprocess.run([sys.executable, "-c", _KERNEL_CHILD], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        line = json.dumps({"tree": which, **row})
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
    ratio = {key: sum(r[key] for r in runs["this"]) / sum(r[key] for r in runs["other"])
             for key in runs["this"][0]}
    line = json.dumps({"this_over_other": ratio})
    print(line, flush=True)
    with out.open("a") as f:
        f.write(line + "\n")
    return 0


def mixed_forward_times(torch) -> dict:
    """One mixed forward (``forward_ragged_impl``) of ENGINE_MODEL at full
    width and depth, random bf16 weights from seed 0, on the ragged phase's
    "served" batch (8 decode rows at the served contexts and a 512-token
    prefill at offset 4096: N = 576, 13 rows) over a 32-layer pool: CUDA
    events over back-to-back forwards, the profiler's device time, and the
    host's time to issue one forward (no sync). Uses the package of the
    working directory, so that two trees are timed by one measurement."""
    from runbookai_tpu_torch.models import llama

    cfg = llama.get_config(ENGINE_MODEL)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, torch.bfloat16, dev, gen)
    _, k, v, tables, ctx, pos, rows, _ = ragged_inputs(torch, dev, gen, torch.bfloat16, "served",
                                                       cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    kv_k = k[None].expand(cfg.n_layers, *k.shape).contiguous()
    kv_v = v[None].expand(cfg.n_layers, *v.shape).contiguous()
    del k, v
    tokens = torch.randint(0, cfg.vocab_size, (pos.numel(),), generator=gen, device=dev)
    sel = torch.cat([torch.arange(B, device=dev) * RQ,
                     torch.tensor([B * RQ + MIX_PF_TOKENS - 1], device=dev)])

    def forward():
        return llama.forward_ragged_impl(params, cfg, tokens, pos, rows, kv_k, kv_v, tables,
                                         ctx, sel, PS, ragged_block=RQ)

    logits = forward()
    torch.cuda.synchronize()
    if not bool(logits.isfinite().all()):
        raise AssertionError("mixed forward: non-finite logits")
    return {"ms": time_ms(forward, iters=10, warmup=2), "device_ms": device_ms(forward, iters=3),
            "host_ms": host_ms(forward, iters=10), "layers": cfg.n_layers,
            "tokens": pos.numel()}


# One mixed forward of the tree in the working directory (--forward-ab),
# measured by this tree's mixed_forward_times (its path in argv[1]).
_FORWARD_CHILD = """
import importlib.util, json, sys, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke_measure", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print(json.dumps(cs.mixed_forward_times(torch)), flush=True)
"""


def forward_ab(other: Path) -> int:
    """One mixed forward of ``other`` and of this tree (the same inputs and
    weights, measured by this file's :func:`mixed_forward_times`), in the
    order other, this, this, other, each in a fresh process; each run's
    times and this tree's mean over the other's in
    ``OUT_DIR/forward_ab.jsonl``."""
    out = OUT_DIR / "forward_ab.jsonl"
    out.write_text("")
    runs: dict[str, list] = {"other": [], "this": []}
    for tree, which in ((other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")):
        proc = subprocess.run([sys.executable, "-c", _FORWARD_CHILD, str(Path(__file__))],
                              cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        line = json.dumps({"tree": which, **row})
        print(line, flush=True)
        with out.open("a") as f:
            f.write(line + "\n")
    ratio = {key: sum(r[key] for r in runs["this"]) / sum(r[key] for r in runs["other"])
             for key in ("ms", "device_ms", "host_ms")}
    line = json.dumps({"this_over_other": ratio})
    print(line, flush=True)
    with out.open("a") as f:
        f.write(line + "\n")
    return 0


def served_line(res: dict) -> dict:
    """A serving phase's line: the forwards it issued counted, not listed."""
    return {**{k: v for k, v in res.items() if k != "dispatches"},
            "forwards": len(res["dispatches"])}


def overlap_ab() -> int:
    """Each serving configuration profiled with the overlapped pipeline on
    and off, in the order on, off, off, on, after one serving run that is
    not recorded (the first run of a configuration in a process pays its
    warm-up): the device's idle share and the serving wall of each run.
    Every line also in ``OUT_DIR/overlap_ab.jsonl``."""
    import torch

    log = OUT_DIR / "overlap_ab.jsonl"
    log.write_text("")
    for weights in ("bfloat16", "int8", "kv_split"):
        phase_engine(torch, weights)
        for rnd, overlap in enumerate((True, False, False, True)):
            res = phase_profile(torch, weights, overlap)
            line = {"round": rnd, "weights": weights, "overlap_decode": overlap,
                    **{k: res[k] for k in ("phase", "wall_ms", "device_busy_ms",
                                           "idle_share")}}
            with log.open("a") as f:
                f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
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
        return serve_ab(Path(sys.argv[2]).resolve(), sys.argv[3:] or ["bfloat16", "int8"])
    if sys.argv[1:2] == ["--kernel-ab"]:
        return kernel_ab(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--forward-ab"]:
        return forward_ab(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--overlap-ab"]:
        print(json.dumps(phase_build()), flush=True)
        return overlap_ab()
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
    rag = phase_ragged(pa, torch)
    emit(rag)
    qmm = phase_qmm(torch)
    emit(qmm)
    emit(phase_forward(torch))
    emit(phase_forward_int8(torch))
    eng = phase_engine(torch)
    emit(served_line(eng))
    prof = phase_profile(torch)
    emit(prof)
    eng8 = phase_engine(torch, weights="int8")
    emit(served_line(eng8))
    emit(phase_profile(torch, weights="int8"))
    emit(phase_witness(torch, pa, "bfloat16", eng))
    emit(phase_witness(torch, pa, "int8", eng8))
    # Mixed dispatch on (bf16): W1 on the main path, its launches counted,
    # its calls witnessed. Not gated on the streams: the ragged blocks and
    # the split path round bf16 at other places.
    mixed = phase_engine(torch, weights="mixed")
    mixed["same_greedy_tokens_as_engine"] = same_token_share(
        mixed["greedy_tokens"], eng["greedy_tokens"])
    mixed["first_divergence_from_engine"] = first_divergence(
        mixed["greedy_tokens"], eng["greedy_tokens"])
    emit(served_line(mixed))
    emit(phase_profile(torch, weights="mixed"))
    emit(phase_witness(torch, pa, "mixed", mixed))
    # The overlapped pipeline off (bf16): the greedy streams must equal the
    # overlapped run's wherever both issued the same forwards.
    off = phase_engine(torch, overlap=False)
    same = off["dispatches"] == eng["dispatches"]
    off["same_dispatches_as_engine"] = same
    off["first_divergence_from_engine"] = first_divergence(off["greedy_tokens"],
                                                           eng["greedy_tokens"])
    if same and off["first_divergence_from_engine"] is not None:
        raise AssertionError(f"overlap off: same forwards as the overlapped run, other "
                             f"greedy tokens at {off['first_divergence_from_engine']}")
    emit(served_line(off))
    off_prof = phase_profile(torch, overlap=False)
    off_prof["idle_share_overlap_on"] = prof["idle_share"]
    emit(off_prof)
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
    emit(served_line(split))
    emit(phase_profile(torch, weights="kv_split"))
    emit(phase_witness(torch, pa, "kv_split", split))

    mma_src = "runbookai_tpu_torch/csrc/chunk_attention.cu"
    dec_src = "runbookai_tpu_torch/csrc/decode_attention.cu"
    pallas = "runbookai_tpu/ops/paged_attention_pallas.py"
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    timing = ("device_ms", "host_ms", "splits", "cold_ms")
    kernels = []
    # K1 and K3 for bf16 queries: the tensor-core kernel over bf16 and int8
    # pools, on the decode input, at head_dim 64 ("hd64") and, for K1, at
    # the served contexts ("served"); f32 queries take the CUDA-core kernel.
    for name, res, served, replaces in (
            ("paged_decode_attention", dec, eng, f"{pallas}:188"),
            ("paged_decode_attention_int8", dec8, eng8, f"{pallas}:240")):
        main_path = res["bfloat16"]
        subs = [x for x in ("served", "hd64") if x in main_path]
        kernels.append({"name": name, "route": "cuda", "source": dec_src,
                        "replaces": replaces, "launches": served["launches"][name],
                        "max_abs_err": max(main_path["max_abs_err"],
                                           *(main_path[x]["max_abs_err"] for x in subs)),
                        "f32_cuda_core_max_abs_err": res["float32"]["max_abs_err"],
                        **{f: main_path[f] for f in fields + timing},
                        **{x: {f: main_path[x][f] for f in fields + timing} for x in subs}})
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
                        **{f: main_path[f] for f in fields + ("device_ms", "cold_ms")},
                        "splits": main_path["splits"],
                        **{kind: main_path[kind] for kind in MMA_KINDS
                           if kind in main_path and kind != "prefill"}})
    # W1: the ragged kernel's per-layer launch on the mixed batch, at the
    # served contexts; the long-context, int8-pool and other geometries'
    # inputs beside it, and K2's one-row prefill of the same 512 tokens.
    # Launches from engine_mixed.
    rag_keys = ("max_abs_err", "pad_max_abs", "launches_per_call", "splits", "tiles",
                "ms", "device_ms", "cold_ms", "host_ms", "call_device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
    kernels.append({"name": "paged_ragged_attention", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/ragged_attention.cu",
                    "replaces": f"{pallas}:468",
                    "launches": mixed["launches"]["paged_ragged_attention"],
                    **{f: rag["served"][f] for f in rag_keys},
                    "max_abs_err": rag["max_abs_err"],
                    **{kind: {f: rag[kind][f] for f in rag_keys}
                       for kind in ("long", "int8", *RAGGED_GEOMETRIES)},
                    "k2_one_row_prefill": rag["k2_one_row_prefill"]})
    # W1's tile list, one launch a mixed forward, on the same batches; its
    # plain version is the tensor-op list on the card. Launches from
    # engine_mixed.
    plan_keys = ("max_abs_err", "live", "ms", "device_ms", "cold_ms", "host_ms", "plain_ms",
                 "plain_device_ms", "plain_host_ms", "bound_ms", "bound_by", "library_ms")
    kernels.append({"name": "ragged_plan", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/ragged_plan.cu",
                    "replaces": f"{pallas}:468", "launches": mixed["launches"]["ragged_plan"],
                    **{f: rag["served"]["plan"][f] for f in plan_keys},
                    "max_abs_err": max(rag[kind]["plan"]["max_abs_err"]
                                       for kind in (*RAGGED_KINDS, "int8", *RAGGED_GEOMETRIES)),
                    **{kind: {f: rag[kind]["plan"][f] for f in plan_keys}
                       for kind in ("long", *RAGGED_GEOMETRIES)}})
    # The second pass of a split K2 call, on the verify input's partials.
    merge = chk["bfloat16"]["merge"]
    kernels.append({"name": "paged_chunk_merge", "route": "cuda", "source": mma_src,
                    "replaces": f"{pallas}:397", "launches": eng["launches"]["paged_chunk_merge"],
                    "launches_int8": eng8["launches"]["paged_chunk_merge"],
                    "max_abs_err": max(merge["max_abs_err"],
                                       chk8["bfloat16"]["merge"]["max_abs_err"]),
                    **{f: merge[f] for f in fields + ("cold_ms",)}, "splits": merge["splits"]})
    # The page-split partial kernels per call as the tp=16 path makes them
    # (one model group's heads over one page shard), the mean over both page
    # shards' calls; launches from engine_kv_split, one call per shard and
    # layer in every forward. library_ms: memory-efficient SDPA with its
    # log-sum-exp over the shard's keys gathered beforehand. bf16 partials
    # run on the tensor-core kernels (K4 decode_attention.cu's, the chunk
    # partial chunk_attention.cu's), f32 queries on the CUDA-core kernel.
    part_fields = fields + ("device_ms", "host_ms", "cold_ms")
    for name, res, replaces, source in (
            ("paged_decode_attention_partial", decp, f"{pallas}:567", dec_src),
            # The JAX package runs T > 1 page-split attention on XLA.
            ("paged_chunk_attention_partial", chkp,
             "runbookai_tpu/parallel/kv_split.py:104", mma_src)):
        main_path = res["bfloat16"]["served"]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": split["launches"][name],
               "calls_per_forward": split["calls_per_forward"],
               "max_abs_err": res["bfloat16"]["max_abs_err"],
               "f32_cuda_core_max_abs_err": res["float32"]["max_abs_err"],
               **{f: main_path[f] for f in part_fields}, "splits": main_path["splits"],
               "q": main_path["q"], "kv_local": main_path["kv_local"]}
        for kind in ("verify", "verify_one_shard", "verify_hd64", "hd64"):
            if kind in res["bfloat16"]:
                case = res["bfloat16"][kind]["served"]
                row[kind] = {**{f: case[f] for f in part_fields}, "splits": case["splits"],
                             "q": case["q"], "max_abs_err": case["max_abs_err"]}
        kernels.append(row)
    # K5 per decode layer: the sum over its seven products at M=8 (and, under
    # "verify", at M=64), each timed on rotating layer slices. Every timed
    # call reads its weights from outside the 50 MB L2 (32 slices of 4 to
    # 58.7 MB), so the device time is also the cold time.
    qmm_rows = {key: {**row, "cold_ms": row["ms"]} for key, row in qmm["per_layer"].items()}
    kernels.append({"name": "qmm_int8", "route": "cuda",
                    "source": "runbookai_tpu_torch/csrc/qmm.cu",
                    "replaces": "runbookai_tpu/ops/qmm_pallas.py:83",
                    "launches": eng8["launches"]["qmm_int8"],
                    "max_abs_err": qmm["max_abs_err"],
                    "f32_cuda_core_max_abs_err": qmm["f32_cuda_core_max_abs_err"],
                    **qmm_rows["decode"], "verify": qmm_rows["verify"],
                    "splits": {f"{c}@{m}": qmm["cases"][f"{m}x{k}x{n}"]["splits"]
                               for m in (8, 64) for c, (k, n) in QMM_SHAPES.items()}})
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
