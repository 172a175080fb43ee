"""Continuous-batching serving engine (host loop) over the paged model.

The counterpart of ``runbookai_tpu/engine/engine.py`` on its split path:
requests are admitted mid-flight, prompts prefill in fixed-size chunks
batched across sequences, and all live sequences share one decode batch of
fixed width.

Scheduling policy per :meth:`EngineCore.step`:

1. admit waiting requests while decode slots + KV pages allow;
2. run one batched prefill dispatch for up to ``prefill_batch`` prefilling
   requests;
3. run one decode dispatch for every decoding request: K autoregressive
   steps, or one prompt-lookup speculative verify of K drafted tokens;
4. finish sequences (stop tokens, budgets, stop strings) and free pages.

Preemption: if the page pool is exhausted the youngest decoding request is
preempted by recompute (pages freed, generated tokens folded into its
prompt, re-queued).

Fixed shapes: decode always runs ``max_batch_slots`` rows (empty slots carry
a null page table and ``ctx_len = 0``); prefill chunks are right-padded to
``prefill_chunk`` and pad tokens write their K/V into the reserved null page
0 via an extra "trash" page-table column at logical position ``max_pages``.
Every forward writes the KV pools in place.

Tensor parallelism: with ``mesh=`` the params are one dict per shard
(``parallel/sharding.py::shard_params``), the pool holds one K and one V
tensor per shard, and every forward (prefill, K-step decode, speculative
verify) runs on the mesh; sampling stays on rank 0's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from runbookai_tpu_torch.engine.kv_cache import KVCacheManager, hash_blocks
from runbookai_tpu_torch.engine.request import (
    EngineOutput,
    EngineRequest,
    FinishReason,
    RequestState,
)
from runbookai_tpu_torch.models.llama import (
    LlamaConfig,
    forward_hidden,
    forward_impl,
    lm_head_logits,
)
from runbookai_tpu_torch.models.quant import is_quantized
from runbookai_tpu_torch.ops.sampling import sample_tokens
from runbookai_tpu_torch.parallel.mesh import Mesh
from runbookai_tpu_torch.parallel.sharding import check_mesh


@dataclass
class EngineConfig:
    page_size: int = 16
    num_pages: int = 2048
    max_batch_slots: int = 8
    prefill_chunk: int = 256
    max_seq_len: int = 8192
    # torch.int8: (values, scales) pools, see resolve_kv_dtype.
    kv_dtype: torch.dtype = torch.bfloat16
    # Reserve this many tokens of page headroom per admitted sequence so
    # decode can proceed a while before needing new allocations.
    admit_headroom_tokens: int = 64
    # Max decode tokens sampled per dispatch (one host sync per K tokens;
    # clamped to a power of two).
    decode_steps_per_dispatch: int = 8
    # Sequences whose prefill chunks run in ONE batched forward per step.
    prefill_batch: int = 4
    # Prompt-lookup speculative decoding (greedy requests): draft the tokens
    # that followed the last occurrence of the trailing n-gram in the
    # sequence's own history and verify all of them in ONE T=K forward.
    speculative: bool = True
    spec_ngram: int = 3
    # Max rounds to skip re-probing speculation after rounds that produced
    # no usable drafts (1, 2, 4, ... up to this cap per consecutive miss).
    spec_backoff_rounds: int = 8


def resolve_kv_dtype(name: Optional[str], default: torch.dtype) -> torch.dtype:
    """The KV pool dtype for a config spelling: "auto" (or empty, or None)
    follows ``default``, the activation dtype; "bf16" pins a bfloat16 pool;
    "int8" an int8 pool with per-(token, kv head) scales. Unknown names
    raise instead of silently serving the activation width."""
    if name in (None, "", "auto"):
        return default
    if name == "fp8":
        raise NotImplementedError("fp8 KV pools are not ported yet "
                                  "(ROADMAP.md queue 1, item 3)")
    resolved = {"bf16": torch.bfloat16, "int8": torch.int8}.get(name)
    if resolved is None:
        raise ValueError(f"kv_dtype {name!r} not one of auto/bf16/fp8/int8")
    return resolved


def check_mesh_serving(cfg: LlamaConfig, layers: dict, ecfg: EngineConfig,
                       mesh: Mesh) -> None:
    """Refuse what the JAX engine refuses on a mesh, and raise for what it
    serves on XLA there and the port has not ported. ``layers`` is the
    params' layer dict, whole or one shard's."""
    check_mesh(cfg, mesh)
    if ecfg.kv_dtype == torch.int8:
        if mesh.seq > 1:
            raise ValueError("kv_dtype=int8 is not supported on a KV page-split "
                             "mesh (seq axis > 1)")
        if mesh.model > 1:
            raise NotImplementedError("int8 KV on a tensor-parallel mesh is not "
                                      "ported yet (ROADMAP.md queue 1, item 7)")
    if mesh.tp > 1 and any(is_quantized(w) for w in layers.values()):
        raise NotImplementedError("int8 weights under tensor parallelism are not "
                                  "ported yet (ROADMAP.md queue 1, item 7)")


def _unsupported(req: EngineRequest) -> Optional[str]:
    s = req.sampling
    if s.guided:
        return "guided decoding"
    if s.logprobs:
        return "logprobs"
    if s.penalized:
        return "presence/frequency penalties"
    if s.logit_bias:
        return "logit_bias"
    return None


class EngineCore:
    """Synchronous stepping core. Drive with :meth:`step` until idle."""

    # ``finished`` high-water trim: a long-running server must not retain
    # every EngineRequest for process lifetime.
    _FINISHED_HIGH_WATER = 4096
    _FINISHED_KEEP = 1024

    def __init__(self, model_cfg: LlamaConfig, params: Any, tokenizer: Any,
                 engine_cfg: Optional[EngineConfig] = None, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        self.cfg = model_cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.params = params
        self.tokenizer = tokenizer
        self.mesh = mesh
        if mesh is None:
            self.device = params["embed"].device
        else:
            if len(params) != mesh.tp:
                raise ValueError(f"{len(params)} param shards for a mesh of {mesh.tp}")
            check_mesh_serving(model_cfg, params[0]["layers"], self.ecfg, mesh)
            self.device = mesh.devices[0]
        self.kv = KVCacheManager(
            n_layers=model_cfg.n_layers,
            num_pages=self.ecfg.num_pages,
            page_size=self.ecfg.page_size,
            n_kv_heads=model_cfg.n_kv_heads,
            head_dim=model_cfg.head_dim,
            max_seq_len=self.ecfg.max_seq_len,
            dtype=self.ecfg.kv_dtype,
            device=self.device,
            mesh=mesh,
        )
        self._kv_k = self.kv.pool.kv_k
        self._kv_v = self.kv.pool.kv_v
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        self.waiting: list[EngineRequest] = []
        self.prefilling: list[EngineRequest] = []
        self.decoding: list[EngineRequest] = []
        self.finished: list[EngineRequest] = []
        self._slots: list[Optional[EngineRequest]] = [None] * self.ecfg.max_batch_slots
        self._last_token: dict[str, int] = {}
        self._spec_backoff = 0
        self._spec_miss_streak = 0
        self.metrics = {"decode_tokens": 0, "decode_steps": 0, "prefill_tokens": 0,
                        "preemptions": 0, "decode_time_s": 0.0, "prefill_time_s": 0.0,
                        "cached_prefix_tokens": 0, "spec_drafted": 0,
                        "spec_accepted": 0, "prefill_steps": 0,
                        "decode_dispatches": 0}

    # ------------------------------------------------------------------ API

    def submit(self, req: EngineRequest) -> None:
        missing = _unsupported(req)
        if missing is not None:
            raise ValueError(f"request {req.request_id}: {missing} is not "
                             f"served by this engine yet")
        if not req.prompt_ids:
            req.prompt_ids = [self.tokenizer.bos_id]
        req.state = RequestState.WAITING
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.decoding)

    def _trash_pos(self) -> int:
        return self.kv.max_pages_per_seq * self.ecfg.page_size

    def _tables_for(self, reqs: list[Optional[EngineRequest]]) -> np.ndarray:
        """[N, max_pages + 1] page tables with the trailing trash column."""
        out = np.zeros((len(reqs), self.kv.max_pages_per_seq + 1), dtype=np.int32)
        for i, r in enumerate(reqs):
            if r is not None and r.request_id in self.kv.seqs:
                out[i, : self.kv.max_pages_per_seq] = self.kv.page_table_row(r.request_id)
        return out

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # ------------------------------------------------------------ scheduling

    def _admit(self) -> None:
        free_slots = sum(s is None for s in self._slots)
        in_flight = len(self.prefilling)
        # Priority first, then arrival: re-queued preempted requests keep
        # their place ahead of same-priority newcomers.
        self.waiting.sort(key=lambda r: (-r.priority, r.arrival_time))
        while self.waiting and (free_slots - in_flight) > 0:
            req = self.waiting[0]
            # Headroom never exceeds what the request can still generate; an
            # idle engine admits with zero headroom so a request that only
            # fits exactly still makes progress.
            headroom = min(self.ecfg.admit_headroom_tokens,
                           max(req.sampling.max_new_tokens - req.num_generated, 0))
            idle = not (self.prefilling or self.decoding)
            if idle:
                headroom = 0
            if req.block_hashes is None:
                req.block_hashes = hash_blocks(req.prompt_ids, self.ecfg.page_size)
            ok, matched = self.kv.probe_admit(req.prompt_ids, headroom,
                                              hashes=req.block_hashes)
            if not ok:
                if idle:
                    # Nothing to release: no future step can make it fit.
                    self.waiting.pop(0)
                    req.state = RequestState.FAILED
                    req.finish_reason = FinishReason.ABORTED
                    req.finish_time = time.perf_counter()
                    self.finished.append(req)
                    if req.done_event is not None:
                        req.done_event.set()
                    continue
                break
            self.waiting.pop(0)
            # Reuse resident pages for the shared prompt prefix: prefill
            # resumes at the first novel token.
            cached = self.kv.add_sequence(req.request_id, req.prompt_ids,
                                          hashes=req.block_hashes,
                                          matched=matched)
            req.state = RequestState.PREFILL
            req.prefill_pos = cached
            if not req.folded_out_ids:
                req.cached_tokens = cached
            self.metrics["cached_prefix_tokens"] += cached
            self.prefilling.append(req)
            in_flight += 1

    @staticmethod
    def _fold_into_prompt(req: EngineRequest) -> None:
        """Fold generated tokens into the prompt for recompute. They move to
        folded_out_ids (not out_ids) so ctx_len never double-counts them."""
        req.prompt_ids = req.prompt_ids + req.out_ids
        req.folded_out_ids = req.folded_out_ids + req.out_ids
        req.out_ids = []
        req.block_hashes = None
        req.prefill_pos = 0

    def _preempt_youngest(self) -> bool:
        """Evict the lowest-priority, most recently arrived decoding request
        (recompute on re-admission)."""
        if not self.decoding:
            return False
        victim = max(self.decoding, key=lambda r: (-r.priority, r.arrival_time))
        self.decoding.remove(victim)
        if victim.slot is not None:
            self._slots[victim.slot] = None
            victim.slot = None
        # Publish the victim's full pages before freeing: re-admission will
        # match its own prefix and recompute only the tail.
        self.kv.release(victim.request_id, token_ids=self._kv_valid_tokens(victim))
        self._fold_into_prompt(victim)
        victim.state = RequestState.WAITING
        self.waiting.insert(0, victim)
        self.metrics["preemptions"] += 1
        return True

    def _kv_valid_tokens(self, req: EngineRequest) -> list[int]:
        """Tokens whose K/V has been written to the pool: prefilled prompt
        tokens plus every generated token that was fed back (all but the
        last emitted one)."""
        valid = req.prompt_ids[: req.prefill_pos]
        if req.out_ids:
            valid = valid + req.out_ids[:-1]
        return valid

    def _finish(self, req: EngineRequest, reason: FinishReason) -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        if req.finish_time is None:
            req.finish_time = time.perf_counter()
        if req.slot is not None:
            self._slots[req.slot] = None
            req.slot = None
        if req in self.decoding:
            self.decoding.remove(req)
        if req in self.prefilling:
            self.prefilling.remove(req)
        self.kv.release(req.request_id, token_ids=self._kv_valid_tokens(req))
        self._last_token.pop(req.request_id, None)
        self.finished.append(req)
        if req.done_event is not None:
            req.done_event.set()

    def force_finish(self, req: EngineRequest) -> None:
        """Best-effort finish for crash recovery: every cleanup step runs
        independently, so a corrupted core still ends with the request out
        of the live pools and its awaiter unblocked."""
        for pool in (self.waiting, self.prefilling, self.decoding):
            if req in pool:
                pool.remove(req)
        if req.slot is not None and req.slot < len(self._slots):
            self._slots[req.slot] = None
            req.slot = None
        try:
            if req.request_id in self.kv.seqs:
                self.kv.release(req.request_id)
        except Exception:  # noqa: BLE001 — release itself may be poisoned
            pass
        self._last_token.pop(req.request_id, None)
        req.state = RequestState.FINISHED
        req.finish_reason = req.finish_reason or FinishReason.ABORTED
        if req not in self.finished:
            self.finished.append(req)
        if req.done_event is not None:
            req.done_event.set()

    def abort(self, request_id: str) -> bool:
        """Abort a live request: frees its slot and KV pages now. Returns
        False when the request is unknown or already finished."""
        for req in self.waiting:
            if req.request_id == request_id:
                self.waiting.remove(req)
                req.state = RequestState.FINISHED
                req.finish_reason = FinishReason.ABORTED
                self.finished.append(req)
                if req.done_event is not None:
                    req.done_event.set()
                return True
        for req in self.prefilling + self.decoding:
            if req.request_id == request_id:
                self._finish(req, FinishReason.ABORTED)
                return True
        return False

    # --------------------------------------------------------------- sampling

    def _sample(self, logits: torch.Tensor, reqs: list[Optional[EngineRequest]],
                positions: np.ndarray) -> torch.Tensor:
        """One token per row of ``logits`` ([N, vocab]) for the requests in
        ``reqs`` (None = pad row, sampled greedily and discarded)."""
        live = [r for r in reqs if r is not None]
        if all(r.sampling.temperature <= 0.0 for r in live):
            return torch.argmax(logits, dim=-1).to(torch.int32)
        n = len(reqs)
        temps = np.zeros((n,), dtype=np.float32)
        top_ps = np.ones((n,), dtype=np.float32)
        top_ks = np.zeros((n,), dtype=np.int32)
        seeds = np.full((n,), -1, dtype=np.int64)
        for i, r in enumerate(reqs):
            if r is not None:
                temps[i] = r.sampling.temperature
                top_ps[i] = r.sampling.top_p
                top_ks[i] = r.sampling.top_k
                if r.sampling.seed is not None:
                    seeds[i] = r.sampling.seed & 0x7FFFFFFF
        use_seed = bool((seeds >= 0).any())
        return sample_tokens(
            logits, self._gen, self._dev(temps), self._dev(top_ps),
            top_k=self._dev(top_ks),
            seeds=self._dev(seeds) if use_seed else None,
            positions=self._dev(positions.astype(np.int64)) if use_seed else None)

    # --------------------------------------------------------------- prefill

    def _run_prefill(self) -> None:
        """One BATCHED prefill dispatch: chunks for up to ``prefill_batch``
        sequences in a single forward."""
        t0 = time.perf_counter()
        rows: list[tuple[EngineRequest, int, int]] = []  # (req, chunk, new_ctx)
        for req in list(self.prefilling[: max(1, self.ecfg.prefill_batch)]):
            chunk_len = min(self.ecfg.prefill_chunk,
                            len(req.prompt_ids) - req.prefill_pos)
            new_ctx = req.prefill_pos + chunk_len
            try:
                self.kv.extend(req.request_id, new_ctx)
            except MemoryError:
                if rows:
                    # Run what fits; this request retries next step. The
                    # head request always fails with rows empty and takes
                    # the preempt/abort path below.
                    continue
                if self._preempt_youngest():
                    return  # retry next step
                self._finish(req, FinishReason.ABORTED)
                return
            rows.append((req, chunk_len, new_ctx))
        if not rows:
            return

        # Pad the row count to a power of two; pad rows write to the null
        # page and attend over one masked key.
        b = 1
        while b < len(rows):
            b *= 2
        t = self.ecfg.prefill_chunk
        tokens = np.zeros((b, t), dtype=np.int64)
        positions = np.full((b, t), self._trash_pos(), dtype=np.int32)
        ctx_lens = np.ones((b,), dtype=np.int32)
        last_idx = np.zeros((b,), dtype=np.int64)
        tables = self._tables_for([r for r, _, _ in rows] + [None] * (b - len(rows)))
        for i, (req, chunk_len, new_ctx) in enumerate(rows):
            tokens[i, :chunk_len] = req.prompt_ids[req.prefill_pos:new_ctx]
            positions[i, :chunk_len] = np.arange(req.prefill_pos, new_ctx)
            ctx_lens[i] = new_ctx
            last_idx[i] = chunk_len - 1

        hidden = forward_hidden(
            self.params, self.cfg, self._dev(tokens), self._dev(positions),
            self._kv_k, self._kv_v, self._dev(tables), self._dev(ctx_lens),
            self.ecfg.page_size, mesh=self.mesh)

        done_rows: list[tuple[int, EngineRequest]] = []
        self.metrics["prefill_steps"] += 1
        for i, (req, chunk_len, new_ctx) in enumerate(rows):
            req.prefill_pos = new_ctx
            self.metrics["prefill_tokens"] += chunk_len
            if req.prefill_pos >= len(req.prompt_ids):
                done_rows.append((i, req))

        if done_rows:
            for i, req in done_rows:
                # Publish the prompt's full pages so following requests with
                # the same prefix skip their prefill.
                self.kv.register_prefix(req.request_id, req.prompt_ids,
                                        hashes=req.block_hashes)
                self.prefilling.remove(req)
                slot = self._slots.index(None)
                self._slots[slot] = req
                req.slot = slot
                req.state = RequestState.DECODE
                self.decoding.append(req)
            # Every completed row's first output token in ONE batched draw;
            # only each row's final real token needs logits.
            last_h = hidden[torch.arange(b, device=self.device), self._dev(last_idx)]
            last_logits = lm_head_logits(self.params, self.cfg, last_h, mesh=self.mesh)
            row_reqs: list[Optional[EngineRequest]] = [None] * b
            for i, req in done_rows:
                row_reqs[i] = req
            toks = self._sample(last_logits, row_reqs, ctx_lens).cpu().numpy()
            for i, req in done_rows:
                if req.first_token_time is None:  # true TTFT across preemption
                    req.first_token_time = time.perf_counter()
                self._emit_token(req, int(toks[i]))
        self.metrics["prefill_time_s"] += time.perf_counter() - t0

    # ---------------------------------------------------------------- decode

    def _emit_token(self, req: EngineRequest, token: int) -> None:
        """Record a sampled token and apply finish rules."""
        req.out_ids.append(token)
        if req.on_token is not None:
            req.on_token(token)
        self._last_token[req.request_id] = token
        stop_ids = set(req.sampling.stop_token_ids) | {self.tokenizer.eos_id,
                                                       self.tokenizer.eot_id}
        if token in stop_ids:
            self._finish(req, FinishReason.STOP_TOKEN)
        elif req.num_generated >= req.sampling.max_new_tokens:
            self._finish(req, FinishReason.MAX_TOKENS)
        elif req.sampling.stop_strings:
            tail = self.tokenizer.decode(
                (req.folded_out_ids[-32:] + req.out_ids[-32:])[-32:])
            if any(s in tail for s in req.sampling.stop_strings):
                self._finish(req, FinishReason.STOP_STRING)

    def _pick_k(self) -> int:
        """Decode tokens per dispatch: the largest power of two <= config
        that fits every sequence's remaining max_seq headroom."""
        k = max(1, self.ecfg.decode_steps_per_dispatch)
        remaining = min(self.ecfg.max_seq_len - r.ctx_len for r in self.decoding)
        while k > 1 and k > remaining:
            k //= 2
        p = 1
        while p * 2 <= k:
            p *= 2
        return p

    def _draft_for(self, req: EngineRequest, max_draft: int) -> list[int]:
        """Prompt-lookup draft: tokens that followed the most recent earlier
        occurrence of the sequence's trailing n-gram."""
        n = self.ecfg.spec_ngram
        hist = req.prompt_ids[: req.prefill_pos] + req.out_ids
        if max_draft < 1 or len(hist) <= n:
            return []
        # Bounded lookback keeps per-dispatch host cost flat on long contexts.
        arr = np.asarray(hist[-2048:], dtype=np.int64)
        tail = arr[-n:]
        windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
        hits = np.nonzero((windows == tail).all(axis=1))[0]
        if hits.size == 0:
            return []
        start = int(hits[-1]) + n
        return arr[start : start + max_draft].tolist()

    def _grow_pages_for_decode(self, k: int) -> None:
        """Ensure every decoding sequence has pages for ctx + k tokens,
        preempting the youngest (or aborting) under pool pressure."""
        for req in list(self.decoding):
            while (req.state == RequestState.DECODE
                   and not self.kv.can_extend(req.request_id, req.ctx_len + k)):
                # _preempt_youngest may evict ``req`` itself; the state
                # guard then exits the loop.
                if not self._preempt_youngest():
                    if req.state == RequestState.DECODE:
                        self._finish(req, FinishReason.ABORTED)
                    break
            if req.state == RequestState.DECODE and req.request_id in self.kv.seqs:
                self.kv.extend(req.request_id, req.ctx_len + k)

    def _decode_multi(self, tokens: np.ndarray, positions: np.ndarray,
                      ctx_lens: np.ndarray, tables: np.ndarray, k: int) -> np.ndarray:
        """K autoregressive decode steps (sampling on the device, one host
        fetch at the end). Pages for ctx + K are allocated beforehand;
        tokens past a stop are discarded host-side and their K/V writes,
        position-addressed, are overwritten by later accepted tokens."""
        reqs = list(self._slots)
        tok = self._dev(tokens)
        pos, ctx = self._dev(positions), self._dev(ctx_lens)
        tables_d = self._dev(tables)
        out = []
        for step in range(k):
            logits = forward_impl(self.params, self.cfg, tok, pos,
                                  self._kv_k, self._kv_v, tables_d, ctx,
                                  self.ecfg.page_size, mesh=self.mesh)
            sampled = self._sample(logits[:, -1], reqs, ctx_lens + step)
            out.append(sampled)
            tok, pos, ctx = sampled[:, None].long(), pos + 1, ctx + 1
        return torch.stack(out, dim=1).cpu().numpy()  # [B, K]

    def _run_decode_spec(self, drafts: dict[str, list[int]], k: int) -> None:
        """Speculative dispatch: feed [last, draft...] as one T=k chunk,
        take the greedy argmax per position and accept the agreeing
        prefix. Rejected positions leave garbage K/V exactly like multi-step
        decode does; later position-addressed writes overwrite it."""
        t0 = time.perf_counter()
        self._grow_pages_for_decode(k)
        if not self.decoding:
            return
        b = self.ecfg.max_batch_slots
        tokens = np.zeros((b, k), dtype=np.int64)
        positions = np.zeros((b, k), dtype=np.int32)
        ctx_lens = np.zeros((b,), dtype=np.int32)
        feeds: dict[str, list[int]] = {}
        for req in self.decoding:
            i = req.slot
            draft = drafts.get(req.request_id, [])[: k - 1]
            feed = [self._last_token[req.request_id]] + draft
            feed = feed + [feed[-1]] * (k - len(feed))  # pad rows to T=k
            feeds[req.request_id] = feed
            tokens[i] = feed
            positions[i] = np.arange(req.ctx_len - 1, req.ctx_len - 1 + k)
            ctx_lens[i] = req.ctx_len + k - 1  # keys written for all fed tokens
            self.metrics["spec_drafted"] += len(draft)
        logits = forward_impl(
            self.params, self.cfg, self._dev(tokens), self._dev(positions),
            self._kv_k, self._kv_v, self._dev(self._tables_for(self._slots)),
            self._dev(ctx_lens), self.ecfg.page_size, mesh=self.mesh)
        toks = torch.argmax(logits, dim=-1).cpu().numpy()  # [B, k]

        emitted = 0
        for req in list(self.decoding):
            i = req.slot
            feed = feeds[req.request_id]
            draft = drafts.get(req.request_id, [])[: k - 1]
            self._emit_token(req, int(toks[i, 0]))
            emitted += 1
            j = 1
            while (req.state == RequestState.DECODE and j <= len(draft)
                   and feed[j] == int(toks[i, j - 1])):
                self._emit_token(req, int(toks[i, j]))
                emitted += 1
                self.metrics["spec_accepted"] += 1
                j += 1
        self.metrics["decode_tokens"] += emitted
        self.metrics["decode_steps"] += 1
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_time_s"] += time.perf_counter() - t0

    def _try_speculate(self, k: int) -> bool:
        """Prompt-lookup speculation for all-greedy batches when most of the
        batch drafts; a draftless probe backs off re-probing."""
        if not (k > 1 and self.ecfg.speculative
                and all(r.sampling.temperature == 0.0 for r in self.decoding)):
            return False
        if self._spec_backoff > 0:
            self._spec_backoff -= 1
            return False
        drafts = {r.request_id: self._draft_for(r, k - 1) for r in self.decoding}
        # An undrafted request gets 1 token from a spec dispatch vs k from
        # multi-step, so speculate only when at least half the batch drafts.
        if 2 * sum(bool(d) for d in drafts.values()) >= len(self.decoding):
            self._spec_miss_streak = 0
            self._run_decode_spec(drafts, k)
            return True
        self._spec_miss_streak += 1
        self._spec_backoff = min(max(0, self.ecfg.spec_backoff_rounds),
                                 2 ** (self._spec_miss_streak - 1))
        return False

    def _run_decode(self) -> None:
        # Sequences at the context limit finish before K is chosen.
        for req in list(self.decoding):
            if req.ctx_len + 1 > self.ecfg.max_seq_len:
                self._finish(req, FinishReason.MAX_TOKENS)
        if not self.decoding:
            return
        k = self._pick_k()
        if self._try_speculate(k):
            return
        t0 = time.perf_counter()
        self._grow_pages_for_decode(k)
        if not self.decoding:
            return
        b = self.ecfg.max_batch_slots
        tokens = np.zeros((b, 1), dtype=np.int64)
        positions = np.zeros((b, 1), dtype=np.int32)
        ctx_lens = np.zeros((b,), dtype=np.int32)
        for req in self.decoding:
            i = req.slot
            tokens[i, 0] = self._last_token[req.request_id]
            positions[i, 0] = req.ctx_len - 1  # position of the token being fed
            ctx_lens[i] = req.ctx_len
        snapshot = [(r, r.slot) for r in self.decoding]
        toks = self._decode_multi(tokens, positions, ctx_lens,
                                  self._tables_for(self._slots), k)
        emitted = 0
        for step_idx in range(k):
            for req, slot in snapshot:
                if req.state == RequestState.DECODE:
                    self._emit_token(req, int(toks[slot, step_idx]))
                    emitted += 1
        self.metrics["decode_tokens"] += emitted
        self.metrics["decode_steps"] += k
        self.metrics["decode_dispatches"] += 1
        self.metrics["decode_time_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------------ step

    def step(self) -> list[EngineRequest]:
        """One scheduler iteration (admit, prefill, decode); returns the
        requests finished during it."""
        if len(self.finished) > self._FINISHED_HIGH_WATER:
            del self.finished[: -self._FINISHED_KEEP]
        before = len(self.finished)
        self._admit()
        if self.prefilling:
            self._run_prefill()
        if self.decoding:
            self._run_decode()
        return self.finished[before:]

    def run_until_idle(self, max_steps: int = 100_000) -> list[EngineRequest]:
        done: list[EngineRequest] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            done.extend(self.step())
        return done

    def output_for(self, req: EngineRequest) -> EngineOutput:
        # Strip the stop token from the visible text.
        ids = req.all_out_ids  # includes tokens folded by preemption
        stop_ids = set(req.sampling.stop_token_ids) | {self.tokenizer.eos_id,
                                                       self.tokenizer.eot_id}
        text_ids = ids[:-1] if ids and ids[-1] in stop_ids else ids
        text = self.tokenizer.decode(text_ids)
        if req.finish_reason == FinishReason.STOP_STRING:
            # OpenAI semantics: the matched stop sequence is not returned.
            cut = min((i for i in (text.find(s) for s in req.sampling.stop_strings)
                       if i >= 0), default=-1)
            if cut >= 0:
                text = text[:cut]
        return EngineOutput(
            request_id=req.request_id,
            token_ids=list(ids),
            text=text,
            finish_reason=req.finish_reason or FinishReason.ABORTED,
            ttft_ms=req.ttft_ms,
            decode_tokens=req.num_generated,
            elapsed_s=time.perf_counter() - req.arrival_time,
            cached_tokens=req.cached_tokens,
        )
