"""Engine request/response types and sampling parameters (a copy of the
JAX package's; the port's engine refuses the fields it does not serve yet:
``guided``, ``logprobs``, the penalties and ``logit_bias``; LoRA adapters,
trace ids and grammar/logprob state are not carried yet)."""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional


class RequestState(str, Enum):
    WAITING = "waiting"  # queued, no pages yet
    PREFILL = "prefill"  # prompt being processed in chunks
    DECODE = "decode"  # generating, owns a batch slot
    FINISHED = "finished"
    FAILED = "failed"


class FinishReason(str, Enum):
    STOP_TOKEN = "stop_token"
    MAX_TOKENS = "max_tokens"
    STOP_STRING = "stop_string"
    GRAMMAR_END = "grammar_end"
    ABORTED = "aborted"


@dataclass
class SamplingParams:
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled; composes with top_p
    max_new_tokens: int = 512
    stop_token_ids: tuple[int, ...] = ()
    stop_strings: tuple[str, ...] = ()
    # When set, token-level grammar masking constrains output ("json" or a
    # compiled schema grammar name).
    guided: Optional[str] = None
    # Top-N token logprobs per sampled token (0 = off). Forces single-step
    # decode dispatches (the multi-step scan never surfaces logits) and
    # disables speculation/grammar fast-forward for the request; values
    # come from the RAW model distribution (pre-grammar-mask).
    logprobs: int = 0
    # OpenAI-style repetition penalties over the request's GENERATED
    # tokens (OpenAI's c[j] counts previously sampled tokens — prompt
    # content is never penalized): logits - presence*(count>0) -
    # frequency*count, applied before masking and greedy selection.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # Per-request sampling seed (OpenAI `seed`): each sampled position
    # draws from a generator derived from (seed, position) — reproducible
    # regardless of batch composition or engine history. None keeps the
    # engine's generator.
    seed: Optional[int] = None
    # OpenAI logit_bias: ((token_id, bias), ...) added to the logits
    # before penalties/masking/greedy. Densified host-side per dispatch
    # (same shipping pattern as grammar masks); -100/+100 effectively
    # ban/force tokens.
    logit_bias: tuple[tuple[int, float], ...] = ()

    @property
    def penalized(self) -> bool:
        return bool(self.presence_penalty or self.frequency_penalty)


@dataclass
class EngineRequest:
    prompt_ids: list[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: str = field(default_factory=lambda: f"req-{uuid.uuid4().hex[:10]}")
    # Scheduling class: higher admits first and is preempted last (FCFS
    # within a class). Interactive agent turns outrank background eval
    # batches this way without separate engines.
    priority: int = 0
    # Monotonic clock — compared against perf_counter() timestamps in the engine.
    arrival_time: float = field(default_factory=time.perf_counter)

    # Mutable engine-owned state:
    state: RequestState = RequestState.WAITING
    prefill_pos: int = 0  # tokens of the prompt already processed
    out_ids: list[int] = field(default_factory=list)
    # Generated tokens folded into prompt_ids by preemption-by-recompute.
    # Logical output = folded_out_ids + out_ids; ctx_len must not double-count.
    folded_out_ids: list[int] = field(default_factory=list)
    # Memoized full-page hash chain over prompt_ids (admission hot path).
    block_hashes: Optional[list[int]] = None
    slot: Optional[int] = None  # decode batch slot index
    first_token_time: Optional[float] = None  # TTFT measurement
    finish_time: Optional[float] = None  # set by _finish; e2e/TPOT source
    finish_reason: Optional[FinishReason] = None
    # Completion signal for the async API (set by AsyncEngine).
    done_event: Optional[asyncio.Event] = None
    # Streaming hook: called with each sampled token id from the engine's
    # worker thread (bridge to an event loop with call_soon_threadsafe).
    # Preemption-by-recompute does NOT re-call this for folded tokens, so
    # a stream sees every token exactly once.
    on_token: Optional[Any] = None
    # Prompt tokens served from the prefix cache at admission.
    cached_tokens: int = 0

    @property
    def ctx_len(self) -> int:
        return self.prefill_pos + len(self.out_ids)

    @property
    def all_out_ids(self) -> list[int]:
        """Every generated token, including ones folded by preemption."""
        return self.folded_out_ids + self.out_ids

    @property
    def num_generated(self) -> int:
        return len(self.folded_out_ids) + len(self.out_ids)

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return (self.first_token_time - self.arrival_time) * 1000.0


@dataclass
class EngineOutput:
    request_id: str
    token_ids: list[int]
    text: str
    finish_reason: FinishReason
    ttft_ms: Optional[float]
    decode_tokens: int
    elapsed_s: float
    # Prompt tokens served from the prefix cache (usage detail).
    cached_tokens: int = 0
