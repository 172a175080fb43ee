"""The ``torch-cuda`` LLM client: agent seam -> the port's serving engine.

The counterpart of the JAX package's ``JaxTpuClient``: renders the chat
template, submits to the continuous-batching engine and parses tool calls
out of the decoded text. Guided-JSON ``complete()`` is not ported yet; the
inherited ``complete`` serves plain (unguided) completions through ``chat``.
"""

from __future__ import annotations

import codecs
from typing import Optional, Sequence, Union

import torch

from runbookai_tpu_torch.agent.types import LLMResponse
from runbookai_tpu_torch.engine.async_engine import AsyncEngine
from runbookai_tpu_torch.engine.engine import (
    EngineConfig,
    EngineCore,
    check_mesh_serving,
    resolve_kv_dtype,
)
from runbookai_tpu_torch.engine.request import SamplingParams
from runbookai_tpu_torch.model.chat_template import (
    build_chat_prompt,
    format_for_model,
    parse_assistant_output,
)
from runbookai_tpu_torch.model.client import BaseLLMClient
from runbookai_tpu_torch.models.llama import (
    get_config,
    init_params,
    init_params_quantized,
)
from runbookai_tpu_torch.parallel.kv_split import plan_kv_split
from runbookai_tpu_torch.parallel.mesh import build_mesh
from runbookai_tpu_torch.parallel.sharding import shard_params
from runbookai_tpu_torch.utils.tokens import ByteTokenizer


def serving_engine_config(cfg, kv_dtype: torch.dtype) -> EngineConfig:
    """The serving configuration's engine: 16-token pages, 2048 pages, 8
    decode slots, 512-token prefill chunks (4 rows a step), 8 decode steps
    per dispatch."""
    return EngineConfig(
        page_size=16, num_pages=2048, max_batch_slots=8, prefill_chunk=512,
        max_seq_len=min(8192, cfg.max_seq_len), kv_dtype=kv_dtype,
        decode_steps_per_dispatch=8, prefill_batch=4)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for cuda without a card raises
    (nothing moves to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


async def stream_text(engine, tokenizer, prompt_ids, sampling,
                      state: Optional[dict] = None):
    """Token stream -> text-piece stream: incremental UTF-8 decode over
    per-token bytes (a character split across tokens never yields mojibake)
    and stop-token skipping, mirroring ``EngineCore.output_for``. ``state``
    (optional dict) receives ``n_tokens`` / ``saw_stop``."""
    stop_ids = {tokenizer.eot_id, tokenizer.eos_id}
    decoder = codecs.getincrementaldecoder("utf-8")("replace")
    async for tok in engine.generate_stream(prompt_ids, sampling):
        if state is not None:
            state["n_tokens"] = state.get("n_tokens", 0) + 1
        if tok in stop_ids:
            if state is not None:
                state["saw_stop"] = True
            continue
        piece = decoder.decode(tokenizer.id_to_bytes(tok))
        if piece:
            yield piece
    tail = decoder.decode(b"", final=True)
    if tail:
        yield tail


class TorchCudaClient(BaseLLMClient):
    def __init__(self, core: EngineCore, tokenizer, temperature: float = 0.0,
                 top_p: float = 1.0, top_k: int = 0, max_new_tokens: int = 1024,
                 chat_format: str = "llama3"):
        self.core = core
        self.engine = AsyncEngine(core)
        self.tokenizer = tokenizer
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.max_new_tokens = max_new_tokens
        self.chat_format = chat_format

    # ------------------------------------------------------------- factories

    @classmethod
    def build(cls, model: str = "llama3-8b-instruct", device="cuda",
              dtype: Union[torch.dtype, str] = torch.bfloat16,
              kv_cache_dtype: str = "auto", seed: int = 0,
              engine_cfg: Optional[EngineConfig] = None, tp: int = 1,
              devices: Optional[Sequence] = None,
              **client_kw) -> "TorchCudaClient":
        """Engine + client for ``model``, initialised at random from ``seed``
        directly on ``device``, with the byte tokenizer. ``dtype="int8"``
        means int8 layer weights (``init_params_quantized``) with bfloat16
        activations, embeddings, norms and LM head. ``kv_cache_dtype``
        ("auto" = the activation dtype, "bf16", "int8") picks the KV pool
        (``resolve_kv_dtype``). The default engine is
        :func:`serving_engine_config`'s.

        ``tp`` > 1 serves on a tensor-parallel mesh planned by
        ``plan_kv_split``: ``model`` = the kv shards, ``seq`` = the page
        shards (for the 8B, tp=8 is 8 x 1 and tp=16 is 8 x 2). ``devices``
        lists one device per shard (repeat a device to hold several shards
        on it); without it the mesh takes one CUDA card per shard, or, for
        ``device="cpu"``, the CPU for every shard. The params are drawn on
        the first device and then cut into shards."""
        dev = resolve_device(device)
        cfg = get_config(model)
        mesh = None
        if tp > 1:
            if devices is None and dev.type == "cpu":
                devices = [dev] * tp
            plan = plan_kv_split(cfg, tp)
            mesh = build_mesh(plan.kv_shards, plan.pg_shards,
                              [resolve_device(d) for d in devices]
                              if devices is not None else None)
            dev = mesh.devices[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if dtype == "int8":
            act = torch.bfloat16
            params = init_params_quantized(cfg, dtype=act, device=dev, generator=gen)
        else:
            act = dtype
            params = init_params(cfg, dtype=act, device=dev, generator=gen)
        ecfg = engine_cfg or serving_engine_config(
            cfg, resolve_kv_dtype(kv_cache_dtype, act))
        if mesh is not None:
            check_mesh_serving(cfg, params["layers"], ecfg, mesh)
            params = shard_params(params, cfg, mesh)
        core = EngineCore(cfg, params, ByteTokenizer(), ecfg, seed=seed, mesh=mesh)
        return cls(core, core.tokenizer,
                   chat_format=format_for_model(model, cfg.family), **client_kw)

    # ------------------------------------------------------------------- API

    def _sampling(self) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            max_new_tokens=self.max_new_tokens,
            stop_token_ids=(self.tokenizer.eot_id, self.tokenizer.eos_id),
        )

    def _prompt_ids(self, system_prompt, user_prompt, tools) -> list[int]:
        return self.tokenizer.encode(build_chat_prompt(
            system_prompt, user_prompt, tools, fmt=self.chat_format))

    async def chat(self, system_prompt, user_prompt, tools=None) -> LLMResponse:
        ids = self._prompt_ids(system_prompt, user_prompt, tools)
        out = await self.engine.generate(ids, self._sampling())
        content, tool_calls, thinking = parse_assistant_output(out.text)
        return LLMResponse(
            content=content,
            tool_calls=tool_calls,
            thinking=thinking,
            usage={
                "prompt_tokens": len(ids),
                "completion_tokens": out.decode_tokens,
                "ttft_ms": int(out.ttft_ms or 0),
            },
        )

    async def chat_stream(self, system_prompt, user_prompt, tools=None):
        """True token streaming: ``{"type": "text", "delta"}`` per decoded
        piece (raw model output), then parsed ``tool_call`` events, then
        ``{"type": "done", "response"}`` with the parsed content, as
        :meth:`chat` returns it."""
        ids = self._prompt_ids(system_prompt, user_prompt, tools)
        state: dict = {}
        parts: list[str] = []
        async for piece in stream_text(self.engine, self.tokenizer, ids,
                                       self._sampling(), state=state):
            parts.append(piece)
            yield {"type": "text", "delta": piece}
        content, tool_calls, thinking = parse_assistant_output("".join(parts))
        for call in tool_calls:
            yield {"type": "tool_call", "call": call}
        yield {"type": "done", "response": LLMResponse(
            content=content, tool_calls=tool_calls, thinking=thinking,
            usage={"prompt_tokens": len(ids),
                   "completion_tokens": state.get("n_tokens", 0)})}

    async def shutdown(self) -> None:
        await self.engine.stop()
