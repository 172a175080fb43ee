"""The ``torch-cuda`` LLM client: agent seam -> the port's serving engine.

The counterpart of the JAX package's ``JaxTpuClient``: renders the chat
template, submits to the continuous-batching engine and parses tool calls
out of the decoded text. ``complete()`` serves the structured orchestrator
under guided JSON decoding by default (``guided_json``): the generic JSON
automaton, or one of the six orchestrator schemas by name. With a LoRA
registry every call may name an adapter (``adapter=``); with a draft model
the engine's speculation drafts through it.
"""

from __future__ import annotations

import codecs
from pathlib import Path
from typing import Optional, Sequence, Union

import torch

from runbookai_tpu_torch.agent.types import LLMResponse
from runbookai_tpu_torch.engine.async_engine import AsyncEngine
from runbookai_tpu_torch.engine.draft import DraftWorker
from runbookai_tpu_torch.engine.engine import (
    EngineConfig,
    EngineCore,
    check_mesh_serving,
    resolve_kv_dtype,
)
from runbookai_tpu_torch.engine.request import SamplingParams
from runbookai_tpu_torch.model.chat_template import (
    build_chat_prompt,
    build_completion_prompt,
    format_for_model,
    parse_assistant_output,
)
from runbookai_tpu_torch.model.client import BaseLLMClient
from runbookai_tpu_torch.model.guided import JsonMaskProvider
from runbookai_tpu_torch.model.schema_guided import orchestrator_schemas
from runbookai_tpu_torch.models.checkpoint import load_or_init, model_config
from runbookai_tpu_torch.models.llama import LlamaConfig, get_config
from runbookai_tpu_torch.models.lora import LoraRegistry
from runbookai_tpu_torch.parallel.kv_split import plan_kv_split
from runbookai_tpu_torch.parallel.mesh import build_mesh
from runbookai_tpu_torch.parallel.sharding import shard_params
from runbookai_tpu_torch.unported import unported
from runbookai_tpu_torch.utils.tokens import load_tokenizer
from runbookai_tpu_torch.utils.weights import discover_weights


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
                      state: Optional[dict] = None, priority: int = 0,
                      request_sink: Optional[list] = None,
                      request_id: Optional[str] = None, adapter: Optional[str] = None):
    """Token stream -> text-piece stream, shared by every streaming surface
    (``chat_stream``, the OpenAI SSE endpoint): incremental UTF-8 decode over
    per-token bytes (a character split across tokens never yields mojibake)
    and stop-token skipping, mirroring ``EngineCore.output_for``. ``state``
    (optional dict) receives ``n_tokens`` / ``saw_stop``."""
    stop_ids = {tokenizer.eot_id, tokenizer.eos_id}
    decoder = codecs.getincrementaldecoder("utf-8")("replace")
    async for tok in engine.generate_stream(prompt_ids, sampling, priority=priority,
                                            adapter=adapter, request_sink=request_sink,
                                            request_id=request_id):
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
                 guided_json: bool = True, chat_format: str = "llama3"):
        self.core = core
        self.engine = AsyncEngine(core)
        self.tokenizer = tokenizer
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.max_new_tokens = max_new_tokens
        self.guided_json = guided_json
        self.chat_format = chat_format

    # ------------------------------------------------------------- factories

    @staticmethod
    def _core(cfg: LlamaConfig, params, tokenizer, ecfg: EngineConfig, seed: int = 0,
              mesh=None, schema_limits=None, lora_registry=None,
              draft_worker=None) -> EngineCore:
        """The engine with the guided-JSON mask provider (the generic JSON
        automaton and the six orchestrator schemas) wired in, and its step
        graphs captured (where ``step_graphs`` is on; the draft worker's
        too), so that no request pays for the capture."""
        masker = JsonMaskProvider(tokenizer, schemas=orchestrator_schemas(),
                                  limits=schema_limits)
        core = EngineCore(cfg, params, tokenizer, ecfg, mask_fn=masker.mask,
                          advance_fn=masker.advance, seed=seed, mesh=mesh,
                          lora_registry=lora_registry, draft_worker=draft_worker)
        core.capture_step_graphs()
        return core

    @classmethod
    def build(cls, model: str = "llama3-8b-instruct", device="cuda",
              dtype: Union[torch.dtype, str] = torch.bfloat16,
              kv_cache_dtype: str = "auto", seed: int = 0,
              engine_cfg: Optional[EngineConfig] = None, tp: int = 1,
              devices: Optional[Sequence] = None, engine: Optional[dict] = None,
              model_path: Optional[str] = None, tokenizer_path: Optional[str] = None,
              schema_limits=None, lora_adapters: Optional[dict] = None, lora_rank: int = 8,
              lora_targets: Sequence[str] = ("wq", "wv"), draft_model: Optional[str] = None,
              draft_model_path: Optional[str] = None, **client_kw) -> "TorchCudaClient":
        """Engine + client for ``model``. Weights come from the HF directory
        that ``discover_weights`` resolves (``model_path`` when it exists,
        else ``$RUNBOOK_WEIGHTS``); without one they are drawn at random from
        ``seed``, directly on ``device``. The tokenizer is the
        ``tokenizer.json`` of ``tokenizer_path`` or of the weights
        directory, else the byte tokenizer (``load_tokenizer``).
        ``dtype="int8"`` means int8 layer weights (quantized on the host
        when loaded, drawn in int8 when random) with bfloat16 activations,
        embeddings, norms and LM head. ``kv_cache_dtype`` ("auto" = the
        activation dtype, "bf16", "fp8", "int8") picks the KV pool
        (``resolve_kv_dtype``). The default engine is
        :func:`serving_engine_config`'s; ``engine``, a serving plan's engine
        block (e.g. ``{"overlap_decode": False, "mixed_dispatch": True,
        "grammar_fast_forward": True, "step_graphs": False}``), is laid over it by
        ``EngineConfig.from_plan``. ``schema_limits`` (a
        ``SchemaLimits``) bounds the orchestrator schemas' strings, arrays
        and free-form values.

        ``tp`` > 1 serves on a tensor-parallel mesh planned by
        ``plan_kv_split``: ``model`` = the kv shards, ``seq`` = the page
        shards (for the 8B, tp=8 is 8 x 1 and tp=16 is 8 x 2). ``devices``
        lists one device per shard (repeat a device to hold several shards
        on it); without it the mesh takes one CUDA card per shard, or, for
        ``device="cpu"``, the CPU for every shard. The params are made on
        the first device and then cut into shards.

        ``lora_adapters`` (name -> HF PEFT directory) serves those adapters
        from a :class:`LoraRegistry` of ``lora_rank`` over ``lora_targets``
        in the activation dtype; ``draft_model`` (and its HF directory
        ``draft_model_path``, else random weights from ``seed``) drafts the
        engine's speculative rounds through a :class:`DraftWorker` with the
        engine's slots, context and page size, as the JAX package's
        ``fleet/build.py`` builds them."""
        dev = resolve_device(device)
        if model_path and not Path(model_path).exists():
            raise FileNotFoundError(f"model_path {model_path!r} does not exist")
        weights = discover_weights(model, model_path)
        tokenizer = load_tokenizer(tokenizer_path or weights)
        cfg = model_config(model, weights)
        mesh = None
        if tp > 1:
            if devices is None and dev.type == "cpu":
                devices = [dev] * tp
            plan = plan_kv_split(cfg, tp)
            mesh = build_mesh(plan.kv_shards, plan.pg_shards,
                              [resolve_device(d) for d in devices]
                              if devices is not None else None)
            dev = mesh.devices[0]
        act = torch.bfloat16 if dtype == "int8" else dtype
        cfg, params = load_or_init(model, weights, dtype=act, device=dev, seed=seed,
                                   quantize_int8=dtype == "int8")
        ecfg = engine_cfg or serving_engine_config(
            cfg, resolve_kv_dtype(kv_cache_dtype, act))
        if engine:
            ecfg = EngineConfig.from_plan(engine, default_kv_dtype=act, base=ecfg)
        if mesh is not None:
            check_mesh_serving(cfg, params["layers"], ecfg, mesh)
            params = shard_params(params, cfg, mesh)
        registry = None
        if lora_adapters:
            registry = LoraRegistry(cfg, rank=lora_rank, targets=tuple(lora_targets),
                                    dtype=act, device=dev)
            for name, path in lora_adapters.items():
                registry.load_peft_dir(name, path)
        worker = None
        if draft_model:
            dcfg, dparams = load_or_init(draft_model, draft_model_path, dtype=act, device=dev,
                                         seed=seed)
            worker = DraftWorker(dcfg, dparams, max_batch_slots=ecfg.max_batch_slots,
                                 max_seq_len=ecfg.max_seq_len, page_size=ecfg.page_size)
        core = cls._core(cfg, params, tokenizer, ecfg, seed=seed, mesh=mesh,
                         schema_limits=schema_limits, lora_registry=registry,
                         draft_worker=worker)
        return cls(core, tokenizer, chat_format=format_for_model(model, cfg.family),
                   **client_kw)

    @classmethod
    def from_config(cls, llm_cfg, device="cuda") -> "TorchCudaClient":
        """Engine + client from an ``LLMConfig`` (``utils/config.py``), after
        the JAX package's ``JaxTpuClient.from_config`` and
        ``fleet/build.py::build_group``: the same ``EngineConfig`` fields
        from the same keys, then :meth:`build` on ``device`` (an argument,
        not a config key).

        Read: ``model``, ``model_path`` (else ``$RUNBOOK_WEIGHTS``, else
        random weights from seed 0), ``tokenizer_path``, ``dtype``,
        ``kv_cache_dtype``, ``temperature``/``top_p``/``top_k``,
        ``max_new_tokens``, ``guided_json``, ``page_size``, ``num_pages``,
        ``max_batch_slots``, ``prefill_chunk``, ``decode_steps``,
        ``max_seq_len`` (capped at the model's), ``mesh.model`` (the
        tensor-parallel mesh, page-split past the kv-head count),
        ``lora_adapters`` with ``lora_rank`` and ``lora_targets`` (a
        :class:`LoraRegistry` serving each PEFT directory under its name)
        and ``draft_model`` with ``draft_model_path`` (a :class:`DraftWorker`).
        ``attn_impl``/``qmm_impl`` choose between JAX's Pallas and XLA
        routes; here each wrapper launches its kernel on a CUDA tensor and
        runs its plain version on a CPU one, so "auto" and "pallas" mean
        that and "xla" raises ``ValueError``.

        Refused with ``NotImplementedError`` naming the ROADMAP item: the
        features the port lacks (``models``, adapters of ``models`` entries
        among them, ``dp_replicas`` > 1, ``plan``, ``kv_spill_pages`` > 0,
        ``mesh.data`` > 1), any ``llm.sched`` field set explicitly, and
        ``llm.obs``/``llm.slo``/``llm.tenants`` away from their defaults.
        ``build_group`` always applies ``llm.sched`` (default ``wdrr``); the
        port admits by priority, then arrival, which orders one class of
        requests, as the agent sends them one at a time, the same way.
        ``llm.obs``, ``llm.slo`` and ``llm.tenants`` at their defaults
        cannot change served bytes, and nothing is built for them: this
        client starts no monitor and no thread."""
        refused = [
            (any(m.adapters for m in llm_cfg.models),
             "llm.models[].adapters (the adapters of a multi-model group)", "queue 1 item 9"),
            (bool(llm_cfg.models), "llm.models (multi-model fleets)", "queue 1 item 9"),
            (llm_cfg.dp_replicas > 1, "llm.dp_replicas > 1 (the data-parallel fleet)",
             "queue 1 item 9"),
            (bool(llm_cfg.plan), "llm.plan (serving plans, autotune/plan.py)",
             "queue 1 item 9"),
            (llm_cfg.kv_spill_pages > 0, "llm.kv_spill_pages (the host spill tier)",
             "queue 1 item 9"),
            (llm_cfg.mesh.data > 1, "llm.mesh.data > 1 (data parallelism)",
             "queue 1 item 6"),
            (bool(llm_cfg.sched.model_fields_set),
             "llm.sched (the weighted scheduler, sched/wdrr.py)", "queue 1 item 9"),
        ] + [(getattr(llm_cfg, name) != type(getattr(llm_cfg, name))(),
              f"llm.{name} away from its defaults ({what})", "queue 1 item 9")
             for name, what in (("obs", "the obs layer"), ("slo", "SLO monitors"),
                                ("tenants", "tenant admission"))]
        for is_set, what, item in refused:
            if is_set:
                raise unported(what, item)
        for name in ("attn_impl", "qmm_impl"):
            if getattr(llm_cfg, name) == "xla":
                raise ValueError(
                    f"llm.{name}: 'xla' selects JAX's kernel-less route; the port "
                    "launches its kernels on the card (use 'auto')")
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": "int8"}[llm_cfg.dtype]
        act = torch.bfloat16 if dtype == "int8" else dtype
        weights = discover_weights(llm_cfg.model, llm_cfg.model_path)
        cfg = model_config(llm_cfg.model, weights)
        ecfg = EngineConfig(
            page_size=llm_cfg.page_size,
            num_pages=llm_cfg.num_pages,
            max_batch_slots=llm_cfg.max_batch_slots,
            prefill_chunk=llm_cfg.prefill_chunk,
            max_seq_len=min(llm_cfg.max_seq_len, cfg.max_seq_len),
            kv_dtype=resolve_kv_dtype(llm_cfg.kv_cache_dtype, act),
            decode_steps_per_dispatch=llm_cfg.decode_steps,
        )
        return cls.build(llm_cfg.model, device=device, dtype=dtype,
                         engine_cfg=ecfg, tp=llm_cfg.mesh.model,
                         model_path=llm_cfg.model_path,
                         tokenizer_path=llm_cfg.tokenizer_path,
                         temperature=llm_cfg.temperature, top_p=llm_cfg.top_p,
                         top_k=llm_cfg.top_k, max_new_tokens=llm_cfg.max_new_tokens,
                         guided_json=llm_cfg.guided_json,
                         lora_adapters=dict(llm_cfg.lora_adapters),
                         lora_rank=llm_cfg.lora_rank, lora_targets=tuple(llm_cfg.lora_targets),
                         draft_model=llm_cfg.draft_model,
                         draft_model_path=llm_cfg.draft_model_path)

    @classmethod
    def for_testing(cls, model_name: str = "llama3-test", params=None, device="cuda",
                    temperature: float = 0.0, max_new_tokens: int = 32,
                    max_seq_len: int = 256, schema_limits=None,
                    model_cfg: Optional[LlamaConfig] = None, lora_registry=None,
                    **engine_kw) -> "TorchCudaClient":
        """A small float32 client on the byte tokenizer, with the engine of
        the JAX package's ``JaxTpuClient.for_testing``. It serves ``params``
        (for example the JAX package's, through
        ``models.convert.params_from_jax``) or, without them, random params
        from seed 0, of ``model_cfg`` (default: ``model_name``'s config),
        with ``lora_registry``'s adapters where one is given;
        ``engine_kw`` overrides any engine setting."""
        tokenizer = load_tokenizer(None)
        dev = resolve_device(device)
        cfg = model_cfg or get_config(model_name)
        if params is None:
            _, params = load_or_init(model_name, None, dtype=torch.float32, device=dev)
        ecfg = EngineConfig(**{**dict(page_size=4, num_pages=256, max_batch_slots=4,
                                      prefill_chunk=32, max_seq_len=max_seq_len,
                                      kv_dtype=torch.float32), **engine_kw})
        core = cls._core(cfg, params, tokenizer, ecfg, schema_limits=schema_limits,
                         lora_registry=lora_registry)
        return cls(core, tokenizer, temperature=temperature, max_new_tokens=max_new_tokens,
                   chat_format=format_for_model(model_name, cfg.family))

    # ------------------------------------------------------------------- API

    def health_snapshot(self) -> dict:
        """The engine's metrics dict and KV-pool pressure for ``/healthz``,
        taken under the AsyncEngine's step lock with a bounded wait: a step
        mutates several keys together, and a liveness probe must not block
        behind a long step (a torn snapshot beats a dead prober)."""
        lock = self.engine._lock
        locked = lock.acquire(timeout=0.5)
        try:
            metrics = dict(self.core.metrics)
            kv = self.core.kv
            pressure = {"pages_total": kv.allocator.num_pages,
                        "pages_in_use": kv.pages_in_use,
                        "pages_cached": kv.allocator.cached_pages,
                        "utilization": round(kv.utilization(), 4)}
        finally:
            if locked:
                lock.release()
        return {"kv": pressure, "metrics": metrics}

    def _sampling(self, guided: Optional[str] = None,
                  max_new: Optional[int] = None) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            max_new_tokens=max_new or self.max_new_tokens,
            stop_token_ids=(self.tokenizer.eot_id, self.tokenizer.eos_id),
            guided=guided,
        )

    def _prompt_ids(self, system_prompt, user_prompt, tools) -> list[int]:
        return self.tokenizer.encode(build_chat_prompt(
            system_prompt, user_prompt, tools, fmt=self.chat_format))

    async def chat(self, system_prompt, user_prompt, tools=None,
                   adapter: Optional[str] = None) -> LLMResponse:
        ids = self._prompt_ids(system_prompt, user_prompt, tools)
        out = await self.engine.generate(ids, self._sampling(), adapter=adapter)
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

    async def chat_stream(self, system_prompt, user_prompt, tools=None,
                          adapter: Optional[str] = None):
        """True token streaming: ``{"type": "text", "delta"}`` per decoded
        piece (raw model output), then parsed ``tool_call`` events, then
        ``{"type": "done", "response"}`` with the parsed content, as
        :meth:`chat` returns it."""
        ids = self._prompt_ids(system_prompt, user_prompt, tools)
        state: dict = {}
        parts: list[str] = []
        async for piece in stream_text(self.engine, self.tokenizer, ids,
                                       self._sampling(), state=state, adapter=adapter):
            parts.append(piece)
            yield {"type": "text", "delta": piece}
        content, tool_calls, thinking = parse_assistant_output("".join(parts))
        for call in tool_calls:
            yield {"type": "tool_call", "call": call}
        yield {"type": "done", "response": LLMResponse(
            content=content, tool_calls=tool_calls, thinking=thinking,
            usage={"prompt_tokens": len(ids),
                   "completion_tokens": state.get("n_tokens", 0)})}

    def _completion_request(self, prompt: str, guided: Optional[bool],
                            schema: Optional[str]) -> tuple[list[int], SamplingParams]:
        """(ids, sampling) of a completion: one place for the guided default,
        the prompt and the grammar, so :meth:`complete` and
        :meth:`complete_stream` give the same text."""
        use_guided = self.guided_json if guided is None else guided
        ids = self.tokenizer.encode(build_completion_prompt(prompt, fmt=self.chat_format))
        grammar = (schema or "json") if use_guided else None
        return ids, self._sampling(guided=grammar)

    async def complete(self, prompt: str, guided: Optional[bool] = None,
                       schema: Optional[str] = None, adapter: Optional[str] = None) -> str:
        """A completion for the structured orchestrator, under guided JSON
        decoding unless ``guided`` (default: ``guided_json``) is False.
        ``schema`` names a compiled grammar (``"triage"``, ``"evaluation"``,
        ... — see ``model.schema_guided.orchestrator_schemas``) that holds the
        output to exactly that document's shape; without it the output is
        any well-formed JSON document."""
        ids, sampling = self._completion_request(prompt, guided, schema)
        out = await self.engine.generate(ids, sampling, adapter=adapter)
        return out.text

    async def complete_stream(self, prompt: str, guided: Optional[bool] = None,
                              schema: Optional[str] = None):
        """The streaming twin of :meth:`complete`: text pieces as the engine
        samples them (a fast-forwarded run arrives as one burst)."""
        ids, sampling = self._completion_request(prompt, guided, schema)
        async for piece in stream_text(self.engine, self.tokenizer, ids, sampling):
            yield piece

    async def shutdown(self) -> None:
        await self.engine.stop()
