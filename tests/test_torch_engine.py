"""Engine, client and CLI of the PyTorch port against the JAX package, on the
CPU (float32).

Both engines get the same weights (JAX ``init_params`` converted with
``params_from_jax``) and the same requests; greedy token streams must be
identical, request for request, across the ``test_engine.py`` scenarios.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.engine.engine import EngineConfig as JEngineConfig
from runbookai_tpu.engine.engine import EngineCore as JEngineCore
from runbookai_tpu.engine.request import EngineRequest as JRequest
from runbookai_tpu.engine.request import SamplingParams as JSampling
from runbookai_tpu.models.llama import CONFIGS as JCONFIGS
from runbookai_tpu.models.llama import init_params as jinit
from runbookai_tpu.utils.tokens import ByteTokenizer as JByteTokenizer
from runbookai_tpu_torch.engine.async_engine import AsyncEngine
from runbookai_tpu_torch.engine.engine import EngineConfig, EngineCore
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.models.convert import params_from_jax
from runbookai_tpu_torch.models.llama import CONFIGS
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

ROOT = Path(__file__).resolve().parent.parent
NAME = "llama3-test"
BASE = dict(page_size=4, num_pages=64, max_batch_slots=4, prefill_chunk=8,
            max_seq_len=128)


@pytest.fixture(scope="module")
def weights():
    jparams = jinit(jax.random.PRNGKey(0), JCONFIGS[NAME], dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _enc(text):
    return ByteTokenizer().encode(text)


SCENARIOS = {
    "single": dict(prompts=["investigate high latency in checkout"], max_new=12),
    "concurrent": dict(prompts=["alpha beta", "incident: api 5xx spike", "z",
                                "why is the payments queue backing up?"],
                       max_new=10),
    # 19 usable pages: the two sequences only fit together until the pool
    # forces an eviction (test_engine.py::test_forced_preemption_mid_decode).
    "preemption": dict(prompts=["a" * 21, "b" * 21], max_new=40,
                       cfg=dict(num_pages=20, max_batch_slots=2,
                                decode_steps_per_dispatch=1,
                                admit_headroom_tokens=8)),
    # The second request re-sends the first one's prompt prefix after it
    # finished: its full pages come from the prefix cache.
    "prefix_cache": dict(prompts=["system: you are an SRE agent. user: check db"],
                         later=["system: you are an SRE agent. user: check cache"],
                         max_new=6),
    # spec_ngram=1: any previously seen byte seeds a draft, so the verify
    # path runs even on a random-weight model's output.
    "speculation": dict(prompts=["restart the api service; restart the api "
                                 "service; restart"], max_new=24,
                        cfg=dict(spec_ngram=1)),
}


def _run(core, req_cls, sampling_cls, spec):
    reqs = [req_cls(prompt_ids=_enc(p),
                    sampling=sampling_cls(max_new_tokens=spec["max_new"]))
            for p in spec["prompts"]]
    for r in reqs:
        core.submit(r)
    core.run_until_idle()
    for p in spec.get("later", []):
        r = req_cls(prompt_ids=_enc(p),
                    sampling=sampling_cls(max_new_tokens=spec["max_new"]))
        core.submit(r)
        core.run_until_idle()
        reqs.append(r)
    return [r.all_out_ids for r in reqs], [r.finish_reason.value for r in reqs]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_greedy_streams_match_jax_engine(weights, scenario):
    spec = SCENARIOS[scenario]
    jparams, tparams = weights
    kw = dict(BASE, **spec.get("cfg", {}))
    jcore = JEngineCore(JCONFIGS[NAME], jparams, JByteTokenizer(),
                        JEngineConfig(block_pages=4, kv_dtype=jnp.float32, **kw))
    tcore = EngineCore(CONFIGS[NAME], tparams, ByteTokenizer(),
                       EngineConfig(kv_dtype=torch.float32, **kw))
    want = _run(jcore, JRequest, JSampling, spec)
    got = _run(tcore, EngineRequest, SamplingParams, spec)
    assert got == want
    assert tcore.kv.allocator.free_pages == kw["num_pages"] - 1  # all returned
    if scenario == "preemption":
        assert tcore.metrics["preemptions"] >= 1
    if scenario == "prefix_cache":
        assert tcore.metrics["cached_prefix_tokens"] > 0
    if scenario == "speculation":
        assert tcore.metrics["spec_drafted"] > 0


def test_engine_refuses_unported_sampling(weights):
    core = EngineCore(CONFIGS[NAME], weights[1], ByteTokenizer(),
                      EngineConfig(kv_dtype=torch.float32, **BASE))
    for sampling in (SamplingParams(guided="json"), SamplingParams(logprobs=2),
                     SamplingParams(presence_penalty=0.5),
                     SamplingParams(logit_bias=((3, 1.0),))):
        with pytest.raises(ValueError):
            core.submit(EngineRequest(prompt_ids=[1, 2], sampling=sampling))


async def test_async_engine_concurrent_generate(weights):
    core = EngineCore(CONFIGS[NAME], weights[1], ByteTokenizer(),
                      EngineConfig(kv_dtype=torch.float32, **BASE))
    eng = AsyncEngine(core)
    outs = await asyncio.gather(
        eng.generate(_enc("one"), SamplingParams(max_new_tokens=3)),
        eng.generate(_enc("two"), SamplingParams(max_new_tokens=3,
                                                 temperature=0.8, seed=5)),
        eng.generate(_enc("three"), SamplingParams(max_new_tokens=3)))
    streamed = [t async for t in eng.generate_stream(_enc("one"),
                                                     SamplingParams(max_new_tokens=3))]
    await eng.stop()
    assert [len(o.token_ids) for o in outs] == [3, 3, 3]
    assert streamed == outs[0].token_ids


async def test_client_chat_matches_jax_client(weights):
    from runbookai_tpu.model.jax_tpu import JaxTpuClient

    jclient = JaxTpuClient.for_testing(NAME, max_new_tokens=16)
    ecfg = EngineConfig(page_size=4, num_pages=256, max_batch_slots=4,
                        prefill_chunk=32, max_seq_len=256, kv_dtype=torch.float32)
    tclient = TorchCudaClient(EngineCore(CONFIGS[NAME], weights[1], ByteTokenizer(), ecfg),
                              ByteTokenizer(), max_new_tokens=16)
    try:
        want = await jclient.chat("You are terse.", "status of checkout?")
        got = await tclient.chat("You are terse.", "status of checkout?")
        events = [e async for e in tclient.chat_stream("You are terse.",
                                                       "status of checkout?")]
    finally:
        await jclient.shutdown()
        await tclient.shutdown()
    assert (got.content, got.usage["completion_tokens"]) == \
        (want.content, want.usage["completion_tokens"])
    assert events[-1]["type"] == "done"
    assert events[-1]["response"].content == got.content


@pytest.mark.parametrize("entry", ["client", "cli", "init_params", "load_params",
                                   "params_from_jax"])
def test_entry_points_ask_for_cuda_by_default(entry):
    """Without ``device="cpu"`` every entry point asks for the card, and
    raises when there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    from runbookai_tpu_torch.models.hf_loader import config_from_hf, load_params
    from runbookai_tpu_torch.models.llama import init_params

    fixture = ROOT / "tests" / "fixtures" / "hf-tiny-untied"
    calls = {
        "client": lambda: TorchCudaClient.build(NAME, dtype=torch.float32),
        "cli": lambda: subprocess.run(
            [sys.executable, "-m", "runbookai_tpu_torch", "chat", "hi", "--model", NAME],
            cwd=ROOT, capture_output=True, text=True, timeout=120, check=True),
        "init_params": lambda: init_params(CONFIGS[NAME], dtype=torch.float32),
        "load_params": lambda: load_params(fixture, config_from_hf(fixture),
                                           dtype=torch.float32),
        "params_from_jax": lambda: params_from_jax(
            {"final_norm": np.ones(4, np.float32)}),
    }
    with pytest.raises((RuntimeError, AssertionError, subprocess.CalledProcessError)):
        calls[entry]()


def test_cli_chat_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "runbookai_tpu_torch", "chat", "hello",
         "--model", NAME, "--device", "cpu", "--max-new-tokens", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["completion_tokens"] == 4
    assert stats["kernel_launches"] == {"paged_decode_attention": 0,
                                        "paged_chunk_attention": 0,
                                        "paged_decode_attention_int8": 0,
                                        "paged_chunk_attention_int8": 0,
                                        "paged_decode_attention_partial": 0,
                                        "paged_chunk_attention_partial": 0,
                                        "qmm_int8": 0}
