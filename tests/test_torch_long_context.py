"""Long contexts on the port against the JAX package, on the CPU (float32).

``tests/test_long_context.py`` serves a prompt past the Llama-3.1 rope-scaling
knee (8,192) on the JAX engine, on one device and on the kv2 x pg2 page split.
Here the same configuration (``_longctx_cfg``: dim 64, 2 layers, 4/2 heads,
``rope_scaling=(8.0, 1.0, 4.0, 8192)``, 16-token pages, one slot, speculation
off) serves one seeded prompt whose positions cross 8,192 by a whole prefill
chunk: once on the JAX ``EngineCore`` (shared by the module), once on the
port's ``EngineCore`` and once on the port's page split (``plan_kv_split(cfg,
4)``: two kv shards by two page shards, every shard on the CPU), with the
JAX params carried across by ``params_from_jax``. The greedy tokens must be
equal. The 33k scenarios run only with ``RUNBOOK_LONGCTX`` set, as the
reference gates its own.

Also: a model name outside ``CONFIGS`` without weights serves
``llama3-test``'s config at random in both packages, and
``llama3-70b-instruct``'s int8 tree (built on the meta device) holds exactly
the bytes ``plan_serving`` plans for it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.models import hf_loader as jloader
from runbookai_tpu.models.llama import init_params as jinit
from runbookai_tpu_torch.engine.engine import EngineConfig, EngineCore
from runbookai_tpu_torch.engine.memory_plan import GiB, plan_serving
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.models import checkpoint as tcheckpoint
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models.convert import params_from_jax
from runbookai_tpu_torch.models.quant import weight_bytes
from runbookai_tpu_torch.parallel.kv_split import plan_kv_split
from runbookai_tpu_torch.parallel.mesh import build_mesh
from runbookai_tpu_torch.parallel.sharding import shard_params
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

from test_long_context import _longctx_cfg, _serve_long

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

KNEE = 8192
CHUNK = 512  # the serving prefill chunk
PROMPT = KNEE + CHUNK + 16  # positions 8,192..8,735 are a whole chunk past the knee
MAX_SEQ = PROMPT + 16  # 546 pages a table
NEW = 4
LONG = 33_000  # the gated scenarios, as test_long_context.py's
LONG_MAX_SEQ = 34_816
GATED = pytest.mark.skipif(not os.environ.get("RUNBOOK_LONGCTX"),
                           reason="the 33k scenarios take minutes on the CPU; "
                                  "set RUNBOOK_LONGCTX=1")


def _port_cfg(max_seq: int) -> tllama.LlamaConfig:
    jcfg = _longctx_cfg(max_seq)
    return tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})


def _params(max_seq: int) -> dict:
    """The JAX engine's params (``_serve_long`` draws them from key 0) as
    the port's, on the CPU."""
    jparams = jinit(jax.random.PRNGKey(0), _longctx_cfg(max_seq), dtype=jnp.float32)
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _prompt(n: int) -> list[int]:
    return np.random.default_rng(0).integers(3, 250, size=n).tolist()  # _serve_long's


def _serve_port(n: int, max_seq: int, tp: int = 1) -> EngineRequest:
    """The port's engine in ``_serve_long``'s configuration (its pool one
    page larger where the page shards need an even count); with ``tp`` > 1
    on the page-split mesh ``plan_kv_split`` plans, every shard on the CPU."""
    cfg = _port_cfg(max_seq)
    params, mesh = _params(max_seq), None
    if tp > 1:
        plan = plan_kv_split(cfg, tp)
        assert plan.pg_shards > 1, plan  # the 70B-style page split is live
        mesh = build_mesh(plan.kv_shards, plan.pg_shards, ["cpu"] * tp)
        params = shard_params(params, cfg, mesh)
    core = EngineCore(cfg, params, ByteTokenizer(), EngineConfig(
        page_size=16, num_pages=-(-(n // 16 + 64) // 2) * 2, max_batch_slots=1,
        prefill_chunk=CHUNK if n == PROMPT else 1024, max_seq_len=max_seq,
        kv_dtype=torch.float32, speculative=False, prefill_batch=1), mesh=mesh)
    req = EngineRequest(prompt_ids=_prompt(n), sampling=SamplingParams(
        temperature=0.0, max_new_tokens=NEW, stop_token_ids=()))
    core.submit(req)
    core.run_until_idle()
    assert req.finish_reason is not None and req.ctx_len > n
    return req


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX engine's greedy tokens on the knee-crossing prompt."""
    req = _serve_long(PROMPT, max_seq=MAX_SEQ, new_tokens=NEW, prefill_chunk=CHUNK)
    assert req.ctx_len > PROMPT and len(req.out_ids) == NEW
    return req.out_ids


@pytest.fixture(scope="module")
def port_tokens():
    return _serve_port(PROMPT, MAX_SEQ).out_ids


def test_prompt_crosses_the_knee_by_a_chunk():
    assert PROMPT - KNEE >= CHUNK
    assert -(-PROMPT // CHUNK) * CHUNK - CHUNK >= KNEE  # the last chunk lies wholly past it
    assert _port_cfg(MAX_SEQ).rope_scaling == (8.0, 1.0, 4.0, KNEE)


def test_engine_matches_jax_past_the_rope_knee(jax_tokens, port_tokens):
    """Chunked prefill past 8,192 and paged decode at positions beyond it on
    the port's engine: the JAX engine's greedy tokens."""
    assert port_tokens == jax_tokens


def test_page_split_matches_jax_past_the_rope_knee(jax_tokens, port_tokens):
    """The same prompt on the kv2 x pg2 page split (the 70B's tp=16
    factorization, scaled down): the unsharded port's tokens and JAX's."""
    got = _serve_port(PROMPT, MAX_SEQ, tp=4).out_ids
    assert got == port_tokens == jax_tokens


@GATED
def test_engine_matches_jax_at_33k():
    want = _serve_long(LONG, max_seq=LONG_MAX_SEQ).out_ids
    assert _serve_port(LONG, LONG_MAX_SEQ).out_ids == want


@GATED
def test_page_split_matches_jax_at_33k():
    want = _serve_long(LONG, max_seq=LONG_MAX_SEQ).out_ids
    assert _serve_port(LONG, LONG_MAX_SEQ, tp=4).out_ids == want


# ------------------------------------------------- a model outside CONFIGS


def test_unknown_model_serves_llama3_test_at_random_like_jax():
    """No weights and a name outside ``CONFIGS``: both loaders serve
    ``llama3-test``'s config, drawn from the seed (the JAX loader's
    ``hf_loader.py::load_or_init``), with leaves of the same shapes."""
    jcfg, jparams = jloader.load_or_init("no-such-model", None, dtype=jnp.float32)
    cfg, params = tcheckpoint.load_or_init("no-such-model", None, dtype=torch.float32,
                                           device="cpu")
    assert jcfg.name == cfg.name == "llama3-test"
    assert tcheckpoint.model_config("no-such-model", None) == cfg
    assert dataclasses.asdict(cfg) == {f.name: getattr(jcfg, f.name)
                                       for f in dataclasses.fields(tllama.LlamaConfig)}
    want = {jax.tree_util.keystr(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    got = {jax.tree_util.keystr(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want
    # A known name still gives its own config.
    assert tcheckpoint.model_config("llama3.1-8b-instruct", None).max_seq_len == 131_072


# --------------------------------------------------- the 70B's int8 plan


def test_70b_int8_tree_is_the_plan():
    """``llama3-70b-instruct``'s int8 tree as ``init_params_quantized`` draws
    it (on the meta device: shapes and types, no memory): 68.45 GB of int8
    layer matrices, 2.10 GB each of bf16 embedding and head, 0.03 GB of f32
    scales, exactly ``plan_serving``'s weight bytes; on an H100 (about 85.0
    GB of device memory) the plan leaves room for more than 1,024 bf16
    pages of 16 tokens."""
    cfg = tllama.CONFIGS["llama3-70b-instruct"]
    tree = tllama.init_params_quantized(cfg, dtype=torch.bfloat16, device="meta")
    layers = tree["layers"]
    matrices = sum(w["q"].numel() for w in layers.values() if isinstance(w, dict))
    scales = sum(w["s"].numel() * 4 for w in layers.values() if isinstance(w, dict))
    assert matrices == 68_451_041_280
    assert tree["embed"].numel() * 2 == tree["lm_head"].numel() * 2 == 2_101_346_304
    assert scales == 26_869_760
    total = weight_bytes(tree)
    assert total == 72_685_879_296
    for hbm in (80 * 10**9, 85 * 10**9):
        plan = plan_serving(cfg, 8192, batch=8, weights="int8", kv_dtype_bytes=2,
                            hbm_bytes=hbm)
        assert plan.weight_bytes_per_chip == total
    page = 16 * plan.kv_bytes_per_token_per_chip
    assert page == 16 * 80 * 2 * 8 * 128 * 2
    assert plan.pool_budget_bytes == 85 * 10**9 - total - int(1.5 * GiB)
    assert plan.pool_budget_bytes // page > 1_024
