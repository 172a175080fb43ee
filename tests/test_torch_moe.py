"""Mixtral's mixture-of-experts serving in the PyTorch port against the JAX
package, on the CPU (float32).

The same inputs, made with numpy from a seed, go through JAX's
``ops/moe.py::moe_ffn`` and the port's (dropless, capacity factors 0.5 and
1.0, int8 experts, all-zero rows where every expert ties), and JAX's
``mixtral-test`` params (carried across by ``params_from_jax``) through both
forwards and both engines. Tolerances: 2e-6 on ``moe_ffn`` (float32, the
same operations), 2e-4 on logits (``test_torch_model.py``), the
``hf-tiny-mixtral`` golden at ``test_hf_golden.py``'s 2e-4 / 2e-3, and
equality on greedy tokens and routes. Expert parallelism (tp = 2, tp = 4
on the page split, and a tp that does not divide E) is held against the
unsharded forward and against JAX's forward on the 8-device CPU mesh.
"""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.engine.engine import EngineConfig as JEngineConfig
from runbookai_tpu.engine.engine import EngineCore as JEngineCore
from runbookai_tpu.engine.memory_plan import plan_serving as jplan_serving
from runbookai_tpu.engine.request import EngineRequest as JRequest
from runbookai_tpu.engine.request import SamplingParams as JSampling
from runbookai_tpu.model.jax_tpu import JaxTpuClient
from runbookai_tpu.models import hf_loader as jhf
from runbookai_tpu.models import llama as jllama
from runbookai_tpu.models import quant as jquant
from runbookai_tpu.models.lora import LoraRegistry as JLoraRegistry
from runbookai_tpu.ops import moe as jmoe
from runbookai_tpu.parallel.mesh import build_mesh as jbuild_mesh
from runbookai_tpu.parallel.sharding import kv_pool_sharding, param_shardings
from runbookai_tpu.utils.tokens import ByteTokenizer as JByteTokenizer
from runbookai_tpu_torch.engine.engine import EngineConfig, EngineCore
from runbookai_tpu_torch.engine.kv_cache import PagePool
from runbookai_tpu_torch.engine.memory_plan import GiB, plan_serving
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.models import hf_loader as thf
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models import quant as tquant
from runbookai_tpu_torch.models.convert import lora_registry_from_jax, params_from_jax
from runbookai_tpu_torch.ops import moe as tmoe
from runbookai_tpu_torch.parallel.mesh import build_mesh
from runbookai_tpu_torch.parallel.sharding import param_splits, shard_params
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

from test_torch_serve_obs import jax_plan_with_exact_scales

from test_torch_model import _paged_inputs

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

NAME = "mixtral-test"  # E = 4, top 2, dim 64, ffn 128, 4/2 heads
CFG = tllama.CONFIGS[NAME]
JCFG = jllama.CONFIGS[NAME]
FIXTURE = Path(__file__).parent / "fixtures" / "hf-tiny-mixtral"
MOE_TOL = dict(rtol=2e-6, atol=2e-6)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
PS = 4
TOK = ByteTokenizer()
ENGINE = dict(page_size=4, num_pages=64, max_batch_slots=4, prefill_chunk=8,
              max_seq_len=128)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def int8_weights(weights):
    jparams = jquant.quantize_params(weights[0])
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


# ------------------------------------------------------------------ moe_ffn


def _bank(rng, e, d=16, f=32):
    """router [D, E] and the expert leaves, float32 numpy."""
    return ((rng.normal(size=(d, e)) * 0.5).astype(np.float32),
            (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32))


_jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=(5, 6))
GEOMETRIES = [(4, 2, 12), (8, 2, 33), (4, 1, 7)]  # (E, K, N)
CASES = {"dropless": 0.0, "capacity_0.5": 0.5, "capacity_1.0": 1.0, "int8": 0.0,
         "zero_rows": 0.5}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("e,k,n", GEOMETRIES)
def test_moe_ffn_matches_jax(e, k, n, case):
    """The same tokens routed, slotted and dropped as JAX's: outputs within
    2e-6 and every (token, k) route equal. A capacity below dropless must
    drop something (else the case tests nothing); zero rows tie every
    expert, and the tie order (lower id first) decides which pairs fill a
    queue."""
    rng = np.random.default_rng(100 * e + 10 * k + n)
    router, wg, wu, wd = _bank(rng, e)
    y = rng.normal(size=(1, n, 16)).astype(np.float32)
    if case == "zero_rows":
        y[0, ::2] = 0.0
    cf = CASES[case]
    experts = (wg, wu, wd)
    if case == "int8":
        jexp = [jquant.quantize_tensor(jnp.asarray(w)) for w in experts]
        texp = [tquant.quantize_tensor(_t(w)) for w in experts]
        for a, b in zip(jexp, texp):
            np.testing.assert_array_equal(b["q"].numpy(), np.asarray(a["q"]))
    else:
        jexp, texp = [jnp.asarray(w) for w in experts], [_t(w) for w in experts]
    want = _jmoe_ffn(jnp.asarray(y), jnp.asarray(router), *jexp, k, cf)
    got = tmoe.moe_ffn(_t(y), _t(router), *texp, k, cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)

    jvals, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(y[0]) @ jnp.asarray(router)), k)
    gate, idx = tmoe.route(_t(y[0]), _t(router), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jvals / jvals.sum(-1, keepdims=True)),
                               **MOE_TOL)
    if cf > 0:
        dropless = tmoe.moe_ffn(_t(y), _t(router), *texp, k, 0.0)
        assert not torch.allclose(got, dropless), "no pair dropped"
    if case == "zero_rows":
        assert (idx[::2] == torch.arange(k)).all()


def test_expert_capacity_matches_jax():
    for n in (1, 3, 7, 8, 33, 512, 2048):
        for e in (1, 3, 4, 8):
            for k in (1, 2, 3):
                for cf in (-1.0, 0.0, 0.1, 0.25, 0.5, 1.0, 1.25, 2.0, 4.0):
                    assert tmoe.expert_capacity(n, e, k, cf) == jmoe.expert_capacity(n, e, k, cf)


def test_moe_ffn_shards_sum_to_the_whole():
    """Each shard's part (its experts, ``first`` on) is zero for the pairs
    it does not hold, and the parts sum to the unsharded output, capacity
    drops included."""
    rng = np.random.default_rng(3)
    router, wg, wu, wd = (_t(w) for w in _bank(rng, 8))
    y = _t(rng.normal(size=(2, 9, 16)).astype(np.float32))
    whole = tmoe.moe_ffn(y, router, wg, wu, wd, 2, 0.5)
    parts = [tmoe.moe_ffn(y, router, wg[s:s + 2], wu[s:s + 2], wd[s:s + 2], 2, 0.5, first=s)
             for s in range(0, 8, 2)]
    np.testing.assert_allclose(sum(parts).numpy(), whole.numpy(), **MOE_TOL)


# ------------------------------------------------------ params, int8, loader


def _shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: np.zeros(x.shape), tree))[0]
    return {k: v.shape for k, v in flat}


def test_init_layouts_match_jax():
    """``init_params`` and ``init_params_quantized`` give JAX's tree: expert
    leaves [L, E, in, out], int8 scales [L, E, 1, out], a dense router."""
    gen = torch.Generator().manual_seed(0)
    for jinit, tinit in ((jllama.init_params, tllama.init_params),
                         (jllama.init_params_quantized, tllama.init_params_quantized)):
        jp = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32))
        tp = tinit(CFG, dtype=torch.float32, device="cpu", generator=gen)
        assert _shapes(jp) == _shapes(tp)
        assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w_gate"]["q"].dtype == torch.int8
    assert tuple(tp["layers"]["w_down"]["s"].shape) == (2, 4, 1, 64)


def test_quantize_and_convert_expert_leaves_like_jax(weights):
    """``quantize_params`` quantizes the expert leaves per (expert, output
    channel) and leaves the router; ``params_from_jax`` carries both trees;
    ``weight_bytes`` and ``dequantize_params`` agree with JAX's."""
    jparams, tparams = weights
    jq = jquant.quantize_params(jparams)
    tq = tquant.quantize_params(tparams)
    carried = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    for name in ("w_gate", "w_up", "w_down"):
        for part in ("q", "s"):
            np.testing.assert_array_equal(tq["layers"][name][part].numpy(),
                                          np.asarray(jq["layers"][name][part]))
            np.testing.assert_array_equal(carried["layers"][name][part].numpy(),
                                          np.asarray(jq["layers"][name][part]))
    assert not tquant.is_quantized(tq["layers"]["router"])
    assert tquant.weight_bytes(tq) == jquant.weight_bytes(jq)
    np.testing.assert_allclose(tquant.dequantize_params(tq, torch.float32)["layers"]["w_up"],
                               np.asarray(jquant.dequantize_params(jq, jnp.float32)
                                          ["layers"]["w_up"]), **MOE_TOL)


def _golden_logits(cfg, params):
    blob = np.load(FIXTURE / "expected_logits.npz")
    ids = blob["input_ids"]
    b, t = ids.shape
    tables, pos = _paged_inputs([t] * b, [0] * b, t)
    shape = (cfg.n_layers, 40 * PS, cfg.n_kv_heads, cfg.head_dim)
    got = tllama.forward_impl(params, cfg, _t(ids).long(), _t(pos), torch.zeros(shape),
                              torch.zeros(shape), _t(tables),
                              torch.full((b,), t, dtype=torch.int32), PS)
    return got.numpy(), blob["logits"]


def test_loader_matches_the_mixtral_golden():
    """``hf-tiny-mixtral`` through the port's loader and paged forward
    against transformers' logits (``test_hf_golden.py``'s tolerance)."""
    cfg, params = thf.load_params(FIXTURE, thf.config_from_hf(FIXTURE), dtype=torch.float32,
                                  device="cpu")
    assert (cfg.n_experts, cfg.top_k_experts, cfg.family) == (4, 2, "mixtral")
    assert tuple(params["layers"]["w_gate"].shape) == (2, 4, 64, 128)
    got, want = _golden_logits(cfg, params)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_int8_loader_matches_jax_loader():
    """``quantize_int8``: the experts quantized per (expert, output
    channel) exactly as JAX's loader does, the router kept; the forward
    stays near the golden."""
    jcfg, jparams = jhf.load_params(FIXTURE, jhf.config_from_hf(FIXTURE), dtype=jnp.float32,
                                    quantize_int8=True)
    cfg, params = thf.load_params(FIXTURE, thf.config_from_hf(FIXTURE), dtype=torch.float32,
                                  device="cpu", quantize_int8=True)
    for name, leaf in params["layers"].items():
        jleaf = jparams["layers"][name]
        if tquant.is_quantized(leaf):
            for part in ("q", "s"):
                np.testing.assert_array_equal(leaf[part].numpy(), np.asarray(jleaf[part]))
        else:
            assert name != "w_gate"
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    assert not tquant.is_quantized(params["layers"]["router"])
    got, want = _golden_logits(cfg, params)
    assert np.abs(got - want).max() < 0.05 * np.abs(want).max()


# ----------------------------------------------------------------- forward


def _forward_steps(rng):
    """A prefill chunk (row 1 with a pad tail), a decode step with an empty
    slot, a T = 4 verify: (tokens, positions, tables, ctx) each."""
    trash = 16 * PS
    tables, pos = _paged_inputs([8, 5], [0, 0], 8)
    steps = [(rng.integers(0, CFG.vocab_size, (2, 8)), pos, tables, np.array([8, 5]))]
    dtables = np.zeros((3, 17), np.int32)
    dtables[:2] = tables
    steps.append((rng.integers(0, CFG.vocab_size, (3, 1)), np.array([[8], [5], [trash]]),
                  dtables, np.array([9, 6, 0])))
    steps.append((rng.integers(0, CFG.vocab_size, (2, 4)),
                  np.array([np.arange(9, 13), np.arange(6, 10)]), tables, np.array([13, 10])))
    return [(tok.astype(np.int32), p.astype(np.int32), tb, c.astype(np.int32))
            for tok, p, tb, c in steps]


@pytest.mark.parametrize("int8", [False, True])
def test_forward_matches_jax(weights, int8_weights, int8):
    """``forward_impl`` over a paged pool against JAX's (``attn_impl`` and
    ``qmm_impl`` Pallas, interpret mode) for a prefill, a decode and a
    verify; logits of real tokens at 2e-4."""
    jparams, tparams = int8_weights if int8 else weights
    shape = (CFG.n_layers, 40 * PS, CFG.n_kv_heads, CFG.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for tokens, pos, tables, ctx in _forward_steps(np.random.default_rng(1)):
        want, jk, jv = jllama.forward(jparams, JCFG, jnp.asarray(tokens), jnp.asarray(pos),
                                      jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
                                      page_size=PS, attn_impl="pallas", qmm_impl="pallas")
        got = tllama.forward_impl(tparams, CFG, _t(tokens).long(), _t(pos), tk, tv,
                                  _t(tables), _t(ctx), PS)
        live = pos < 16 * PS
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **LOGIT_TOL)


def test_forward_ragged_matches_jax(weights):
    """A decode row and a 5-token prefill row in the flat layout, pads on a
    null row: the pads route and take capacity as JAX's do (dropless here,
    and at a capacity factor of 0.5, where they crowd real tokens out)."""
    jparams, tparams = weights
    rq, trash = 8, 2 * PS
    rng = np.random.default_rng(2)
    k0 = rng.normal(size=(CFG.n_layers, 5 * PS, CFG.n_kv_heads, CFG.head_dim)
                    ).astype(np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0]], np.int32)
    tokens = np.zeros((3 * rq,), np.int32)
    positions = np.full((3 * rq,), trash, np.int32)
    row_ids = np.array([0] * rq + [1] * rq + [2] * rq, np.int32)
    tokens[0], positions[0] = 7, 4
    tokens[rq:rq + 5], positions[rq:rq + 5] = [1, 2, 3, 4, 5], range(5)
    ctx = np.array([5, 5, 0], np.int32)
    sel = np.array([0, rq + 4], np.int32)
    for cf in (0.0, 0.5):
        jcfg, cfg = (dataclasses.replace(c, capacity_factor=cf) for c in (JCFG, CFG))
        want, _, _ = jllama.forward_ragged_impl(
            jparams, jcfg, *map(jnp.asarray, (tokens, positions, row_ids)),
            jnp.asarray(k0), jnp.asarray(k0), jnp.asarray(tables), jnp.asarray(ctx),
            jnp.asarray(sel), page_size=PS, block_pages=2, ragged_block=rq)
        got = tllama.forward_ragged_impl(tparams, cfg, _t(tokens).long(), _t(positions),
                                         _t(row_ids), _t(k0), _t(k0), _t(tables), _t(ctx),
                                         _t(sel).long(), PS, ragged_block=rq)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


# ------------------------------------------------------- expert parallelism

E3 = dataclasses.replace(CFG, n_experts=3)  # 3 experts: no tp > 1 divides them
JE3 = dataclasses.replace(JCFG, n_experts=3)


@pytest.fixture(scope="module")
def e3_weights():
    jparams = jllama.init_params(jax.random.PRNGKey(1), JE3, dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


MESHES = [("tp2", 2, 1, False), ("tp4_page_split", 2, 2, False), ("e3_tp2", 2, 1, True)]


@pytest.mark.parametrize("name,model,seq,e3", MESHES, ids=[m[0] for m in MESHES])
def test_expert_parallel_forward(weights, e3_weights, name, model, seq, e3):
    """The shards hold JAX's device slices (experts over ``model`` where E
    divides by tp, else whole; the router whole), and the sharded forward
    (prefill, decode, verify) equals the unsharded one and JAX's on the
    same mesh."""
    jparams, tparams = e3_weights if e3 else weights
    cfg, jcfg = (E3, JE3) if e3 else (CFG, JCFG)
    jmesh = jbuild_mesh(1, model=model, seq=seq)
    tmesh = build_mesh(model, seq, ["cpu"] * (model * seq))
    ep = param_splits(cfg, tmesh)["layers.w_gate"]
    assert ep == (None if e3 else (1, "model"))
    jsharded = jax.tree.map(jax.device_put, jparams, param_shardings(jcfg, jmesh))
    shards = shard_params({**tparams, "layers": dict(tparams["layers"])}, cfg, tmesh)
    coords = {d: (int(s), int(m)) for (_, _, s, m), d in np.ndenumerate(jmesh.devices)}
    for leaf in ("w_gate", "w_down", "router"):
        for piece in jsharded["layers"][leaf].addressable_shards:
            s, m = coords[piece.device]
            np.testing.assert_array_equal(shards[tmesh.rank(m, s)]["layers"][leaf].numpy(),
                                          np.asarray(piece.data))
    shape = (cfg.n_layers, 16 * PS, cfg.n_kv_heads, cfg.head_dim)
    jk = jv = jax.device_put(jnp.zeros(shape), kv_pool_sharding(jcfg, jmesh))
    pool = PagePool.create(cfg.n_layers, 16, PS, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                           device="cpu", mesh=tmesh)
    whole = PagePool.create(cfg.n_layers, 16, PS, cfg.n_kv_heads, cfg.head_dim,
                            torch.float32, device="cpu")
    tables = np.zeros((2, 9), np.int32)
    tables[0, :5] = [9, 2, 12, 3, 15]
    tables[1, :5] = [4, 11, 5, 13, 6]
    for tokens, pos, _, ctx in _forward_steps(np.random.default_rng(4)):
        b = tokens.shape[0]
        tb = np.zeros((b, 9), np.int32)
        tb[:2] = tables
        pos = np.where(pos >= 16 * PS, 8 * PS, pos).astype(np.int32)
        want, jk, jv = jllama.forward_impl(
            jsharded, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jk, jv, jnp.asarray(tb),
            jnp.asarray(ctx), page_size=PS, block_pages=4, attn_impl="pallas", mesh=jmesh)
        args = (_t(tokens).long(), _t(pos))
        got = tllama.forward_impl(shards, cfg, *args, pool.kv_k, pool.kv_v, _t(tb), _t(ctx),
                                  PS, mesh=tmesh)
        ref = tllama.forward_impl(tparams, cfg, *args, whole.kv_k, whole.kv_v, _t(tb),
                                  _t(ctx), PS)
        live = pos < 8 * PS
        np.testing.assert_allclose(got.numpy()[live], ref.numpy()[live], **LOGIT_TOL)
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **LOGIT_TOL)


# ----------------------------------------------------------------- engines


def _enc(text):
    return TOK.encode(text)


SPEC_PROMPT = "restart the api service; restart the api service; restart"
PROMPTS = ["alpha beta gamma delta epsilon", "incident: api 5xx spike", "z",
           "why is the payments queue backing up?"]
# mode -> (prompts, max new tokens, engine overrides of both packages)
MODES = {
    "chunked_multi_step": (PROMPTS, 10, dict(decode_steps_per_dispatch=4)),
    "prompt_lookup": ([SPEC_PROMPT], 24, dict(spec_ngram=1)),
    "overlap_off": (PROMPTS, 10, dict(overlap_decode=False)),
    "mixed_dispatch": (PROMPTS, 10, dict(mixed_dispatch=True)),
}


def _serve(core, req_cls, sampling_cls, prompts, max_new, adapters=None, stagger=False):
    reqs = [req_cls(prompt_ids=_enc(p), sampling=sampling_cls(max_new_tokens=max_new,
                                                               stop_token_ids=()),
                    **({} if adapters is None else {"adapter": a}))
            for p, a in zip(prompts, adapters or [None] * len(prompts))]
    core.submit(reqs[0])
    while stagger and not reqs[0].out_ids:
        core.step()
    for r in reqs[1:]:
        core.submit(r)
    core.run_until_idle()
    return [r.all_out_ids for r in reqs]


def _engines(jparams, tparams, kw, jkv=jnp.float32, tkv=torch.float32, **jextra):
    jcore = JEngineCore(JCFG, jparams, JByteTokenizer(),
                        JEngineConfig(block_pages=4, kv_dtype=jkv, **kw, **jextra))
    tcore = EngineCore(CFG, tparams, TOK, EngineConfig(kv_dtype=tkv, **kw))
    return jcore, tcore


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_match_jax_engine(weights, mode):
    """Chunked prefill (8-token chunks of prompts up to 37 tokens), k-step
    decode, the prompt-lookup verify, overlap off and mixed dispatch:
    streams equal to the JAX ``EngineCore``'s, every page given back."""
    prompts, max_new, extra = MODES[mode]
    kw = dict(ENGINE, **extra)
    jcore, tcore = _engines(*weights, kw)
    stagger = mode == "mixed_dispatch"
    want = _serve(jcore, JRequest, JSampling, prompts, max_new, stagger=stagger)
    assert _serve(tcore, EngineRequest, SamplingParams, prompts, max_new,
                  stagger=stagger) == want
    assert tcore.kv.allocator.free_pages == kw["num_pages"] - 1
    if mode == "prompt_lookup":
        assert tcore.metrics["spec_drafted"] > 0
    if mode == "mixed_dispatch":
        assert tcore.metrics["mixed_steps"] > 0


def test_int8_streams_match_jax_engine(int8_weights):
    """int8 experts and attention weights (float32 activations): K5's plain
    version for the 2-D products, the widened product for the experts, in
    both packages."""
    kw = dict(ENGINE, decode_steps_per_dispatch=4)
    jcore, tcore = _engines(*int8_weights, kw, attn_impl="pallas", qmm_impl="pallas")
    want = _serve(jcore, JRequest, JSampling, PROMPTS, 10)
    assert _serve(tcore, EngineRequest, SamplingParams, PROMPTS, 10) == want


def test_bf16_streams_match_jax_engine(weights):
    """bfloat16 weights, activations and pool in both engines."""
    bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim > 1 else x, weights[0])
    tparams = params_from_jax(jax.tree.map(np.asarray, bf), device="cpu")
    jcore, tcore = _engines(bf, tparams, ENGINE, jkv=jnp.bfloat16, tkv=torch.bfloat16)
    want = _serve(jcore, JRequest, JSampling, PROMPTS[:2], 8)
    assert _serve(tcore, EngineRequest, SamplingParams, PROMPTS[:2], 8) == want


def test_step_graphs_capture_and_replay_moe(weights):
    """Every bucket (prefill at 1/2/4 rows, T = 1, the greedy loops, the
    verifies, mixed) captures with MoE layers (the emulated capture refuses
    any host read) and its replays give the eager engine's and JAX's
    streams."""
    kw = dict(ENGINE, spec_ngram=1, mixed_dispatch=True, decode_steps_per_dispatch=4)
    prompts = [SPEC_PROMPT, *PROMPTS[:2]]
    jcore = JEngineCore(JCFG, weights[0], JByteTokenizer(),
                        JEngineConfig(block_pages=4, kv_dtype=jnp.float32, **kw))
    want = _serve(jcore, JRequest, JSampling, prompts, 16, stagger=True)
    outs = {}
    for graphs in (True, False):
        core = EngineCore(CFG, weights[1], TOK, EngineConfig(kv_dtype=torch.float32,
                                                             step_graphs=graphs, **kw))
        outs[graphs] = _serve(core, EngineRequest, SamplingParams, prompts, 16, stagger=True)
        if graphs:
            kinds = {kind for kind, _ in core._graphs.buckets}
            assert kinds == {"prefill", "forward", "loop", "mixed"}
            assert core.metrics["graph_captures"] == len(core._graphs.buckets)
            assert core.metrics["graph_replays"] > 0
    assert outs[True] == outs[False] == want


def test_lora_adapter_on_mixtral_matches_jax(weights):
    """An attention-target adapter (wq, wk, wv, wo) on ``mixtral-test``:
    base and adapter rows in one batch as the JAX engine serves them."""
    rng = np.random.default_rng(9)
    rank, targets = 4, ("wq", "wk", "wv", "wo")
    hd = CFG.n_heads * CFG.head_dim
    ins = {"wq": CFG.dim, "wk": CFG.dim, "wv": CFG.dim, "wo": hd}
    outs = {"wq": hd, "wk": CFG.n_kv_heads * CFG.head_dim,
            "wv": CFG.n_kv_heads * CFG.head_dim, "wo": CFG.dim}
    jreg = JLoraRegistry(JCFG, rank=rank, targets=targets, dtype=jnp.float32)
    jreg.register("sre", {t: {"A": rng.normal(size=(CFG.n_layers, ins[t], rank)) * 0.3,
                              "B": rng.normal(size=(CFG.n_layers, rank, outs[t])) * 0.3}
                          for t in targets})
    kw = dict(ENGINE, speculative=False, decode_steps_per_dispatch=2)
    jcore = JEngineCore(JCFG, weights[0], JByteTokenizer(),
                        JEngineConfig(block_pages=4, kv_dtype=jnp.float32, **kw),
                        lora_registry=jreg)
    tcore = EngineCore(CFG, weights[1], TOK, EngineConfig(kv_dtype=torch.float32, **kw),
                       lora_registry=lora_registry_from_jax(jreg, CFG, device="cpu",
                                                            dtype=torch.float32))
    prompts, adapters = [PROMPTS[1]] * 2, [None, "sre"]
    want = _serve(jcore, JRequest, JSampling, prompts, 8, adapters)
    got = _serve(tcore, EngineRequest, SamplingParams, prompts, 8, adapters)
    assert got == want and got[0] != got[1]


async def test_client_chats_in_mistral_format(weights):
    """``TorchCudaClient.for_testing("mixtral-test")`` (``[INST]`` prompts)
    on JAX's params replies as ``JaxTpuClient.for_testing`` does."""
    jclient = JaxTpuClient.for_testing(NAME)
    tclient = TorchCudaClient.for_testing(
        NAME, params=params_from_jax(jax.tree.map(np.asarray, jclient.core.params),
                                     device="cpu"), device="cpu")
    try:
        assert tclient.chat_format == jclient.chat_format == "mistral"
        want = await jclient.chat("You are terse.", "hello")
        got = await tclient.chat("You are terse.", "hello")
        assert got.content == want.content and got.usage["completion_tokens"] > 0
        assert got.usage["completion_tokens"] == want.usage["completion_tokens"]
    finally:
        await jclient.shutdown()
        await tclient.shutdown()
    random = TorchCudaClient.for_testing(NAME, device="cpu")
    try:
        assert (await random.chat("You are terse.", "hello")).usage["completion_tokens"] > 0
    finally:
        await random.shutdown()


# -------------------------------------------------------------- memory plan


def _meta_bytes(cfg, weights):
    init = tllama.init_params_quantized if weights == "int8" else tllama.init_params
    return tquant.weight_bytes(init(cfg, dtype=torch.bfloat16, device="meta"))


@pytest.mark.parametrize("weights_kind", ["bf16", "int8"])
@pytest.mark.parametrize("model", ["mixtral-test", "mixtral-8x7b-instruct"])
def test_plan_counts_every_expert(model, weights_kind):
    """The plan's weight bytes equal the tree's (``weight_bytes``; the 8x7B
    in closed form, on the meta device), where JAX's plan counts only the
    top_k active experts and offers the rest to the pool."""
    cfg = tllama.CONFIGS[model]
    kw = dict(max_seq_len=8192, hbm_bytes=80 * 10**9, weights=weights_kind)
    plan = plan_serving(cfg, **kw)
    assert plan.weight_bytes_per_chip == _meta_bytes(cfg, weights_kind)
    jplan = jplan_serving(jllama.CONFIGS[model], **kw)
    assert jplan.weight_bytes_per_chip < plan.weight_bytes_per_chip
    if model == "mixtral-8x7b-instruct" and weights_kind == "int8":
        assert 46.5e9 < plan.weight_bytes_per_chip < 47.5e9
        assert jplan.weight_bytes_per_chip < 14e9  # the JAX plan's undercount


@pytest.mark.parametrize("model", ["llama3-8b-instruct", "llama3-test", "qwen2-test",
                                   "llama3.2-1b-instruct"])
def test_plan_keeps_dense_numbers(model):
    """Dense models: every field of the plan as before (JAX's), int8 scales
    counted as the tree holds them (``test_torch_serve_obs.py``)."""
    for weights_kind, tp in (("bf16", 1), ("int8", 1), ("int8", 4)):
        kw = dict(max_seq_len=8192, hbm_bytes=16 * GiB, weights=weights_kind, tp=tp)
        got = dataclasses.asdict(plan_serving(tllama.CONFIGS[model], **kw))
        want = dataclasses.asdict(jax_plan_with_exact_scales(
            jplan_serving(jllama.CONFIGS[model], **kw), tllama.CONFIGS[model], tp,
            weights_kind))
        assert got == {k: v for k, v in want.items() if k != "host_spill_bytes"}
