"""Multi-LoRA serving of the PyTorch port against the JAX package, on the CPU
(float32), after ``tests/test_lora.py``.

Both packages serve ``llama3-test`` with the JAX package's params and the
same adapters: a JAX ``LoraRegistry`` carried across by
``models/convert.py::lora_registry_from_jax`` (names, rows and float32 host
arrays). Tolerances: 1e-5 on ``apply_lora`` and on logits, equality on
greedy tokens. The adapters target all four projections, so the wo delta
(added once on a tensor-parallel mesh) is exercised too.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from runbookai_tpu.engine.engine import EngineConfig as JEngineConfig
from runbookai_tpu.engine.engine import EngineCore as JEngineCore
from runbookai_tpu.engine.request import EngineRequest as JRequest
from runbookai_tpu.engine.request import SamplingParams as JSampling
from runbookai_tpu.model.jax_tpu import JaxTpuClient
from runbookai_tpu.models import llama as jllama
from runbookai_tpu.models.lora import LoraRegistry as JLoraRegistry
from runbookai_tpu.models.lora import apply_lora as japply_lora
from runbookai_tpu.server.openai_api import OpenAIServer as JOpenAIServer
from runbookai_tpu.utils.tokens import ByteTokenizer as JByteTokenizer
from runbookai_tpu_torch import __main__ as cli
from runbookai_tpu_torch.engine.engine import EngineConfig, EngineCore
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models.convert import lora_registry_from_jax, params_from_jax
from runbookai_tpu_torch.models.lora import LoraRegistry, apply_lora
from runbookai_tpu_torch.parallel.mesh import build_mesh
from runbookai_tpu_torch.parallel.sharding import shard_params
from runbookai_tpu_torch.server.openai_api import OpenAIServer
from runbookai_tpu_torch.utils.config import load_config
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

NAME = "llama3-test"
JCFG = jllama.CONFIGS[NAME]
CFG = tllama.CONFIGS[NAME]
RANK = 4
TARGETS = ("wq", "wk", "wv", "wo")
TOL = dict(rtol=1e-5, atol=1e-5)
ENGINE = dict(page_size=4, num_pages=128, max_batch_slots=4, prefill_chunk=16,
              max_seq_len=128, speculative=False, decode_steps_per_dispatch=2)
TIMEOUT = 30  # every HTTP request's, in seconds
TOK = ByteTokenizer()
ADAPTERS = (None, "adapter0", "adapter1")  # one request each, base first
PROMPT = "status of payment-api?"


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _rand_adapter(seed: int, targets=TARGETS) -> dict:
    rng = np.random.default_rng(seed)
    ins = {"wq": CFG.dim, "wk": CFG.dim, "wv": CFG.dim, "wo": CFG.n_heads * CFG.head_dim}
    outs = {"wq": CFG.n_heads * CFG.head_dim, "wk": CFG.n_kv_heads * CFG.head_dim,
            "wv": CFG.n_kv_heads * CFG.head_dim, "wo": CFG.dim}
    return {t: {"A": rng.normal(size=(CFG.n_layers, ins[t], RANK)) * 0.3,
                "B": rng.normal(size=(CFG.n_layers, RANK, outs[t])) * 0.3} for t in targets}


def _jregistry(n: int = 2) -> JLoraRegistry:
    reg = JLoraRegistry(JCFG, rank=RANK, targets=TARGETS, dtype=jnp.float32)
    for i in range(n):
        reg.register(f"adapter{i}", _rand_adapter(100 + i))
    return reg


def _tregistry(jreg: JLoraRegistry) -> LoraRegistry:
    return lora_registry_from_jax(jreg, CFG, device="cpu", dtype=torch.float32)


def _jcore(jparams, reg, **kw):
    return JEngineCore(JCFG, jparams, JByteTokenizer(), JEngineConfig(
        block_pages=8, kv_dtype=jnp.float32, **{**ENGINE, **kw}), lora_registry=reg)


def _tcore(tparams, reg, mesh=None, **kw):
    return EngineCore(CFG, tparams, TOK, EngineConfig(kv_dtype=torch.float32,
                                                      **{**ENGINE, **kw}),
                      mesh=mesh, lora_registry=reg)


def _greedy(core, req_cls, sampling_cls, adapters, prompt=PROMPT, n=8, stagger=False):
    """Greedy streams of one request per entry of ``adapters`` on ``core``,
    submitted together or, with ``stagger``, the others once the first has
    its first token (its decode then meets their prefill: mixed steps with
    mixed dispatch on)."""
    reqs = [req_cls(prompt_ids=TOK.encode(prompt),
                    sampling=sampling_cls(max_new_tokens=n, stop_token_ids=()), adapter=a)
            for a in adapters]
    core.submit(reqs[0])
    while stagger and not reqs[0].out_ids:
        core.step()
    for r in reqs[1:]:
        core.submit(r)
    core.run_until_idle()
    return [r.out_ids for r in reqs]


# ------------------------------------------------------------- apply_lora


@pytest.mark.parametrize("leaf", ["wq", "wo"])
def test_apply_lora_matches_jax(leaf):
    rng = np.random.default_rng(5)
    d_in = CFG.n_heads * CFG.head_dim if leaf == "wo" else CFG.dim
    x = rng.normal(size=(3, 5, d_in)).astype(np.float32)
    a = (rng.normal(size=(3, d_in, RANK)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(3, RANK, CFG.dim)) * 0.3).astype(np.float32)
    ids = np.array([2, 0, 1], np.int64)
    want = japply_lora(jnp.asarray(x), {leaf: {"A": jnp.asarray(a), "B": jnp.asarray(b)}},
                       leaf, jnp.asarray(ids, jnp.int32))
    got = apply_lora(torch.from_numpy(x), {leaf: {"A": torch.from_numpy(a),
                                                  "B": torch.from_numpy(b)}},
                     leaf, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[1].numpy(), x[1] @ a[0] @ b[0], **TOL)


# ----------------------------------------------------------------- forward


def _inputs(kind: str):
    """Four rows at adapters (0, 1, 2, 1): a prefill chunk (T = 5, one row
    with a pad tail), or a decode step over what that prefill wrote, or the
    same tokens in the ragged layout (one 8-token block a row)."""
    ps, rq = 4, 8
    tables = np.zeros((4, 9), np.int32)
    for i in range(4):
        tables[i, :2] = [1 + 2 * i, 2 + 2 * i]
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, CFG.vocab_size, size=(4, 5)).astype(np.int32)
    pos = np.tile(np.arange(5, dtype=np.int32), (4, 1))
    ctx = np.array([5, 5, 5, 3], np.int32)
    pos[3, 3:] = 8 * ps  # the pad tail goes to the trash column
    ids = np.array([0, 1, 2, 1], np.int32)
    if kind == "decode":
        return tokens[:, :1], np.array([[5], [5], [5], [3]], np.int32), tables, ctx + 1, ids
    if kind == "ragged":
        flat_tok = np.zeros((4 * rq,), np.int32)
        flat_pos = np.full((4 * rq,), 8 * ps, np.int32)
        for i in range(4):
            flat_tok[i * rq: i * rq + ctx[i]] = tokens[i, :ctx[i]]
            flat_pos[i * rq: i * rq + ctx[i]] = np.arange(ctx[i])
        return flat_tok, flat_pos, tables, ctx, ids
    return tokens, pos, tables, ctx, ids


@pytest.mark.parametrize("kind", ["prefill", "decode", "ragged"])
def test_forward_logits_match_jax(weights, kind):
    """``forward_impl`` (prefill, decode after it) and ``forward_ragged_impl``
    with adapters against JAX's on the same pools, within 1e-5."""
    jparams, tparams = weights
    jreg = _jregistry()
    jp = {**jparams, "lora": jreg.stacked()}
    # The JAX params with their stacked tree, carried across as numpy; the
    # registry carried across stacks the same tree.
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for leaf, ab in _tregistry(jreg).stacked().items():
        for name, w in ab.items():
            torch.testing.assert_close(w, tp["lora"][leaf][name], rtol=0, atol=0)
    shape = (CFG.n_layers, 16 * 4, CFG.n_kv_heads, CFG.head_dim)
    pool = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jk = jv = jnp.asarray(pool)
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    if kind == "decode":  # the prefill's K/V first, in both pools
        tok, pos, tables, ctx, ids = _inputs("prefill")
        _, jk, jv = jllama.forward(jp, JCFG, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
                                   jnp.asarray(tables), jnp.asarray(ctx), page_size=4,
                                   adapter_ids=jnp.asarray(ids))
        tllama.forward_impl(tp, CFG, torch.from_numpy(tok).long(), torch.from_numpy(pos),
                            tk, tv, torch.from_numpy(tables), torch.from_numpy(ctx), 4,
                            adapter_ids=torch.from_numpy(ids).long())
    tok, pos, tables, ctx, ids = _inputs(kind)
    if kind == "ragged":
        rows = np.repeat(np.arange(4, dtype=np.int32), 8)
        sel = np.array([i * 8 + c - 1 for i, c in enumerate(ctx)], np.int32)
        want, _, _ = jllama.forward_ragged_impl(
            jp, JCFG, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(rows), jk, jv,
            jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(sel), page_size=4,
            adapter_ids=jnp.asarray(ids), ragged_block=8)
        got = tllama.forward_ragged_impl(
            tp, CFG, torch.from_numpy(tok).long(), torch.from_numpy(pos),
            torch.from_numpy(rows), tk, tv, torch.from_numpy(tables), torch.from_numpy(ctx),
            torch.from_numpy(sel).long(), 4, adapter_ids=torch.from_numpy(ids).long())
    else:
        want, _, _ = jllama.forward(jp, JCFG, jnp.asarray(tok), jnp.asarray(pos), jk, jv,
                                    jnp.asarray(tables), jnp.asarray(ctx), page_size=4,
                                    adapter_ids=jnp.asarray(ids))
        got = tllama.forward_impl(tp, CFG, torch.from_numpy(tok).long(),
                                  torch.from_numpy(pos), tk, tv, torch.from_numpy(tables),
                                  torch.from_numpy(ctx), 4,
                                  adapter_ids=torch.from_numpy(ids).long())
        if kind == "prefill":  # the pad tail's logits are discarded by every caller
            want, got = np.asarray(want)[:, :3], got[:, :3]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if kind == "prefill":
        # Without ids every row takes the zero adapter: the base logits exactly.
        args = (torch.from_numpy(tok).long(), torch.from_numpy(pos))
        rest = (torch.from_numpy(tables), torch.from_numpy(ctx), 4)
        base = tllama.forward_impl(tparams, CFG, *args, torch.from_numpy(pool.copy()),
                                   torch.from_numpy(pool.copy()), *rest)
        zero = tllama.forward_impl(tp, CFG, *args, torch.from_numpy(pool.copy()),
                                   torch.from_numpy(pool.copy()), *rest)
        torch.testing.assert_close(zero, base, rtol=0, atol=0)


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's greedy streams: each adapter solo on a fresh engine,
    the three batched (one step apart) on the split path and with mixed
    dispatch."""
    jparams, _ = weights
    jreg = _jregistry()
    solo = [_greedy(_jcore(jparams, jreg), JRequest, JSampling, [a])[0] for a in ADAPTERS]
    batch = _greedy(_jcore(jparams, jreg), JRequest, JSampling, ADAPTERS, stagger=True)
    mixed = _greedy(_jcore(jparams, jreg, mixed_dispatch=True), JRequest, JSampling, ADAPTERS,
                    stagger=True)
    return {"solo": solo, "batch": batch, "batch_mixed": mixed, "registry": jreg}


ENGINE_MODES = {
    "eager": dict(),
    "graphs": dict(step_graphs=True),
    "mixed": dict(mixed_dispatch=True),
    "mixed_graphs": dict(mixed_dispatch=True, step_graphs=True),
    "tp2": dict(),
    "page_split": dict(),
}
MESHES = {"tp2": (2, 1), "page_split": (2, 2)}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_batched_streams_match_jax_engine(weights, jax_streams, mode):
    """Base and two adapters in one batch (one step apart), on one engine,
    with step graphs emulated, with mixed dispatch, on a model=2 head-shard
    mesh and on a model=2 x seq=2 page split: each row's greedy stream
    equals the JAX engine's in the same batch and its solo stream (no
    leakage through the gather)."""
    _, tparams = weights
    treg = _tregistry(jax_streams["registry"])
    mesh = None
    if mode in MESHES:
        mesh = build_mesh(*MESHES[mode], ["cpu"] * (MESHES[mode][0] * MESHES[mode][1]))
        tparams = shard_params({**tparams, "layers": dict(tparams["layers"])}, CFG, mesh)
    core = _tcore(tparams, treg, mesh=mesh, **ENGINE_MODES[mode])
    got = _greedy(core, EngineRequest, SamplingParams, ADAPTERS, stagger=True)
    want = jax_streams["batch_mixed" if "mixed" in mode else "batch"]
    assert got == want
    assert got == jax_streams["solo"]
    assert len({tuple(s) for s in got}) == 3  # every adapter changes the stream
    if "mixed" in mode:
        assert core.metrics["mixed_steps"] > 0
    if "graphs" in mode:
        assert core.metrics["graph_replays"] > 0


def test_solo_streams_match_jax_and_zero_adapter_is_base(weights, jax_streams):
    _, tparams = weights
    treg = _tregistry(jax_streams["registry"])
    for adapter, want in zip(ADAPTERS, jax_streams["solo"]):
        assert _greedy(_tcore(tparams, treg), EngineRequest, SamplingParams,
                       [adapter])[0] == want
    # The zero adapter at index 0 is exactly the engine without a registry.
    assert _greedy(_tcore(tparams, None), EngineRequest, SamplingParams,
                   [None])[0] == jax_streams["solo"][0]


def test_unknown_adapter_rejected(weights, jax_streams):
    _, tparams = weights
    core = _tcore(tparams, _tregistry(jax_streams["registry"]))
    with pytest.raises(KeyError, match="nope"):
        core.submit(EngineRequest(prompt_ids=TOK.encode("x"), adapter="nope"))
    with pytest.raises(ValueError, match="no LoRA registry"):
        _tcore(tparams, None).submit(EngineRequest(prompt_ids=TOK.encode("x"),
                                                   adapter="adapter0"))


def test_register_is_atomic_on_validation_failure():
    reg = LoraRegistry(CFG, rank=RANK, targets=TARGETS, dtype=torch.float32, device="cpu")
    reg.register("adapter0", _rand_adapter(1))
    rows_before = {t: len(reg._host[t]["A"]) for t in reg.targets}
    bad = _rand_adapter(7)
    bad["wv"]["B"] = bad["wv"]["B"][:, :, :-1]  # wq, wk valid, wv invalid
    with pytest.raises(ValueError):
        reg.register("broken", bad)
    assert {t: len(reg._host[t]["A"]) for t in reg.targets} == rows_before
    assert "broken" not in reg.names
    reg.register("adapterX", _rand_adapter(8))
    assert len({len(reg._host[t]["A"]) for t in reg.targets}) == 1
    assert reg.stacked()["wo"]["A"].shape == (CFG.n_layers, 3, CFG.n_heads * CFG.head_dim,
                                              RANK)


def _write_peft(path, seed: int, modules=("q_proj", "v_proj"), alpha: float = 8.0,
                layers=None) -> dict:
    """An HF PEFT directory written with ``safetensors.numpy``; its tensors."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    outs = {"q_proj": CFG.n_heads * CFG.head_dim, "k_proj": CFG.n_kv_heads * CFG.head_dim,
            "v_proj": CFG.n_kv_heads * CFG.head_dim, "o_proj": CFG.dim}
    tensors = {}
    for i in range(CFG.n_layers if layers is None else layers):
        for proj in modules:
            base = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            d_in = CFG.n_heads * CFG.head_dim if proj == "o_proj" else CFG.dim
            tensors[f"{base}.lora_A.weight"] = rng.normal(size=(RANK, d_in)).astype(np.float32)
            tensors[f"{base}.lora_B.weight"] = rng.normal(size=(outs[proj], RANK)).astype(
                np.float32)
    path.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": RANK, "lora_alpha": alpha, "target_modules": list(modules)}))
    return tensors


def test_peft_dir_loading(tmp_path, weights):
    """A PEFT directory loads to JAX's arrays (``alpha / r`` folded into B),
    serves JAX's greedy stream, and uncovered modules or partial layer
    coverage are refused."""
    jparams, tparams = weights
    tensors = _write_peft(tmp_path / "sre", 7)
    jreg = JLoraRegistry(JCFG, rank=RANK, targets=("wq", "wv"), dtype=jnp.float32)
    treg = LoraRegistry(CFG, rank=RANK, targets=("wq", "wv"), dtype=torch.float32,
                        device="cpu")
    assert treg.load_peft_dir("sre", tmp_path / "sre") == jreg.load_peft_dir(
        "sre", tmp_path / "sre") == 1
    b0 = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight"]
    np.testing.assert_allclose(treg.stacked()["wq"]["B"][0, 1].numpy(), b0.T * 2.0, atol=1e-6)
    for t in ("wq", "wv"):
        for ab in ("A", "B"):
            np.testing.assert_array_equal(treg.stacked()[t][ab].numpy(),
                                          np.asarray(jreg.stacked()[t][ab]))
    want = _greedy(_jcore(jparams, jreg), JRequest, JSampling, ["sre"], prompt="hello")
    got = _greedy(_tcore(tparams, treg), EngineRequest, SamplingParams, ["sre"],
                  prompt="hello")
    assert got == want
    _write_peft(tmp_path / "o", 8, modules=("o_proj",))
    with pytest.raises(ValueError, match="not covered"):
        treg.load_peft_dir("o", tmp_path / "o")
    _write_peft(tmp_path / "half", 9, layers=1)
    with pytest.raises(ValueError, match="covers 1 of 2 layers"):
        treg.load_peft_dir("half", tmp_path / "half")


def test_prefix_cache_is_adapter_namespaced(weights, jax_streams):
    """An adapter request publishes its prompt pages; a base request with the
    same prompt right after must not ride them, and the adapter's own second
    request does."""
    _, tparams = weights
    treg = _tregistry(jax_streams["registry"])
    prompt = "the same shared system prompt used by everyone!"
    clean_base = _greedy(_tcore(tparams, treg), EngineRequest, SamplingParams, [None],
                         prompt=prompt)[0]
    core = _tcore(tparams, treg)
    tuned = _greedy(core, EngineRequest, SamplingParams, ["adapter0"], prompt=prompt)[0]
    assert _greedy(core, EngineRequest, SamplingParams, [None], prompt=prompt)[0] == clean_base
    assert tuned != clean_base
    cached = core.metrics["cached_prefix_tokens"]
    assert _greedy(core, EngineRequest, SamplingParams, ["adapter0"],
                   prompt=prompt)[0] == tuned
    assert core.metrics["cached_prefix_tokens"] > cached  # reuse within the namespace


def test_hot_load_recaptures_and_serves(weights, jax_streams):
    """With step graphs (emulated), an adapter registered while serving adds
    a row: the next step drains the window, frees the graphs and captures
    them again (``graph_captures``), and the next dispatch serves the new
    adapter as an engine that knew it from the start. A graph left over the
    old tree would read freed storage: its body raises. An update of the
    same shapes keeps the graphs and serves the new weights."""
    jparams, tparams = weights
    jreg = _jregistry(1)
    treg = _tregistry(jreg)
    core = _tcore(tparams, treg, step_graphs=True)
    before = _greedy(core, EngineRequest, SamplingParams, ["adapter0"])[0]
    captures = core.metrics["graph_captures"]
    stale = core._graphs[("forward", 1)]
    stale_body, stale_inputs = stale.body, dict(stale.inputs)
    treg.register("late", _rand_adapter(777))
    jreg.register("late", _rand_adapter(777))
    late = _greedy(core, EngineRequest, SamplingParams, ["late"])[0]
    assert core.metrics["graph_captures"] == 2 * captures
    assert late == _greedy(_jcore(jparams, jreg), JRequest, JSampling, ["late"])[0]
    assert late != before
    assert _greedy(core, EngineRequest, SamplingParams, ["adapter0"])[0] == before
    with pytest.raises(RuntimeError):
        stale_body(**stale_inputs)
    # Same shapes: copied into the storage the graphs read. (A new prompt:
    # pages cached under the adapter's row hold K/V of its old weights, in
    # both packages.)
    new = _rand_adapter(778)
    treg.update_adapter("late", new)
    jreg.update_adapter("late", new)
    core.refresh_lora()
    assert core.metrics["graph_captures"] == 2 * captures
    prompt = "after the update"
    assert _greedy(core, EngineRequest, SamplingParams, ["late"], prompt=prompt)[0] == _greedy(
        _jcore(jparams, jreg), JRequest, JSampling, ["late"], prompt=prompt)[0]


# -------------------------------------------------------------------- HTTP


def _request(srv, path, payload=None):
    """(status, JSON body) of one request."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", headers={"Content-Type": "application/json"},
        data=None if payload is None else json.dumps(payload).encode(),
        method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _strip(body):
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in ("id", "created")}
    if isinstance(body, list):
        return [_strip(v) for v in body]
    return body


def _chat(model=None):
    body = {"max_tokens": 8, "messages": [{"role": "user", "content": "hi"}]}
    return body if model is None else {**body, "model": model}


@pytest.fixture
def servers(weights):
    """JAX's server over ``JaxTpuClient.for_testing`` with one adapter and the
    port's over the same params and adapter, both allowing runtime loads."""
    _, tparams = weights
    jreg = _jregistry(1)
    treg = _tregistry(jreg)
    jsrv = JOpenAIServer(JaxTpuClient.for_testing(NAME, max_new_tokens=8, lora_registry=jreg),
                         model_name=NAME, port=0, allow_runtime_adapters=True)
    tsrv = OpenAIServer(TorchCudaClient.for_testing(NAME, params=tparams, device="cpu",
                                                    max_new_tokens=8, lora_registry=treg),
                        model_name=NAME, port=0, allow_runtime_adapters=True)
    for srv in (jsrv, tsrv):
        srv.start_background()
    try:
        yield jsrv, tsrv
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_http_adapter_routing_and_hot_load_match_jax(servers, tmp_path):
    """Adapter-as-model routing, ``/v1/models`` rows, an unknown name's 404,
    the hot load (and a bad path's 400 without the path), then the loaded
    adapter serving by name: every status and body equal to the JAX
    server's apart from ``id`` and ``created``."""
    _write_peft(tmp_path / "hot", 9, modules=("q_proj",), alpha=RANK)
    steps = [("/v1/models", None), ("/v1/chat/completions", _chat()),
             ("/v1/chat/completions", _chat("adapter0")), ("/v1/chat/completions", _chat("hot")),
             ("/v1/adapters", {"name": "hot", "path": str(tmp_path / "hot")}),
             ("/v1/adapters", {"name": "x", "path": "/nonexistent"}),
             ("/v1/adapters", {"name": 3}),
             ("/v1/chat/completions", _chat("hot")), ("/v1/models", None)]
    results = []
    for path, payload in steps:
        want, got = (_request(srv, path, payload) for srv in servers)
        assert (got[0], _strip(got[1])) == (want[0], _strip(want[1])), path
        results.append(got)
    assert [r[0] for r in results] == [200, 200, 200, 404, 200, 400, 400, 200, 200]
    assert "/nonexistent" not in json.dumps(results[5][1])
    assert results[4][1] == {"loaded": "hot", "adapters": ["adapter0", "hot"]}
    assert [m["id"] for m in results[8][1]["data"]] == [NAME, "adapter0", "hot"]
    assert {m.get("parent") for m in results[8][1]["data"][1:]} == {NAME}
    texts = [r[1]["choices"][0]["message"]["content"] for r in (results[1], results[2],
                                                                 results[7])]
    assert len(set(texts)) == 3  # each adapter applied
    core = servers[1].client.core
    assert core.lora.names == ["adapter0", "hot"] and core._lora_rows() == 3


def test_adapter_loading_gated_by_default(weights):
    """403 without ``allow_runtime_adapters``; 400 with it but no registry:
    the JAX server's statuses and bodies."""
    _, tparams = weights
    payload = {"name": "x", "path": "/tmp"}
    for allow, reg in ((False, _jregistry(0)), (True, None)):
        jsrv = JOpenAIServer(JaxTpuClient.for_testing(NAME, max_new_tokens=4,
                                                      lora_registry=reg),
                             model_name=NAME, port=0, allow_runtime_adapters=allow)
        tsrv = OpenAIServer(TorchCudaClient.for_testing(
            NAME, params=tparams, device="cpu", max_new_tokens=4,
            lora_registry=None if reg is None else _tregistry(reg)),
            model_name=NAME, port=0, allow_runtime_adapters=allow)
        for srv in (jsrv, tsrv):
            srv.start_background()
        try:
            want, got = (_request(srv, "/v1/adapters", payload) for srv in (jsrv, tsrv))
        finally:
            jsrv.shutdown()
            tsrv.shutdown()
        assert got == want and got[0] == (400 if allow else 403)


def test_serve_flag_reaches_the_server(tmp_path):
    """``build_server`` (the ``serve`` command's construction) from
    ``llm.lora_adapters``: the adapter serves by name, and ``POST
    /v1/adapters`` answers 403 unless ``allow_adapter_loading`` (``serve
    --allow-adapter-loading``), then hot-loads."""
    _write_peft(tmp_path / "a", 11)
    _write_peft(tmp_path / "b", 12)
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({"llm": {
        "provider": "jax-tpu", "model": NAME, "dtype": "float32", "max_new_tokens": 4,
        "lora_rank": RANK, "lora_adapters": {"a": str(tmp_path / "a")}}}))
    for allow in (False, True):
        server, _ = cli.build_server(load_config(path=str(config)), port=0, device="cpu",
                                     allow_adapter_loading=allow)
        server.start_background()
        try:
            assert _request(server, "/v1/chat/completions", _chat("a"))[0] == 200
            status, body = _request(server, "/v1/adapters",
                                    {"name": "b", "path": str(tmp_path / "b")})
            assert status == (200 if allow else 403), body
            if allow:
                assert _request(server, "/v1/chat/completions", _chat("b"))[0] == 200
        finally:
            server.shutdown()
