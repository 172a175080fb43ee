"""The int8 serving path of the PyTorch port against the JAX package, on the
CPU: int8 KV pools (values + one float32 absmax scale per (token, kv head))
and int8 layer weights.

Inputs are made with numpy from a seed and fed to both. The attention
kernels run only on the card; here the plain versions that their wrappers
compute for CPU tensors are held against the Pallas int8 decode kernel in
interpret mode on every row, and against the XLA gather path
``ops/attention.paged_attention`` on the rows where both are defined alike
(ctx >= 1, real query tokens), at 2e-5 in float32. The forward and the
engine are held against the JAX ones with ``attn_impl="pallas"`` and
``qmm_impl="pallas"`` (the Pallas kernels in interpret mode), in float32.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.engine import engine as jengine
from runbookai_tpu.engine.kv_cache import PagePool as JPagePool
from runbookai_tpu.engine.request import EngineRequest as JRequest
from runbookai_tpu.engine.request import SamplingParams as JSampling
from runbookai_tpu.models import llama as jllama
from runbookai_tpu.models import quant as jquant
from runbookai_tpu.ops import attention as jattn
from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu.utils.tokens import ByteTokenizer as JByteTokenizer
from runbookai_tpu_torch.engine import engine as tengine
from runbookai_tpu_torch.engine.kv_cache import PagePool
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models.convert import params_from_jax
from runbookai_tpu_torch.ops import attention as tattn
from runbookai_tpu_torch.ops import paged_attention as tpa
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

from test_torch_engine import BASE, SCENARIOS, _run
from test_torch_model import MAX_SEQ, _np_params, _paged_inputs

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)  # test_pallas_kernel.py:41
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
PS, N_KV, HD, NUM_PAGES = 4, 2, 32, 48
MAX_PAGES = 8  # + 1 trash column


def _t(x):
    return torch.from_numpy(np.array(x))


def _tables(rng, ctx_lens):
    """Distinct pages per sequence; entries past ctx point at random live
    pages (garbage the kernels must not attend); trash column = null page."""
    tables = np.zeros((len(ctx_lens), MAX_PAGES + 1), np.int32)
    perm = rng.permutation(np.arange(1, NUM_PAGES))
    nxt = 0
    for i, ctx in enumerate(ctx_lens):
        need = -(-ctx // PS)
        tables[i, :need] = perm[nxt:nxt + need]
        nxt += need
        tables[i, need:MAX_PAGES] = rng.integers(1, NUM_PAGES, MAX_PAGES - need)
    return tables


def _int8_pools(rng):
    """The same quantized K and V pools for both frameworks: (jax, torch)."""
    out = []
    for _ in range(2):
        raw = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
        vals, scales = jattn.quantize_kv(jnp.asarray(raw))
        out.append(((vals, scales), (_t(vals), _t(scales))))
    return out


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, N_KV, HD)).astype(np.float32) * 4
    x[0, 0, 0] = 0.0  # an all-zero vector: the 1e-8 clamp before the division
    want_q, want_s = jattn.quantize_kv(jnp.asarray(x))
    got_q, got_s = tattn.quantize_kv(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_write_kv_pages_batch_int8_matches_jax():
    rng = np.random.default_rng(2)
    vals = rng.integers(-127, 128, size=(NUM_PAGES * PS, N_KV, HD)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(NUM_PAGES * PS, N_KV)).astype(np.float32)
    new = rng.normal(size=(2, 6, N_KV, HD)).astype(np.float32)
    tables = _tables(rng, [7, 10])
    trash = MAX_PAGES * PS
    # Row 0 writes positions 3..8; row 1 writes 2 real tokens then a pad
    # tail at the trash position (-> trash column -> null page 0).
    pos = np.array([np.arange(3, 9), [8, 9, trash, trash, trash, trash]], np.int32)
    want = jattn.write_kv_pages_batch(
        (jnp.asarray(vals), jnp.asarray(scales)), jnp.asarray(new), jnp.asarray(pos),
        jnp.asarray(tables), PS)
    pool = (_t(vals), _t(scales))
    out = tattn.write_kv_pages_batch(pool, _t(new), _t(pos), _t(tables), PS)
    assert out[0] is pool[0] and out[1] is pool[1]  # in place
    # Page 0 takes the duplicate pad writes (never read); the rest is exact.
    for got, w, before in zip(pool, want, (vals, scales)):
        np.testing.assert_array_equal(got.numpy()[PS:], np.asarray(w)[PS:])
        assert not np.array_equal(got.numpy()[PS:], before[PS:])
    # The pad tail's values landed on the null page, through the trash column.
    assert not np.array_equal(pool[1].numpy()[:PS], scales[:PS])


@pytest.mark.parametrize("group", [1, 4, 8])
def test_plain_int8_decode_matches_pallas_and_xla(group):
    rng = np.random.default_rng(10 + group)
    ctx = [0, 1, 5, 32]
    (jk, tk), (jv, tv) = _int8_pools(rng)
    tables = _tables(rng, ctx)
    q = rng.normal(size=(len(ctx), N_KV * group, HD)).astype(np.float32)
    ctx_np = np.asarray(ctx, np.int32)
    got = tpa.paged_decode_attention(_t(q), tk, tv, _t(tables), _t(ctx_np), PS).numpy()
    pallas = np.asarray(jpallas.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx_np),
        page_size=PS, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    assert np.all(got[0] == 0.0)  # ctx 0 -> zeros, as the Pallas kernel
    xla = np.asarray(jattn.paged_attention(
        jnp.asarray(q[:, None]), jk, jv, jnp.asarray(tables), jnp.asarray(ctx_np),
        jnp.asarray(np.maximum(ctx_np - 1, 0)[:, None]), page_size=PS,
        block_pages=2))[:, 0]
    live = ctx_np >= 1
    np.testing.assert_allclose(got[live], xla[live], **TOL)


@pytest.mark.parametrize("group", [1, 4, 8])
def test_plain_int8_chunk_matches_xla(group):
    """T > 1 over an int8 pool: JAX serves these calls on its XLA gather
    path, the port on the chunk kernel; they agree on every row a caller
    keeps."""
    rng = np.random.default_rng(20 + group)
    t = 6
    trash = MAX_PAGES * PS
    starts = [0, 9, 20, 12, trash]
    real = [6, 6, 6, 2, 0]
    ctx = [6, 15, 26, 14, 1]
    (jk, tk), (jv, tv) = _int8_pools(rng)
    tables = _tables(rng, ctx)
    tables[4] = 0
    pos = np.full((5, t), trash, np.int32)
    for i, (s, n) in enumerate(zip(starts, real)):
        pos[i, :n] = np.arange(s, s + n)
    q = rng.normal(size=(5, t, N_KV * group, HD)).astype(np.float32)
    ctx_np = np.asarray(ctx, np.int32)
    got = tpa.paged_chunk_attention(_t(q), tk, tv, _t(tables), _t(ctx_np), _t(pos),
                                    PS).numpy()
    xla = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx_np),
        jnp.asarray(pos), page_size=PS, block_pages=2))
    for i, n in enumerate(real):
        np.testing.assert_allclose(got[i, :n], xla[i, :n], **TOL)


def test_reference_paged_attention_int8_matches_xla():
    """The port's blockwise reference dequantizes on gather as the XLA path
    does, on every row, a fully masked one included."""
    rng = np.random.default_rng(30)
    ctx = [0, 3, 17]
    (jk, tk), (jv, tv) = _int8_pools(rng)
    tables = _tables(rng, ctx)
    q = rng.normal(size=(3, 2, 4, HD)).astype(np.float32)
    pos = np.array([[0, 0], [1, 2], [15, 16]], np.int32)
    ctx_np = np.asarray(ctx, np.int32)
    want = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx_np),
        jnp.asarray(pos), page_size=PS, block_pages=2))
    got = tattn.paged_attention(_t(q), tk, tv, _t(tables), _t(ctx_np), _t(pos), PS,
                                block_pages=2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_page_pool_layout_matches_jax():
    want = JPagePool.create(2, 8, 4, 2, 16, dtype=jnp.int8)
    got = PagePool.create(2, 8, 4, 2, 16, dtype=torch.int8, device="cpu")
    for t_pool, j_pool in ((got.kv_k, want.kv_k), (got.kv_v, want.kv_v)):
        assert [(tuple(x.shape), str(x.dtype).split(".")[1]) for x in t_pool] == \
            [(x.shape, x.dtype.name) for x in j_pool]


@pytest.mark.parametrize("name", [None, "", "auto", "bf16", "int8"])
def test_resolve_kv_dtype_matches_jax(name):
    want = jengine.resolve_kv_dtype(name, jnp.float32)
    got = tengine.resolve_kv_dtype(name, torch.float32)
    assert str(got).split(".")[1] == jnp.dtype(want).name


def test_resolve_kv_dtype_refuses_fp8_and_unknown_names():
    with pytest.raises(NotImplementedError, match="item 3"):
        tengine.resolve_kv_dtype("fp8", torch.bfloat16)
    with pytest.raises(ValueError):
        tengine.resolve_kv_dtype("int4", torch.bfloat16)


@pytest.mark.parametrize("name", ["llama3-test", "qwen2-test"])
def test_forward_int8_matches_jax_pallas(name):
    """int8 weights and an int8 pool: prefill (T = 8, with a pad tail) and
    decode (T = 1, with an empty slot) against JAX ``forward`` with the Pallas
    attention and qmm kernels in interpret mode."""
    cfg, np_params = _np_params(name)
    np_params = jax.tree.map(np.asarray, jquant.quantize_params(np_params))
    tparams = params_from_jax(np_params, device="cpu")
    tcfg = tllama.CONFIGS[name]
    rng = np.random.default_rng(1)
    jk = JPagePool.create(cfg.n_layers, 40, 4, cfg.n_kv_heads, cfg.head_dim,
                          dtype=jnp.int8).kv_k
    jv = jk
    tk = PagePool.create(cfg.n_layers, 40, 4, cfg.n_kv_heads, cfg.head_dim,
                         dtype=torch.int8, device="cpu")
    tk, tv = tk.kv_k, tk.kv_v
    run = dict(page_size=4, attn_impl="pallas", qmm_impl="pallas")

    t, ctx = 8, [8, 5]
    tables, pos = _paged_inputs(ctx, [0, 0], t)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, t)).astype(np.int32)
    jlog, jk, jv = jllama.forward(np_params, cfg, jnp.asarray(tokens), jnp.asarray(pos),
                                  jk, jv, jnp.asarray(tables), jnp.asarray(ctx, jnp.int32),
                                  **run)
    tlog = tllama.forward_impl(tparams, tcfg, torch.from_numpy(tokens).long(),
                               torch.from_numpy(pos), tk, tv, torch.from_numpy(tables),
                               torch.tensor(ctx, dtype=torch.int32), 4)
    for i, c in enumerate(ctx):
        np.testing.assert_allclose(tlog[i, :c].numpy(), np.asarray(jlog)[i, :c], **LOGIT_TOL)
    # The pools hold the same K/V outside the null page: scales to float32
    # rounding, values to within one step where a rounding boundary fell
    # between the two frameworks' float32 K/V.
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got[1].numpy()[:, 4:], np.asarray(want[1])[:, 4:],
                                   rtol=1e-5, atol=0)
        step = np.abs(got[0].numpy()[:, 4:].astype(np.int32)
                      - np.asarray(want[0])[:, 4:].astype(np.int32))
        assert step.max() <= 1 and step.mean() < 1e-3

    dtok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    dpos = np.array([[8], [5], [0]], np.int32)
    dctx = np.array([9, 6, 0], np.int32)
    dtables = np.zeros((3, MAX_SEQ // 4 + 1), np.int32)
    dtables[:2] = tables
    dtables[0, 2] = 30  # row 0 grows onto a fresh page
    jlog, _, _ = jllama.forward(np_params, cfg, jnp.asarray(dtok), jnp.asarray(dpos),
                                jk, jv, jnp.asarray(dtables), jnp.asarray(dctx), **run)
    tlog = tllama.forward_impl(tparams, tcfg, torch.from_numpy(dtok).long(),
                               torch.from_numpy(dpos), tk, tv, torch.from_numpy(dtables),
                               torch.from_numpy(dctx), 4)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


@pytest.fixture(scope="module")
def int8_weights():
    cfg = jllama.CONFIGS["llama3-test"]
    jparams = jquant.quantize_params(
        jllama.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_int8_greedy_streams_match_jax_engine(int8_weights, scenario):
    """int8 weights and an int8 pool in both engines, float32 activations:
    the greedy streams are identical, request for request."""
    spec = SCENARIOS[scenario]
    jparams, tparams = int8_weights
    kw = dict(BASE, **spec.get("cfg", {}))
    jcore = jengine.EngineCore(
        jllama.CONFIGS["llama3-test"], jparams, JByteTokenizer(),
        jengine.EngineConfig(block_pages=4, kv_dtype=jnp.int8, attn_impl="pallas",
                             qmm_impl="pallas", **kw))
    assert (jcore.ecfg.attn_impl, jcore.ecfg.qmm_impl) == ("pallas", "pallas")
    tcore = tengine.EngineCore(tllama.CONFIGS["llama3-test"], tparams, ByteTokenizer(),
                               tengine.EngineConfig(kv_dtype=torch.int8, **kw))
    assert isinstance(tcore.kv.pool.kv_k, tuple)
    want = _run(jcore, JRequest, JSampling, spec)
    got = _run(tcore, EngineRequest, SamplingParams, spec)
    assert got == want
    assert tcore.kv.allocator.free_pages == kw["num_pages"] - 1  # all returned


def test_cli_chat_int8_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "runbookai_tpu_torch", "chat", "hello",
         "--model", "llama3-test", "--device", "cpu", "--max-new-tokens", "4",
         "--dtype", "int8", "--kv-cache-dtype", "int8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["completion_tokens"] == 4
    assert set(stats["kernel_launches"]) >= {"paged_decode_attention_int8",
                                             "paged_chunk_attention_int8", "qmm_int8"}
    assert not any(stats["kernel_launches"].values())
