"""Model of the PyTorch port against the JAX package, on the CPU (float32).

The same numpy weights (converted with ``params_from_jax``) and the same
inputs go through JAX ``forward_impl`` with the Pallas kernels in interpret
mode and through the port's ``forward_impl`` (the kernels' plain versions),
over a paged pool, for a prefill chunk and a decode step. The port's loader
is held against the checked-in HF goldens at the tolerance of
``test_hf_golden.py:60``.
"""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.models import llama as jllama
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models.convert import params_from_jax
from runbookai_tpu_torch.models.hf_loader import config_from_hf, load_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

FIXTURES = Path(__file__).parent / "fixtures"
PS = 4
NUM_PAGES = 40
MAX_SEQ = 64
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def test_configs_pin_the_jax_copy():
    assert set(tllama.CONFIGS) == set(jllama.CONFIGS)
    for name, cfg in jllama.CONFIGS.items():
        assert dataclasses.asdict(tllama.CONFIGS[name]) == dataclasses.asdict(cfg)
        assert tllama.CONFIGS[name].total_params == cfg.total_params


@pytest.mark.parametrize("name", ["llama3-test", "qwen2-test"])
def test_init_params_layout_matches_jax(name):
    jp = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(0), jllama.CONFIGS[name], dtype=jnp.float32))
    tp = tllama.init_params(tllama.CONFIGS[name], dtype=torch.float32,
                            device="cpu", generator=torch.Generator().manual_seed(0))
    flat_j = {k: v.shape for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {k: tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(
                  jax.tree.map(lambda x: np.zeros(x.shape), tp))[0]}
    assert flat_j == flat_t
    assert str(tp["layers"]["wq"].dtype) == "torch.float32"


def _np_params(name, seed=0):
    cfg = jllama.CONFIGS[name]
    params = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(seed), cfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for leaf in ("bq", "bk", "bv", "attn_norm", "mlp_norm"):
        if leaf in params["layers"]:  # non-trivial biases and norm weights
            base = params["layers"][leaf]
            params["layers"][leaf] = (base + 0.1 * rng.normal(size=base.shape)
                                      ).astype(np.float32)
    return cfg, params


def _paged_inputs(ctx_lens, starts, t):
    """Tables with disjoint pages + trash column; positions from ``starts``,
    pad tail at the trash position."""
    max_pages = MAX_SEQ // PS
    b = len(ctx_lens)
    tables = np.zeros((b, max_pages + 1), np.int32)
    nxt = 1
    for i, ctx in enumerate(ctx_lens):
        need = -(-ctx // PS)
        tables[i, :need] = np.arange(nxt, nxt + need)
        nxt += need
    pos = np.full((b, t), max_pages * PS, np.int32)
    for i, (s, c) in enumerate(zip(starts, ctx_lens)):
        pos[i, : c - s] = np.arange(s, c)
    return tables, pos


@pytest.mark.parametrize("name", ["llama3-test", "qwen2-test"])
def test_forward_matches_jax_pallas(name):
    cfg, np_params = _np_params(name)
    tparams = params_from_jax(np_params, device="cpu")
    tcfg = tllama.CONFIGS[name]
    rng = np.random.default_rng(1)
    shape = (cfg.n_layers, NUM_PAGES * PS, cfg.n_kv_heads, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)

    # Prefill: row 0 a full 8-token chunk, row 1 five tokens + pad tail.
    t = 8
    ctx = [8, 5]
    tables, pos = _paged_inputs(ctx, [0, 0], t)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, t)).astype(np.int32)
    jlog, jk, jv = jllama.forward(np_params, cfg, jnp.asarray(tokens), jnp.asarray(pos),
                                  jk, jv, jnp.asarray(tables), jnp.asarray(ctx, jnp.int32),
                                  page_size=PS, attn_impl="pallas")
    tlog = tllama.forward_impl(tparams, tcfg, torch.from_numpy(tokens).long(),
                               torch.from_numpy(pos), tk, tv, torch.from_numpy(tables),
                               torch.tensor(ctx, dtype=torch.int32), PS)
    for i, c in enumerate(ctx):
        np.testing.assert_allclose(tlog[i, :c].numpy(), np.asarray(jlog)[i, :c], **LOGIT_TOL)
    # The pools hold the same K/V outside the null page.
    np.testing.assert_allclose(tk.numpy()[:, PS:], np.asarray(jk)[:, PS:], **LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy()[:, PS:], np.asarray(jv)[:, PS:], **LOGIT_TOL)

    # Decode: one token per row at position ctx, plus an empty slot (ctx 0).
    dtok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    dpos = np.array([[8], [5], [0]], np.int32)
    dctx = np.array([9, 6, 0], np.int32)
    dtables = np.zeros((3, MAX_SEQ // PS + 1), np.int32)
    dtables[:2] = tables
    dtables[0, 2] = 30  # row 0 grows onto a fresh page
    jlog, _, _ = jllama.forward(np_params, cfg, jnp.asarray(dtok), jnp.asarray(dpos),
                                jk, jv, jnp.asarray(dtables), jnp.asarray(dctx),
                                page_size=PS, attn_impl="pallas")
    tlog = tllama.forward_impl(tparams, tcfg, torch.from_numpy(dtok).long(),
                               torch.from_numpy(dpos), tk, tv, torch.from_numpy(dtables),
                               torch.from_numpy(dctx), PS)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


@pytest.mark.parametrize("name", ["hf-tiny-untied", "hf-tiny-tied",
                                  "hf-tiny-qwen2", "hf-tiny-rope31", "hf-tiny-mixtral"])
def test_loader_forward_matches_hf_goldens(name):
    d = FIXTURES / name
    cfg, params = load_params(d, config_from_hf(d, name=name), dtype=torch.float32,
                              device="cpu")
    blob = np.load(d / "expected_logits.npz")
    ids, want = blob["input_ids"], blob["logits"]
    b, t = ids.shape
    tables, pos = _paged_inputs([t] * b, [0] * b, t)
    shape = (cfg.n_layers, NUM_PAGES * PS, cfg.n_kv_heads, cfg.head_dim)
    logits = tllama.forward_impl(
        params, cfg, torch.from_numpy(ids).long(), torch.from_numpy(pos),
        torch.zeros(shape), torch.zeros(shape), torch.from_numpy(tables),
        torch.full((b,), t, dtype=torch.int32), PS)
    np.testing.assert_allclose(logits.numpy(), want, atol=2e-4, rtol=2e-3)


def test_converter_carries_quantized_leaves():
    """An int8 ``{"q", "s"}`` leaf converts to the same two arrays in their
    own types, whatever ``dtype`` the other leaves are cast to; a subtree of
    other keys is refused."""
    rng = np.random.default_rng(5)
    q = rng.integers(-127, 128, size=(2, 8, 16)).astype(np.int8)
    s = rng.uniform(size=(2, 1, 16)).astype(np.float32)
    out = params_from_jax({"embed": np.ones((4, 8), np.float32),
                           "layers": {"wq": {"q": q, "s": s},
                                      "attn_norm": np.ones((2, 8), np.float32)}},
                          device="cpu", dtype=torch.bfloat16)
    wq = out["layers"]["wq"]
    assert (wq["q"].dtype, wq["s"].dtype) == (torch.int8, torch.float32)
    np.testing.assert_array_equal(wq["q"].numpy(), q)
    np.testing.assert_array_equal(wq["s"].numpy(), s)
    assert out["embed"].dtype == torch.bfloat16
    assert out["layers"]["attn_norm"].dtype == torch.float32
    with pytest.raises(ValueError):
        params_from_jax({"layers": {"wq": {"A": q, "B": q}}}, device="cpu")
