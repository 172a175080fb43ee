"""int8 weights in the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both. The quantizers must
agree exactly; the int8 matmul kernel runs only on the card, so here its
plain version (what ``qmm_int8`` computes for CPU tensors) is held against
the Pallas ``qmm_pallas`` in interpret mode at 1e-5 in float32, and the
port's routing between the kernel and the matmul expression must equal the
JAX package's ``qmm_pallas_eligible`` over a grid of shapes.
"""

import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.models import hf_loader as jloader
from runbookai_tpu.models import llama as jllama
from runbookai_tpu.models import quant as jquant
from runbookai_tpu.ops import qmm_pallas as jqmm
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models import quant as tquant
from runbookai_tpu_torch.models.hf_loader import config_from_hf, load_params
from runbookai_tpu_torch.ops import qmm as tqmm

FIXTURES = Path(__file__).parent / "fixtures"
QMM_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(seed, shape):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel: the 1e-8 scale clamp
    return w


@pytest.mark.parametrize("shape", [(3, 16, 8), (2, 64, 128), (1, 512, 384)])
def test_quantize_tensor_matches_jax(shape):
    w = _weights(0, shape)
    want = jquant.quantize_tensor(jnp.asarray(w))
    got = tquant.quantize_tensor(_t(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(tquant.dequantize_tensor(got).numpy(),
                                  np.asarray(jquant.dequantize_tensor(want)))


@pytest.mark.parametrize("in_axis", [-2, -1])
def test_quantize_array_np_matches_jax(in_axis):
    w = _weights(1, (2, 48, 64))
    for got, want in zip(tquant.quantize_array_np(w, in_axis),
                         jquant.quantize_array_np(w, in_axis)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_quantize_params_and_weight_bytes_match_jax():
    cfg = jllama.CONFIGS["llama3-test"]
    jp = jllama.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = {"embed": _t(np.asarray(jp["embed"])),
          "final_norm": _t(np.asarray(jp["final_norm"])),
          "lm_head": _t(np.asarray(jp["lm_head"])),
          "layers": {k: _t(np.asarray(v)) for k, v in jp["layers"].items()}}
    jq, tq = jquant.quantize_params(jp), tquant.quantize_params(tp)
    for k, v in jq["layers"].items():
        assert tquant.is_quantized(tq["layers"][k]) == jquant.is_quantized(v)
        if jquant.is_quantized(v):
            np.testing.assert_array_equal(tq["layers"][k]["q"].numpy(), np.asarray(v["q"]))
    assert tquant.weight_bytes(tq) == jquant.weight_bytes(jq)
    back_t = tquant.dequantize_params(tq, dtype=torch.float32)
    back_j = jquant.dequantize_params(jq, dtype=jnp.float32)
    np.testing.assert_array_equal(back_t["layers"]["w_up"].numpy(),
                                  np.asarray(back_j["layers"]["w_up"]))


def test_eligibility_matches_qmm_pallas_eligible():
    ms = [1, 5, 8, 16, 64, 255, 256, 257, 2048]
    dims = [16, 32, 48, 64, 96, 128, 200, 256, 384, 640, 1024, 4096, 14336]
    for m, k, n in itertools.product(ms, dims, dims):
        assert tqmm.qmm_eligible(m, k, n) == jqmm.qmm_pallas_eligible(m, k, n), (m, k, n)
    assert tqmm.MAX_M == jqmm.MAX_PALLAS_M


@pytest.mark.parametrize("m,k,n", [(5, 64, 128), (8, 96, 256), (20, 128, 384),
                                   (64, 32, 128)])
def test_plain_qmm_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 2.0, size=(1, n)) / 127).astype(np.float32)
    want = np.asarray(jqmm.qmm_pallas(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                      interpret=True))
    got = tqmm.qmm_int8(_t(x), _t(q), _t(s))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **QMM_TOL)


def test_qmm_int8_refuses_ineligible_shapes():
    x = torch.zeros((257, 64))
    with pytest.raises(ValueError):
        tqmm.qmm_int8(x, torch.zeros((64, 128), dtype=torch.int8), torch.ones((1, 128)))
    with pytest.raises(ValueError):  # N not a multiple of 128
        tqmm.qmm_int8(x[:8], torch.zeros((64, 96), dtype=torch.int8), torch.ones((1, 96)))


def test_qmm_splits_tile_k():
    """Every split of the wrapper's plan cuts K into whole multiples of 32
    rows, and the splits cover K."""
    for m, (k, n) in itertools.product(
            [5, 8, 64, 256], [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]):
        plan = tqmm.qmm_plan(m, k, n)
        assert plan.splits >= 1 and plan.k_slice % 32 == 0, (m, k, n, plan)
        assert (plan.splits - 1) * plan.k_slice < k <= plan.splits * plan.k_slice


@pytest.mark.parametrize("lead", [(1, 1), (2, 4), (4, 64), (2, 200)])
def test_qmm_routes_by_shape_like_jax(lead, monkeypatch):
    """The port sends exactly the products to the kernel that JAX sends to
    qmm_pallas, over the llama3-test matrices (64 -> 64, 128, 64 -> 128
    and 128 -> 64), and both routes agree with JAX's ``qmm(impl="pallas")``."""
    rng = np.random.default_rng(sum(lead))
    calls = []
    real = tllama.qmm_int8
    monkeypatch.setattr(tllama, "qmm_int8",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for k, n in [(64, 64), (64, 128), (128, 64), (64, 32)]:
        w = tquant.quantize_tensor(_t(rng.normal(size=(k, n)).astype(np.float32)))
        x = rng.normal(size=lead + (k,)).astype(np.float32)
        calls.clear()
        got = tllama.qmm(_t(x), w)
        m = int(np.prod(lead))
        assert bool(calls) == jqmm.qmm_pallas_eligible(m, k, n), (lead, k, n)
        want = jllama.qmm(jnp.asarray(x), {"q": jnp.asarray(w["q"].numpy()),
                                           "s": jnp.asarray(w["s"].numpy())},
                          impl="pallas")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **QMM_TOL)


@pytest.mark.parametrize("name", ["llama3-test", "qwen2-test"])
def test_init_params_quantized_layout_matches_jax(name):
    jp = jax.tree.map(np.asarray, jllama.init_params_quantized(
        jax.random.PRNGKey(0), jllama.CONFIGS[name], dtype=jnp.float32))
    tp = tllama.init_params_quantized(tllama.CONFIGS[name], dtype=torch.float32,
                                      device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    flat_j = {k: (v.shape, v.dtype.name) for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_j == flat_t
    for k in tquant.LAYER_QUANT_KEYS:
        leaf = tp["layers"][k]
        assert int(leaf["q"].min()) >= -127 and int(leaf["q"].max()) <= 127
        np.testing.assert_array_equal(leaf["s"].numpy(), jp["layers"][k]["s"])
    # Dequantized std matches the scaled-normal init: 1 / sqrt(fan_in).
    w = tquant.dequantize_tensor(tp["layers"]["w_gate"])
    assert abs(float(w.std()) * np.sqrt(tllama.CONFIGS[name].dim) - 1.0) < 0.05


@pytest.mark.parametrize("name", ["hf-tiny-untied", "hf-tiny-tied", "hf-tiny-qwen2"])
def test_quantized_loader_matches_jax(name):
    d = FIXTURES / name
    _, jp = jloader.load_params(d, jloader.config_from_hf(d), dtype=jnp.float32,
                                quantize_int8=True)
    _, tp = load_params(d, config_from_hf(d), dtype=torch.float32, device="cpu",
                        quantize_int8=True)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert flat_j.keys() == flat_t.keys()
    for path, want in flat_j.items():
        got = flat_t[path].numpy()
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
