"""Ops of the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both. The paged attention
kernels run only on the card; here their plain versions (what the wrappers
compute for CPU tensors) are held against the Pallas kernels in interpret
mode at the tolerance of ``test_pallas_kernel.py`` (2e-5, float32), on every
row, and against the XLA reference ``ops/attention.paged_attention`` on the
rows where both are defined alike (ctx >= 1, real query tokens).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.models import llama as jllama
from runbookai_tpu.ops import attention as jattn
from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu.ops import rope as jrope
from runbookai_tpu.ops import sampling as jsampling
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.ops import attention as tattn
from runbookai_tpu_torch.ops import paged_attention as tpa
from runbookai_tpu_torch.ops import rope as trope
from runbookai_tpu_torch.ops import sampling as tsampling

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)  # test_pallas_kernel.py:41
PS, N_KV, HD, NUM_PAGES = 4, 2, 32, 48
MAX_PAGES = 8  # + 1 trash column


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("theta,scaling", [(10_000.0, None),
                                           (500_000.0, (8.0, 1.0, 4.0, 64))])
def test_rope_matches_jax(theta, scaling):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 96, size=(2, 5)).astype(np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, scaling))
    got = trope.apply_rope(_t(x), _t(pos), theta, scaling).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tllama.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


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


def test_write_kv_pages_batch_matches_jax():
    rng = np.random.default_rng(2)
    pool = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
    new = rng.normal(size=(2, 6, N_KV, HD)).astype(np.float32)
    tables = _tables(rng, [7, 10])
    trash = MAX_PAGES * PS
    # Row 0 writes positions 3..8; row 1 writes 2 real tokens then a pad
    # tail at the trash position (-> trash column -> null page 0).
    pos = np.array([np.arange(3, 9), [8, 9, trash, trash, trash, trash]], np.int32)
    want = np.asarray(jattn.write_kv_pages_batch(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(pos), jnp.asarray(tables), PS))
    got = _t(pool.copy())
    out = tattn.write_kv_pages_batch(got, _t(new), _t(pos), _t(tables), PS)
    assert out is got  # in place
    # Page 0 takes the duplicate pad writes (never read); the rest is exact.
    np.testing.assert_array_equal(got.numpy()[PS:], want[PS:])
    assert not np.array_equal(got.numpy()[PS:], pool[PS:])


def _pools(rng):
    k = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
    v = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
    return k, v


@pytest.mark.parametrize("group", [1, 4, 8])
def test_plain_decode_matches_pallas_and_xla(group):
    rng = np.random.default_rng(10 + group)
    ctx = [0, 1, 5, 32]
    k, v = _pools(rng)
    tables = _tables(rng, ctx)
    q = rng.normal(size=(len(ctx), N_KV * group, HD)).astype(np.float32)
    ctx_np = np.asarray(ctx, np.int32)
    got = tpa.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx_np), PS).numpy()
    pallas = np.asarray(jpallas.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx_np), page_size=PS, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    assert np.all(got[0] == 0.0)  # ctx 0 -> zeros, as the Pallas kernel
    xla = np.asarray(jattn.paged_attention(
        jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx_np), jnp.asarray(np.maximum(ctx_np - 1, 0)[:, None]),
        page_size=PS, block_pages=2))[:, 0]
    live = ctx_np >= 1
    np.testing.assert_allclose(got[live], xla[live], **TOL)


@pytest.mark.parametrize("group", [1, 4, 8])
def test_plain_chunk_matches_pallas_and_xla(group):
    rng = np.random.default_rng(20 + group)
    t = 6
    trash = MAX_PAGES * PS
    # Rows: prefill from 0; prefill continuing at 9; verify from ctx-1;
    # a 2-token chunk with a pad tail at the trash position; a pad row
    # (ctx 1, null table) as the engine builds them.
    starts = [0, 9, 20, 12, trash]
    real = [6, 6, 6, 2, 0]
    ctx = [6, 15, 26, 14, 1]
    k, v = _pools(rng)
    tables = _tables(rng, ctx)
    tables[4] = 0
    pos = np.full((5, t), trash, np.int32)
    for i, (s, n) in enumerate(zip(starts, real)):
        pos[i, :n] = np.arange(s, s + n)
    q = rng.normal(size=(5, t, N_KV * group, HD)).astype(np.float32)
    ctx_np = np.asarray(ctx, np.int32)
    args_t = (_t(q), _t(k), _t(v), _t(tables), _t(ctx_np), _t(pos), PS)
    got = tpa.paged_chunk_attention(*args_t).numpy()
    pallas = np.asarray(jpallas.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx_np), jnp.asarray(pos), page_size=PS, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    xla = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx_np), jnp.asarray(pos), page_size=PS, block_pages=2))
    for i, n in enumerate(real):
        np.testing.assert_allclose(got[i, :n], xla[i, :n], **TOL)


def test_reference_paged_attention_matches_xla():
    """The port's blockwise reference keeps the XLA path's semantics on every
    row, including a fully masked one (ctx 0 averages V, unlike the
    kernels)."""
    rng = np.random.default_rng(30)
    ctx = [0, 3, 17]
    k, v = _pools(rng)
    tables = _tables(rng, ctx)
    q = rng.normal(size=(3, 2, 4, HD)).astype(np.float32)
    pos = np.array([[0, 0], [1, 2], [15, 16]], np.int32)
    ctx_np = np.asarray(ctx, np.int32)
    want = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx_np), jnp.asarray(pos), page_size=PS, block_pages=2))
    got = tattn.paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx_np),
                                _t(pos), PS, block_pages=2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrappers_reject_non_cpu_non_cuda():
    q = torch.zeros((1, 2, HD), device="meta")
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q, q, q, q, q, PS)


# ------------------------------------------------------------------ sampling


def _logits(rng, b, vocab=64):
    # A smooth descending profile so every token of the filtered support
    # has a probability a few thousand draws cannot miss.
    base = -0.35 * np.arange(vocab, dtype=np.float32)
    return np.stack([base[rng.permutation(vocab)] for _ in range(b)])


def test_greedy_matches_jax():
    rng = np.random.default_rng(40)
    logits = rng.normal(size=(6, 300)).astype(np.float32)
    temps = np.zeros((6,), np.float32)
    top_p = np.ones((6,), np.float32)
    import jax

    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(top_p)))
    got = tsampling.sample_tokens(_t(logits), None, _t(temps), _t(top_p)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p,top_k", [(0.5, 0), (1.0, 5), (0.8, 3)])
def test_filtered_support_matches_jax(top_p, top_k):
    """Both frameworks draw only from the same top-p/top-k support: the port's
    filter gives the support, and thousands of JAX draws land on exactly it."""
    import jax

    rng = np.random.default_rng(41)
    row = _logits(rng, 1)
    n = 4000
    logits = np.repeat(row, n, axis=0)
    temps = np.full((n,), 0.7, np.float32)
    tp = np.full((n,), top_p, np.float32)
    tk = np.full((n,), top_k, np.int32)
    drawn = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(3), jnp.asarray(temps),
        jnp.asarray(tp), top_k=jnp.asarray(tk)))
    filtered = tsampling.filter_logits(_t(row), _t(temps[:1]), _t(tp[:1]), _t(tk[:1]))
    support = set(np.nonzero(filtered.numpy()[0] > -1e29)[0].tolist())
    assert set(drawn.tolist()) == support
    g = torch.Generator().manual_seed(0)
    ours = tsampling.sample_tokens(_t(logits), g, _t(temps), _t(tp), top_k=_t(tk)).numpy()
    assert set(ours.tolist()) == support


def test_seeded_draw_is_independent_of_batch():
    rng = np.random.default_rng(42)
    logits = _logits(rng, 4)
    temps = np.full((4,), 1.0, np.float32)
    tp = np.ones((4,), np.float32)
    seeds = np.array([7, -1, 7, 123], np.int64)
    pos = np.array([5, 5, 9, 5], np.int64)
    batch = tsampling.sample_tokens(_t(logits), torch.Generator().manual_seed(1),
                                    _t(temps), _t(tp), seeds=_t(seeds),
                                    positions=_t(pos)).numpy()
    for i in (0, 2, 3):
        solo = tsampling.sample_tokens(
            _t(logits[i:i + 1]), torch.Generator().manual_seed(99), _t(temps[:1]),
            _t(tp[:1]), seeds=_t(seeds[i:i + 1]), positions=_t(pos[i:i + 1])).numpy()
        assert solo[0] == batch[i]


# ------------------------------------------------------------------- hygiene


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "runbookai_tpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "runbookai_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): [n for n in _imported_modules(f) if _forbidden(n)]
           for f in files}
    assert {f: n for f, n in bad.items() if n} == {}
    # The eval suite and the simulator are among them.
    assert {f"runbookai_tpu_torch/{m}.py" for m in (
        "evalsuite/scoring", "evalsuite/converters", "evalsuite/runner", "evalsuite/run_all",
        "simulate/__init__", "simulate/generator", "simulate/provision")} <= set(bad)
    # And at run time: importing every module of the port loads neither.
    mods = [".".join(f.relative_to(ROOT).with_suffix("").parts)
            for f in files if f.name not in ("__main__.py", "chip_smoke.py")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'runbookai_tpu', 'triton')]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
