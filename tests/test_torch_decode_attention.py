"""The tensor-core decode attention kernel's host side, on the CPU.

The kernel (``runbookai_tpu_torch/csrc/decode_attention.cu``) runs only on
the card, where ``chip_smoke.py`` holds it against its plain version. Here:
its routing, its split plan at the engine's shapes, and an f32 emulation of
what it computes differently from the plain version: the split over
page-table columns, each split's 64-key tiles cut into one 16-key slice per
warp with its own running max and sum, the warps combined at the end, and
the live splits merged in split order in the same launch. The emulation is
held against the plain version and the Pallas kernel in interpret mode.
Inputs are made with numpy from a seed.
"""

import inspect
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu_torch.ops import paged_attention as tpa

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)  # test_pallas_kernel.py:41
PS, N_KV, HD = 4, 2, 16
NUM_PAGES, MAX_PAGES = 128, 40  # + 1 trash column
KEYS, WARPS, WARP_KEYS = 64, 4, 16  # the kernel's tile, warps and keys a warp
NEG_INF = -1e30


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("q_dtype,hd,pool,route", [
    (torch.bfloat16, 128, torch.bfloat16, "mma"), (torch.bfloat16, 64, torch.bfloat16, "mma"),
    (torch.float32, 128, torch.bfloat16, "cuda_core"),
    (torch.float32, 128, torch.float32, "cuda_core"),
    (torch.float32, 16, torch.int8, "cuda_core"),
    (torch.bfloat16, 128, torch.int8, "cuda_core"),  # K3
    (torch.bfloat16, 128, torch.float32, "cuda_core"),
    (torch.bfloat16, 96, torch.bfloat16, None), (torch.bfloat16, 16, torch.bfloat16, None),
    (torch.float16, 128, torch.float16, None),
])
def test_decode_route(q_dtype, hd, pool, route):
    if route is None:
        with pytest.raises(ValueError):
            tpa.decode_route(q_dtype, hd, pool)
    else:
        assert tpa.decode_route(q_dtype, hd, pool) == route


# ------------------------------------------------------------------- plan


# (b, n_q, n_kv, hd, P): the 8B's decode step of 8 slots, the 70B's, one
# head shard of tp=8, a table of 5 columns, one of a single column, and the
# shapes of the emulation below.
PLANS = {
    "llama3_8b": (8, 32, 8, 128, 513),
    "llama3_70b": (8, 64, 8, 128, 513),
    "tp8_shard": (8, 4, 1, 128, 513),
    "five_cols": (1, 4, 1, 128, 5),
    "one_col": (3, 8, 8, 64, 1),
    "emulated": (8, N_KV * 4, N_KV, HD, MAX_PAGES + 1),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_decode_plan_covers_every_column_once(case):
    b, n_q, n_kv, hd, p = PLANS[case]
    plan = tpa.decode_plan(b, n_q, n_kv, hd, p)
    owner = [s for s in range(plan.splits) for _ in range(plan.cols)][:p]
    assert len(owner) == p  # every column in exactly one split
    assert sorted(set(owner)) == list(range(plan.splits))  # no split is empty
    assert plan.splits <= max(1, -(-2 * tpa.SMS // n_kv))
    assert plan.cols >= min(p, tpa.DECODE_MIN_COLS)
    assert plan.workspace_floats == (0 if plan.splits == 1
                                     else b * n_q * plan.splits * (hd + 2))
    # A function of host values only: no tensor, so no host sync.
    params = inspect.signature(tpa.decode_plan).parameters
    assert list(params) == ["b", "n_q", "n_kv", "hd", "p"]
    assert all(v.annotation in (int, "int") for v in params.values())


def test_decode_plan_at_the_engine_shapes():
    plan = tpa.decode_plan(*PLANS["llama3_8b"])
    assert (plan.splits, plan.cols) == (33, 16)  # 33 x 64 = 2,112 blocks at B=8
    assert plan.workspace_floats * 4 == 4_392_960
    assert tpa.decode_plan(*PLANS["llama3_70b"]).splits == 33
    assert (tpa.decode_plan(*PLANS["tp8_shard"]).splits,
            tpa.decode_plan(*PLANS["tp8_shard"]).cols) == (103, 5)
    assert (tpa.decode_plan(*PLANS["one_col"]).splits,
            tpa.decode_plan(*PLANS["one_col"]).workspace_floats) == (1, 0)
    # chip_smoke.py's decode input: blocks with keys per (sequence, kv head),
    # 464 of the 2,112 at the 8B; at the served contexts (at most 950
    # tokens) at most four live splits a sequence.
    live = [-(-(-(-c // 16)) // 16) for c in (0, 1, 16, 17, 1000, 8191, 300, 4097)]
    assert live == [0, 1, 1, 1, 4, 32, 2, 17] and 8 * sum(live) == 464
    assert max(-(-(-(-c // 16)) // 16) for c in range(951)) == 4


# ---------------------------------------------- the kernel emulated in f32


def emulate_decode(q, k, v, tables, ctx, page_size, cols):
    """What ``decode_attention_mma_kernel`` computes, in f32: for each
    (sequence, kv head) and each split of ``cols`` table columns that starts
    below ceil(ctx / ps), 64-key tiles whose 16-key slices go to four warps,
    each with its own online softmax in log2 units; the warps combined in
    warp order; one live split normalised, several merged in split order.
    Returns the output [B, n_q, hd] and every split's partial ``(acc, m, l)``
    (m in natural-log units), ``(0, -1e30, 0)`` where the kernel's block
    exits before loading."""
    b, n_q, hd = q.shape
    n_kv = k.shape[1]
    group, p = n_q // n_kv, tables.shape[1]
    splits = -(-p // cols)
    scale_log2 = 1.0 / math.sqrt(hd) / math.log(2.0)
    out = torch.zeros(b, n_q, hd)
    parts = (torch.zeros(splits, b, n_q, hd), torch.full((splits, b, n_q), NEG_INF),
             torch.zeros(splits, b, n_q))
    for i in range(b):
        hi = max(0, min(int(ctx[i]), p * page_size))
        n_cols = -(-hi // page_size)
        n_live = -(-n_cols // cols) if n_cols else 0
        for kvh in range(n_kv):
            heads = slice(kvh * group, (kvh + 1) * group)
            qg = q[i, heads].float()
            live_parts = []
            for s in range(n_live):
                lo = s * cols * page_size
                end = min(hi, lo + cols * page_size)
                wm = torch.full((WARPS, group), NEG_INF)
                wl = torch.zeros(WARPS, group)
                wo = torch.zeros(WARPS, group, hd)
                for it in range(-(-(end - lo) // KEYS)):
                    for w in range(WARPS):
                        key0 = lo + it * KEYS + WARP_KEYS * w
                        if key0 >= end:
                            continue
                        pos = torch.arange(key0, key0 + WARP_KEYS)
                        live = pos < end
                        rows = (tables[i, pos[live] // page_size].long() * page_size
                                + pos[live] % page_size)
                        kk = torch.zeros(WARP_KEYS, hd)
                        vv = torch.zeros(WARP_KEYS, hd)
                        kk[live], vv[live] = k[rows, kvh].float(), v[rows, kvh].float()
                        x = torch.where(live, (qg @ kk.T) * scale_log2, NEG_INF)
                        m_new = torch.maximum(wm[w], x.amax(-1))
                        alpha = torch.exp2(wm[w] - m_new)
                        pr = torch.where(live, torch.exp2(x - m_new[:, None]), 0.0)
                        wl[w] = wl[w] * alpha + pr.sum(-1)
                        wo[w] = wo[w] * alpha[:, None] + pr @ vv
                        wm[w] = m_new
                mx = wm.amax(0)
                cw = torch.exp2(wm - mx)
                acc = (wo * cw[..., None]).sum(0)
                den = (wl * cw).sum(0)
                live_parts.append((acc, mx, den))
                parts[0][s, i, heads], parts[1][s, i, heads] = acc, mx * math.log(2.0)
                parts[2][s, i, heads] = den
            if n_live == 1:
                acc, _, den = live_parts[0]
                out[i, heads] = acc / den.clamp_min(1e-30)[:, None]
            elif n_live > 1:  # the last block to finish: weights, then sums, in split order
                m_all = torch.stack([mx for _, mx, _ in live_parts])
                wt = torch.exp2(m_all - m_all.amax(0))
                den = sum(d * w for (_, _, d), w in zip(live_parts, wt)).clamp_min(1e-30)
                acc = sum(a * w[:, None] for (a, _, _), w in zip(live_parts, wt))
                out[i, heads] = acc / den[:, None]
    return out, parts


def _inputs(rng, group):
    """ctx 0, 1, rows on one page (3 and a full page), a page and one key,
    and rows over several splits and tiles, up to the full table."""
    ctx = np.asarray([0, 1, 3, PS, PS + 1, 37, 100, MAX_PAGES * PS], np.int32)
    k = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
    v = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
    tables = rng.integers(1, NUM_PAGES, size=(len(ctx), MAX_PAGES + 1)).astype(np.int32)
    tables[:, MAX_PAGES] = 0
    perm = rng.permutation(np.arange(1, NUM_PAGES))
    nxt = 0
    for i, c in enumerate(ctx):
        need = -(-c // PS)
        tables[i, :need] = perm[nxt:nxt + need]
        nxt += need
    q = rng.normal(size=(len(ctx), N_KV * group, HD)).astype(np.float32)
    return q, k, v, tables, ctx


@pytest.mark.parametrize("group,cols", [(4, 5), (4, 1), (1, 4), (8, 20), (4, 41)])
def test_decode_split_path_equals_plain_and_pallas(group, cols):
    """cols 5 is the plan at these shapes; 20 gives two tiles a split, 41
    one split over the whole table."""
    rng = np.random.default_rng(90 + group + cols)
    q, k, v, tables, ctx = _inputs(rng, group)
    if cols == 5:
        assert tpa.decode_plan(len(ctx), q.shape[1], N_KV, HD, MAX_PAGES + 1).cols == 5
    got, parts = emulate_decode(_t(q), _t(k), _t(v), _t(tables), _t(ctx), PS, cols)
    want = tpa.plain_paged_attention(_t(q)[:, None], _t(k), _t(v), _t(tables), _t(ctx),
                                     None, PS)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.all(got[0] == 0)  # ctx 0
    pallas = np.asarray(jpallas.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), page_size=PS, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    # The splits the kernel skips hold (0, -1e30, 0): merging them too moves
    # nothing, and their partials with the live ones give the plain result.
    merged = tpa.merge_partials(list(zip(*parts)), torch.device("cpu"))
    np.testing.assert_allclose(merged.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    for i, c in enumerate(ctx):
        first_dead = -(-(-(-int(c) // PS)) // cols)
        assert torch.all(parts[2][first_dead:, i] == 0)
        assert torch.all(parts[1][first_dead:, i] == NEG_INF)
        assert torch.all(parts[2][:first_dead, i] > 0)


def test_decode_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(97)
    q, k, v, tables, ctx = _inputs(rng, 4)
    got = tpa.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), PS)
    want = tpa.plain_paged_attention(_t(q)[:, None], _t(k), _t(v), _t(tables), _t(ctx),
                                     None, PS)[:, 0]
    assert torch.equal(got, want)


# ------------------------------------------------- chip_smoke's profile


def test_chip_smoke_classes_the_decode_kernels():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ns = "void (anonymous namespace)::"
    new = ns + "decode_attention_mma_kernel<__nv_bfloat16, 128>((anonymous namespace)::DecodeArgs)"
    removed = ns + ("paged_attention_kernel<__nv_bfloat16, __nv_bfloat16, false, false>("
                    "(anonymous namespace)::Args)")
    k3 = ns + "paged_attention_kernel<__nv_bfloat16, signed char, false, false>((anonymous namespace)::Args)"
    f32 = ns + "paged_attention_kernel<float, float, false, false>((anonymous namespace)::Args)"
    assert chip_smoke.kernel_class(new) == "decode_attention"
    assert chip_smoke.kernel_class(removed) == "decode_attention"
    assert chip_smoke.kernel_class(k3) == "decode_attention_int8"
    assert chip_smoke.removed_bf16(removed) == "decode"
    assert [chip_smoke.removed_bf16(n) for n in (new, k3, f32)] == [None] * 3
