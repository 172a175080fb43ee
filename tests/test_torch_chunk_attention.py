"""The tensor-core chunk attention kernel's host side, on the CPU.

The kernel (``runbookai_tpu_torch/csrc/chunk_attention.cu``) runs only on
the card, where ``chip_smoke.py`` holds it against its plain version. Here:
its split plan at the engine's shapes, the routing of chunk calls, and f32
emulations of what it computes differently from the CUDA-core kernel: the
split over page-table columns with the merge of the splits' partials
(against the plain version and the Pallas kernel in interpret mode), the
int8 scales applied to score columns and folded into P, and P carried as
two bf16 parts. Inputs are made with numpy from a seed.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu_torch.ops import paged_attention as tpa
from runbookai_tpu_torch.ops.attention import quantize_kv

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)  # test_pallas_kernel.py:41
PS, N_KV, HD = 4, 2, 16
NUM_PAGES, MAX_PAGES = 96, 20  # + 1 trash column
TRASH = MAX_PAGES * PS


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------- plan


# (b, t, n_q, n_kv, hd, P): the engine's 4 x 512 prefill and its one-row
# prefill, its T=8 verify of 8 slots, the verify on one head shard of tp=8, a
# T=37 chunk, a table of 5 columns and one of a single column.
PLANS = {
    "prefill": (4, 512, 32, 8, 128, 513),
    "prefill_one_row": (1, 512, 32, 8, 128, 513),
    "verify": (8, 8, 32, 8, 128, 513),
    "tp8_shard": (8, 8, 4, 1, 128, 513),
    "t37": (2, 37, 32, 8, 128, 513),
    "five_cols": (1, 8, 4, 1, 128, 5),
    "one_col": (3, 16, 8, 8, 64, 1),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_chunk_plan_covers_every_column_once(case):
    b, t, n_q, n_kv, hd, p = PLANS[case]
    plan = tpa.chunk_plan(b, t, n_q, n_kv, hd, p)
    group = n_q // n_kv
    assert plan.rows in (32, 64) and plan.q_tiles * plan.rows >= t * group
    assert (plan.q_tiles - 1) * plan.rows < t * group
    ctas = b * n_kv * plan.q_tiles
    owner = [s for s in range(plan.splits) for _ in range(plan.cols)][:p]
    assert len(owner) == p  # every column in exactly one split
    assert sorted(set(owner)) == list(range(plan.splits))  # no split is empty
    if ctas >= 2 * tpa.SMS:
        assert plan.splits == 1
    else:
        assert plan.splits <= -(-p // 16) or p < 16
    want_ws = 0 if plan.splits == 1 else plan.splits * b * t * n_q * (hd + 2) * 4
    assert plan.workspace_bytes == want_ws


def test_chunk_plan_at_the_engine_shapes():
    prefill = tpa.chunk_plan(*PLANS["prefill"])
    assert (prefill.rows, prefill.q_tiles, prefill.splits, prefill.workspace_bytes) == \
        (64, 32, 1, 0)  # 4 x 8 x 32 = 1,024 blocks
    one_row = tpa.chunk_plan(*PLANS["prefill_one_row"])  # 256 blocks: split
    assert (one_row.rows, one_row.q_tiles, one_row.splits, one_row.cols) == (64, 32, 2, 257)
    assert one_row.workspace_bytes == 2 * 512 * 32 * 130 * 4
    verify = tpa.chunk_plan(*PLANS["verify"])
    assert (verify.rows, verify.q_tiles, verify.splits, verify.cols) == (32, 1, 5, 103)
    assert verify.splits * 8 * 8 * verify.q_tiles >= 2 * tpa.SMS
    acc = 5 * 8 * 8 * 32 * 128 * 4
    assert acc == 5_242_880 and verify.workspace_bytes == acc + 2 * 5 * 8 * 8 * 32 * 4
    shard = tpa.chunk_plan(*PLANS["tp8_shard"])
    assert (shard.q_tiles, shard.splits, shard.cols) == (1, 33, 16)  # 8 blocks a split
    assert shard.workspace_bytes == 33 * 8 * 8 * 4 * 130 * 4  # acc 4,325,376 B + m, l
    t37 = tpa.chunk_plan(*PLANS["t37"])
    assert (t37.rows, t37.q_tiles, t37.splits) == (64, 3, 6)


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 16, "cuda_core"),
    (torch.bfloat16, 16, None), (torch.bfloat16, 96, None), (torch.bfloat16, 256, None),
    (torch.float16, 128, None),
])
def test_chunk_route(dtype, hd, route):
    assert tpa.chunk_mma_eligible(dtype, hd) == (route == "mma")
    if route is None:
        with pytest.raises(ValueError):
            tpa.chunk_route(dtype, hd)
    else:
        assert tpa.chunk_route(dtype, hd) == route


# ------------------------------------------------- split and merge, in f32


def _inputs(rng, group, int8=False):
    """Rows: a prefill from 0 (its first queries see nothing past the first
    split); a verify whose context ends inside the second split (later
    splits see no key); a chunk continuing at 40; a ctx-0 row; the engine's
    pad row (null table, ctx 1, queries at the trash position)."""
    t = 6
    starts = [0, 24, 40, 0, TRASH]
    real = [6, 6, 6, 0, 0]
    ctx = [6, 30, 46, 0, 1]
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
    tables[4] = 0
    pos = np.full((len(ctx), t), TRASH, np.int32)
    for i, (s, n) in enumerate(zip(starts, real)):
        pos[i, :n] = np.arange(s, s + n)
    pos[3] = np.arange(t)  # ctx 0: nothing cached, whatever the positions
    q = rng.normal(size=(len(ctx), t, N_KV * group, HD)).astype(np.float32)
    kt, vt = _t(k), _t(v)
    if int8:
        kt, vt = quantize_kv(kt), quantize_kv(vt)
    return q, (k, v), (kt, vt), tables, np.asarray(ctx, np.int32), pos


@pytest.mark.parametrize("group,cols", [(1, 1), (4, 2), (4, 3), (8, 7), (4, 21)])
def test_split_path_equals_plain_and_pallas(group, cols):
    rng = np.random.default_rng(50 + group + cols)
    q, (k, v), (kt, vt), tables, ctx, pos = _inputs(rng, group)
    q_start = _t(pos[:, 0])
    args = (_t(q), kt, vt, _t(tables), _t(ctx), q_start, PS)
    acc, m, l = tpa.plain_chunk_partials(*args, cols)
    assert acc.shape[0] == -(-(MAX_PAGES + 1) // cols)
    got = tpa.merge_partials(list(zip(acc, m, l)), torch.device("cpu")).numpy()
    want = tpa.plain_paged_attention(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[3] == 0.0)  # ctx 0
    pallas = np.asarray(jpallas.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(pos), page_size=PS, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    # A split that sees no key writes (0, -1e30, 0): the verify row's
    # context ends at key 29, the pad row reads key 0 only.
    for row, first_dead_col in ((1, -(-30 // PS)), (4, 1)):
        for s in range(-(-first_dead_col // cols), acc.shape[0]):
            if s * cols >= first_dead_col:
                assert torch.all(acc[s, row] == 0) and torch.all(l[s, row] == 0)
                assert torch.all(m[s, row] == tpa.NEG_INF)
    # Causal rows that see nothing in a split: the prefill's query 0 sees
    # key 0 only, so every split past the first is empty for it.
    assert torch.all(l[1:, 0, 0] == 0)


def test_chunk_merge_on_cpu_is_merge_partials_and_the_cast():
    rng = np.random.default_rng(60)
    acc = _t(rng.normal(size=(3, 2, 5, 4, HD)).astype(np.float32))
    m = _t(rng.normal(size=(3, 2, 5, 4)).astype(np.float32))
    l = _t(rng.uniform(0.5, 2.0, size=(3, 2, 5, 4)).astype(np.float32))
    m[:, 0, 0], l[:, 0, 0], acc[:, 0, 0] = tpa.NEG_INF, 0.0, 0.0  # seen by no split
    m[1, 1, 1], l[1, 1, 1], acc[1, 1, 1] = tpa.NEG_INF, 0.0, 0.0  # one empty split
    for dtype in (torch.float32, torch.bfloat16):
        got = tpa.chunk_merge(acc, m, l, dtype)
        want = tpa.merge_partials(list(zip(acc, m, l)), torch.device("cpu")).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.all(got[0, 0] == 0)


# ----------------------------------------------------- int8 and P in bf16


def _gather(values, scales, tables, ctx, b):
    rows = (tables[b, :-(-ctx // PS)].astype(np.int64)[:, None] * PS
            + np.arange(PS)).reshape(-1)[:ctx]
    return values[rows].astype(np.float32), scales[rows]  # [S, n_kv, hd], [S, n_kv]


@pytest.mark.parametrize("group", [1, 4])
def test_int8_column_scaling_equals_dequantize_then_attend(group):
    """What the kernel does over an int8 pool: Q against the int8 values
    widened, each score column times k_scale, v_scale folded into P before
    P V, l summed from the unscaled P; in f32 it equals the plain version,
    which dequantizes the pool first."""
    rng = np.random.default_rng(70 + group)
    q, _, (kt, vt), tables, ctx, pos = _inputs(rng, group, int8=True)
    want = tpa.plain_paged_attention(_t(q), kt, vt, _t(tables), _t(ctx),
                                     _t(pos[:, 0]), PS).numpy()
    kv, ks = kt[0].numpy(), kt[1].numpy()
    vv, vs = vt[0].numpy(), vt[1].numpy()
    out = np.zeros_like(q)
    for b in range(q.shape[0]):
        if ctx[b] == 0:
            continue
        k_i, k_s = _gather(kv, ks, tables, ctx[b], b)
        v_i, v_s = _gather(vv, vs, tables, ctx[b], b)
        for t in range(q.shape[1]):
            live = np.arange(ctx[b]) <= pos[b, 0] + t
            for h in range(q.shape[2]):
                kvh = h // group
                s = (k_i[:, kvh] @ q[b, t, h]) * k_s[:, kvh] / np.sqrt(HD)
                if not live.any():
                    continue
                p = np.where(live, np.exp(s - s[live].max()), 0.0)
                out[b, t, h] = ((p * v_s[:, kvh]) @ v_i[:, kvh]) / p.sum()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_p_in_two_bf16_parts_meets_the_bf16_check():
    """chip_smoke.py's bf16 check (|err| <= 1e-3 + 1e-2 |ref|) on a T=8
    verify over short contexts, bf16 inputs: P rounded once to bf16 for P V
    fails it where an output is near zero; P as hi + lo bf16 parts (the
    kernel) passes."""
    rng = np.random.default_rng(80)
    n, t, h = 8, 8, 4
    bf = lambda x: _t(x).bfloat16().float()  # noqa: E731
    q, k, v = (bf(rng.normal(size=s).astype(np.float32))
               for s in ((n, t, h, 128), (n, 24, 128), (n, 24, 128)))
    ctx = np.arange(n) + 9  # verify from ctx - 1: query 0 sees ctx - 8 keys
    outs = {}
    for mode in ("once", "two_parts", "f32"):
        out = torch.zeros(n, t, h, 128)
        for b in range(n):
            s = torch.einsum("thd,sd->ths", q[b], k[b, :ctx[b]]) / np.sqrt(128)
            live = torch.arange(ctx[b])[None, :] <= torch.arange(t)[:, None] + ctx[b] - 8
            s = torch.where(live[:, None, :], s, -torch.inf)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            if mode == "once":
                p_used = p.bfloat16().float()
            elif mode == "two_parts":
                hi = p.bfloat16().float()
                p_used = hi + (p - hi).bfloat16().float()
            else:
                p_used = p
            out[b] = (p_used @ v[b, :ctx[b]]) / p.sum(-1, keepdim=True)
        outs[mode] = out.bfloat16().float()
    ref = outs["f32"]

    def over(got):
        return int(((got - ref).abs() > 1e-3 + 1e-2 * ref.abs()).sum())

    assert over(outs["once"]) > 0
    assert over(outs["two_parts"]) == 0


# ------------------------------------------------- chip_smoke's profile


def test_chip_smoke_classes_the_new_kernels_with_the_chunk_calls():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ns = "void (anonymous namespace)::"
    cases = {
        "chunk_attention_mma_kernel<__nv_bfloat16, 128, 2>((anonymous namespace)::ChunkArgs)":
            ("chunk_attention", "chunk_attention", False),
        "chunk_attention_mma_kernel<signed char, 128, 4>((anonymous namespace)::ChunkArgs)":
            ("chunk_attention_int8", "chunk_attention_int8", False),
        "chunk_merge_kernel<__nv_bfloat16>(float const*, float const*, float const*, "
        "__nv_bfloat16*, int, long long, int)": ("chunk_attention", "chunk_attention_int8",
                                                 False),
        "paged_attention_kernel<__nv_bfloat16, __nv_bfloat16, true, false>("
        "(anonymous namespace)::Args)": ("chunk_attention", "chunk_attention", True),
        "paged_attention_kernel<float, signed char, true, false>((anonymous namespace)::Args)":
            ("chunk_attention_int8", "chunk_attention_int8", False),
        "paged_attention_kernel<__nv_bfloat16, __nv_bfloat16, true, true>("
        "(anonymous namespace)::Args)": ("chunk_attention_partial",
                                         "chunk_attention_partial", False),
    }
    for name, (bf16_cls, int8_cls, old) in cases.items():
        assert chip_smoke.kernel_class(ns + name) == bf16_cls
        assert chip_smoke.kernel_class(ns + name, int8_pools=True) == int8_cls
        assert chip_smoke.old_bf16_chunk(ns + name) == old
