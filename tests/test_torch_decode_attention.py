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
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu_torch.ops import paged_attention as tpa
from runbookai_tpu_torch.ops.attention import quantize_kv

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)  # test_pallas_kernel.py:41
PS, N_KV, HD = 4, 2, 16
NUM_PAGES, MAX_PAGES = 128, 40  # + 1 trash column
KEYS, WARPS, WARP_KEYS = 64, 4, 16  # the kernel's tile, warps and keys a warp
NEG_INF = -1e30


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("q_dtype,hd,pool,partial,route", [
    (torch.bfloat16, 128, torch.bfloat16, False, "mma"),
    (torch.bfloat16, 64, torch.bfloat16, False, "mma"),
    (torch.float32, 128, torch.bfloat16, False, "cuda_core"),
    (torch.float32, 128, torch.float32, False, "cuda_core"),
    (torch.float32, 16, torch.int8, False, "cuda_core"),
    (torch.bfloat16, 128, torch.int8, False, "mma"),  # K3
    (torch.bfloat16, 64, torch.int8, False, "mma"),
    (torch.bfloat16, 16, torch.int8, False, None),
    (torch.bfloat16, 128, torch.float32, False, "cuda_core"),
    (torch.bfloat16, 96, torch.bfloat16, False, None),
    (torch.bfloat16, 16, torch.bfloat16, False, None),
    (torch.float16, 128, torch.float16, False, None),
    # The page-split partials (K4 and the chunk partial): bf16 over a bf16
    # slice on the tensor cores, f32 on the CUDA cores, no int8 pools.
    (torch.bfloat16, 128, torch.bfloat16, True, "mma"),
    (torch.bfloat16, 64, torch.bfloat16, True, "mma"),
    (torch.float32, 128, torch.bfloat16, True, "cuda_core"),
    (torch.bfloat16, 128, torch.float32, True, "cuda_core"),
    (torch.bfloat16, 16, torch.bfloat16, True, None),
    (torch.bfloat16, 128, torch.int8, True, None),
    (torch.float32, 128, torch.int8, True, None),
])
def test_decode_route(q_dtype, hd, pool, partial, route):
    if route is None:
        with pytest.raises(ValueError):
            tpa.decode_route(q_dtype, hd, pool, partial=partial)
    else:
        assert tpa.decode_route(q_dtype, hd, pool, partial=partial) == route


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


def emulate_decode(q, k, v, tables, ctx, page_size, cols, scales=None, shard=None,
                   pages_local=None):
    """What ``decode_attention_mma_kernel`` computes, in f32: for each
    (sequence, kv head) and each split of ``cols`` table columns that starts
    below ceil(ctx / ps), the split's keys in 64-key tiles whose 16-key
    slices go to four warps, each with its own online softmax in log2 units;
    the warps combined in warp order; one live split written as it is,
    several merged in split order (log2 units) by the last to finish.

    - K1 (the default): the keys are the split's run of positions below ctx;
      the output is normalised.
    - int8 mode (``scales = (k_scale, v_scale)``, ``k`` and ``v`` the int8
      values): the values widened, each score column multiplied by its
      key's k scale after Q K^T, and its v scale folded into P.
    - owned-page mode (K4: ``shard`` and ``pages_local``, ``k`` and ``v``
      the shard's slice): a split's keys are the offsets of its owned
      columns' local pages, the columns listed in table order, cut at ctx;
      the output is the un-normalised (acc, m in natural-log units, l), a
      row with no owned key (0, -1e30, 0).

    Returns the output ([B, n_q, hd], or ``(acc, m, l)`` in owned-page
    mode) and every split's partial ``(acc, m, l)`` (m in natural-log
    units), ``(0, -1e30, 0)`` where the kernel's block exits before loading
    or owns no key."""
    b, n_q, hd = q.shape
    n_kv = k.shape[1]
    group, p = n_q // n_kv, tables.shape[1]
    splits = -(-p // cols)
    scale_log2 = 1.0 / math.sqrt(hd) / math.log(2.0)
    owned = shard is not None
    out = (torch.zeros(b, n_q, hd), torch.full((b, n_q), NEG_INF), torch.zeros(b, n_q)) \
        if owned else torch.zeros(b, n_q, hd)
    parts = (torch.zeros(splits, b, n_q, hd), torch.full((splits, b, n_q), NEG_INF),
             torch.zeros(splits, b, n_q))
    ln = lambda m2, den: torch.where(den > 0, m2 * math.log(2.0), NEG_INF)  # noqa: E731
    for i in range(b):
        hi = max(0, min(int(ctx[i]), p * page_size))
        n_cols = -(-hi // page_size)
        n_live = -(-n_cols // cols) if n_cols else 0
        for kvh in range(n_kv):
            heads = slice(kvh * group, (kvh + 1) * group)
            qg = q[i, heads].float()
            live_parts = []
            for s in range(n_live):
                if owned:  # the owned columns of the split, in table order
                    run = [c for c in range(s * cols, min((s + 1) * cols, n_cols))
                           if int(tables[i, c]) // pages_local == shard]
                    offs = torch.arange(page_size)
                    pos = torch.cat([c * page_size + offs for c in run] or [offs[:0]])
                    rows = torch.cat([(int(tables[i, c]) - shard * pages_local) * page_size
                                      + offs for c in run] or [offs[:0]])
                    assert torch.all((rows >= 0) & (rows < pages_local * page_size))
                    rows = rows[pos < hi]  # only the last column is cut: a prefix
                else:
                    pos = torch.arange(s * cols * page_size,
                                       min(hi, (s + 1) * cols * page_size))
                    rows = tables[i, pos // page_size].long() * page_size + pos % page_size
                n_keys = len(rows)
                wm = torch.full((WARPS, group), NEG_INF)
                wl = torch.zeros(WARPS, group)
                wo = torch.zeros(WARPS, group, hd)
                for it in range(-(-n_keys // KEYS)):
                    for w in range(WARPS):
                        j0 = it * KEYS + WARP_KEYS * w
                        if j0 >= n_keys:
                            continue
                        live = torch.arange(j0, j0 + WARP_KEYS) < n_keys
                        r = rows[j0:j0 + WARP_KEYS]
                        kk = torch.zeros(WARP_KEYS, hd)
                        vv = torch.zeros(WARP_KEYS, hd)
                        kk[live], vv[live] = k[r, kvh].float(), v[r, kvh].float()
                        x = (qg @ kk.T) * scale_log2
                        if scales is not None:  # k scale on the score columns
                            ksc = torch.zeros(WARP_KEYS)
                            ksc[live] = scales[0][r, kvh]
                            x = x * ksc
                        x = torch.where(live, x, NEG_INF)
                        m_new = torch.maximum(wm[w], x.amax(-1))
                        alpha = torch.exp2(wm[w] - m_new)
                        pr = torch.where(live, torch.exp2(x - m_new[:, None]), 0.0)
                        wl[w] = wl[w] * alpha + pr.sum(-1)
                        if scales is not None:  # v scale folded into P
                            vsc = torch.zeros(WARP_KEYS)
                            vsc[live] = scales[1][r, kvh]
                            pr = pr * vsc
                        wo[w] = wo[w] * alpha[:, None] + pr @ vv
                        wm[w] = m_new
                mx = wm.amax(0)
                cw = torch.exp2(wm - mx)
                acc = (wo * cw[..., None]).sum(0)
                den = (wl * cw).sum(0)
                live_parts.append((acc, mx, den))
                parts[0][s, i, heads], parts[1][s, i, heads] = acc, ln(mx, den)
                parts[2][s, i, heads] = den
            if n_live == 1:
                acc, mx, den = live_parts[0]
            elif n_live > 1:  # the last block to finish: weights, then sums, in split order
                m_all = torch.stack([mx for _, mx, _ in live_parts])
                mx = m_all.amax(0)
                wt = torch.exp2(m_all - mx)
                den = sum(d * w for (_, _, d), w in zip(live_parts, wt))
                acc = sum(a * w[:, None] for (a, _, _), w in zip(live_parts, wt))
            else:
                continue
            if owned:
                out[0][i, heads], out[1][i, heads], out[2][i, heads] = acc, ln(mx, den), den
            else:
                out[i, heads] = acc / den.clamp_min(1e-30)[:, None]
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


# ------------------------------------------------ K3: over an int8 pool


def _int8_pools(k, v):
    """The port's int8 pools of f32 K and V: ((values, scales), (values, scales))."""
    return quantize_kv(_t(k)), quantize_kv(_t(v))


@pytest.mark.parametrize("group,cols", [(1, None), (3, None), (4, None), (7, 20), (8, 1),
                                        (4, 41)])
def test_decode_int8_split_path_equals_plain_and_pallas(group, cols):
    """K3: the int8 values widened, k scales on the score columns and v
    scales folded into P, in the same split walk as K1; against the plain
    version (which dequantizes first) and Pallas ``_paged_decode_attention_int8``
    in interpret mode. ``None`` takes ``decode_plan``'s columns."""
    rng = np.random.default_rng(120 + group + (cols or 0))
    q, k, v, tables, ctx = _inputs(rng, group)
    if cols is None:
        cols = tpa.decode_plan(len(ctx), q.shape[1], N_KV, HD, MAX_PAGES + 1).cols
    kq, vq = _int8_pools(k, v)
    assert kq[0].dtype == torch.int8 and kq[1].shape == (NUM_PAGES * PS, N_KV)
    got, parts = emulate_decode(_t(q), kq[0], vq[0], _t(tables), _t(ctx), PS, cols,
                                scales=(kq[1], vq[1]))
    want = tpa.plain_paged_attention(_t(q)[:, None], kq, vq, _t(tables), _t(ctx), None,
                                     PS)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert torch.all(got[0] == 0)  # ctx 0
    pallas = np.asarray(jpallas.paged_decode_attention(
        jnp.asarray(q), (jnp.asarray(kq[0].numpy()), jnp.asarray(kq[1].numpy())),
        (jnp.asarray(vq[0].numpy()), jnp.asarray(vq[1].numpy())), jnp.asarray(tables),
        jnp.asarray(ctx), page_size=PS, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    merged = tpa.merge_partials(list(zip(*parts)), torch.device("cpu"))
    np.testing.assert_allclose(merged.numpy(), want.numpy(), **TOL)
    # A scale left off either side moves the result beyond TOL.
    for sc in ((torch.ones_like(kq[1]), vq[1]), (kq[1], torch.ones_like(vq[1]))):
        wrong, _ = emulate_decode(_t(q), kq[0], vq[0], _t(tables), _t(ctx), PS, cols,
                                  scales=sc)
        assert np.abs(wrong.numpy() - want.numpy()).max() > 1e-2


# ------------------------------------- K4: over a page shard's own pages


SHARDS = 2
LOCAL = NUM_PAGES // SHARDS


def _shard_tables(rng, ctx):
    """Tables over both shards' pages, distinct per sequence: sequence 6 lies
    on shard 1 alone (shard 0 owns none of its keys); the full-table
    sequence 7 puts columns 0-7 on shard 1 and 8-15 on shard 0, so that a
    split of at most 8 columns sees only the other shard's pages there; the
    rest draw from both shards at random. Entries past ctx are random pages,
    the trash column page 0."""
    free = [list(rng.permutation(np.arange(max(1, s * LOCAL), (s + 1) * LOCAL)))
            for s in range(SHARDS)]
    tables = rng.integers(1, NUM_PAGES, size=(len(ctx), MAX_PAGES + 1)).astype(np.int32)
    tables[:, MAX_PAGES] = 0
    for i, c in enumerate(ctx):
        for col in range(-(-int(c) // PS)):
            if i == 6:
                s = 1
            elif i == 7 and col < 16:
                s = 1 if col < 8 else 0
            else:
                s = int(rng.integers(SHARDS)) if free[0] and free[1] else int(not free[0])
            tables[i, col] = free[s].pop()
    return tables


@pytest.mark.parametrize("group,cols", [(1, None), (3, None), (4, None), (7, 4), (8, 1),
                                        (4, 41)])
def test_decode_partial_owned_pages_equals_plain_and_pallas(group, cols):
    """K4 on each of two page shards: the owned columns of each split listed
    in table order, tiles of four owned pages, (acc, m, l) combined in split
    order; against the plain partial and Pallas
    ``paged_decode_attention_partial`` in interpret mode. Rows with no owned
    key, and splits whose live columns are all foreign, give exactly
    (0, -1e30, 0). ``None`` takes ``decode_plan``'s columns."""
    rng = np.random.default_rng(140 + group + (cols or 0))
    q, k, v, _, ctx = _inputs(rng, group)
    tables = _shard_tables(rng, ctx)
    if cols is None:
        cols = tpa.decode_plan(len(ctx), q.shape[1], N_KV, HD, MAX_PAGES + 1).cols
    for shard in range(SHARDS):
        sl = slice(shard * LOCAL * PS, (shard + 1) * LOCAL * PS)
        (acc, m, l), parts = emulate_decode(_t(q), _t(k[sl]), _t(v[sl]), _t(tables), _t(ctx),
                                            PS, cols, shard=shard, pages_local=LOCAL)
        plain = tpa.paged_decode_attention_partial(_t(q), _t(k[sl]), _t(v[sl]), _t(tables),
                                                   _t(ctx), shard, PS, LOCAL)
        pallas = jpallas.paged_decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[sl]), jnp.asarray(v[sl]), jnp.asarray(tables),
            jnp.asarray(ctx), jnp.int32(shard), page_size=PS, pages_local=LOCAL,
            interpret=True)
        for got, w_plain, w_pallas in zip((acc, m, l), plain, pallas):
            np.testing.assert_allclose(got.numpy(), w_plain.numpy(), **TOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(w_pallas), **TOL)
        # No owned key: exactly (0, -1e30, 0), after the conversion to ln.
        empty = [0] + ([6] if shard == 0 else [])
        for i in empty:
            assert torch.all(acc[i] == 0) and torch.all(l[i] == 0)
            assert torch.all(m[i] == NEG_INF)
        # A live split whose columns are all foreign writes (0, -1e30, 0).
        foreign = range(0, 8) if shard == 0 else range(8, 16)
        for s in range(-(-(MAX_PAGES + 1) // cols)):
            run = range(s * cols, min((s + 1) * cols, MAX_PAGES))
            if len(run) and set(run) <= set(foreign):
                assert torch.all(parts[2][s, 7] == 0) and torch.all(parts[1][s, 7] == NEG_INF)
                assert torch.all(parts[0][s, 7] == 0)
        assert torch.all(l[7] > 0) and torch.all(l[5] >= 0)
    # Both shards' partials merged give K1 on the whole pool.
    whole = tpa.plain_paged_attention(_t(q)[:, None], _t(k), _t(v), _t(tables), _t(ctx),
                                      None, PS)[:, 0]
    halves = [emulate_decode(_t(q), _t(k[sl]), _t(v[sl]), _t(tables), _t(ctx), PS, cols,
                             shard=s, pages_local=LOCAL)[0]
              for s, sl in enumerate((slice(0, LOCAL * PS), slice(LOCAL * PS, None)))]
    np.testing.assert_allclose(tpa.merge_partials(halves, torch.device("cpu")).numpy(),
                               whole.numpy(), **TOL)


def test_decode_partial_cuts_only_the_last_column():
    """The live keys of a K4 block are a prefix of its owned keys: only the
    column of position ctx - 1 can be cut short, and it is the last column
    below ctx, so when the shard owns it, it is the last in the list."""
    rng = np.random.default_rng(150)
    for _ in range(200):
        n_cols = int(rng.integers(1, 30))
        ctx = (n_cols - 1) * PS + int(rng.integers(1, PS + 1))
        owned = rng.random(n_cols) < 0.5
        pos = [c * PS + o for c in np.flatnonzero(owned) for o in range(PS)]
        live = [x < ctx for x in pos]
        assert live == sorted(live, reverse=True)  # True... then False...
        assert sum(live) == len(pos) - (n_cols * PS - ctx if owned[-1] else 0)


def test_decode_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(97)
    q, k, v, tables, ctx = _inputs(rng, 4)
    got = tpa.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), PS)
    want = tpa.plain_paged_attention(_t(q)[:, None], _t(k), _t(v), _t(tables), _t(ctx),
                                     None, PS)[:, 0]
    assert torch.equal(got, want)


# ------------------------- a 2,048-column table: 32k contexts (K1 and K4)


# llama3.1-8b-instruct served at max_seq_len 32,768: 16-token pages, 2,048
# table columns and the trash column. One sequence near 32k, the rest short.
WIDE_PS, WIDE_P = 16, 2048
WIDE_CTX = [32_767, 0, 1, 17, 300, 1000, 16, 4097]
WIDE_PAGES = 2 * 1_300  # two page shards of 1,300 pages


def _wide_inputs(rng, group, shards=1):
    """K/V of WIDE_PAGES pages (2 kv heads, head_dim 16), tables of
    WIDE_P + 1 columns whose live pages are distinct per sequence; with
    ``shards`` > 1 each live column draws its page from a random shard."""
    local = WIDE_PAGES // shards
    free = [list(rng.permutation(np.arange(max(1, s * local), (s + 1) * local)))
            for s in range(shards)]
    tables = rng.integers(1, WIDE_PAGES, size=(len(WIDE_CTX), WIDE_P + 1)).astype(np.int32)
    tables[:, WIDE_P] = 0
    for i, c in enumerate(WIDE_CTX):
        for col in range(-(-c // WIDE_PS)):
            tables[i, col] = free[int(rng.integers(shards))].pop()
    k = rng.normal(size=(WIDE_PAGES * WIDE_PS, N_KV, HD)).astype(np.float32)
    v = rng.normal(size=(WIDE_PAGES * WIDE_PS, N_KV, HD)).astype(np.float32)
    q = rng.normal(size=(len(WIDE_CTX), N_KV * group, HD)).astype(np.float32)
    return q, k, v, tables, np.asarray(WIDE_CTX, np.int32)


def test_decode_plan_at_a_wide_table():
    """``decode_plan`` at 2,049 columns, by its docstring's arithmetic:
    min(ceil(2 * 132 / n_kv), floor(2049 / 4)) splits of ceil(2049 / S)
    columns, then the count shrunk so that no split is empty."""
    p = WIDE_P + 1
    for shape, (splits, cols) in (((8, 32, 8, 128), (33, 63)),  # the 8B
                                  ((8, 64, 8, 128), (33, 63)),  # the 70B: group 8
                                  ((8, 4, 1, 128), (257, 8))):  # tp=16: one shard's call
        b, n_q, n_kv, hd = shape
        want = max(1, min(-(-2 * tpa.SMS // n_kv), p // tpa.DECODE_MIN_COLS))
        assert -(-p // -(-p // want)) == splits and -(-p // want) == cols
        plan = tpa.decode_plan(b, n_q, n_kv, hd, p)
        assert (plan.splits, plan.cols) == (splits, cols)
        assert plan.workspace_floats == b * n_q * splits * (hd + 2)
    # The 32k row's 2,048 live columns reach every split; a 1,000-token row
    # only the first.
    assert -(-2048 // 63) == 33 and -(-(-(-1000 // 16)) // 63) == 1


@pytest.mark.parametrize("group", [4, 8])
def test_decode_split_path_at_a_wide_table(group):
    """K1 at the 8B's (group 4) and the 70B's (group 8) split of a 2,049-column
    table, one row at 32,767 keys: against the plain version."""
    rng = np.random.default_rng(160 + group)
    q, k, v, tables, ctx = _wide_inputs(rng, group)
    cols = tpa.decode_plan(8, 8 * group, 8, 128, WIDE_P + 1).cols
    got, parts = emulate_decode(_t(q), _t(k), _t(v), _t(tables), _t(ctx), WIDE_PS, cols)
    want = tpa.plain_paged_attention(_t(q)[:, None], _t(k), _t(v), _t(tables), _t(ctx),
                                     None, WIDE_PS)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.all(got[1] == 0)  # ctx 0
    assert torch.all(parts[2][:, 0] > 0)  # the 32k row: every split live
    assert torch.all(parts[2][1:, 5] == 0)  # 1,000 tokens: the first split only


def test_decode_partial_at_a_wide_table():
    """K4 at the tp=16 call's split (257 splits of 8 columns) on two page
    shards of a 2,049-column table, the 32k row's pages drawn over both:
    each shard's (acc, m, l) against the plain partial, their merge against
    K1's plain version on the whole pool."""
    rng = np.random.default_rng(170)
    q, k, v, tables, ctx = _wide_inputs(rng, 4, shards=2)
    cols = tpa.decode_plan(8, 4, 1, 128, WIDE_P + 1).cols
    local = WIDE_PAGES // 2
    halves = []
    for shard in range(2):
        sl = slice(shard * local * WIDE_PS, (shard + 1) * local * WIDE_PS)
        (acc, m, l), _ = emulate_decode(_t(q), _t(k[sl]), _t(v[sl]), _t(tables), _t(ctx),
                                        WIDE_PS, cols, shard=shard, pages_local=local)
        plain = tpa.paged_decode_attention_partial(_t(q), _t(k[sl]), _t(v[sl]), _t(tables),
                                                   _t(ctx), shard, WIDE_PS, local)
        for got, want in zip((acc, m, l), plain):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        assert torch.all(l[0] > 0)  # the 32k row has pages on both shards
        halves.append((acc, m, l))
    whole = tpa.plain_paged_attention(_t(q)[:, None], _t(k), _t(v), _t(tables), _t(ctx),
                                      None, WIDE_PS)[:, 0]
    np.testing.assert_allclose(tpa.merge_partials(halves, torch.device("cpu")).numpy(),
                               whole.numpy(), **TOL)


# ------------------------------------------------- chip_smoke's profile


def test_chip_smoke_classes_the_decode_kernels():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ns = "void (anonymous namespace)::"
    new = ns + ("decode_attention_mma_kernel<__nv_bfloat16, 128, false, (anonymous "
                "namespace)::DecodeArgs>((anonymous namespace)::DecodeArgs)")
    new_k3 = ns + ("decode_attention_mma_kernel<signed char, 64, false, (anonymous "
                   "namespace)::DecodeInt8Args>((anonymous namespace)::DecodeInt8Args)")
    removed = ns + ("paged_attention_kernel<__nv_bfloat16, __nv_bfloat16, false, false>("
                    "(anonymous namespace)::Args)")
    k3 = ns + "paged_attention_kernel<__nv_bfloat16, signed char, false, false>((anonymous namespace)::Args)"
    f32 = ns + "paged_attention_kernel<float, float, false, false>((anonymous namespace)::Args)"
    f32_k3 = ns + "paged_attention_kernel<float, signed char, false, false>((anonymous namespace)::Args)"
    assert chip_smoke.kernel_class(new) == "decode_attention"
    assert chip_smoke.kernel_class(removed) == "decode_attention"
    assert chip_smoke.kernel_class(k3) == "decode_attention_int8"
    assert chip_smoke.kernel_class(new_k3) == "decode_attention_int8"
    assert chip_smoke.kernel_class(f32_k3) == "decode_attention_int8"
    assert chip_smoke.removed_bf16(removed) == "decode"
    assert chip_smoke.removed_bf16(k3) == "decode_int8"  # K3's CUDA-core version
    assert [chip_smoke.removed_bf16(n) for n in (new, new_k3, f32, f32_k3)] == [None] * 4
