"""W1's tile list (``ragged_plan``) and an f32 emulation of the ragged
kernel's schedule, on the CPU.

The kernel (``csrc/ragged_attention.cu``) runs only on the card; here its
host side and its arithmetic are held against the plain version and the
Pallas ``paged_ragged_attention(interpret=True)``: the list at the serving
configuration's mixed shape and at this file's shapes (each tile inside one
run, every (token, head) row covered once, heaviest first, counts from
shapes only, at most 16 one-block runs split, each in a workspace slot of
its own), the tile list kernel's schedule emulated step by step and held
record for record against the plain list, and the kernel's walk emulated
in f32 from that list: prefill
tiles of up to 128 rows over 64-key tiles with per-row causal limits, one-block
tiles in key groups combined in order, their splits over key ranges merged in
split order, score columns and P scaled over int8 pools. Inputs are made with
numpy from a seed.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu_torch.ops import attention as tattn
from runbookai_tpu_torch.ops import paged_attention as tpa
from test_torch_ragged_attention import HD, PS, RQ, TOL, _pad_blocks, _t, ragged_case

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

KEYS = 64  # keys of a K/V tile


def serving_layout(dec_ctx, pf_len, pf_start=4096, slots=8, pf_tokens=512, rows=13,
                   trash=8192):
    """The serving configuration's mixed batch as ``chip_smoke.py``'s
    ragged inputs lay it out: one block per decode slot (None: a free slot,
    a pad block of the null row), then a ``pf_len``-token prefill row at
    ``pf_start`` in the ``pf_tokens`` budget, the rest pad blocks. Returns
    numpy (row_ids, positions, ctx)."""
    n = slots * RQ + pf_tokens
    row_ids = np.full(n, rows - 1, np.int32)
    pos = np.full(n, trash, np.int32)
    ctx = np.zeros(rows, np.int32)
    for s, c in enumerate(dec_ctx):
        if c:
            row_ids[s * RQ:(s + 1) * RQ] = s
            pos[s * RQ] = c - 1
            ctx[s] = c
    off = slots * RQ
    pos[off:off + pf_len] = np.arange(pf_start, pf_start + pf_len)
    row_ids[off:off + -(-pf_len // RQ) * RQ] = slots
    ctx[slots] = pf_start + pf_len
    return row_ids, pos, ctx


SERVED = [83, 150, 266, 397, 512, 640, 800, 942]
LONG = [1, 16, 17, 1000, 8191, 300, 4097, None]


def _plan(rows, pos, ctx, n_q, n_kv, hd, p, ps):
    return tpa.ragged_plan(_t(rows), _t(ctx), _t(pos), n_q, n_kv, hd, p, ps, RQ)


def _runs(rows):
    """(first token, tokens) of each run of equal-row blocks."""
    blocks = rows.reshape(-1, RQ)[:, 0]
    runs, start = [], 0
    for b in range(1, len(blocks) + 1):
        if b == len(blocks) or blocks[b] != blocks[start]:
            runs.append((start * RQ, (b - start) * RQ))
            start = b
    return runs


def _live_tiles(plan):
    return plan.tiles[:int(plan.live)].tolist()


def test_ragged_plan_at_the_serving_mixed_shape():
    """8 decode rows at the served contexts and a 512-token prefill at offset
    4096 (N = 576, 32 query / 8 kv heads, head_dim 128, 513-column tables):
    16 prefill tiles of 128 rows and 8 one-block tiles of 32 rows per kv
    head, none split; 132 persistent blocks; about 70k key visits per kv
    head for the prefill, where 32-row blocks of 8 tokens walked 279k."""
    rows, pos, ctx = serving_layout(SERVED, 512)
    plan = _plan(rows, pos, ctx, 32, 8, 128, 513, 16)
    shape = plan.shape
    assert (shape.ctas, shape.keys_per_split, shape.max_splits) == (132, 1088, 8)
    tiles = _live_tiles(plan)
    assert len(tiles) == 8 * (16 + 8)
    prefill = [t for t in tiles if t[7] == 0]
    decode = [t for t in tiles if t[7] > 0]
    assert len(prefill) == 128 and all(t[4] == 128 for t in prefill)
    assert len(decode) == 64 and all((t[4], t[6], t[7]) == (32, 0, 1) for t in decode)
    assert tiles[:128] == prefill  # every prefill tile walks more keys than any decode tile
    visits = sum(t[5] for t in prefill) // 8
    assert visits == sum(4096 + 32 * (i + 1) for i in range(16))  # 69,888
    old = sum(min(4608, 4096 + 8 * b + 8) for b in range(64))  # K2 at [N / 8, 8]: per 8 tokens
    assert old == 278784 and old > 3.9 * visits


@pytest.mark.parametrize("kind", ["served", "long"])
@pytest.mark.parametrize("geo", [(32, 8, 128), (28, 4, 128), (32, 8, 64), (64, 8, 128)])
def test_ragged_plan_covers_each_row_once(kind, geo):
    """Each tile lies inside one run; the prefill tiles and the first split
    of each one-block tile cover every (token, head) row of every run once;
    a one-block tile's splits partition its keys in order; live tiles come
    first, heaviest first."""
    n_q, n_kv, hd = geo
    group = n_q // n_kv
    dec, pf = (SERVED, 512) if kind == "served" else (LONG, 500)
    rows, pos, ctx = serving_layout(dec, pf)
    plan = _plan(rows, pos, ctx, n_q, n_kv, hd, 513, 16)
    runs = _runs(rows)
    starts = {s: t for s, t in runs}
    cover = np.zeros((len(rows), n_q), np.int64)
    keys: dict = {}
    slots: dict = {}
    for row, tok0, kvh, r0, nr, hi, split, nsplits, slot in _live_tiles(plan):
        assert tok0 in starts and rows[tok0] == row
        assert 0 <= r0 and r0 + nr <= starts[tok0] * group and nr <= 128
        if nsplits > 1:
            assert slots.setdefault(slot, tok0) == tok0  # one run a workspace slot
        else:
            assert slot == 0
        if nsplits:
            assert starts[tok0] == RQ and (r0, nr) == (0, RQ * group)
            lo = split * plan.shape.keys_per_split
            keys.setdefault((tok0, kvh), []).append((split, nsplits, lo, hi))
            if split:
                continue
        rr = r0 + np.arange(nr)
        np.add.at(cover, (tok0 + rr // group, kvh * group + rr % group), 1)
    assert (cover == 1).all()
    kps = plan.shape.keys_per_split
    for (tok0, _), splits in keys.items():
        splits.sort()
        n = splits[0][1]
        bound = max(0, min(int(ctx[rows[tok0]]), 513 * 16, int(pos[tok0]) + RQ))
        assert [x[0] for x in splits] == list(range(n)) and n == max(1, -(-bound // kps))
        assert [(lo, hi) for *_, lo, hi in splits] == \
            [(x * kps, min(bound, (x + 1) * kps)) for x in range(n)]
    w = plan.weight.tolist()
    live = int(plan.live)
    assert all(x >= 0 for x in w[:live]) and all(x == -1 for x in w[live:])
    assert w[:live] == sorted(w[:live], reverse=True)
    assert not plan.tiles[live:].any()
    # The split runs' slots: their ranks in the batch's order.
    assert [slots[x] for x in sorted(slots)] == sorted(slots.values())
    assert sorted(slots) == list(range(len(slots)))
    if kind == "long":  # the 8191-token decode row splits, the 1-token one does not
        assert max(s[0][1] for s in keys.values()) == plan.shape.max_splits


def test_ragged_plan_depends_on_shapes_only():
    """Two batches of the same shapes (other contexts, other layouts) give
    the same capacity, CTA count, split size and record shape; the same
    batch gives the same list twice."""
    a = _plan(*serving_layout(SERVED, 512), 32, 8, 128, 513, 16)
    b = _plan(*serving_layout(LONG, 500), 32, 8, 128, 513, 16)
    assert a.shape == b.shape and a.tiles.shape == b.tiles.shape
    assert int(a.live) != int(b.live)
    again = _plan(*serving_layout(SERVED, 512), 32, 8, 128, 513, 16)
    assert torch.equal(a.tiles, again.tiles) and torch.equal(a.live, again.live)


def emulate_plan_kernel(rows, pos, ctx, shape, n_kv, key_max):
    """``ragged_plan.cu``'s kernel step by step in numpy: the blocks' rows
    and positions, each run's length and key bound at its first block, the
    wide one-block runs' ranks and the tile counts by exclusive prefix sums,
    each run's tiles at its offset, each live tile's place by counting the
    heavier tiles and the earlier ones as heavy, the records written for
    every kv head. Returns (tiles, live, weight)."""
    rq, group, ks = shape.rq, shape.group, shape.keys_per_split
    per_head = shape.capacity // n_kv
    nb = len(rows) // rq
    brow, bpos = rows[::rq].astype(np.int64), pos[::rq].astype(np.int64)
    length, hi = np.zeros(nb, np.int64), np.zeros(nb, np.int64)
    for b in range(nb):
        if b == 0 or brow[b] != brow[b - 1]:
            n = 1
            while b + n < nb and brow[b + n] == brow[b]:
                n += 1
            length[b] = n
            hi[b] = max(0, min(min(int(ctx[brow[b]]), key_max), bpos[b + n - 1] + rq))
    wide = (length == 1) & (hi > ks)
    slot = np.cumsum(wide) - wide  # exclusive
    count = np.where(length == 1, np.where(wide & (slot < shape.split_runs), -(-hi // ks), 1),
                     np.where(length > 1, -(-length * rq * group // 128), 0))
    off = np.cumsum(count) - count
    total = int(count.sum())

    def record(b, loc):
        if length[b] == 1:
            split = count[b] > 1
            lo = loc * ks if split else 0
            h = min(hi[b], (loc + 1) * ks) if split else hi[b]
            return ([brow[b], b * rq, 0, 0, rq * group, h, loc if split else 0, count[b],
                     slot[b] if split else 0], h - lo)
        r0 = loc * 128
        nr = min(128, length[b] * rq * group - r0)
        tok_last = (r0 + nr - 1) // group
        pos_last = bpos[b + tok_last // rq] + tok_last % rq
        h = max(0, min(min(int(ctx[brow[b]]), key_max), pos_last + 1))
        return [brow[b], b * rq, 0, r0, nr, h, 0, 0, 0], h

    recs = [record(b, loc) for b in range(nb) for loc in range(count[b])]
    assert [off[b] + loc for b in range(nb) for loc in range(count[b])] == list(range(total))
    w = [x[1] for x in recs]
    tiles = np.zeros((per_head * n_kv, tpa.RAGGED_FIELDS), np.int64)
    weight = np.full(per_head * n_kv, -1, np.int64)
    for i, (f, wi) in enumerate(recs):
        place = sum(wj > wi or (wj == wi and j < i) for j, wj in enumerate(w))
        for h in range(n_kv):
            tiles[place * n_kv + h] = f
            tiles[place * n_kv + h, 2] = h
            weight[place * n_kv + h] = wi
    return tiles, total * n_kv, weight


def many_wide_runs(slots: int = 18, ctx_len: int = 700, pf_len: int = 20):
    """``slots`` decode rows whose keys exceed one split (700 keys and up,
    at 640 a split of 300-column tables of 16-token pages), a ``pf_len``-token prefill at offset 900 and two pad blocks;
    numpy (row_ids, positions, ctx)."""
    rows, pos = [], []
    ctx = [ctx_len + s for s in range(slots)] + [900 + pf_len, 0]
    for s in range(slots):
        rows += [s] * RQ
        pos += [ctx[s] - 1] + [4000] * (RQ - 1)
    rows += [slots] * (-(-pf_len // RQ) * RQ)
    pos += list(range(900, 900 + pf_len)) + [4000] * (-pf_len % RQ)
    rows += [slots + 1] * (2 * RQ)
    pos += [4000] * (2 * RQ)
    return np.array(rows, np.int32), np.array(pos, np.int32), np.array(ctx, np.int32)


LAYOUTS = {"served": lambda: serving_layout(SERVED, 512),
           "long": lambda: serving_layout(LONG, 500),
           "many_wide_runs": many_wide_runs,
           "one_block_prefill": lambda: serving_layout([None] * 8, 5)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("geo", [(32, 8, 128), (28, 4, 128), (8, 8, 64), (64, 8, 128)])
def test_plan_kernel_schedule_gives_the_plain_list(layout, geo):
    """The tile list kernel's schedule, emulated, writes the plain list
    record for record (records, live count, weights), the dead records
    zero."""
    n_q, n_kv, hd = geo
    rows, pos, ctx = LAYOUTS[layout]()
    p = 513 if layout != "many_wide_runs" else 300
    plan = _plan(rows, pos, ctx, n_q, n_kv, hd, p, 16)
    tiles, live, weight = emulate_plan_kernel(rows, pos, ctx, plan.shape, n_kv, p * 16)
    assert live == int(plan.live)
    np.testing.assert_array_equal(plan.tiles.numpy(), tiles)
    np.testing.assert_array_equal(plan.weight.numpy(), weight)
    assert plan.tiles.dtype == plan.live.dtype == plan.weight.dtype == torch.int32


def test_split_runs_are_bounded_by_shapes():
    """Of 18 wide one-block runs the first 16 split (workspace slots 0 to
    15, in the batch's order) and the last two walk all their keys in one
    tile; the workspace holds 16 runs' partials whatever the batch, 17.0 MB
    at the serving shape where a slot per block took 76.7 MB; the capacity
    bounds the live tiles of a batch made only of wide runs."""
    rows, pos, ctx = many_wide_runs()
    plan = _plan(rows, pos, ctx, 8, 2, 16, 300, 16)
    assert plan.shape.split_runs == tpa.RAGGED_SPLIT_RUNS == 16
    assert plan.shape.keys_per_split == 640
    one_block = {}
    for row, tok0, kvh, r0, nr, hi, split, nsplits, slot in _live_tiles(plan):
        if nsplits:
            one_block.setdefault(tok0 // RQ, set()).add((nsplits, slot, hi if nsplits == 1
                                                         else None))
    for s in range(18):
        (nsplits, slot, hi), = one_block[s]
        if s < 16:
            assert (nsplits, slot, hi) == (2, s, None)
        else:
            assert (nsplits, slot, hi) == (1, 0, int(ctx[s]))
    served = tpa.ragged_shape(576, 32, 8, 128, 513, 16)
    assert served.workspace_floats == 16 * 8 * 8 * 32 * 130  # 17,039,360 B of f32
    assert served.counters == 2 + 16 * 8
    assert 72 * 8 * 8 * 32 * 130 * 4 > 4.4 * served.workspace_floats * 4
    crowded = many_wide_runs(slots=30, pf_len=8)  # nothing but one-block runs, all wide
    plan = _plan(*crowded, 8, 2, 16, 300, 16)
    assert int(plan.live) <= plan.shape.capacity
    assert sum(t[7] > 1 for t in _live_tiles(plan)) == 16 * 2 * 2


@pytest.mark.parametrize("group", [1, 4])
def test_emulated_kernel_past_the_split_runs(group):
    """The emulated kernel on a batch with more wide runs than split, at
    1e-4 of the plain version, pad blocks exactly zero."""
    rows, pos, ctx = many_wide_runs()
    rng = np.random.default_rng(50 + group)
    n_kv, hd, ps, p = 2, 16, 16, 300
    num_pages = 1000
    k = rng.standard_normal((num_pages * ps, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages * ps, n_kv, hd)).astype(np.float32)
    tables = np.zeros((len(ctx), p), np.int32)
    perm, nxt = rng.permutation(np.arange(1, num_pages)), 0
    for r, c in enumerate(ctx):
        need = -(-int(c) // ps)
        tables[r, :need] = perm[nxt:nxt + need]
        nxt += need
    q = rng.standard_normal((len(rows), n_kv * group, hd)).astype(np.float32)
    kp, vp = _t(k).to(torch.bfloat16).float(), _t(v).to(torch.bfloat16).float()
    plan = _plan(rows, pos, ctx, n_kv * group, n_kv, hd, p, ps)
    got = emulate_ragged_kernel(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), plan, ps)
    assert not got.isnan().any()
    plain = tpa.plain_ragged_attention(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), _t(rows),
                                       ps, RQ)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    pads = _pad_blocks(rows, ctx)
    assert pads and not got.numpy()[pads].any()


def _row_warps(nr):
    w = -(-nr // 16)
    return 1 if w <= 1 else 2 if w <= 2 else 4 if w <= 4 else 8


def emulate_ragged_kernel(q, k, v, tables, ctx, pos, plan, ps):
    """The ragged kernel's walk over ``plan``'s live tiles, in f32 (P exact;
    the kernel's P in two bf16 parts is exact to about 2**-16). Rows no tile
    writes stay NaN."""
    kv, ks = (k if isinstance(k, tuple) else (k, None))
    vv, vs = (v if isinstance(v, tuple) else (v, None))
    kv, vv = kv.float(), vv.float()
    q = q.float()
    n, n_q, hd = q.shape
    group = n_q // kv.shape[1]
    rq, kps = plan.shape.rq, plan.shape.keys_per_split
    scale_log2 = 1.0 / math.sqrt(hd) * math.log2(math.e)
    out = torch.full_like(q, float("nan"))
    parts: dict = {}
    for row, tok0, kvh, r0, nr, hi, split, nsplits, slot in _live_tiles(plan):
        lo = split * kps if nsplits else 0
        rr = r0 + torch.arange(nr)
        tok = tok0 + rr // group
        head = kvh * group + rr % group
        lim = torch.clamp(pos[tok - tok % rq].long() + tok % rq + 1, max=hi)
        qq = q[tok, head]
        kg_n = 8 // _row_warps(nr) if nsplits else 1
        m = torch.full((kg_n, nr), -1e30)
        l = torch.zeros(kg_n, nr)
        o = torch.zeros(kg_n, nr, hd)
        n_tiles = -(-(hi - lo) // KEYS) if hi > lo else 0
        for it in range(n_tiles):
            kg = it % kg_n
            key = lo + it * KEYS + torch.arange(KEYS)
            live = key < hi
            safe = torch.where(live, key, 0)
            prow = tables[row, safe // ps].long() * ps + safe % ps
            s = qq @ kv[prow, kvh].T * scale_log2
            if ks is not None:
                s = s * ks[prow, kvh]
            mask = (key[None, :] < lim[:, None]) & live[None, :]
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m[kg], s.amax(1))
            alpha = torch.exp2(m[kg] - m_new)
            p = torch.where(mask, torch.exp2(s - m_new[:, None]), 0.0)
            l[kg] = l[kg] * alpha + p.sum(1)
            if vs is not None:
                p = p * vs[prow, kvh]
            o[kg] = o[kg] * alpha[:, None] + p @ vv[prow, kvh]
            m[kg] = m_new
        mx = m.amax(0)
        w = torch.exp2(m - mx)  # the key groups, combined in order
        den = (l * w).sum(0)
        acc = (o * w[..., None]).sum(0)
        if nsplits > 1:  # the kernel's workspace holds a split run's partials by slot
            part = parts.setdefault((slot, kvh), {})
            assert split not in part and all(x[3][0] == tok[0] for x in part.values())
            part[split] = (acc, mx, den, tok, head, nsplits)
        else:
            out[tok, head] = acc / den.clamp_min(1e-30)[:, None]
    for splits in parts.values():
        assert sorted(splits) == list(range(next(iter(splits.values()))[5]))
        ordered = [splits[s] for s in sorted(splits)]
        mx = torch.stack([x[1] for x in ordered]).amax(0)
        w = [torch.exp2(x[1] - mx) for x in ordered]
        den = sum(x[2] * wi for x, wi in zip(ordered, w))
        acc = sum(x[0] * wi[:, None] for x, wi in zip(ordered, w))
        _, _, _, tok, head, _ = ordered[0]
        out[tok, head] = acc / den.clamp_min(1e-30)[:, None]
    return out


def _dequantized(pool):
    return (pool[0].float() * pool[1][..., None]).numpy()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group", [1, 4, 7, 8])
def test_emulated_kernel_matches_plain_and_pallas(group, int8):
    """The emulated schedule over this file's mixed batch (decode rows, a
    free slot, a two-block prefill, a one-block chunk, a pad block) against
    the plain version and the Pallas ``paged_ragged_attention`` in interpret
    mode, every token, at 1e-4; pad blocks exactly zero. The pools hold
    bf16 values (what the kernel reads), or are int8 (Pallas then reads them
    dequantized)."""
    (q, k, v, tables, ctx, pos, rows), _ = ragged_case(30 + group, n_kv=2, group=group)
    if int8:
        kp, vp = tattn.quantize_kv(_t(k)), tattn.quantize_kv(_t(v))
        jk, jv = _dequantized(kp), _dequantized(vp)
    else:
        kp = _t(k).to(torch.bfloat16).float()
        vp = _t(v).to(torch.bfloat16).float()
        jk, jv = kp.numpy(), vp.numpy()
    n_q = q.shape[1]
    plan = _plan(rows, pos, ctx, n_q, 2, HD, tables.shape[1], PS)
    got = emulate_ragged_kernel(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), plan, PS)
    assert not got.isnan().any()
    plain = tpa.plain_ragged_attention(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), _t(rows),
                                       PS, RQ)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    want = np.asarray(jpallas.paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv),
        *map(jnp.asarray, (tables, ctx, pos, rows)), page_size=PS, ragged_block=RQ,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pads = _pad_blocks(rows, ctx)
    assert pads and not got.numpy()[pads].any()


def long_case(seed: int, group: int, n_kv: int = 2, hd: int = 16, ps: int = 16):
    """A mixed batch whose one-block tiles split: decode rows at contexts
    1200, 513 and 1 (in three, two and one splits at 512 keys a split), a
    free slot, a 40-token prefill at offset 900 (one to three 128-row tiles
    at groups 1 to 7) and a pad block; 200-column tables of 16-token pages."""
    rng = np.random.default_rng(seed)
    n_q, p, num_pages = n_kv * group, 200, 400
    k = rng.standard_normal((num_pages * ps, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages * ps, n_kv, hd)).astype(np.float32)
    ctx = np.array([1200, 513, 1, 0, 940, 0], np.int32)
    tables = np.zeros((len(ctx), p + 1), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    nxt = 0
    for r, c in enumerate(ctx):
        need = -(-int(c) // ps)
        tables[r, :need] = perm[nxt:nxt + need]
        nxt += need
    trash = p * ps
    rows, pos = [], []
    for r, c in ((0, 1200), (1, 513), (2, 1), (5, 0)):
        rows += [r] * RQ
        pos += [c - 1 if c else trash] + [trash] * (RQ - 1)
    rows += [4] * 40
    pos += list(range(900, 940))
    rows += [5] * RQ
    pos += [trash] * RQ
    q = rng.standard_normal((len(rows), n_q, hd)).astype(np.float32)
    return q, k, v, tables, ctx, np.array(pos, np.int32), np.array(rows, np.int32), ps


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group", [1, 4, 7, 8])
def test_emulated_splits_merge_in_order(group, int8):
    """Long decode rows split over key ranges (512 keys a split at these
    200-column tables); the emulated splits, merged in split order, against
    the plain version at 1e-4, pad blocks exactly zero."""
    q, k, v, tables, ctx, pos, rows, ps = long_case(40 + group, group)
    kp, vp = ((tattn.quantize_kv(_t(k)), tattn.quantize_kv(_t(v))) if int8
              else (_t(k).to(torch.bfloat16).float(), _t(v).to(torch.bfloat16).float()))
    plan = _plan(rows, pos, ctx, q.shape[1], 2, q.shape[2], tables.shape[1], ps)
    assert plan.shape.keys_per_split == 512
    splits = {t[1]: t[7] for t in _live_tiles(plan) if t[7]}
    assert splits[0] == 3 and splits[8] == 2 and splits[16] == 1
    got = emulate_ragged_kernel(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), plan, ps)
    assert not got.isnan().any()
    plain = tpa.plain_ragged_attention(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), _t(rows),
                                       ps, RQ)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    pads = _pad_blocks(rows, ctx)
    assert pads and not got.numpy()[pads].any()


# A 2,048-column table (+ the trash column): max_seq_len 32,768 of 16-token pages.
WIDE_P, WIDE_PS = 2049, 16


def test_ragged_shape_at_a_wide_table():
    """``ragged_shape`` at 2,049 columns, by its docstring's arithmetic: a
    one-block tile's keys split into ranges of 64 * max(8, ceil(2049 * 16 /
    512)) = 4,160 keys, at most 8 of them; the capacity bounds one tile a
    one-block run, 7 more for each of 16 split runs and the prefill tiles, per
    kv head; the 8B's (group 4) and the 70B's (group 8) serving mixed batch
    of N = 576."""
    for (n_q, n_kv), prefill_tiles in (((32, 8), 18), ((64, 8), 36)):
        group = n_q // n_kv
        shape = tpa.ragged_shape(576, n_q, n_kv, 128, WIDE_P, WIDE_PS)
        keys = 64 * max(512 // 64, -(-WIDE_P * WIDE_PS // (64 * 8)))
        assert (shape.keys_per_split, shape.max_splits) == (keys, 8) == (4160, 8)
        assert -(-72 * RQ * group // 128) == prefill_tiles
        per_head = 72 + 16 * 7 + prefill_tiles
        assert (shape.capacity, shape.ctas) == (n_kv * per_head, min(n_kv * per_head,
                                                                     tpa.SMS))
        assert (shape.split_runs, shape.counters) == (16, 2 + 16 * n_kv)
        assert shape.workspace_floats == 16 * n_kv * 8 * RQ * group * 130


def wide_case(seed: int, group: int, n_kv: int = 2, hd: int = 16,
              pf_start: int = 16_000, pf_len: int = 24):
    """A mixed batch over 2,049-column tables: decode rows at 32,767, 83 and
    1 keys, a free slot, a ``pf_len``-token prefill at offset ``pf_start``
    and a pad block."""
    rng = np.random.default_rng(seed)
    ps, p = WIDE_PS, WIDE_P
    ctx = np.array([32_767, 83, 1, 0, pf_start + pf_len, 0], np.int32)
    num_pages = max(3_200, sum(-(-int(c) // ps) for c in ctx) + 1)
    k = rng.standard_normal((num_pages * ps, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages * ps, n_kv, hd)).astype(np.float32)
    tables = np.zeros((len(ctx), p), np.int32)
    perm, nxt = rng.permutation(np.arange(1, num_pages)), 0
    for r, c in enumerate(ctx):
        need = -(-int(c) // ps)
        tables[r, :need] = perm[nxt:nxt + need]
        nxt += need
    trash = (p - 1) * ps
    rows, pos = [], []
    for r, c in ((0, 32_767), (1, 83), (2, 1), (5, 0)):
        rows += [r] * RQ
        pos += [c - 1 if c else trash] + [trash] * (RQ - 1)
    rows += [4] * pf_len + [5] * RQ
    pos += list(range(pf_start, pf_start + pf_len)) + [trash] * RQ
    q = rng.standard_normal((len(rows), n_kv * group, hd)).astype(np.float32)
    return q, k, v, tables, ctx, np.array(pos, np.int32), np.array(rows, np.int32)


@pytest.mark.parametrize("group", [4, 8])
def test_emulated_kernel_at_a_wide_table(group):
    """The emulated schedule with one decode row at a 32k context: its
    one-block tile splits into all 8 key ranges of 4,160 keys, merged in
    order; every token against the plain version at 1e-4, pad blocks
    exactly zero."""
    q, k, v, tables, ctx, pos, rows = wide_case(60 + group, group)
    kp, vp = _t(k).to(torch.bfloat16).float(), _t(v).to(torch.bfloat16).float()
    plan = _plan(rows, pos, ctx, q.shape[1], 2, q.shape[2], WIDE_P, WIDE_PS)
    splits = {t[1]: t[7] for t in _live_tiles(plan) if t[7]}
    assert splits[0] == plan.shape.max_splits == 8 and splits[8] == splits[16] == 1
    got = emulate_ragged_kernel(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), plan, WIDE_PS)
    assert not got.isnan().any()
    plain = tpa.plain_ragged_attention(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), _t(rows),
                                       WIDE_PS, RQ)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    pads = _pad_blocks(rows, ctx)
    assert pads and not got.numpy()[pads].any()


@pytest.mark.parametrize("group", [4, 8])
def test_emulated_long_prefill_at_a_wide_table(group):
    """A 32k prompt's last chunk in the mixed batch: 128 prefill tokens at
    offset 32,640 (ctx 32,768) beside the 32,767-key decode row. The prefill
    is not split: each of its tiles walks every key below its rows'
    positions, about 32.7k, in one run. Every token against the plain
    version at 1e-4, pad blocks exactly zero."""
    q, k, v, tables, ctx, pos, rows = wide_case(70 + group, group, pf_start=32_640,
                                                pf_len=128)
    kp, vp = _t(k).to(torch.bfloat16).float(), _t(v).to(torch.bfloat16).float()
    plan = _plan(rows, pos, ctx, q.shape[1], 2, q.shape[2], WIDE_P, WIDE_PS)
    prefill = [t for t in _live_tiles(plan) if t[0] == 4]
    assert prefill and all(t[7] == 0 for t in prefill)
    assert max(t[5] for t in prefill) == 32_768
    assert len(prefill) == 2 * -(-128 * group // 128)
    got = emulate_ragged_kernel(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), plan, WIDE_PS)
    assert not got.isnan().any()
    plain = tpa.plain_ragged_attention(_t(q), kp, vp, _t(tables), _t(ctx), _t(pos), _t(rows),
                                       WIDE_PS, RQ)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    pads = _pad_blocks(rows, ctx)
    assert pads and not got.numpy()[pads].any()


def test_ragged_tile_attention_on_the_cpu_is_the_plain_version():
    """On CPU tensors the per-layer launch and the whole call compute the
    plain version and count no launch."""
    (q, k, v, tables, ctx, pos, rows), _ = ragged_case(5, n_kv=2, group=4)
    plan = _plan(rows, pos, ctx, q.shape[1], 2, HD, tables.shape[1], PS)
    tpa.reset_launches()
    got = tpa.ragged_tile_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), _t(pos),
                                    _t(rows), plan, PS)
    whole = tpa.paged_ragged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), _t(pos),
                                       _t(rows), PS, ragged_block=RQ)
    plain = tpa.plain_ragged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), _t(pos),
                                       _t(rows), PS, RQ)
    assert torch.equal(got, plain) and torch.equal(whole, plain)
    assert tpa.launches["paged_ragged_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_ragged_builds_no_tile_list_on_the_cpu(monkeypatch, dtype):
    """The mixed forward builds W1's tile list only where the ragged kernel
    reads it: on CPU tensors each layer runs the plain version, with no
    list."""
    from runbookai_tpu_torch.models import llama as tllama

    cfg = tllama.CONFIGS["llama3-test"]
    params = tllama.init_params(cfg, dtype=dtype, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    ps, rq = 4, RQ
    shape = (cfg.n_layers, 16 * ps, cfg.n_kv_heads, cfg.head_dim)
    k0 = _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    v0 = _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    tables = _t(np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0]], np.int32))
    tokens = torch.zeros(3 * rq, dtype=torch.long)
    positions = torch.full((3 * rq,), 2 * ps, dtype=torch.int32)
    row_ids = _t(np.repeat(np.arange(3, dtype=np.int32), rq))
    tokens[0], positions[0] = 7, 4
    tokens[rq:rq + 5] = torch.arange(1, 6)
    positions[rq:rq + 5] = torch.arange(5, dtype=torch.int32)
    ctx = _t(np.array([5, 5, 0], np.int32))
    sel = torch.tensor([0, rq + 4])

    def no_list(*args, **kwargs):
        raise AssertionError("a tile list was built for the plain version")

    monkeypatch.setattr(tllama, "ragged_plan", no_list)
    got = tllama.forward_ragged_impl(params, cfg, tokens, positions, row_ids, k0, v0, tables,
                                     ctx, sel, ps, ragged_block=rq)
    assert got.shape == (2, cfg.vocab_size) and got.isfinite().all()


def test_chip_smoke_classes_w1_and_its_tile_list_apart():
    """The profile's classes: W1's kernel over bf16 and int8 pools, its tile
    list's kernel in a class of its own, neither a removed instantiation."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    ns = "void (anonymous namespace)::"
    cases = {"ragged_attention_kernel<__nv_bfloat16, 128>((anonymous namespace)::RaggedArgs)":
             "ragged_attention",
             "ragged_attention_kernel<signed char, 64>((anonymous namespace)::RaggedArgs)":
             "ragged_attention_int8",
             "ragged_plan_kernel((anonymous namespace)::PlanArgs)": "ragged_plan"}
    for name, cls in cases.items():
        assert chip_smoke.kernel_class(ns + name) == cls
        assert chip_smoke.removed_bf16(ns + name) is None
    assert chip_smoke.PLAN_KERNEL in ns + "ragged_plan_kernel((anonymous namespace)::PlanArgs)"


def test_ragged_route():
    assert tpa.ragged_route(torch.bfloat16, 128, 4, 8) == "mma"
    assert tpa.ragged_route(torch.bfloat16, 64, 16, 8) == "mma"
    assert tpa.ragged_route(torch.float32, 128, 4, 8) == "cuda_core"
    with pytest.raises(ValueError):
        tpa.ragged_route(torch.bfloat16, 128, 32, 8)  # 256 rows a one-block tile
    with pytest.raises(ValueError):
        tpa.ragged_route(torch.bfloat16, 96, 4, 8)
