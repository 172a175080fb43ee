"""The page-split chunk partial on the tensor-core kernel: its host side, on
the CPU.

The kernel (``chunk_partial_mma_kernel`` in
``runbookai_tpu_torch/csrc/chunk_attention.cu``, the tensor-core chunk
kernel's rows, tiles and steps over one page shard's pages) runs only on the card,
where ``chip_smoke.py`` holds it against its plain version. Here: an f32
emulation of what it computes differently from the plain version, held
against the plain version and JAX's XLA ``_partial_flash``: each block lists
the table columns of its split below its key bound whose page the shard
owns, in table order, walks them in 64-key tiles (four 16-token pages) with
each key's own position in the ctx and causal masks, and writes (acc, m, l);
the last split of a row tile to finish combines the splits in split order,
in the same launch. Tables
whose ownership interleaves page by page and tables whose sequences each lie
on one shard. Inputs are made with numpy from a seed.
"""

import math
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from runbookai_tpu.parallel import kv_split as jkv
from runbookai_tpu.parallel.mesh import SEQ_AXIS as JSEQ
from runbookai_tpu.parallel.mesh import build_mesh as jbuild_mesh
from runbookai_tpu_torch.ops import paged_attention as tpa

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)  # test_pallas_kernel.py:41
PS, N_KV, HD = 16, 2, 16
PG, NUM_PAGES, MAX_PAGES = 2, 64, 20  # + 1 trash column
LOCAL = NUM_PAGES // PG
TRASH = MAX_PAGES * PS
KEYS = 64  # keys a tile: four pages
NEG_INF = -1e30


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------- the kernel emulated in f32


def emulate_chunk_partial(q, k_local, v_local, tables, ctx, q_start, shard, plan, walks=None,
                          pages_local=LOCAL):
    """What the partial kernel computes, in f32: for every (sequence, kv head, row tile
    of ``plan.rows`` (token, group head) rows) and split, the owned columns
    of the split below the block's key bound, keys in tiles of 64 with
    their positions, an online softmax in log2 units masked by pos < min(hi,
    q_start + t + 1), and (acc, m in natural-log units, l); several splits
    combined in split order (plain version: combine_partials). ``walks``, if
    given, collects each block's (sequence, split, columns, local pages,
    key bound in columns). Page shard ``shard`` owns global pages
    ``[shard * pages_local, (shard + 1) * pages_local)``."""
    b, t, n_q, hd = q.shape
    n_kv, p = k_local.shape[1], tables.shape[1]
    group = n_q // n_kv
    scale_log2 = 1.0 / math.sqrt(hd) / math.log(2.0)
    acc = torch.zeros(plan.splits, b, t, n_q, hd)
    m = torch.full((plan.splits, b, t, n_q), NEG_INF)
    l = torch.zeros(plan.splits, b, t, n_q)
    for i in range(b):
        for kvh in range(n_kv):
            for tile in range(plan.q_tiles):
                rr = torch.arange(tile * plan.rows, min((tile + 1) * plan.rows, t * group))
                tok, head = rr // group, kvh * group + rr % group
                t_last = int(tok[-1])
                hi = min(int(ctx[i]), p * PS, int(q_start[i]) + t_last + 1)
                lim = torch.clamp(q_start[i] + tok + 1, max=hi)
                for s in range(plan.splits):
                    c0 = s * plan.cols
                    c1 = min(c0 + plan.cols, -(-hi // PS)) if hi > 0 else c0
                    cols = [c for c in range(c0, c1)
                            if int(tables[i, c]) // pages_local == shard]
                    pages = [int(tables[i, c]) - shard * pages_local for c in cols]
                    if walks is not None:
                        walks.append((i, s, cols, pages, c1))
                    n_keys = len(cols) * PS
                    j = torch.arange(n_keys)
                    pos = torch.tensor(cols, dtype=torch.long).repeat_interleave(PS) * PS + j % PS
                    rows = torch.tensor(pages, dtype=torch.long).repeat_interleave(PS) * PS + j % PS
                    qr = q[i, tok, head].float()
                    m2 = torch.full((len(rr),), NEG_INF)
                    lr = torch.zeros(len(rr))
                    o = torch.zeros(len(rr), hd)
                    for it in range(-(-n_keys // KEYS)):
                        sl = slice(it * KEYS, (it + 1) * KEYS)
                        live = pos[sl][None, :] < lim[:, None]
                        x = torch.where(live, (qr @ k_local[rows[sl], kvh].float().T)
                                        * scale_log2, NEG_INF)
                        m_new = torch.maximum(m2, x.amax(-1))
                        alpha = torch.exp2(m2 - m_new)
                        pr = torch.where(live, torch.exp2(x - m_new[:, None]), 0.0)
                        lr = lr * alpha + pr.sum(-1)
                        o = o * alpha[:, None] + pr @ v_local[rows[sl], kvh].float()
                        m2 = m_new
                    acc[s, i, tok, head] = o
                    m[s, i, tok, head] = torch.where(lr > 0, m2 * math.log(2.0), NEG_INF)
                    l[s, i, tok, head] = lr
    if plan.splits == 1:
        return acc[0], m[0], l[0]
    return tpa.combine_partials(list(zip(acc, m, l)), torch.device("cpu"))


def _inputs(rng, t, group, layout):
    """Rows: a prefill from 0; a verify over 300 cached tokens; a chunk
    continuing at 100; a ctx-0 row; the engine's pad row (null table, ctx 1,
    queries at the trash position). ``interleaved`` draws each sequence's
    pages from the whole pool; ``one_shard`` gives sequence i ascending pages
    of shard i % PG only, as the engine's allocator hands out long runs."""
    starts = [0, 300 - t, 100, 0, TRASH]
    real = [t, t, t, 0, 0]
    ctx = np.asarray([t, 300, 100 + t, 0, 1], np.int32)
    k = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
    v = rng.normal(size=(NUM_PAGES * PS, N_KV, HD)).astype(np.float32)
    tables = rng.integers(1, NUM_PAGES, size=(len(ctx), MAX_PAGES + 1)).astype(np.int32)
    tables[:, MAX_PAGES] = 0
    free = list(rng.permutation(np.arange(1, NUM_PAGES)))
    runs = [list(range(max(1, s * LOCAL), (s + 1) * LOCAL)) for s in range(PG)]
    for i, c in enumerate(ctx):
        need = -(-int(c) // PS)
        if layout == "interleaved":
            tables[i, :need] = [free.pop() for _ in range(need)]
        else:
            run = runs[i % PG]
            tables[i, :need], runs[i % PG] = run[:need], run[need:]
    tables[4] = 0
    pos = np.full((len(ctx), t), TRASH, np.int32)
    for i, (s, n) in enumerate(zip(starts, real)):
        pos[i, :n] = np.arange(s, s + n)
    pos[3] = np.arange(t)  # ctx 0: nothing cached, whatever the positions
    q = rng.normal(size=(len(ctx), t, N_KV * group, HD)).astype(np.float32)
    return q, k, v, tables, ctx, pos


def _plan(q, tables, cols):
    """chunk_plan of these shapes, or the same rows with ``cols`` columns a
    split."""
    b, t, n_q, hd = q.shape
    plan = tpa.chunk_plan(b, t, n_q, N_KV, hd, tables.shape[1])
    if cols is None:
        return plan
    splits = -(-tables.shape[1] // cols)
    return tpa.ChunkPlan(plan.rows, plan.q_tiles, splits, cols, 0)


CASES = [  # (t, group, layout, cols): None takes chunk_plan's split
    (6, 4, "interleaved", None), (6, 4, "one_shard", None), (6, 2, "interleaved", 1),
    (20, 4, "interleaved", 3), (20, 4, "one_shard", 21), (20, 1, "one_shard", 2),
]


@pytest.mark.parametrize("t,group,layout,cols", CASES)
def test_owned_page_walk_equals_plain_and_partial_flash(t, group, layout, cols):
    rng = np.random.default_rng(100 + t + group + (cols or 0) + len(layout))
    q, k, v, tables, ctx, pos = _inputs(rng, t, group, layout)
    plan = _plan(q, tables, cols)
    assert plan.rows == (32 if t * group <= 32 else 64)
    want_m, want_l, want_acc = _partial_flash(q, k, v, tables, ctx, pos)
    q_start = _t(pos[:, 0])
    for shard, (kk, vv) in enumerate(zip(_t(k).chunk(PG), _t(v).chunk(PG))):
        walks = []
        acc, m, l = emulate_chunk_partial(_t(q), kk, vv, _t(tables), _t(ctx), q_start, shard,
                                          plan, walks)
        plain = tpa.plain_paged_attention_partial(_t(q), kk, vv, _t(tables), _t(ctx), q_start,
                                                  PS, shard, LOCAL)
        # acc sums up to hundreds of terms of size up to max |v|: its f32
        # rounding scales with l, so it is held to 1e-6 of l (acc / l).
        np.testing.assert_allclose(_normalised(acc, l), _normalised(plain[0], plain[2]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(m.numpy(), plain[1].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(l.numpy(), plain[2].numpy(), rtol=1e-6, atol=1e-6)
        # JAX masks by each query's own position: compare the rows every
        # caller keeps (not the ctx-0 row, nor the pad row).
        keep = slice(0, 3)
        np.testing.assert_allclose(acc[keep].numpy(),
                                   want_acc[shard].reshape(acc.shape)[keep], **TOL)
        np.testing.assert_allclose(m[keep].numpy(), want_m[shard].reshape(m.shape)[keep], **TOL)
        np.testing.assert_allclose(l[keep].numpy(), want_l[shard].reshape(l.shape)[keep], **TOL)
        # Every block lists exactly its split's owned columns below its
        # bound, in table order, and reads local pages only.
        for i, s, cols_, pages, c1 in walks:
            c0 = s * plan.cols
            owned = [c for c in range(c0, max(c0, c1)) if tables[i, c] // LOCAL == shard]
            assert cols_ == owned and all(0 <= pg < LOCAL for pg in pages)
        # A row with no owned key: (0, -1e30, 0).
        for row in range(3):
            n_cols = -(-int(ctx[row]) // PS)
            if not any(tables[row, :n_cols] // LOCAL == shard):
                assert torch.all(acc[row] == 0) and torch.all(l[row] == 0)
                assert torch.all(m[row] == NEG_INF)
        assert torch.all(l[3] == 0) and torch.all(m[3] == NEG_INF)  # ctx 0
    if layout == "one_shard":  # sequence 0 lies on shard 0 only
        assert all(tables[0, :1] // LOCAL == 0)


def _normalised(acc, l):
    return (acc / l.clamp_min(1e-30)[..., None]).numpy()


def _partial_flash(q, k, v, tables, ctx, pos):
    """JAX's ``_partial_flash`` on every page shard under ``shard_map`` (it
    reads the shard index there): (m, l, acc) stacked over the shards."""
    jmesh = jbuild_mesh(1, model=1, seq=PG)

    def per_shard(q_, k_, v_, tab, c, qp):
        m, l, acc = jkv._partial_flash(q_, k_, v_, tab, c, qp, page_size=PS, block_pages=4,
                                       pages_local=LOCAL, my_pg=jax.lax.axis_index(JSEQ))
        return m[None], l[None], acc[None]

    rep = P()
    out = jax.shard_map(per_shard, mesh=jmesh, in_specs=(rep, P(JSEQ), P(JSEQ), rep, rep, rep),
                        out_specs=(P(JSEQ), P(JSEQ), P(JSEQ)), check_vma=False)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(pos))
    return tuple(np.asarray(x) for x in out)


def test_chunk_plan_at_the_page_split_call_shapes():
    """One call of the 8B's tp=16 path (a model group's 4 query heads over
    its kv head): the 4 x 512 prefill splits in three, the T=8 verify in 33;
    the owned-column list fits in shared memory (at most 513 ints)."""
    prefill = tpa.chunk_plan(4, 512, 4, 1, 128, 513)
    assert (prefill.rows, prefill.q_tiles, prefill.splits, prefill.cols) == (64, 32, 3, 171)
    verify = tpa.chunk_plan(8, 8, 4, 1, 128, 513)
    assert (verify.rows, verify.q_tiles, verify.splits, verify.cols) == (32, 1, 33, 16)
    assert max(prefill.cols, verify.cols) <= 513


def test_chunk_plan_at_a_wide_table():
    """The tp=16 call at 2,049 columns (max_seq_len 32,768): the 4 x 512
    prefill splits in three of 683 columns, the T=8 verify in 33 of 63; the
    owned-column list of a split (at most ``cols`` entries) stays in shared
    memory."""
    prefill = tpa.chunk_plan(4, 512, 4, 1, 128, 2049)
    assert (prefill.rows, prefill.q_tiles, prefill.splits, prefill.cols) == (64, 32, 3, 683)
    verify = tpa.chunk_plan(8, 8, 4, 1, 128, 2049)
    assert (verify.rows, verify.q_tiles, verify.splits, verify.cols) == (32, 1, 33, 63)


@pytest.mark.parametrize("cols", [683, 63])
def test_owned_page_walk_at_a_wide_table(cols):
    """The owned-page walk over a 2,049-column table at the tp=16 call's
    splits: a T=8 chunk at offset 32,752 (ctx 32,760) whose pages interleave
    over two shards of 1,100 pages, a verify over 1,000 tokens on shard 1
    alone, a ctx-0 row; each shard's (acc, m, l) against the plain partial,
    and both merged against the plain version on the whole pool."""
    rng = np.random.default_rng(180 + cols)
    t, group, p, local = 8, 4, 2049, 1_100
    ctx = np.asarray([32_760, 1000, 0], np.int32)
    k = rng.normal(size=(2 * local * PS, N_KV, HD)).astype(np.float32)
    v = rng.normal(size=(2 * local * PS, N_KV, HD)).astype(np.float32)
    tables = rng.integers(1, 2 * local, size=(3, p)).astype(np.int32)
    tables[:, p - 1] = 0
    free = [list(rng.permutation(np.arange(max(1, s * local), (s + 1) * local)))
            for s in range(2)]
    for col in range(-(-32_760 // PS)):
        tables[0, col] = free[col % 2].pop()
    for col in range(-(-1000 // PS)):
        tables[1, col] = free[1].pop()
    pos = np.asarray([np.arange(32_752, 32_760), np.arange(992, 1000), np.arange(t)],
                     np.int32)
    q = rng.normal(size=(3, t, N_KV * group, HD)).astype(np.float32)
    plan = _plan(q, tables, cols)
    q_start = _t(pos[:, 0])
    parts = []
    for shard, (kk, vv) in enumerate(zip(_t(k).chunk(2), _t(v).chunk(2))):
        acc, m, l = emulate_chunk_partial(_t(q), kk, vv, _t(tables), _t(ctx), q_start, shard,
                                          plan, pages_local=local)
        plain = tpa.plain_paged_attention_partial(_t(q), kk, vv, _t(tables), _t(ctx), q_start,
                                                  PS, shard, local)
        np.testing.assert_allclose(_normalised(acc, l), _normalised(plain[0], plain[2]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(m.numpy(), plain[1].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(l.numpy(), plain[2].numpy(), rtol=1e-6, atol=1e-6)
        assert torch.all(l[0] > 0)  # the 32k chunk sees keys on both shards
        assert torch.all(l[1] == 0) == (shard == 0)  # the verify's pages: shard 1 only
        parts.append((acc, m, l))
    whole = tpa.plain_paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), q_start, PS)
    np.testing.assert_allclose(tpa.merge_partials(parts, torch.device("cpu")).numpy()[:2],
                               whole.numpy()[:2], **TOL)


# -------------------------------------------- the merge of a call's splits


def test_split_partials_merge_then_cross_shards_equals_merging_everything():
    """The in-launch merge of each shard's splits into one partial (plain
    version: combine_partials), then ``merge_partials`` across shards,
    equals ``merge_partials`` of every split of every shard; a row no split
    saw gives (0, -1e30, 0)."""
    rng = np.random.default_rng(110)
    shards = []
    for _ in range(PG):
        acc = _t(rng.normal(size=(4, 3, 5, 2, HD)).astype(np.float32))
        m = _t(rng.normal(size=(4, 3, 5, 2)).astype(np.float32))
        l = _t(rng.uniform(0.5, 2.0, size=(4, 3, 5, 2)).astype(np.float32))
        m[:, 0, 0], l[:, 0, 0], acc[:, 0, 0] = NEG_INF, 0.0, 0.0  # seen by no split
        m[2, 1, 1], l[2, 1, 1], acc[2, 1, 1] = NEG_INF, 0.0, 0.0  # one empty split
        shards.append((acc, m, l))
    combined = [tpa.combine_partials(list(zip(*sh)), torch.device("cpu")) for sh in shards]
    for acc, m, l in combined:
        assert torch.all(acc[0, 0] == 0) and torch.all(l[0, 0] == 0)
        assert torch.all(m[0, 0] == NEG_INF)
    got = tpa.merge_partials(combined, torch.device("cpu"))
    every = [part for acc, m, l in shards for part in zip(acc, m, l)]
    want = tpa.merge_partials(every, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.all(got[0, 0] == 0)


def test_partial_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(111)
    q, k, v, tables, ctx, pos = _inputs(rng, 6, 4, "interleaved")
    for shard, (kk, vv) in enumerate(zip(_t(k).chunk(PG), _t(v).chunk(PG))):
        got = tpa.paged_chunk_attention_partial(_t(q), kk, vv, _t(tables), _t(ctx), _t(pos),
                                                shard, PS, LOCAL)
        want = tpa.plain_paged_attention_partial(_t(q), kk, vv, _t(tables), _t(ctx),
                                                 _t(pos[:, 0]), PS, shard, LOCAL)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------- chip_smoke's profile


def test_chip_smoke_classes_the_partial_kernels():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ns = "void (anonymous namespace)::"
    mma = ns + "chunk_partial_mma_kernel<128, 2>((anonymous namespace)::ChunkArgs)"
    k2 = ns + "chunk_attention_mma_kernel<__nv_bfloat16, 128, 4>((anonymous namespace)::ChunkArgs)"
    k2_merge = ns + ("chunk_merge_kernel<__nv_bfloat16>(float const*, float const*, "
                     "float const*, __nv_bfloat16*, int, long long, int)")
    removed = ns + ("paged_attention_kernel<__nv_bfloat16, __nv_bfloat16, true, true>("
                    "(anonymous namespace)::Args)")
    k4 = ns + ("paged_attention_kernel<__nv_bfloat16, __nv_bfloat16, false, true>("
               "(anonymous namespace)::Args)")
    k4_mma = ns + ("decode_attention_mma_kernel<__nv_bfloat16, 128, true, (anonymous "
                   "namespace)::DecodePartialArgs>((anonymous namespace)::DecodePartialArgs)")
    f32_k4 = ns + "paged_attention_kernel<float, float, false, true>((anonymous namespace)::Args)"
    f32_pool_k4 = ns + ("paged_attention_kernel<__nv_bfloat16, float, false, true>("
                        "(anonymous namespace)::Args)")
    assert [chip_smoke.kernel_class(n) for n in (mma, removed, k4, k4_mma, f32_k4)] == [
        "chunk_attention_partial", "chunk_attention_partial", "decode_attention_partial",
        "decode_attention_partial", "decode_attention_partial"]
    assert chip_smoke.kernel_class(k2) == "chunk_attention"
    assert chip_smoke.kernel_class(k2_merge, int8_pools=True) == "chunk_attention_int8"
    assert chip_smoke.removed_bf16(removed) == "chunk_partial"
    assert chip_smoke.removed_bf16(k4) == "decode_partial"  # K4's CUDA-core version
    assert [chip_smoke.removed_bf16(n) for n in (mma, k4_mma, f32_k4, f32_pool_k4)] == [None] * 4
