"""Ragged paged attention (W1) of the PyTorch port against the JAX package,
on the CPU.

The mixed prefill+decode batch is flat ([N] tokens), in 8-token blocks each
owned by one row. Here: the port's plain ``ragged_paged_attention`` against
JAX's XLA op, W1's plain route (``paged_ragged_attention`` on CPU tensors)
against the Pallas ``paged_ragged_attention`` in interpret mode, pad blocks
(a null row with ``ctx_len = 0``) giving zeros, GQA groups 1, 4 and 7, an
int8 pool, and an f32 emulation of the chunk kernel at ``[N / 8, 8]`` as
the tensor-parallel mixed forward runs it per head shard: the block rows
gathered, then the chunk kernel's split over page columns and its merge,
at a geometry where ``chunk_plan`` splits. W1's own kernel on CUDA
tensors (``csrc/ragged_attention.cu``) is emulated in
``tests/test_torch_ragged_plan.py``. Inputs are made with numpy from a
seed.
"""

import os
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.ops import attention as jattn
from runbookai_tpu.ops import paged_attention_pallas as jpallas
from runbookai_tpu_torch.ops import attention as tattn
from runbookai_tpu_torch.ops import paged_attention as tpa

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_mixed_dispatch.py:465
RQ = 8  # the engine's _RAGGED_BLOCK
PS, HD = 4, 16
NUM_PAGES, MAX_PAGES = 64, 20  # + 1 trash column
TRASH = MAX_PAGES * PS


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def ragged_case(seed: int, n_kv: int, group: int):
    """A mixed batch as the engine lays it out: two decode rows (one token
    each at ctx - 1, seven pad tokens at the trash position), a free decode
    slot (its block owned by the null row), a 13-token prefill chunk at
    offset 7 (two blocks, the second with three pad tokens), a 3-token
    chunk at offset 0, and one whole pad block of the null row. Returns
    numpy (q, k, v, tables, ctx, positions, row_ids) and the real token
    indices."""
    rng = np.random.default_rng(seed)
    n_q = n_kv * group
    k = rng.standard_normal((NUM_PAGES * PS, n_kv, HD)).astype(np.float32)
    v = rng.standard_normal((NUM_PAGES * PS, n_kv, HD)).astype(np.float32)
    ctx = np.array([9, 30, 0, 20, 3, 0], np.int32)  # rows 2 and 5: null rows
    tables = np.zeros((len(ctx), MAX_PAGES + 1), np.int32)
    perm = rng.permutation(np.arange(1, NUM_PAGES))
    nxt = 0
    for r, c in enumerate(ctx):
        need = -(-int(c) // PS)
        tables[r, :need] = perm[nxt:nxt + need]
        nxt += need
    rows, pos, real = [], [], []

    def run(row, start, count, span):
        base = len(rows)
        for i in range(span):
            rows.append(row)
            pos.append(start + i if i < count else TRASH)
            if i < count:
                real.append(base + i)

    run(0, 8, 1, RQ)  # decode row, ctx 9
    run(1, 29, 1, RQ)  # decode row, ctx 30
    run(5, 0, 0, RQ)  # free slot: the null row
    run(3, 7, 13, 2 * RQ)  # prefill chunk 7..19, ctx 20
    run(4, 0, 3, RQ)  # prefill chunk 0..2, ctx 3
    run(5, 0, 0, RQ)  # pad block
    q = rng.standard_normal((len(rows), n_q, HD)).astype(np.float32)
    return (q, k, v, tables, ctx, np.array(pos, np.int32), np.array(rows, np.int32)), real


def _quantized(k, v):
    kq, vq = tattn.quantize_kv(_t(k)), tattn.quantize_kv(_t(v))
    return kq, vq, tuple(jnp.asarray(x.numpy()) for x in kq), \
        tuple(jnp.asarray(x.numpy()) for x in vq)


def _pad_blocks(row_ids, ctx):
    """Flat indices of the tokens of blocks owned by a row with ctx 0."""
    return [i for i, r in enumerate(row_ids) if ctx[r] == 0]


@pytest.mark.parametrize("group", [1, 4, 7, 8])
def test_plain_ragged_matches_jax_xla(group):
    (q, k, v, tables, ctx, pos, rows), real = ragged_case(group, n_kv=2, group=group)
    got = tattn.ragged_paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), _t(pos),
                                       _t(rows), PS, block_pages=4, ragged_block=RQ)
    want = jattn.ragged_paged_attention(*map(jnp.asarray, (q, k, v, tables, ctx, pos, rows)),
                                        PS, block_pages=4, ragged_block=RQ)
    # The XLA op averages V on fully masked rows where the kernels give
    # zeros, so only the real tokens are compared.
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], **TOL)


@pytest.mark.parametrize("group", [1, 4, 7, 8])
def test_w1_plain_route_matches_pallas_interpret(group):
    (q, k, v, tables, ctx, pos, rows), real = ragged_case(10 + group, n_kv=2, group=group)
    got = tpa.paged_ragged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), _t(pos),
                                     _t(rows), PS, ragged_block=RQ)
    want = np.asarray(jpallas.paged_ragged_attention(
        *map(jnp.asarray, (q, k, v, tables, ctx, pos, rows)), page_size=PS,
        ragged_block=RQ, interpret=True))
    assert got.shape == q.shape and got.dtype == torch.float32
    # Every token, pads included: both take positions q_start + t.
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pads = _pad_blocks(rows, ctx)
    assert len(pads) == 2 * RQ
    assert not got.numpy()[pads].any() and not want[pads].any()  # zeros, as Pallas
    # The real tokens agree with the XLA op too.
    xla = np.asarray(jattn.ragged_paged_attention(
        *map(jnp.asarray, (q, k, v, tables, ctx, pos, rows)), PS, block_pages=4,
        ragged_block=RQ))
    np.testing.assert_allclose(got.numpy()[real], xla[real], **TOL)


def test_w1_plain_route_over_an_int8_pool():
    (q, k, v, tables, ctx, pos, rows), real = ragged_case(3, n_kv=2, group=4)
    kq, vq, jk, jv = _quantized(k, v)
    got = tpa.paged_ragged_attention(_t(q), kq, vq, _t(tables), _t(ctx), _t(pos), _t(rows),
                                     PS, ragged_block=RQ)
    want = jattn.ragged_paged_attention(jnp.asarray(q), jk, jv, *map(
        jnp.asarray, (tables, ctx, pos, rows)), PS, block_pages=4, ragged_block=RQ)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], **TOL)
    plain = tattn.ragged_paged_attention(_t(q), kq, vq, _t(tables), _t(ctx), _t(pos),
                                         _t(rows), PS, block_pages=4, ragged_block=RQ)
    np.testing.assert_allclose(got.numpy()[real], plain.numpy()[real], **TOL)
    assert not got.numpy()[_pad_blocks(rows, ctx)].any()


def test_w1_counts_no_launch_on_the_cpu():
    (q, k, v, tables, ctx, pos, rows), _ = ragged_case(4, n_kv=2, group=4)
    tpa.reset_launches()
    tpa.paged_ragged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), _t(pos), _t(rows),
                               PS, ragged_block=RQ)
    assert tpa.launches["paged_ragged_attention"] == 0  # the plain version ran


def test_chunk_plan_at_the_mixed_shapes():
    """K2 at the mixed batch's block shape, as the tensor-parallel mixed
    forward calls it: the serving config's mixed batch (8 decode blocks +
    512 prefill tokens = 72 blocks) makes 576 blocks: no split, one launch.
    A budget of 16 tokens (9 blocks) splits."""
    serving = tpa.chunk_plan(72, RQ, 32, 8, 128, 513)
    assert (serving.rows, serving.q_tiles, serving.splits, serving.workspace_bytes) == \
        (32, 1, 1, 0)
    small = tpa.chunk_plan(9, RQ, 32, 8, 128, 513)
    assert small.splits > 1
    group7 = tpa.chunk_plan(72, RQ, 28, 4, 128, 513)  # qwen2-7b's geometry
    assert (group7.rows, group7.q_tiles) == (64, 1)


@pytest.mark.parametrize("group", [1, 4, 7, 8])
def test_cuda_route_emulated_split_and_merge(group):
    """The mixed batch as one chunk call at [N / 8, 8] on each block's
    gathered table row and context (the tensor-parallel mixed forward's
    attention per head shard, and W1's f32 route); that call's split over
    page columns (``chunk_plan`` splits this small batch) is emulated as
    the splits' partials and their merge, in f32, against the plain
    version. Every split of a pad block sees no key, and the merge still
    gives zeros."""
    (q, k, v, tables, ctx, pos, rows), _ = ragged_case(20 + group, n_kv=2, group=group)
    n, n_q, hd = q.shape
    nb = n // RQ
    block_rows = _t(rows).reshape(nb, RQ)[:, 0]
    bt = _t(tables).index_select(0, block_rows)
    bc = _t(ctx).index_select(0, block_rows)
    qb = _t(q).reshape(nb, RQ, n_q, hd)
    q_start = _t(pos).reshape(nb, RQ)[:, 0].contiguous()
    plan = tpa.chunk_plan(nb, RQ, n_q, 2, hd, bt.shape[1])
    assert plan.splits > 1
    acc, m, l = tpa.plain_chunk_partials(qb, _t(k), _t(v), bt, bc, q_start, PS, plan.cols)
    merged = tpa.merge_partials(list(zip(acc, m, l)), qb.device).reshape(n, n_q, hd)
    want = tpa.paged_ragged_attention(_t(q), _t(k), _t(v), _t(tables), _t(ctx), _t(pos),
                                      _t(rows), PS, ragged_block=RQ)
    np.testing.assert_allclose(merged.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    pads = _pad_blocks(rows, ctx)
    pad_blocks = sorted({i // RQ for i in pads})
    assert (l[:, pad_blocks] == 0).all() and (m[:, pad_blocks] == tpa.NEG_INF).all()
    assert not merged.numpy()[pads].any()
