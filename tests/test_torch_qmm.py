"""The tensor-core int8 matmul kernel (K5, ``csrc/qmm.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
``plain_qmm_int8``. Here its arithmetic is emulated in float32 and held
against the plain version and against the JAX package's ``qmm_pallas`` in
interpret mode:

- ``emulate_qmm``: each split sums its 64-row K tiles in order, the splits'
  partials are added in split order (the in-launch merge), ``s`` is applied
  once and the result rounded once;
- ``fragment_walk`` (the mma.sync route, m <= 8) and ``wgmma_walk``
  (m > 8): each block's work as the kernel does it,
  lane by lane: the swizzled int8 and bf16 stages, ``ldmatrix`` (``.trans``
  over the int8 tile), the byte-permute widening to bf16, the products with
  output channels on the A side (``mma.m16n8k16``, or ``wgmma.m64n64k16``
  with x read through its shared-memory descriptor), the K warps' halves
  added at the end, and the epilogue's writes;
- ``qmm_plan`` at every M the kernel takes and the 8B's and the 70B's seven
  products.

Tolerances: float32 results differ from the plain version only by the order
of the float32 sums, at most ``QMM_TOL`` (1e-5) for K <= 4096 at these
magnitudes; bf16 results are rounded once from those sums, so they may
differ by one bf16 ulp, inside ``chip_smoke.py``'s bf16 ``TOL`` (atol 1e-3,
rtol 1e-2).
"""

import inspect
import itertools
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbookai_tpu.ops import qmm_pallas as jqmm
from runbookai_tpu_torch.ops import build as tbuild
from runbookai_tpu_torch.ops import qmm as tqmm

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

ROOT = Path(__file__).resolve().parent.parent
QMM_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)
# llama3-8b-instruct's seven layer matrices, (K, N).
SHAPES_8B = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
             "wo": (4096, 4096), "w_gate": (4096, 14336), "w_up": (4096, 14336),
             "w_down": (14336, 4096)}
# llama3-70b-instruct's.
SHAPES_70B = {"wq": (8192, 8192), "wk": (8192, 1024), "wv": (8192, 1024),
              "wo": (8192, 8192), "w_gate": (8192, 28672), "w_up": (8192, 28672),
              "w_down": (28672, 8192)}


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    q[0, 0], q[-1, -1] = -127, 127
    s = (rng.uniform(0.5, 2.0, size=(1, n)) / (127 * np.sqrt(k))).astype(np.float32)
    return x, q, s


def _slices(k, k_slice):
    return [(b, min(k, b + k_slice)) for b in range(0, k, k_slice)]


def emulate_qmm(x, q, s, plan, route):
    """The kernel's sums in float32, in its order: per split, the route's
    partial sums (``mma``, m <= 8: each 64-row stage's two 32-row halves in
    two sums, added at the end; ``wgmma``: the stages in order; ``f32``:
    eight warps on every eighth row of K, added in warp order), the splits'
    partials added in split order from zero,
    then ``s`` once; returns (the float32 result, the result rounded to x's
    type)."""
    xf, qf = x.float(), q.float()
    m, n = x.shape[0], q.shape[1]
    parts = []
    for b, e in _slices(x.shape[1], plan.k_slice):
        if route == "f32":
            acc = torch.zeros((m, n))
            for w in range(8):
                acc = acc + xf[:, b + w:e:8] @ qf[b + w:e:8]
        else:
            halves = [torch.zeros((m, n)), torch.zeros((m, n))]
            kw = 2 if route == "mma" else 1
            for t in range(b, e, tqmm.QMM_TILE_K):
                for h in range(2):
                    lo, hi = t + 32 * h, min(e, t + 32 * h + 32)
                    if lo < hi:
                        halves[h % kw] = halves[h % kw] + xf[:, lo:hi] @ qf[lo:hi]
            acc = halves[0] + halves[1] if kw == 2 else halves[0]
        parts.append(acc)
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    out = total * s.float()
    return out, out.to(x.dtype)


def _pallas(x, q, s):
    return np.asarray(jqmm.qmm_pallas(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                      interpret=True))


# ------------------------------------------------- the emulated arithmetic


@pytest.mark.parametrize("m", [1, 5, 8, 64, 200, 256])
@pytest.mark.parametrize("k,n", list(itertools.product([32, 96, 4096], [128, 384, 1024])))
def test_emulated_kernel_matches_plain_and_pallas(m, k, n):
    """Each route's sums (the f32 kernel's on f32 x; the bf16 route's on the
    same values) against the plain version and Pallas interpret."""
    x, q, s = _inputs(m, k, n, seed=m * 7 + k + n)
    tx, tq, ts = torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s)
    got, rounded = emulate_qmm(tx, tq, ts, tqmm.qmm_plan(m, k, n, f32=True), "f32")
    assert torch.equal(got, rounded)  # f32 x: no rounding step
    route = tqmm.qmm_route(m)
    bf16_sums, _ = emulate_qmm(tx, tq, ts, tqmm.qmm_plan(m, k, n), route)
    np.testing.assert_allclose(bf16_sums.numpy(), got.numpy(), **QMM_TOL)
    plain = tqmm.plain_qmm_int8(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **QMM_TOL)
    np.testing.assert_allclose(got.numpy(), _pallas(x, q, s), **QMM_TOL)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (64, 4096, 4096), (64, 4096, 1024),
                                   (5, 96, 384), (33, 96, 128), (256, 14336, 128)])
def test_emulated_kernel_in_bf16_within_one_rounding(m, k, n):
    """bf16 x: the emulation and the plain version round the same f32 sums
    (up to their order) once to bf16."""
    x, q, s = _inputs(m, k, n, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    plan = tqmm.qmm_plan(m, k, n)
    got, rounded = emulate_qmm(xb, torch.from_numpy(q), torch.from_numpy(s), plan,
                               tqmm.qmm_route(m))
    plain = tqmm.plain_qmm_int8(xb, torch.from_numpy(q), torch.from_numpy(s))
    assert rounded.dtype == plain.dtype == torch.bfloat16
    np.testing.assert_allclose(rounded.float().numpy(), plain.float().numpy(), **BF16_TOL)
    np.testing.assert_allclose(got.numpy(), (xb.float() @ torch.from_numpy(q).float()
                                             * torch.from_numpy(s)).numpy(), **QMM_TOL)


def test_int8_widens_exactly_to_bf16():
    """Every int8 value becomes the same bf16 number, by a cast and by the
    kernel's byte trick: bias by 0x80, place under 0x4B00_0000 (2^23 +
    byte), subtract 2^23 + 128, keep the float's upper half."""
    v = np.arange(-128, 128, dtype=np.int64)
    assert torch.equal(torch.from_numpy(v).to(torch.int8).to(torch.bfloat16).float(),
                       torch.from_numpy(v).float())
    biased = (v.astype(np.int8).view(np.uint8) ^ 0x80).astype(np.uint32)
    f = (np.uint32(0x4B000000) | biased).view(np.float32) - np.float32(8388736.0)
    bits = f.view(np.uint32)
    assert np.array_equal(f, v.astype(np.float32))
    assert not (bits & 0xFFFF).any()  # the bf16 (upper half) is exact
    upper = (bits & 0xFFFF0000).view(np.float32)
    assert np.array_equal(upper, v.astype(np.float32))


# ------------------------------------------------- one block, lane by lane


def _swz128(row, chunk):
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _ldmatrix_x4(smem, addrs, trans):
    """ldmatrix.x4.b16: lanes 8i..8i+7 give the rows of matrix i; returns
    [4][32] words of each lane."""
    lanes = np.arange(32)
    g, c = lanes // 4, lanes % 4
    regs = np.zeros((4, 32), dtype=np.uint32)
    for i in range(4):
        mat = np.stack([smem[addrs[8 * i + j]:addrs[8 * i + j] + 16].view(np.uint16)
                        for j in range(8)]).astype(np.uint32)  # [row][b16 col]
        if trans:
            regs[i] = mat[2 * c, g] | (mat[2 * c + 1, g] << 16)
        else:
            regs[i] = mat[g, 2 * c] | (mat[g, 2 * c + 1] << 16)
    return regs


def _widen_pairs(w):
    u = w ^ np.uint32(0x80808080)
    f = [((np.uint32(0x4B000000) | ((u >> (8 * j)) & 0xFF)).view(np.float32)
          - np.float32(8388736.0)).view(np.uint32) for j in range(4)]
    even = (f[0] >> 16) | (f[2] & np.uint32(0xFFFF0000))
    odd = (f[1] >> 16) | (f[3] & np.uint32(0xFFFF0000))
    return even, odd


def _bf16(words):
    lo = (words & 0xFFFF).astype(np.uint32) << 16
    hi = words & np.uint32(0xFFFF0000)
    return lo.view(np.float32), hi.view(np.float32)


def _mma(d, a, b0, b1):
    """d [4][32] += A (16 x 16) @ B (16 x 8), from the lanes' fragments."""
    lanes = np.arange(32)
    g, c = lanes // 4, lanes % 4
    A = np.zeros((16, 16), dtype=np.float64)
    B = np.zeros((16, 8), dtype=np.float64)
    for reg, (r0, k0) in zip(a, [(0, 0), (8, 0), (0, 8), (8, 8)]):
        lo, hi = _bf16(reg)
        A[g + r0, 2 * c + k0], A[g + r0, 2 * c + k0 + 1] = lo, hi
    for reg, k0 in ((b0, 0), (b1, 8)):
        lo, hi = _bf16(reg)
        B[2 * c + k0, g], B[2 * c + k0 + 1, g] = lo, hi
    D = (A @ B).astype(np.float32)
    d[0] += D[g, 2 * c]
    d[1] += D[g, 2 * c + 1]
    d[2] += D[g + 8, 2 * c]
    d[3] += D[g + 8, 2 * c + 1]


def _q_stage(qbytes, k0, k_end, n0, tile_n):
    """A landed int8 q stage: K rows [k0, k0 + 64) of channels [n0, n0 +
    tile_n), rows of tile_n bytes, 128-byte lines swizzled (q_offset)."""
    per_line = 128 // tile_n
    stage = np.zeros(64 * tile_n, dtype=np.uint8)
    for r, ch in itertools.product(range(64), range(tile_n // 16)):
        if k0 + r < k_end:
            dst = _swz128(r // per_line, (r % per_line) * (tile_n // 16) + ch)
            stage[dst:dst + 16] = qbytes[k0 + r, n0 + 16 * ch:n0 + 16 * ch + 16]
    return stage


def _a_fragments(stage, k0, chunk, tile_n):
    """a_fragments: the widened A fragments of 16 channels over 32 K rows."""
    per_line = 128 // tile_n
    lanes = np.arange(32)
    rows = k0 + lanes
    r = _ldmatrix_x4(stage, [_swz128(rw // per_line, (rw % per_line) * (tile_n // 16) + chunk)
                             for rw in rows], trans=True)
    e0, o0 = _widen_pairs(r[0])
    e1, o1 = _widen_pairs(r[1])
    e2, o2 = _widen_pairs(r[2])
    e3, o3 = _widen_pairs(r[3])
    return [e0, o0, e1, o1], [e2, o2, e3, o3]


def fragment_walk(x_bf16, q, s, k_slice):
    """rb_qmm_int8's mma.sync route (m <= 8) for one call: every block and
    lane as qmm_mma_kernel does it, then the in-launch merge; returns (f32
    result, bf16 output)."""
    m, k = x_bf16.shape
    n = q.shape[1]
    xbits = x_bf16.view(torch.int16).numpy().view(np.uint16)
    qbytes = q.numpy().view(np.uint8)
    lanes = np.arange(32)
    g, c = lanes // 4, lanes % 4
    slices = _slices(k, k_slice)
    tile_n = tqmm.QMM_TILE_N
    ws = np.zeros((n // tile_n, len(slices), m, tile_n), dtype=np.float32)
    for tile, (split, (k_begin, k_end)) in itertools.product(range(n // tile_n),
                                                            enumerate(slices)):
        acc = np.zeros((8, 2, 4, 32), dtype=np.float32)  # [warp][m16 tile][register][lane]
        for k0 in range(k_begin, k_end, tqmm.QMM_TILE_K):
            stage = np.concatenate([_q_stage(qbytes, k0, k_end, tile * tile_n, tile_n),
                                    np.zeros(8 * 128, dtype=np.uint8)])
            for r, ch in itertools.product(range(8), range(8)):
                if r < m and k0 + 8 * ch < k_end:
                    dst = 64 * tile_n + _swz128(r, ch)
                    stage[dst:dst + 16] = xbits[r, k0 + 8 * ch:k0 + 8 * ch + 8].view(np.uint8)
            for warp in range(8):
                wc, kk = warp % 4, warp // 4
                af = [_a_fragments(stage, kk * 32, wc * 2 + mt, tile_n) for mt in range(2)]
                b = _ldmatrix_x4(stage, [64 * tile_n + _swz128(ln & 7, kk * 4 + (ln >> 3))
                                         for ln in lanes], trans=False)
                for mt in range(2):
                    _mma(acc[warp, mt], af[mt][0], b[0], b[1])
                    _mma(acc[warp, mt], af[mt][1], b[2], b[3])
        acc[:4] += acc[4:]  # K warp 0 adds K warp 1's sums
        for wc, mt, h in itertools.product(range(4), range(2), range(2)):
            ch = wc * 32 + mt * 16 + 2 * g
            row = 2 * c + h
            live = row < m
            ws[tile, split, row[live], ch[live]] = acc[wc, mt, h][live]
            ws[tile, split, row[live], ch[live] + 1] = acc[wc, mt, 2 + h][live]
    total = np.zeros((n // tile_n, m, tile_n), dtype=np.float32)
    for split in range(len(slices)):  # the last block's merge, in split order
        total += ws[:, split]
    out = (total.transpose(1, 0, 2).reshape(m, n) * s.numpy()).astype(np.float32)
    return torch.from_numpy(out), torch.from_numpy(out).to(torch.bfloat16)


def _desc_read(xstage, ks):
    """The k16 x n64 B operand that a wgmma reads through desc128 + 2 ks
    (32 bytes a step) from a 1024-aligned x tile: element (k, n) at the
    K-major address n // 8 * 1024 + n % 8 * 128 + 32 ks + 2 k, with the
    hardware's 128-byte swizzle (address bits 4-6 XOR bits 7-9)."""
    b = np.zeros((16, 64), dtype=np.float32)
    for kk, nn in itertools.product(range(16), range(64)):
        addr = nn // 8 * 1024 + nn % 8 * 128 + 32 * ks + 2 * kk
        phys = addr ^ (((addr >> 7) & 7) << 4)
        bits = np.uint32(xstage[phys:phys + 2].view(np.uint16)[0]) << 16
        b[kk, nn] = bits.view(np.float32)
    return b


def wgmma_walk(x_bf16, q, s, k_slice, tile_n):
    """rb_qmm_int8's wgmma route (m > 8) for one call: every block's warps'
    A fragments, m64n64k16 over each 64-row group of the x tile read
    through the descriptor, the accumulators' lane layout, the epilogue and
    the merge."""
    m, k = x_bf16.shape
    n = q.shape[1]
    xbits = x_bf16.view(torch.int16).numpy().view(np.uint16)
    qbytes = q.numpy().view(np.uint8)
    lanes = np.arange(32)
    g, c = lanes // 4, lanes % 4
    slices = _slices(k, k_slice)
    ws = np.zeros((n // tile_n, len(slices), m, tile_n), dtype=np.float32)
    for tile, (split, (k_begin, k_end)) in itertools.product(range(n // tile_n),
                                                            enumerate(slices)):
        groups = -(-m // 64)
        acc = np.zeros((groups, tile_n // 16, 32, 32), dtype=np.float32)  # [group][warp][reg][lane]
        for k0 in range(k_begin, k_end, 64):
            qs = _q_stage(qbytes, k0, k_end, tile * tile_n, tile_n)
            xs = np.zeros(groups * 64 * 128, dtype=np.uint8)
            for r, ch in itertools.product(range(64 * groups), range(8)):
                if r < m and k0 + 8 * ch < k_end:
                    dst = _swz128(r, ch)
                    xs[dst:dst + 16] = xbits[r, k0 + 8 * ch:k0 + 8 * ch + 8].view(np.uint8)
            frags = [_a_fragments(qs, 0, w, tile_n) + _a_fragments(qs, 32, w, tile_n)
                     for w in range(tile_n // 16)]
            for rg, wg, ks in itertools.product(range(groups), range(tile_n // 64), range(4)):
                a = np.zeros((64, 16), dtype=np.float32)
                for w4 in range(4):  # the warpgroup's warp w4: A rows 16 w4..
                    regs = frags[4 * wg + w4][ks]
                    for reg, (r0, kk0) in zip(regs, [(0, 0), (8, 0), (0, 8), (8, 8)]):
                        lo, hi = _bf16(reg)
                        a[16 * w4 + g + r0, 2 * c + kk0] = lo
                        a[16 * w4 + g + r0, 2 * c + kk0 + 1] = hi
                d = a @ _desc_read(xs[rg * 64 * 128:], ks)
                for w4, j in itertools.product(range(4), range(8)):
                    rows, reg = 16 * w4 + g, acc[rg, 4 * wg + w4]
                    reg[4 * j + 0] += d[rows, 8 * j + 2 * c]
                    reg[4 * j + 1] += d[rows, 8 * j + 2 * c + 1]
                    reg[4 * j + 2] += d[rows + 8, 8 * j + 2 * c]
                    reg[4 * j + 3] += d[rows + 8, 8 * j + 2 * c + 1]
        for rg, warp, j, h in itertools.product(range(groups), range(tile_n // 16), range(8),
                                                range(2)):
            row, ch = 64 * rg + 8 * j + 2 * c + h, warp * 16 + 2 * g
            live = row < m
            ws[tile, split, row[live], ch[live]] = acc[rg, warp, 4 * j + h][live]
            ws[tile, split, row[live], ch[live] + 1] = acc[rg, warp, 4 * j + 2 + h][live]
    total = np.zeros((n // tile_n, m, tile_n), dtype=np.float32)
    for split in range(len(slices)):
        total += ws[:, split]
    out = (total.transpose(1, 0, 2).reshape(m, n) * s.numpy()).astype(np.float32)
    return torch.from_numpy(out), torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n,k_slice,tile_n", [
    (16, 224, 128, 96, 64),    # 64-channel tiles, a zero-filled half stage
    (33, 128, 256, 64, 128),   # rows past M zero-filled
    (64, 192, 128, 128, 128),
    (64, 160, 128, 160, 64),   # one split
    (100, 96, 128, 64, 128),   # two row groups
    (200, 64, 128, 32, 64),    # four row groups, the last partly past M
])
def test_wgmma_walk_matches_plain(m, k, n, k_slice, tile_n):
    x, q, s = _inputs(m, k, n, seed=m + k + tile_n)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    got, out = wgmma_walk(xb, qt, st, k_slice, tile_n)
    want = xb.float() @ qt.float() * st
    np.testing.assert_allclose(got.numpy(), want.numpy(), **QMM_TOL)
    np.testing.assert_allclose(out.float().numpy(),
                               tqmm.plain_qmm_int8(xb, qt, st).float().numpy(), **BF16_TOL)


@pytest.mark.parametrize("m,k,n,k_slice", [
    (8, 224, 256, 96),    # slices 96, 96, 32: a half tile, zero-filled
    (5, 160, 128, 160),   # rows past M zero-filled, one split
    (1, 96, 128, 32),
])
def test_fragment_walk_matches_plain(m, k, n, k_slice):
    x, q, s = _inputs(m, k, n, seed=m + k)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    got, out = fragment_walk(xb, qt, st, k_slice)
    want = xb.float() @ qt.float() * st
    np.testing.assert_allclose(got.numpy(), want.numpy(), **QMM_TOL)
    np.testing.assert_allclose(out.float().numpy(),
                               tqmm.plain_qmm_int8(xb, qt, st).float().numpy(), **BF16_TOL)


# ------------------------------------------------- the plan


def _plan_cases(shapes=SHAPES_8B):
    """Every M the kernel takes, a model's four (K, N) (the 8B's unless
    given) and both types of x."""
    return itertools.product(range(1, tqmm.MAX_M + 1), sorted(set(shapes.values())),
                             (False, True))


def test_qmm_plan_tiles_k_and_the_output(shapes=SHAPES_8B):
    """Every split is a whole number of 32-row units, the splits cover K
    once (only the last may be shorter), and the grid of column tiles times
    splits covers every (K unit, output tile) exactly once."""
    for m, (k, n), f32 in _plan_cases(shapes):
        plan = tqmm.qmm_plan(m, k, n, f32)
        wide = f32 or tqmm.qmm_route(m) != "wgmma" or n // tqmm.QMM_TILE_N >= tbuild.SMS // 8
        assert plan.tile_n == (tqmm.QMM_TILE_N if wide else tqmm.QMM_NARROW_TILE_N)
        assert n % plan.tile_n == 0
        assert plan.k_slice % tqmm.QMM_UNIT_K == 0 and plan.k_slice > 0, (m, k, n)
        slices = _slices(k, plan.k_slice)
        assert len(slices) == plan.splits, (m, k, n)
        assert all((e - b) % tqmm.QMM_UNIT_K == 0 and e > b for b, e in slices)
        cover = np.zeros((k // tqmm.QMM_UNIT_K, n // plan.tile_n), dtype=np.int64)
        for tile, (b, e) in itertools.product(range(n // plan.tile_n), slices):
            cover[b // tqmm.QMM_UNIT_K:e // tqmm.QMM_UNIT_K, tile] += 1
        assert (cover == 1).all(), (m, k, n)


def test_qmm_plan_fills_the_sms_within_the_cached_workspace(shapes=SHAPES_8B):
    """Blocks >= the SMs wherever K (two stages a split) and the workspace
    allow it, the partials fit the workspace cap, and the merge reads at
    most QMM_MERGE_ROWS rows of partials a channel beyond what filling the
    SMs needs."""
    for m, (k, n), f32 in _plan_cases(shapes):
        plan = tqmm.qmm_plan(m, k, n, f32)
        tiles = n // plan.tile_n
        assert plan.workspace_floats <= tqmm.QMM_WORKSPACE_FLOATS, (m, k, n)
        assert plan.workspace_floats == (0 if plan.splits == 1 else plan.splits * m * n)
        if tiles * plan.splits < tbuild.SMS:
            more = plan.splits + 1
            assert (more > k // (2 * tqmm.QMM_TILE_K)
                    or more * m * n > tqmm.QMM_WORKSPACE_FLOATS), (m, k, n, plan)
        fill = -(-tbuild.SMS // tiles)
        assert plan.splits <= max(fill + 2, tqmm.QMM_MERGE_ROWS // m), (m, k, n, plan)
    # The model's products fill the SMs at every M.
    for m, (k, n), f32 in _plan_cases(shapes):
        plan = tqmm.qmm_plan(m, k, n, f32)
        assert plan.splits * n // plan.tile_n >= tbuild.SMS, (m, k, n, f32, plan)


def test_qmm_plan_at_the_70b_shapes():
    """The same at llama3-70b-instruct's four (K, N), K up to 28,672: every
    product takes the kernel, the splits tile K and the output, and fill
    the SMs within the workspace."""
    assert all(tqmm.qmm_eligible(m, k, n) for m in (1, 8, 64, 256)
               for k, n in SHAPES_70B.values())
    test_qmm_plan_tiles_k_and_the_output(SHAPES_70B)
    test_qmm_plan_fills_the_sms_within_the_cached_workspace(SHAPES_70B)
    assert [tqmm.qmm_plan(8, k, n).splits for k, n in sorted(set(SHAPES_70B.values()))] == \
        [64, 8, 2, 8]  # chip_smoke.py's qmm_70b_kernel cases at M = 8


def test_qmm_plan_depends_on_shapes_only():
    """The plan takes ints and a flag, never a tensor (so it can be fixed per
    CUDA-graph bucket), and is cached."""
    assert list(inspect.signature(tqmm.qmm_plan.__wrapped__).parameters) == ["m", "k", "n",
                                                                            "f32"]
    assert tqmm.qmm_plan(8, 4096, 1024) is tqmm.qmm_plan(8, 4096, 1024)
    assert [tqmm.qmm_route(m) for m in (1, 8, 9, 64, 65, 256)] == ["mma"] * 2 + ["wgmma"] * 4
    assert tqmm.qmm_route(64, f32=True) == "f32"


def test_split_workspace_allocates_only_to_grow():
    dev = torch.device("cpu")
    tbuild._split_workspaces.pop((None, -1), None)
    try:
        c1, w1 = tbuild.split_workspace(dev, -1, 16, 1000)
        assert int(c1.abs().sum()) == 0
        c2, w2 = tbuild.split_workspace(dev, -1, 8, 500)
        assert c2 is c1 and w2 is w1  # a smaller call reuses the cached tensors
        c3, w3 = tbuild.split_workspace(dev, -1, 8, 2000)
        assert w3.numel() == 2000 and c3.numel() == 16 and w3 is not w1
    finally:
        tbuild._split_workspaces.pop((None, -1), None)


def test_qmm_int8_on_cpu_is_the_plain_version_and_counts_no_launch():
    x, q, s = _inputs(8, 96, 128)
    before = tqmm.launches["qmm_int8"]
    got = tqmm.qmm_int8(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert torch.equal(got, tqmm.plain_qmm_int8(torch.from_numpy(x), torch.from_numpy(q),
                                                torch.from_numpy(s)))
    assert tqmm.launches["qmm_int8"] == before


# ------------------------------------------------- chip_smoke's profile


def test_chip_smoke_classes_the_qmm_kernels():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ns = "void (anonymous namespace)::"
    mma = ns + "qmm_mma_kernel((anonymous namespace)::QmmArgs)"
    wgmma = ns + "qmm_wgmma_kernel<2, 1>((anonymous namespace)::QmmArgs)"
    f32 = ns + "qmm_f32_kernel((anonymous namespace)::QmmArgs)"
    removed = ns + ("qmm_kernel<__nv_bfloat16>(const T1 *, const signed char *, const "
                    "float *, T1 *, float *, int, int, int, int)")
    finish = ns + "qmm_finish_kernel<__nv_bfloat16>(const float *, const float *, T1 *, int, int, int)"
    assert [chip_smoke.kernel_class(n)
            for n in (mma, wgmma, f32, removed, finish)] == ["qmm"] * 5
    assert chip_smoke.removed_bf16(removed) == "qmm"
    assert chip_smoke.removed_bf16(finish) == "qmm"
    assert [chip_smoke.removed_bf16(n) for n in (mma, wgmma, f32)] == [None] * 3
