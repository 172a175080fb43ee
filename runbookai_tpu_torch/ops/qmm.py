"""Int8 weight-only matmul of the decode and verify forwards, and its plain
version.

The CUDA kernel ``rb_qmm_int8`` (``csrc/qmm.cu``) replaces the Pallas TPU
kernel ``qmm_pallas`` of ``runbookai_tpu/ops/qmm_pallas.py``: ``(x2 @
widen(q)) * s`` with int8 ``q [K, N]`` read once from device memory, float32
sums and the per-output-channel scale ``s [1, N]`` applied once to each sum.
Decode is bound by the bytes of the weights, so reading int8 instead of a
bf16 copy halves them. bf16 x runs on the tensor cores, f32 x on a CUDA-core
kernel (:func:`qmm_route`); all split K as :func:`qmm_plan` says and merge the
splits in the same launch, so a call is one launch and allocates only its
output.

:func:`qmm_eligible` is the JAX package's ``qmm_pallas_eligible`` with its
constants, copied so that the port sends exactly the shapes to the kernel
that the JAX package sends to ``qmm_pallas`` (``models/llama.py::qmm`` takes
the matmul expression for the others). :func:`qmm_int8` raises on any other
shape. Given CPU tensors it computes the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from runbookai_tpu_torch.ops.build import SMS, library, raise_on, split_workspace

# Decode/verify dispatches have M = batch_slots * k_steps rows (<= ~256);
# larger M is chunked prefill, which the matmul expression serves.
MAX_M = 256
_BK_CANDIDATES = (1024, 512, 256, 128, 64, 32)
_BN_CANDIDATES = (512, 256, 128)

# The kernels' tiles (csrc/qmm.cu): output channels a block (64 on the wgmma
# route when N has fewer than SMS / 8 tiles of 128, as the 8B's wk and wv),
# rows of K a pipeline stage; splits are cut in whole units of QMM_UNIT_K rows
# (every eligible K is a multiple of it) and hold at least two stages. The f32
# kernel's blocks own QMM_F32_ROWS rows of x each.
QMM_TILE_N, QMM_NARROW_TILE_N, QMM_TILE_K, QMM_UNIT_K = 128, 64, 64, 32
QMM_F32_ROWS = 8
# Splits times rows of x at most (the last split's merge reads every split's
# partial tile from L2), unless filling the SMs needs more.
QMM_MERGE_ROWS = 512
# The most f32 split partials a call may use: the cached workspace never
# grows past it for this kernel (32 MiB).
QMM_WORKSPACE_FLOATS = 1 << 23

# Kernel launches (plain-version calls are not counted).
launches = {"qmm_int8": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick(cands: tuple[int, ...], dim: int) -> int | None:
    for c in cands:
        if dim % c == 0:
            return c
    return None


def qmm_eligible(m: int, k: int, n: int) -> bool:
    """Whether an ``[m, k] @ [k, n]`` int8 product takes the kernel."""
    return (m <= MAX_M
            and _pick(_BK_CANDIDATES, k) is not None
            and _pick(_BN_CANDIDATES, n) is not None)


@dataclass(frozen=True)
class QmmPlan:
    """How the kernel covers one ``[m, k] @ [k, n]`` call."""

    splits: int  # slices of K, one block each per column tile
    k_slice: int  # rows of K a slice (the last may be shorter)
    tile_n: int  # output channels a block
    workspace_floats: int  # f32 partials of every split; 0 unsplit


def qmm_route(m: int, f32: bool = False) -> str:
    """The kernel of ``rb_qmm_int8`` for ``m`` rows: ``"f32"`` (CUDA cores),
    ``"mma"`` (mma.sync) for bf16 x with m <= 8, ``"wgmma"`` for more."""
    if f32:
        return "f32"
    return "mma" if m <= 8 else "wgmma"


@functools.lru_cache(maxsize=1024)
def qmm_plan(m: int, k: int, n: int, f32: bool = False) -> QmmPlan:
    """The split over K of one call, from its shapes (and x's type) only.

    The grid is the column tiles times the splits: about four blocks per SM
    for the small blocks of the mma route, two for the others (on the card,
    neither fewer splits nor more waves were faster), at least one block
    per SM, at most :data:`QMM_MERGE_ROWS` / m splits unless filling the
    SMs needs more, at least two 64-row stages a split, and no more
    partials than :data:`QMM_WORKSPACE_FLOATS`. Slices are whole 32-row
    units, rounded up where that still fills the SMs (fewer, even slices)
    and down where it would not."""
    narrow = qmm_route(m, f32) == "wgmma" and n // QMM_TILE_N < SMS // 8
    tile_n = QMM_NARROW_TILE_N if narrow else QMM_TILE_N
    tiles = n // tile_n
    fill = -(-SMS // tiles)
    per_sm = 4 if qmm_route(m, f32) == "mma" else 2
    want = max(fill, min(per_sm * SMS // tiles, max(fill, QMM_MERGE_ROWS // m)))
    want = max(1, min(want, k // (2 * QMM_TILE_K)))
    while True:
        units = k // QMM_UNIT_K
        k_slice = -(-units // want) * QMM_UNIT_K
        if -(-k // k_slice) * tiles < min(SMS, want * tiles):
            k_slice = units // want * QMM_UNIT_K
        splits = -(-k // k_slice)
        if splits == 1 or splits * m * n <= QMM_WORKSPACE_FLOATS:
            break
        want -= 1
    return QmmPlan(splits, k_slice, tile_n, 0 if splits == 1 else splits * m * n)


def plain_qmm_int8(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 product and scale, rounded once to x's type."""
    return ((x2.float() @ q.float()) * s.float()).to(x2.dtype)


def qmm_int8(
    x2: torch.Tensor,  # [M, K] float32 or bfloat16
    q: torch.Tensor,  # [K, N] int8
    s: torch.Tensor,  # [1, N] float32
) -> torch.Tensor:
    """``(x2 @ q) * s`` in x2's dtype, for shapes :func:`qmm_eligible` takes."""
    m, k = x2.shape
    n = q.shape[1]
    if q.shape[0] != k or tuple(s.shape) != (1, n):
        raise ValueError(f"qmm shapes x {tuple(x2.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not match")
    if not qmm_eligible(m, k, n):
        raise ValueError(f"qmm_int8 does not take [{m}, {k}] @ [{k}, {n}] "
                         f"(see qmm_eligible)")
    if x2.device.type == "cpu":
        return plain_qmm_int8(x2, q, s)
    if x2.device.type != "cuda":
        raise ValueError(f"qmm_int8 runs on cuda or cpu tensors, got {x2.device}")
    for t in (q, s):
        if t.device != x2.device:
            raise ValueError(f"tensors on {t.device} and {x2.device}")
    if not (x2.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("qmm_int8 needs contiguous tensors")
    if x2.dtype not in _DTYPE_CODES or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"qmm_int8 takes float32 or bfloat16 x, int8 q and float32 "
                        f"s, got {x2.dtype}, {q.dtype}, {s.dtype}")
    if x2.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("qmm_int8 needs x and q 16-byte aligned")
    f32 = x2.dtype == torch.float32
    plan = qmm_plan(m, k, n, f32)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    counters = ws = None
    if plan.splits > 1:
        row_tiles = -(-m // QMM_F32_ROWS) if f32 else 1
        counters, ws = split_workspace(x2.device, stream, row_tiles * (n // plan.tile_n),
                                       plan.workspace_floats)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    rc = library().rb_qmm_int8(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), m, k, n, plan.k_slice,
        plan.tile_n, _DTYPE_CODES[x2.dtype], stream)
    raise_on(rc, "qmm_int8")
    launches["qmm_int8"] += 1
    return out
