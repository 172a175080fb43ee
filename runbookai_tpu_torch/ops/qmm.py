"""Int8 weight-only matmul of the decode and verify forwards, and its plain
version.

The CUDA kernel ``rb_qmm_int8`` (``csrc/qmm.cu``) replaces the Pallas TPU
kernel ``qmm_pallas`` of ``runbookai_tpu/ops/qmm_pallas.py``: ``(x2 @
widen(q)) * s`` with int8 ``q [K, N]`` read once from device memory, float32
sums and the per-output-channel scale ``s [1, N]`` applied once to each sum.
Decode is bound by the bytes of the weights, so reading int8 instead of a
bf16 copy halves them.

:func:`qmm_eligible` is the JAX package's ``qmm_pallas_eligible`` with its
constants, copied so that the port sends exactly the shapes to the kernel
that the JAX package sends to ``qmm_pallas`` (``models/llama.py::qmm`` takes
the matmul expression for the others). :func:`qmm_int8` raises on any other
shape. Given CPU tensors it computes the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from runbookai_tpu_torch.ops.build import library, raise_on

# Decode/verify dispatches have M = batch_slots * k_steps rows (<= ~256);
# larger M is chunked prefill, which the matmul expression serves.
MAX_M = 256
_BK_CANDIDATES = (1024, 512, 256, 128, 64, 32)
_BN_CANDIDATES = (512, 256, 128)

# The kernel's block tile (csrc/qmm.cu kRows, kCols) and the SMs of an H100,
# from which the wrapper sizes the split over K.
QMM_ROWS, QMM_COLS = 8, 128
SMS = 132

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


def qmm_splits(m: int, k: int, n: int) -> int:
    """Slices of K for one call: enough blocks for about two per SM, at most
    ``k / (32 m)`` slices so that the float partial sums stay under a quarter
    of the weight bytes, each slice a whole multiple of 32 rows of K."""
    blocks = -(-m // QMM_ROWS) * (n // QMM_COLS)
    splits = max(1, min(-(-2 * SMS // blocks), k // (32 * m)))
    while k % (32 * splits):
        splits += 1
    return splits


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
    if q.data_ptr() % 4:
        raise ValueError("qmm_int8 needs q 4-byte aligned")
    splits = qmm_splits(m, k, n)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
               if splits > 1 else None)
    rc = library().rb_qmm_int8(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), m, k, n, k // splits,
        _DTYPE_CODES[x2.dtype], torch.cuda.current_stream(x2.device).cuda_stream)
    raise_on(rc, "qmm_int8")
    launches["qmm_int8"] += 1
    return out
