"""Paged attention kernels of the serving forward, their plain versions, and
their build.

Two CUDA kernels (``csrc/paged_attention.cu``) replace the Pallas TPU
kernels of ``runbookai_tpu/ops/paged_attention_pallas.py``:

- :func:`paged_decode_attention` — one query token per sequence (T = 1);
  replaces Pallas ``paged_decode_attention``.
- :func:`paged_chunk_attention` — T > 1 (chunked prefill and the speculative
  verify); replaces Pallas ``paged_chunk_attention``.

Semantics follow the Pallas kernels, not the XLA reference
``ops/attention.paged_attention``: a row that sees no key (ctx 0) gives
zeros, and chunk query positions derive from ``q_positions[:, 0] + t`` (the
contiguity contract; the prefill pad tail breaks it, but those rows are
discarded by every caller).

A wrapper given CPU tensors computes the plain version below; given CUDA
tensors it launches the kernel or raises. The kernels are compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface on
first use (into ``runbookai_tpu_torch/_build/``) and loaded with ``ctypes``.
``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e30

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "paged_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per wrapper (plain-version calls are not counted).
launches = {"paged_decode_attention": 0, "paged_chunk_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------------- build


def build() -> tuple[Path, str]:
    """Compile ``csrc/paged_attention.cu`` unless a library built from the
    same source bytes exists. Returns (library path, ptxas report)."""
    src = SOURCE.read_bytes()
    lib_path = BUILD_DIR / f"libpaged_attention_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the paged attention kernels need "
                           "the CUDA toolkit to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rb_paged_decode_attention.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, p]
        lib.rb_paged_decode_attention.restype = i
        lib.rb_paged_chunk_attention.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i, p]
        lib.rb_paged_chunk_attention.restype = i
        lib.rb_error_string.argtypes = [i]
        lib.rb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ----------------------------------------------------------- plain version


def plain_paged_attention(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_flat: torch.Tensor,  # [num_pages * page_size, n_kv, hd]
    v_flat: torch.Tensor,  # same
    page_tables: torch.Tensor,  # [B, P] int32
    ctx_lens: torch.Tensor,  # [B] int32
    q_start: Optional[torch.Tensor],  # [B] int32; None = no causal mask
    page_size: int,
) -> torch.Tensor:
    """Plain PyTorch version of both kernels: gather each sequence's pages,
    mask keys at ``pos >= ctx`` (and, with ``q_start``, at ``pos >
    q_start + t``), softmax in f32 with masked probabilities zeroed and the
    normaliser clamped at 1e-30. Returns [B, T, n_q, hd] in q's dtype."""
    b, t, n_q, hd = q.shape
    n_kv = k_flat.shape[1]
    group = n_q // n_kv
    max_ctx = int(ctx_lens.max()) if b else 0
    n_pages = min(page_tables.shape[1], -(-max_ctx // page_size))
    if n_pages <= 0:
        return torch.zeros_like(q)
    dev = q.device
    pages = page_tables[:, :n_pages].long()
    rows = (pages[:, :, None] * page_size
            + torch.arange(page_size, device=dev)).reshape(b, -1)  # [B, S]
    k = k_flat[rows].float()  # [B, S, n_kv, hd]
    v = v_flat[rows].float()
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, t, n_kv, group, hd)
    scores = torch.einsum("btkgd,bskd->btkgs", qf, k)
    pos = torch.arange(rows.shape[1], device=dev)
    mask = (pos[None, :] < ctx_lens[:, None].long())[:, None, :]  # [B, 1, S]
    if q_start is not None:
        qpos = q_start[:, None].long() + torch.arange(t, device=dev)  # [B, T]
        mask = mask & (pos[None, None, :] <= qpos[:, :, None])
    mask = mask[:, :, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("btkgs,bskd->btkgd", p, v) / l.clamp_min(1e-30)
    return out.reshape(b, t, n_q, hd).to(q.dtype)


# ------------------------------------------------------------------ wrappers


def _check(q, k_flat, v_flat, page_tables, ctx_lens, page_size, extra=()):
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, got {q.device}")
    tensors = (q, k_flat, v_flat, page_tables, ctx_lens, *extra)
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"tensors on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError("paged attention needs contiguous tensors")
    if q.dtype not in _DTYPE_CODES or k_flat.dtype not in _DTYPE_CODES:
        raise TypeError(f"q {q.dtype} / pool {k_flat.dtype}: kernels take "
                        f"float32 or bfloat16")
    if v_flat.dtype != k_flat.dtype or v_flat.shape != k_flat.shape:
        raise ValueError("K and V pools differ in dtype or shape")
    for x in (page_tables, ctx_lens, *extra):
        if x.dtype != torch.int32:
            raise TypeError(f"page tables and lengths must be int32, got {x.dtype}")
    n_q, hd = q.shape[-2:]
    if k_flat.ndim != 3 or k_flat.shape[2] != hd or k_flat.shape[0] % page_size:
        raise ValueError(f"pool shape {tuple(k_flat.shape)} does not hold "
                         f"pages of {page_size} x [n_kv, {hd}]")
    if n_q % k_flat.shape[1]:
        raise ValueError(f"{n_q} query heads do not group over {k_flat.shape[1]} kv heads")
    b = q.shape[0]
    if page_tables.ndim != 2 or page_tables.shape[0] != b or ctx_lens.shape != (b,):
        raise ValueError("page tables must be [B, P] and ctx_lens [B]")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _load().rb_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def paged_decode_attention(
    q: torch.Tensor,  # [B, n_q, hd]
    k_flat: torch.Tensor,  # [num_pages * page_size, n_kv, hd]
    v_flat: torch.Tensor,  # same
    page_tables: torch.Tensor,  # [B, P] int32 (physical page ids; 0 = null)
    ctx_lens: torch.Tensor,  # [B] int32
    page_size: int,
) -> torch.Tensor:
    """Ragged paged attention for decode (one query token per sequence)."""
    if q.device.type == "cpu":
        return plain_paged_attention(q[:, None], k_flat, v_flat, page_tables,
                                     ctx_lens, None, page_size)[:, 0]
    _check(q, k_flat, v_flat, page_tables, ctx_lens, page_size)
    lib = _load()
    b, n_q, hd = q.shape
    out = torch.empty_like(q)
    rc = lib.rb_paged_decode_attention(
        q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(),
        page_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        b, n_q, k_flat.shape[1], hd, page_size, page_tables.shape[1],
        1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_flat.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out


def chunk_q_block(n_q: int, n_kv: int, t: int) -> int:
    """Query tokens per chunk-kernel block: about 32 query-head rows."""
    return max(1, min(t, 32 // (n_q // n_kv)))


def paged_chunk_attention(
    q: torch.Tensor,  # [B, T, n_q, hd]
    k_flat: torch.Tensor,  # [num_pages * page_size, n_kv, hd]
    v_flat: torch.Tensor,  # same
    page_tables: torch.Tensor,  # [B, P] int32
    ctx_lens: torch.Tensor,  # [B] int32, cache length AFTER the chunk
    q_positions: torch.Tensor,  # [B, T] int32, contiguous ascending per row
    page_size: int,
) -> torch.Tensor:
    """Ragged paged attention for T > 1 chunks (prefill / speculative
    verify), causal over ``q_positions[:, 0] + t``."""
    q_start = q_positions[:, 0].contiguous()
    if q.device.type == "cpu":
        return plain_paged_attention(q, k_flat, v_flat, page_tables, ctx_lens,
                                     q_start, page_size)
    _check(q, k_flat, v_flat, page_tables, ctx_lens, page_size, (q_start,))
    lib = _load()
    b, t, n_q, hd = q.shape
    n_kv = k_flat.shape[1]
    out = torch.empty_like(q)
    rc = lib.rb_paged_chunk_attention(
        q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(),
        page_tables.data_ptr(), ctx_lens.data_ptr(), q_start.data_ptr(),
        out.data_ptr(), b, t, n_q, n_kv, hd, page_size, page_tables.shape[1],
        chunk_q_block(n_q, n_kv, t), 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_flat.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_chunk_attention")
    launches["paged_chunk_attention"] += 1
    return out
