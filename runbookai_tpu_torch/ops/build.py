"""Build and load the port's CUDA kernels.

Every source in ``runbookai_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked into
one shared library with a plain C interface, named by a hash of all the
sources and headers, under ``runbookai_tpu_torch/_build/``. :func:`library` builds it on
first use unless a library of the same sources exists, and loads it with
``ctypes``; :data:`SIGNATURES` declares every exported function.
:func:`split_workspace` holds the counters and float32 partials of the
kernels that merge their splits in the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes; every pointer and the stream are c_void_p. All return int
# (a cudaError_t, 0 on success) except rb_error_string.
SIGNATURES = {
    # q, k, v, k_scale, v_scale, tables, ctx_lens, out, B, n_q, n_kv, hd, ps,
    # P, scale, q_dtype, kv_dtype, stream
    "rb_paged_decode_attention": [_p] * 8 + [_i] * 6 + [_f, _i, _i, _p],
    # q, k, v, k_scale, v_scale, tables, ctx_lens, q_start, out, B, T, n_q,
    # n_kv, hd, ps, P, tq, scale, q_dtype, kv_dtype, stream
    "rb_paged_chunk_attention": [_p] * 9 + [_i] * 8 + [_f, _i, _i, _p],
    # q, k, v, tables, ctx_lens, acc, m, l, B, n_q, n_kv, hd, ps, P, shard,
    # pages_local, scale, q_dtype, kv_dtype, stream
    "rb_paged_decode_attention_partial": [_p] * 8 + [_i] * 8 + [_f, _i, _i, _p],
    # q, k, v, tables, ctx_lens, q_start, acc, m, l, B, T, n_q, n_kv, hd, ps,
    # P, tq, shard, pages_local, scale, q_dtype, kv_dtype, stream
    "rb_paged_chunk_attention_partial": [_p] * 9 + [_i] * 10 + [_f, _i, _i, _p],
    # q, k, v, k_scale, v_scale, tables, ctx_lens, q_start, out, ws_acc, ws_m,
    # ws_l, B, T, n_q, n_kv, hd, ps, P, rows, splits, cols, scale, kv_dtype,
    # stream
    "rb_paged_chunk_attention_mma": [_p] * 12 + [_i] * 10 + [_f, _i, _p],
    # q, k, v, tables, ctx_lens, q_pos, acc, m, l, ws, counters, B, T, n_q,
    # n_kv, hd, ps, P, rows, splits, cols, shard, pages_local, scale, stream
    "rb_paged_chunk_attention_partial_mma": [_p] * 11 + [_i] * 12 + [_f, _p],
    # acc, m, l, out, splits, n_rows, hd, out_dtype, stream
    "rb_paged_chunk_merge": [_p] * 4 + [_i, ctypes.c_longlong, _i, _i, _p],
    # q, k, v, k_scale, v_scale, tables, ctx_lens, out, ws, counters, B, n_q,
    # n_kv, hd, ps, P, splits, cols, scale, kv_dtype, stream
    "rb_paged_decode_attention_mma": [_p] * 10 + [_i] * 8 + [_f, _i, _p],
    # q, k, v, tables, ctx_lens, acc, m, l, ws, counters, B, n_q, n_kv, hd, ps,
    # P, splits, cols, shard, pages_local, scale, stream
    "rb_paged_decode_attention_partial_mma": [_p] * 10 + [_i] * 10 + [_f, _p],
    # q, k, v, k_scale, v_scale, tables, ctx_lens, q_pos, tiles, live, out, ws,
    # counters, ctas, n_q, n_kv, hd, ps, P, rq, keys_per_split, max_splits,
    # scale, kv_dtype, stream
    "rb_paged_ragged_attention": [_p] * 13 + [_i] * 9 + [_f, _i, _p],
    # row_ids, q_pos, ctx_lens, tiles, live, weight, nb, rq, group, n_kv,
    # key_max, keys_per_split, split_runs, per_head, stream
    "rb_ragged_plan": [_p] * 6 + [_i] * 8 + [_p],
    # x, q, s, out, ws, counters, M, K, N, k_slice, tile_n, x_dtype, stream
    "rb_qmm_int8": [_p] * 6 + [_i] * 6 + [_p],
}

# The SMs of an H100, from which the kernels' plans size their grids.
SMS = 132

_lib: Optional[ctypes.CDLL] = None

# Per (device, stream): the int32 counters (zero between launches) and f32
# split partials of the kernels that merge their splits in the launch (the
# decode kernel, the chunk partial, W1, the int8 matmul), grown when a larger
# shape comes. Calls on one stream run in order, so they share it.
_split_workspaces: dict = {}


def split_workspace(device: torch.device, stream: int, n_counters: int, n_floats: int):
    """The stream's (counters, workspace), at least ``n_counters`` and
    ``n_floats`` long; allocated only when a call needs more than any
    before it."""
    key = (device.index, stream)
    counters, ws = _split_workspaces.get(key, (None, None))
    if counters is None or counters.numel() < n_counters or ws.numel() < n_floats:
        n_counters = max(n_counters, 0 if counters is None else counters.numel())
        n_floats = max(n_floats, 0 if ws is None else ws.numel())
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
        _split_workspaces[key] = (counters, ws)
    return counters, ws


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build() -> tuple[Path, str]:
    """Compile and link every source unless a library built from the same
    source and header bytes exists. Returns (library path, ptxas report)."""
    srcs = sources()
    digest = hashlib.sha256()
    for src in sorted([*srcs, *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib_path = BUILD_DIR / f"librunbook_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                           "toolkit to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = str(os.getpid())
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    reports, failed = [], []
    for src, proc in zip(srcs, procs):
        _, err = proc.communicate()
        reports.append(f"== {src.name}\n{err}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib_path, "\n".join(reports)


def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rb_error_string.argtypes = [ctypes.c_int]
        lib.rb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def raise_on(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = library().rb_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
