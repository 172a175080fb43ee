"""Parameter conversion from the JAX package's layout.

Both packages keep the same stacked pytree (``embed``, ``layers`` with
``[L, in, out]`` matrices, ``final_norm``, optional ``lm_head``), so
conversion is one tensor per leaf; it lets the tests feed both packages the
same weights. The bge encoder's params (``models/bge.py``) share their layout
with the JAX package's too. An int8 ``{"q": int8, "s": float32}`` layer leaf converts to a
dict of the same two tensors, in their own types; MoE expert leaves
``[L, E, in, out]`` (plain or int8) and the router carry across as they are. A draft model's params are
any Llama config's. LoRA adapters carry across too: a stacked ``"lora"``
tree (``{leaf: {"A", "B"}}``) inside the params, and a whole JAX
``LoraRegistry`` (its names and float32 host arrays,
:func:`lora_registry_from_jax`), so both packages serve the same adapters.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from runbookai_tpu_torch.models.llama import LlamaConfig, Params
from runbookai_tpu_torch.models.lora import LoraRegistry


def params_from_jax(np_params: dict, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """Turn the JAX parameter pytree, as nested dicts of numpy arrays, into
    the port's tensors on ``device`` (cuda unless the caller passes
    ``device="cpu"``). Norm weights stay float32; int8 leaves keep their
    types; other leaves keep their dtype unless ``dtype`` is given."""

    def tensor(x: Any) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy
            return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True))

    def leaf(name: str, x: Any) -> Any:
        if isinstance(x, dict):
            if set(x) != {"q", "s"}:
                raise ValueError(f"{name}: unsupported parameter subtree {sorted(x)}")
            return {"q": tensor(x["q"]).to(device, torch.int8),
                    "s": tensor(x["s"]).to(device, torch.float32)}
        t = tensor(x)
        if name.endswith("norm"):
            t = t.float()
        elif dtype is not None:
            t = t.to(dtype)
        return t.to(device)

    out: Params = {}
    for name, value in np_params.items():
        if name == "lora":
            out[name] = {t: {ab: leaf(t, w) for ab, w in ab_w.items()}
                         for t, ab_w in value.items()}
        elif isinstance(value, dict):
            if name != "layers":
                raise ValueError(f"unsupported parameter subtree {name!r}")
            out[name] = {k: leaf(k, v) for k, v in value.items()}
        else:
            out[name] = leaf(name, value)
    return out


def lora_registry_from_jax(jax_registry, cfg: LlamaConfig, device="cuda",
                           dtype: torch.dtype = torch.bfloat16) -> LoraRegistry:
    """A port :class:`LoraRegistry` holding what a JAX package
    ``LoraRegistry`` holds: the same rank, targets, names at the same rows
    and float32 host arrays (``alpha / r`` already folded into B), stacked on
    ``device`` in ``dtype``. ``cfg`` is the port's config of the same model."""
    reg = LoraRegistry(cfg, rank=jax_registry.rank, targets=tuple(jax_registry.targets),
                       dtype=dtype, device=device)
    reg._host = {t: {ab: [np.array(a, np.float32, copy=True) for a in arrays]
                     for ab, arrays in ab_arrays.items()}
                 for t, ab_arrays in jax_registry._host.items()}
    reg._names = dict(jax_registry._names)
    return reg


def bge_params_from_jax(np_params: dict, device="cuda") -> dict:
    """The JAX package's bge params (``models/bge.py``: top-level embedding
    and norm leaves, ``layers`` stacked ``[L, ...]``), as nested dicts of
    numpy arrays, as the port's tensors on ``device``, each leaf in its own
    dtype: the state :class:`~runbookai_tpu_torch.models.bge.BertEncoder`
    takes."""
    return params_from_jax(np_params, device=device)
