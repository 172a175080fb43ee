"""Parameter conversion from the JAX package's layout.

Both packages keep the same stacked pytree (``embed``, ``layers`` with
``[L, in, out]`` matrices, ``final_norm``, optional ``lm_head``), so
conversion is one tensor per leaf; it lets the tests feed both packages the
same weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from runbookai_tpu_torch.models.llama import Params


def params_from_jax(np_params: dict, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """Turn the JAX parameter pytree, as nested dicts of numpy arrays, into
    the port's tensors on ``device`` (cuda unless the caller passes
    ``device="cpu"``). Norm weights stay float32; other leaves keep their
    dtype unless ``dtype`` is given."""

    def leaf(name: str, x: Any) -> torch.Tensor:
        if isinstance(x, dict):
            raise ValueError(f"{name}: quantized leaves are not ported")
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        if name.endswith("norm"):
            t = t.float()
        elif dtype is not None:
            t = t.to(dtype)
        return t.to(device)

    out: Params = {}
    for name, value in np_params.items():
        if isinstance(value, dict):
            if name != "layers":
                raise ValueError(f"unsupported parameter subtree {name!r} "
                                 f"(LoRA and quantized leaves are not ported)")
            out[name] = {k: leaf(k, v) for k, v in value.items()}
        else:
            out[name] = leaf(name, value)
    return out
