"""Model-weight checkpoints: convert once, reload fast.

The counterpart of ``runbookai_tpu/models/checkpoint.py``, and the loader's
entry: :func:`load_or_init` and :func:`model_config` take a checkpoint, an
HF directory (``models/hf_loader.py``) or no directory (random params from a
seed), deciding which in :func:`_source`. Loading an HF directory re-reads
and re-stacks every shard (and re-quantizes for int8) on each boot; a
checkpoint holds the port's params as they are:

    HF safetensors ──load_or_init(quantize_int8=...)──▶ params
    params ──save_checkpoint──▶ dir (config.json + params.safetensors)
    dir ──load_checkpoint──▶ params on the device, one tensor at a time

``config.json`` is ``dataclasses.asdict(cfg)``, as the JAX package writes
it. The JAX package writes the tree with orbax (a ``pytree/`` directory);
the port has no orbax, so its tree is one safetensors file of the flattened
leaves, named by their path (``embed``, ``layers.wq``, ``layers.wq.q``,
``layers.wq.s``, ...). int8 ``{"q", "s"}`` leaves, MoE ``[L, E, in, out]``
leaves and the router round-trip unchanged. The two packages' checkpoints
are not interchangeable: :func:`load_checkpoint` refuses a JAX one by name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import torch

from runbookai_tpu_torch.models.hf_loader import (
    config_from_hf,
    iter_safetensors,
    load_params,
    write_safetensors,
)
from runbookai_tpu_torch.models.llama import (
    CONFIGS,
    LlamaConfig,
    Params,
    init_params,
    init_params_quantized,
)
from runbookai_tpu_torch.models.quant import is_quantized, quantize_params

_CONFIG_FILE = "config.json"
_TREE_FILE = "params.safetensors"
_ORBAX_TREE = "pytree"  # the JAX package's tree directory


def _flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flatten(sub, f"{prefix}{name}.").items()}
    return {prefix[:-1]: tree}


def _insert(tree: dict, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def save_checkpoint(path: str | Path, cfg: LlamaConfig, params: Any) -> Path:
    """Write ``config.json`` and the params under ``path`` (made if
    missing); each tensor reaches the host alone."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    (path / _CONFIG_FILE).write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    write_safetensors(path / _TREE_FILE, _flatten(params))
    return path


def checkpoint_config(path: str | Path) -> LlamaConfig:
    data = json.loads((Path(path) / _CONFIG_FILE).read_text())
    # JSON turns the rope_scaling tuple into a list; the config must stay
    # hashable and equal to the one saved.
    if data.get("rope_scaling") is not None:
        data["rope_scaling"] = tuple(data["rope_scaling"])
    return LlamaConfig(**data)


def is_checkpoint(path: Optional[str | Path]) -> bool:
    return bool(path) and (Path(path) / _CONFIG_FILE).is_file() \
        and (Path(path) / _TREE_FILE).is_file()


def is_jax_checkpoint(path: Optional[str | Path]) -> bool:
    """A checkpoint of the JAX package: ``config.json`` beside an orbax
    ``pytree/`` directory."""
    return bool(path) and (Path(path) / _CONFIG_FILE).is_file() \
        and (Path(path) / _ORBAX_TREE).is_dir()


def load_checkpoint(path: str | Path, dtype: Optional[torch.dtype] = None,
                    device="cuda") -> tuple[LlamaConfig, Any]:
    """Restore ``(cfg, params)`` onto ``device`` (cuda unless the caller
    passes ``device="cpu"``), each tensor read and moved before the next.
    ``dtype`` casts the floating leaves that are not float32 (the norms, int8
    payloads and their scales, and float32 checkpoints stay as written).
    Raises ``ValueError`` for a JAX package checkpoint (orbax)."""
    path = Path(path).absolute()
    if is_jax_checkpoint(path) and not is_checkpoint(path):
        raise ValueError(
            f"{path} is a checkpoint of the JAX package (config.json + an orbax "
            f"{_ORBAX_TREE}/ directory); the PyTorch port reads its own format "
            f"(config.json + {_TREE_FILE}) and has no orbax reader. Convert the "
            "HF weights with `python -m runbookai_tpu_torch weights convert`.")
    cfg = checkpoint_config(path)
    params: dict = {}
    for name, t in iter_safetensors(path / _TREE_FILE):
        if dtype is not None and t.is_floating_point() and t.dtype != torch.float32:
            t = t.to(dtype)
        _insert(params, name, t.to(device))
    return cfg, params


def _source(model_path: Optional[str | Path]) -> str:
    """Where :func:`load_or_init` takes the params from: ``"random"`` with
    no ``model_path`` or a missing one, ``"checkpoint"`` for a checkpoint
    directory (the port's; the JAX package's is refused when it loads),
    else ``"hf"``."""
    if not model_path or not Path(model_path).exists():
        return "random"
    if is_checkpoint(model_path) or is_jax_checkpoint(model_path):
        return "checkpoint"
    return "hf"


def model_config(model_name: str, model_path: Optional[str | Path]) -> LlamaConfig:
    """The config :func:`load_or_init` gives, without the weights: a
    checkpoint directory's own, an HF directory's (named ``model_name``), or,
    where there is no directory, ``model_name``'s built-in one
    (:func:`random_config`)."""
    source = _source(model_path)
    if source == "checkpoint":
        return checkpoint_config(model_path)  # a JAX one fails at the load
    if source == "hf":
        return config_from_hf(model_path, name=model_name)
    return random_config(model_name)


def random_config(model_name: str) -> LlamaConfig:
    """The config of random weights for ``model_name``: its built-in one, or
    ``llama3-test``'s for a name outside ``CONFIGS``, as the JAX loader
    serves such a name (``runbookai_tpu/models/hf_loader.py::load_or_init``)."""
    return CONFIGS.get(model_name, CONFIGS["llama3-test"])


def load_or_init(model_name: str, model_path: Optional[str | Path],
                 dtype: torch.dtype = torch.bfloat16, device="cuda", seed: int = 0,
                 quantize_int8: bool = False) -> tuple[LlamaConfig, Params]:
    """Load a checkpoint or an HF directory at ``model_path`` when it exists,
    else draw ``model_name``'s params at random from ``seed``, on ``device``
    (cuda unless the caller passes ``device="cpu"``). ``quantize_int8`` gives
    the seven layer matrices as int8 ``{"q", "s"}`` leaves: quantized on the
    host when loaded from HF (``load_params``), drawn directly in int8 when
    random (``init_params_quantized``); ``dtype`` is the activation dtype.
    Random params take :func:`random_config`'s config: a name outside
    ``CONFIGS`` gives ``llama3-test``'s, as in the JAX package.

    A checkpoint directory is recognised before HF parsing and restored as
    written (``dtype`` casts its floating leaves that are not float32);
    ``quantize_int8`` quantizes its layer matrices unless they are int8
    already. A JAX package checkpoint (orbax) raises ``ValueError``. On a
    mesh the caller cuts the loaded params
    (``parallel/sharding.py::shard_params``)."""
    source = _source(model_path)
    if source == "checkpoint":
        cfg, params = load_checkpoint(model_path, dtype=dtype, device=device)
        if quantize_int8 and not any(is_quantized(v) for v in params["layers"].values()):
            params = quantize_params(params)
        return cfg, params
    if source == "hf":
        cfg = config_from_hf(model_path, name=model_name)
        return load_params(model_path, cfg, dtype=dtype, device=device,
                           quantize_int8=quantize_int8)
    cfg = random_config(model_name)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = init_params_quantized if quantize_int8 else init_params
    return cfg, init(cfg, dtype=dtype, device=device, generator=gen)


def convert_hf_to_checkpoint(model_path: str | Path, out_path: str | Path,
                             model_name: str = "hf-model", quantize_int8: bool = False,
                             dtype: Optional[torch.dtype] = None,
                             allow_random_init: bool = False, device="cuda") -> Path:
    """One-time conversion: an HF directory to a checkpoint (int8 layer
    matrices with ``quantize_int8``), through ``device``.

    Raises ``FileNotFoundError`` for a missing ``model_path``: falling back
    to random weights here would write a valid-looking checkpoint of noise.
    ``allow_random_init`` opts into that fallback (``model_name``'s config,
    or ``llama3-test``'s for a name without one, drawn from seed 0). As in
    the JAX package, a loaded directory's config is named ``model_name``
    only where that is a known model's name, else ``hf-model``."""
    exists = Path(model_path).exists()
    if not exists and not allow_random_init:
        raise FileNotFoundError(
            f"weights convert: model_path does not exist: {model_path} "
            "(pass --random-init to write a random-weights checkpoint)")
    name = model_name if model_name in CONFIGS else "hf-model" if exists else "llama3-test"
    cfg, params = load_or_init(name, model_path, dtype=dtype or torch.bfloat16,
                               device=device, quantize_int8=quantize_int8)
    return save_checkpoint(out_path, cfg, params)
