"""The serving mesh and its collectives.

The counterpart of ``runbookai_tpu/parallel/mesh.py`` for one process. The
JAX package runs one program over a mesh of devices under ``shard_map``;
here a mesh is an explicit list of devices, one per shard, and the forward
loops over the shards. A collective is a function over the shards' tensors:
it moves them to one device, combines them there and hands each shard its
copy. Several shards may sit on one device (the CPU tests give
``["cpu"] * n``); shards on one device then share one copy of a replicated
activation.

Axes: ``model`` shards attention heads, the MLP and the vocabulary
(Megatron tensor parallelism); ``seq`` shards the page pool's token axis
for KV page-split serving (``parallel/kv_split.py``); ``data`` is 1.
The combined tensor-parallel axis is model-major, as ``(MODEL_AXIS,
SEQ_AXIS)`` orders it in JAX: shard (m, s) is TP rank ``m * seq + s``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """``model`` x ``seq`` shards; ``devices[r]`` holds TP rank ``r``."""

    model: int
    seq: int
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if self.model < 1 or self.seq < 1:
            raise ValueError(f"mesh axes must be >= 1, got model={self.model} "
                             f"seq={self.seq}")
        if len(self.devices) != self.model * self.seq:
            raise ValueError(f"mesh {self.model}x{self.seq} needs "
                             f"{self.model * self.seq} devices, got {len(self.devices)}")

    @property
    def tp(self) -> int:
        return self.model * self.seq

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: 1, SEQ_AXIS: self.seq, MODEL_AXIS: self.model}

    def rank(self, m: int, s: int) -> int:
        """TP rank of shard (model m, seq s): model-major."""
        return m * self.seq + s

    def coords(self, rank: int) -> tuple[int, int]:
        """(model, seq) of a TP rank."""
        return divmod(rank, self.seq)


def build_mesh(model: int = 1, seq: int = 1,
               devices: Optional[Sequence] = None) -> Mesh:
    """A ``model`` x ``seq`` mesh. With no ``devices`` it takes one CUDA
    card per shard and raises where the host has fewer; a caller that wants
    several shards on one device passes the list itself."""
    need = model * seq
    if devices is None:
        have = torch.cuda.device_count()
        if have < need:
            raise ValueError(f"mesh {model}x{seq} needs {need} CUDA devices, "
                             f"have {have} (pass devices= to place several "
                             f"shards on one device)")
        devices = [f"cuda:{i}" for i in range(need)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"mesh {model}x{seq} needs {need} devices, "
                         f"got {len(devices)}")
    return Mesh(model=model, seq=seq, devices=tuple(devices[:need]))


# ---------------------------------------------------------------- collectives


def replicate(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """One copy of ``x`` per shard; shards on one device share it."""
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return out


def map_replicated(fn: Callable, *lists: list) -> list:
    """``fn`` over replicated lists, shard by shard, evaluated once per
    distinct tuple of tensors, so that shards sharing their inputs share
    the result."""
    done: dict[tuple, object] = {}
    out = []
    for args in zip(*lists):
        key = tuple(map(id, args))
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


def all_reduce_sum(parts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Sum of the shards' partial results, one copy per shard. The sum runs
    in float32 on rank 0's device, in rank order, and is cast back once.
    A single part (a product that every shard would compute alike, from a
    replicated weight) is only handed out."""
    home = mesh.devices[0]
    if len(parts) == 1:
        return replicate(parts[0], mesh)
    total = parts[0].to(home, torch.float32)
    for p in parts[1:]:
        total = total + p.to(home, torch.float32)
    return replicate(total.to(parts[0].dtype), mesh)


def all_gather(parts: list[torch.Tensor], dim: int,
               device: torch.device) -> torch.Tensor:
    """The shards' slices concatenated along ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)
