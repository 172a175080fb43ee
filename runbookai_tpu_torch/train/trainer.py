"""Next-token fine-tuning of the whole model on one GPU.

The counterpart of ``runbookai_tpu/train/trainer.py``: the loss
(:func:`masked_cross_entropy`, :func:`loss_fn`), AdamW written out as
``optax.adamw`` computes it (:class:`Adam`, shared with
``train/lora_trainer.py``), and :class:`Trainer`, whose ``train_step`` runs
:func:`~runbookai_tpu_torch.models.llama.forward_train` under autograd with
each layer rematerialised in the backward. JAX's trainer also shards the
batch and the params over a data x model mesh, or runs the pipeline or the
ring-attention forward on a ``pipe`` or ``seq`` axis; those need several
cards and are not ported (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from runbookai_tpu_torch.models.llama import LlamaConfig, Params, forward_train, init_params
from runbookai_tpu_torch.unported import unported


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         pad_id: int) -> torch.Tensor:
    """Mean next-token cross-entropy of float32 ``logits`` [B, T, V] over the
    ``targets`` [B, T] that are not ``pad_id``."""
    mask = (targets != pad_id).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, pad_id: int,
            adapter_ids: Optional[torch.Tensor] = None, remat: bool = False
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, T], ignoring pad
    targets: the forward reads ``tokens[:, :-1]`` and predicts
    ``tokens[:, 1:]``."""
    logits = forward_train(params, cfg, tokens[:, :-1], adapter_ids=adapter_ids, remat=remat)
    return masked_cross_entropy(logits, tokens[:, 1:], pad_id)


class Adam:
    """Adam over a list of float tensors, op for op as ``optax.adam`` (and,
    with ``weight_decay``, ``optax.adamw``) computes it: ``mu = 0.1 g + 0.9
    mu``, ``nu = 0.001 g**2 + 0.999 nu``, both bias-corrected by ``1 -
    b**count``, the update ``mu_hat / (sqrt(nu_hat) + eps)`` plus
    ``weight_decay * p`` on every leaf, scaled by ``-lr`` and added to ``p``
    in place. A leaf whose gradients were always zero keeps its value bit
    for bit (zero moments, a zero update)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, leaves: list[torch.Tensor], learning_rate: float,
                 weight_decay: float = 0.0):
        self.leaves = leaves
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        self.count += 1
        # The bias corrections in float32 on the host, as optax computes
        # them (exact as Python floats, so the divisions below round alike).
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(self.count))
                    for b in (self.b1, self.b2))
        # A profiler range named as torch's own optimizers name theirs.
        with torch.profiler.record_function("Optimizer.step#Adam.step"):
            for p, g, mu, nu in zip(self.leaves, grads, self.mu, self.nu):
                mu.copy_((1 - self.b1) * g + self.b1 * mu)
                nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if self.weight_decay:
                    update = update + self.weight_decay * p
                p.add_(update * -self.lr)


def _leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


class Trainer:
    """Full fine-tuning on one card: params drawn from ``seed`` (a
    ``torch.Generator`` on ``device``) in ``dtype``, AdamW (``optax.adamw``'s
    numbers), and ``train_step(tokens) -> loss``. ``remat`` recomputes each
    layer's activations in the backward. A ``mesh`` with any axis over 1
    (data, tensor, pipeline or sequence parallelism) is not ported."""

    def __init__(self, cfg: LlamaConfig, mesh=None, learning_rate: float = 1e-5,
                 weight_decay: float = 0.01, pad_id: int = 0,
                 dtype: torch.dtype = torch.float32, remat: bool = True, seed: int = 0,
                 device="cuda"):
        if mesh is not None and any(n > 1 for n in mesh.shape.values()):
            raise unported(f"training on a mesh {dict(mesh.shape)} (data, tensor, "
                           "pipeline and sequence parallelism)", "queue 1 item 6")
        self.cfg = cfg
        self.pad_id = pad_id
        self.remat = remat
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = init_params(cfg, dtype=dtype, device=self.device, generator=gen)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        self.state = TrainState(params=params,
                                opt_state=Adam(leaves, learning_rate, weight_decay))

    def train_step(self, tokens) -> float:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        opt = self.state.opt_state
        loss = loss_fn(self.state.params, self.cfg, tokens, self.pad_id, remat=self.remat)
        grads = torch.autograd.grad(loss, opt.leaves)
        opt.step(grads)
        self.state.step += 1
        return loss.item()
