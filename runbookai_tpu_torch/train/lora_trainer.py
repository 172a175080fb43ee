"""LoRA fine-tuning: train one adapter of a registry with the base frozen.

The counterpart of ``runbookai_tpu/train/lora_trainer.py``. The trainable
tree IS the serving tree: the stacked ``{leaf: {"A": [L, N, in, r], "B":
[L, N, r, out]}}`` of :class:`~runbookai_tpu_torch.models.lora.LoraRegistry`,
so a tuned adapter goes back into the registry that live engines serve from
(:meth:`LoraTrainer.publish`, then each engine's ``refresh_lora()``) or out
as an HF PEFT directory (:meth:`LoraTrainer.export_peft`) with no
conversion. Gradients reach only the selected adapter row; the base params
are read, never updated, and carry no optimizer state (Adam moments for the
rank-r factors only, the memory point of LoRA). The base forward is the
serving one's pieces (:func:`~runbookai_tpu_torch.models.llama.forward_train`:
bf16 or int8 weights as they are, int8 products widened, never the int8
kernel) with each layer rematerialised in the backward.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from runbookai_tpu_torch.models.hf_loader import write_safetensors
from runbookai_tpu_torch.models.llama import LlamaConfig
from runbookai_tpu_torch.models.lora import LoraRegistry
from runbookai_tpu_torch.train.trainer import Adam, loss_fn

# Our leaves -> HF PEFT module names.
_PEFT_OF = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}


class LoraTrainer:
    """Fine-tuning step of one registry row over a frozen base model.

    ``adapter_name`` selects the row that trains; every other row, the
    reserved zero row included, receives zero gradients through the gather
    and keeps its value bit for bit (zero moments, zero updates)."""

    def __init__(self, cfg: LlamaConfig, base_params: Any, registry: LoraRegistry,
                 adapter_name: str, learning_rate: float = 1e-4, pad_id: int = 0,
                 remat: bool = True):
        self.cfg = cfg
        self.registry = registry
        self.adapter_name = adapter_name
        self.adapter_idx = registry.index_of(adapter_name)
        self.pad_id = pad_id
        self.remat = remat
        # A float32 MASTER copy, cloned: the registry may hold bf16 for
        # serving, where Adam's ~1e-4 steps round to nothing, and live
        # engines hold the registry's stacked tensors.
        self.lora_tree = {t: {ab: w.detach().to(torch.float32, copy=True)
                              for ab, w in ab_w.items()}
                          for t, ab_w in registry.stacked().items()}
        self.device = registry.device
        # A freshly registered adapter is all zero, a saddle point (A = 0 and
        # B = 0 zero every LoRA gradient). Standard LoRA init: A ~ N(0,
        # 1/in), B = 0, so the output starts at the base model's and dB is
        # nonzero from the first step.
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        for leaves in self.lora_tree.values():
            a_row = leaves["A"][:, self.adapter_idx]
            if not (a_row.any() or leaves["B"][:, self.adapter_idx].any()):
                fan_in = torch.sqrt(torch.tensor(float(a_row.shape[1]), device=self.device))
                a_row.copy_(torch.randn(a_row.shape, generator=gen, device=self.device)
                            / fan_in)
        self.trainable = [w for ab_w in self.lora_tree.values() for w in ab_w.values()]
        for w in self.trainable:
            w.requires_grad_(True)
        self.opt = Adam(self.trainable, learning_rate)
        self.base = {k: v for k, v in base_params.items() if k != "lora"}

    def train_step(self, tokens) -> float:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        adapter_ids = torch.full((tokens.shape[0],), self.adapter_idx, dtype=torch.long,
                                 device=self.device)
        loss = loss_fn({**self.base, "lora": self.lora_tree}, self.cfg, tokens, self.pad_id,
                       adapter_ids=adapter_ids, remat=self.remat)
        self.opt.step(torch.autograd.grad(loss, self.trainable))
        return loss.item()

    def _row(self, t: str, ab: str) -> np.ndarray:
        """The trained adapter's ``[L, in, r]`` A or ``[L, r, out]`` B, float32."""
        return self.lora_tree[t][ab][:, self.adapter_idx].detach().cpu().numpy()

    def publish(self) -> None:
        """Push ONLY the trained adapter's row into the registry, so live
        engines serve it after ``refresh_lora()``; other rows (and adapters
        registered after this trainer was built) are untouched."""
        self.registry.update_adapter(self.adapter_name, {
            t: {"A": self._row(t, "A"), "B": self._row(t, "B")}
            for t in self.registry.targets})

    def export_peft(self, out_dir, alpha: Optional[float] = None) -> None:
        """Write the trained adapter as an HF PEFT directory
        (``adapter_config.json``, ``adapter_model.safetensors``). The
        registry folds ``alpha / r`` into B at load; export divides it back
        out (default alpha = r, a scale of 1)."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        alpha = float(alpha if alpha is not None else self.registry.rank)
        inv_scale = self.registry.rank / alpha
        tensors = {}
        for t in self.registry.targets:
            a, b = self._row(t, "A"), self._row(t, "B")  # [L, in, r], [L, r, out]
            for i in range(self.cfg.n_layers):
                base = f"base_model.model.model.layers.{i}.self_attn.{_PEFT_OF[t]}"
                tensors[f"{base}.lora_A.weight"] = np.ascontiguousarray(
                    a[i].T.astype(np.float32))  # [r, in]
                tensors[f"{base}.lora_B.weight"] = np.ascontiguousarray(
                    (b[i] * inv_scale).T.astype(np.float32))  # [out, r]
        write_safetensors(out / "adapter_model.safetensors", tensors)
        (out / "adapter_config.json").write_text(json.dumps({
            "r": self.registry.rank, "lora_alpha": alpha,
            "target_modules": sorted(_PEFT_OF[t] for t in self.registry.targets),
            "peft_type": "LORA",
        }, indent=2))
