"""What the stage-1 and stage-2 trainers share: moving a batch to the
device, the step's dropout bits and seeds, the frozen backbone, one
training step
(forward, backward, optimizer), the per-group learning rates, and the
resumable train-state artifact.

A subclass sets `args`, `device`, `backbone`, `model` (an nn.Module whose
children are the optimizer's named modules), `opt` (engine/optim.
GroupedOptimizer), `lr` ({group: rate}), `arch`, `drop_gen`, `loss_fn`
(batch, drop_bits, drop_seeds) -> (total, metrics), `start_epoch` and
`steps`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    load_checkpoint, save_checkpoint)
from text_guided_face_recognition_tpu_torch.engine.evaluate import (
    backbone_features)
from text_guided_face_recognition_tpu_torch.ops.dropout import (
    draw, draw_seeds)

__all__ = ["TrainerBase", "nan_guard"]


def nan_guard(metrics: Dict[str, float], step: int) -> None:
    for k, v in metrics.items():
        if not math.isfinite(v):
            raise FloatingPointError(
                f"non-finite metric {k!r}={v} at step {step}")


class TrainerBase:
    def _apply_lrs(self) -> None:
        for group, lr in self.lr.items():
            self.opt.set_lr(group, lr)

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """A loader batch (numpy) on the device; string fields dropped."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     non_blocking=True)
                for k, v in batch.items() if k != "key"}

    def draw_drop(self, b: int, t: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """One step's dropout for the text tower, drawn on the device from
        drop_gen: (host bits, kernel seeds). In host mode (fused_dropout)
        the bits of every site and no seeds; in prng mode the bits of the
        sites the kernels do not draw, then their int32 seeds. (None, None)
        without dropout."""
        n_bits, n_seeds = self.model.text_encoder.model.drop_counts(b, t)
        if not n_bits:
            return None, None
        bits = draw(n_bits, self.drop_gen, self.device)
        seeds = (draw_seeds(n_seeds, self.drop_gen, self.device) if n_seeds
                 else None)
        return bits, seeds

    @torch.no_grad()
    def image_features(self, img: torch.Tensor):
        """The frozen backbone's (global, local) features."""
        return backbone_features(self.backbone, self.args.model_type, img)

    def compute_grads(self, batch, drop_bits=None, drop_seeds=None):
        """Forward and backward of one step: the gradients land in the
        parameters' .grad. Returns (total, metrics). The step draws its
        dropout (`draw_drop`) unless the caller replays one."""
        if drop_bits is None and drop_seeds is None:
            drop_bits, drop_seeds = self.draw_drop(*batch["caps"].shape)
        self.opt.zero_grad()
        total, metrics = self.loss_fn(batch, drop_bits, drop_seeds)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch, drop_bits=None, acc=None, drop_seeds=None
                   ) -> Dict[str, torch.Tensor]:
        """One training step on a device batch; returns its metrics (added
        to `acc` on the device when given)."""
        _, metrics = self.compute_grads(batch, drop_bits, drop_seeds)
        self.opt.step()
        self.steps += 1
        if acc is not None:
            metrics = {k: acc[k] + v for k, v in metrics.items()}
        return metrics

    def save_state(self, save_dir: str, epoch: int) -> None:
        """The resumable third artifact: model, optimizer, epoch, LRs."""
        save_checkpoint(f"{save_dir}/train_state_{epoch}", {
            "model": self.model.state_dict(),
            "optimizer": self.opt.state_dict(),
            "meta": {"epoch": epoch, "lr": dict(self.lr)}})

    def resume_from(self, path: str) -> None:
        tree = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(tree["model"])
        self.opt.load_state_dict(tree["optimizer"])
        self.lr = {k: float(v) for k, v in tree["meta"]["lr"].items()}
        self._apply_lrs()
        self.start_epoch = int(tree["meta"]["epoch"]) + 1
        print("resumed from", path, "at epoch", self.start_epoch)
