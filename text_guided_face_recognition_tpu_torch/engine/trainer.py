"""What the stage-1 and stage-2 trainers share: moving a batch to the
device, the step's dropout bits and seeds, the frozen backbone, one
training step
(forward, backward, optimizer), the per-group learning rates, the
frozen-feature cache's refresh, and the resumable train state: the port's
own artifact, or the JAX package's exported by tools/
export_jax_checkpoint.py.

A subclass sets `args`, `device`, `backbone`, `model` (an nn.Module whose
children are the optimizer's named modules), `opt` (engine/optim.
GroupedOptimizer), `lr` ({group: rate}), `arch`, `drop_gen`, `loss_fn`
(batch, drop_bits, drop_seeds) -> (total, metrics), `start_epoch` and
`steps`, and calls `init_step(eager)`.

The compiled step. On a CUDA device a trainer runs its step as one CUDA
graph of forward, backward and optimizer, the counterpart of the JAX
package's `jax.jit(train_step, donate_argnums=(0,))`, unless it was made
with `eager=True` (on the CPU it is always eager). The first WARMUP_STEPS
steps run eagerly on the capture stream (the lazy set-up of the kernels:
K2's arrival counters of that stream, the half-layer backwards' side stream,
the libraries' first loads); the next step is captured and replayed, and
every later one replayed. Each is a real step: N steps captured equal N
eager steps. A replay reads the batch from static buffers it is copied into,
one a key of the captured batch (`img`, or the cached `img_gl` and `img_lc`;
the train loader drops its last batch, so shapes are fixed; a batch of other
keys or shapes raises), and the dropout bits and seeds from static buffers
that `drop_gen` fills before it, outside the graph, in the eager step's
order. Learning rates and Adam counts are tensors the graph reads
(engine/optim.py). A capture that fails raises: there is no eager fallback.
The kernels' launch counters count at capture, not at replay.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    is_jax_export, load_checkpoint, load_jax_export, save_checkpoint)
from text_guided_face_recognition_tpu_torch.engine.evaluate import (
    backbone_features)
from text_guided_face_recognition_tpu_torch.engine.feature_cache import (
    FrozenFeatureCache)
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    optimizer_state_from_jax, state_dict_from_jax)
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
        """A loader batch (numpy, or CPU tensors) on the device; string
        fields dropped."""
        return {k: (v if torch.is_tensor(v) else torch.as_tensor(
                    np.asarray(v))).to(self.device, non_blocking=True)
                for k, v in batch.items() if k != "key"}

    def init_feature_cache(self) -> None:
        """The frozen-feature cache when `frozen_feature_cache` is on."""
        self.feat_cache = (FrozenFeatureCache(self.backbone, self.args,
                                              self.device)
                           if self.args.frozen_feature_cache else None)

    def refresh_features(self) -> None:
        """Before an epoch's first batch: the cache's refresh over the
        train split (no batch of the epoch is made before it)."""
        if self.feat_cache is not None:
            self.feat_cache.refresh(self.train_ds)

    def draw_drop(self, b: int, t: int, out=(None, None)
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """One step's dropout for the text encoder, drawn on the device from
        drop_gen: (host bits, kernel seeds), into the tensors `out` when
        given. BERT in host mode (fused_dropout): the bits of every site
        and no seeds; in prng mode the bits of the sites the kernels do not
        draw, then their int32 seeds. LSTM/GRU: the embeddings' bits. (None,
        None) without dropout."""
        n_bits, n_seeds = self.model.text_encoder.drop_counts(b, t)
        if not n_bits:
            return None, None
        bits = draw(n_bits, self.drop_gen, self.device, out=out[0])
        seeds = (draw_seeds(n_seeds, self.drop_gen, self.device, out=out[1])
                 if n_seeds else None)
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
        to `acc` on the device when given). Eager, or the captured step
        (module docstring)."""
        if self.eager:
            metrics = self._eager_step(batch, drop_bits, drop_seeds)
        elif self.graph is None and self._warm < self.WARMUP_STEPS:
            side = self._capture_stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                metrics = self._eager_step(batch, drop_bits, drop_seeds)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._warm += 1
        else:
            metrics = self._replay(batch, drop_bits, drop_seeds)
        self.steps += 1
        if acc is not None:
            return {k: acc[k] + v for k, v in metrics.items()}
        return metrics

    # ------------------------------------------------------ the step --

    WARMUP_STEPS = 3

    def init_step(self, eager: bool) -> None:
        """Eager steps (`eager`, or a device other than CUDA) or the
        captured step."""
        self.eager = bool(eager) or self.device.type != "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_replays = 0
        self._warm = 0
        self._capture_stream = (None if self.eager
                                else torch.cuda.Stream(self.device))

    def _eager_step(self, batch, drop_bits, drop_seeds):
        _, metrics = self.compute_grads(batch, drop_bits, drop_seeds)
        self.opt.step()
        return metrics

    def _replay(self, batch, drop_bits, drop_seeds):
        """Fill the static inputs (the batch, then this step's dropout from
        drop_gen unless the caller hands it), capture at the first call,
        replay; the metrics are copied out of the graph's outputs."""
        if self.graph is None:
            self._static = {k: torch.empty_like(v) for k, v in batch.items()}
            n_bits, n_seeds = self.model.text_encoder.drop_counts(
                *batch["caps"].shape)
            self._static_drop = tuple(
                torch.empty(n, dtype=torch.int32, device=self.device)
                if n_bits and n else None for n in (n_bits, n_seeds))
        sig = {k: (v.shape, v.dtype) for k, v in batch.items()}
        want = {k: (v.shape, v.dtype) for k, v in self._static.items()}
        if sig.keys() != want.keys():
            raise ValueError(f"the captured train step reads the batch keys "
                             f"{sorted(want)}, got {sorted(sig)} (captured "
                             "with or without the frozen-feature cache; "
                             "eager=True takes any)")
        if sig != want:
            raise ValueError(f"the captured train step takes batches of "
                             f"{want}, got {sig} (the train loader drops "
                             "its last batch; eager=True takes any)")
        for k, v in batch.items():
            self._static[k].copy_(v)
        if drop_bits is None and drop_seeds is None:
            self.draw_drop(*batch["caps"].shape, out=self._static_drop)
        else:
            for dst, src in zip(self._static_drop, (drop_bits, drop_seeds)):
                if dst is not None:
                    dst.copy_(src)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.graph_replays += 1
        return {k: v.clone() for k, v in self._static_out.items()}

    def _capture(self) -> None:
        """Capture forward, backward and optimizer step on the warmed-up
        capture stream. Gradients are made inside the capture (set to None
        first), so each replay writes them where the captured optimizer
        reads them."""
        side = self._capture_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        self.opt.zero_grad()
        graph = torch.cuda.CUDAGraph()
        bits, seeds = self._static_drop
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                total, metrics = self.loss_fn(self._static, bits, seeds)
                total.backward()
                self.opt.step()
        except Exception as e:
            raise RuntimeError(
                f"{type(self).__name__}: capturing the train step in a CUDA "
                f"graph failed (fused_block={self.args.fused_block!r}, "
                f"compute_dtype={self.args.compute_dtype!r}): {e}") from e
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._static_out = {k: v.detach() for k, v in metrics.items()}
        self.graph = graph

    def save_state(self, save_dir: str, epoch: int) -> None:
        """The resumable third artifact: model, optimizer, epoch, LRs."""
        save_checkpoint(f"{save_dir}/train_state_{epoch}", {
            "model": self.model.state_dict(),
            "optimizer": self.opt.state_dict(),
            "meta": {"epoch": epoch, "lr": dict(self.lr)}})

    def resume_from(self, path: str) -> None:
        """The model, optimizer, learning rates and epoch of a train state:
        the port's artifact, or a JAX package train state exported to
        `.npz` (its parameters, batch statistics and optimizer state
        through engine/from_jax.py)."""
        if is_jax_export(path):
            tree = load_jax_export(path)
            self.model.load_state_dict(state_dict_from_jax(
                tree["params"], tree.get("batch_stats"), module=self.model))
            self.opt.load_state_dict(optimizer_state_from_jax(
                tree.get("opt", {}), self.model, self.opt))
        else:
            tree = load_checkpoint(path, map_location=self.device)
            self.model.load_state_dict(tree["model"])
            self.opt.load_state_dict(tree["optimizer"])
        self.lr = {k: float(v) for k, v in tree["meta"]["lr"].items()}
        self._apply_lrs()
        self.start_epoch = int(tree["meta"]["epoch"]) + 1
        print("resumed from", path, "at epoch", self.start_epoch)
