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
`steps`, and calls `init_parallel(post_gather)`, then `init_step(eager)`.

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

Data parallelism (`init_parallel`, under a process group of parallel/
mesh.py; the JAX package's jit over a data mesh). Each rank loads its
B / N rows of every global batch, runs the towers and heads on them, and
the subclass's loss gathers what the loss needs (parallel/contrastive.py)
and evaluates the global loss, the same on every rank; the trained
BatchNorms take global-batch statistics. After the backward the gradients
of the modules below the gather (`post_gather` names those after it) are
summed over the ranks, one flat bucket an optimizer group and dtype
that the backward accumulates them into (`attach_buckets`), so every
parameter holds the one-device gradient of the global batch before
the optimizer. Dropout: in host mode every rank draws the global step's
bits and takes its rows' (`local_bits`), so the step equals one process's
on the same bits; in prng mode also the kernels' seeds, each folded with
the rank (`fold_seeds`) so that no two ranks draw the same masks. Under
NCCL the collectives are captured in the step's graph; gloo's cannot be,
and a captured step under gloo raises (ask for eager=True). Rank 0 alone
prints and writes checkpoints; every rank resumes from the same file.

The modes of the step (`set_mode`, before the first step; parallel/spmd.py
and parallel/partial_fc.py put a trainer into the other two):

  data_parallel  the default above: global-batch BatchNorm, the summed
                 buckets reduced in the parameters' dtype, the gradient
                 cast in the optimizer;
  shard_map      the JAX package's explicit shard_map steps (its parallel/
                 spmd.py): each rank's BatchNorms normalise with its own
                 rows' statistics (`sync` off) and the running statistics
                 are averaged over the ranks after the step; the gradients
                 are cast to `grads_dtype` before the collectives and, in
                 bfloat16, summed in bfloat16; a stage-1 encoder clip
                 (`apply_grad_clip`) is applied to the summed gradient;
  partial_fc     the class-sharded stage-2 step (parallel/partial_fc.py):
                 as shard_map, with the rows of the classifier that this
                 rank holds kept out of every collective.

The JAX steps average (pmean) the gradients of the modules after the
gather and the metrics. Every rank evaluates the same loss on the same
gathered values, so those are the same on every rank and their mean is
their value: the port makes no collective for them (the tests hold the
ranks equal).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    is_jax_export, load_checkpoint, load_jax_export, prune_checkpoints,
    save_checkpoint)
from text_guided_face_recognition_tpu_torch.engine.evaluate import (
    backbone_features)
from text_guided_face_recognition_tpu_torch.engine.feature_cache import (
    FrozenFeatureCache)
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    optimizer_state_from_jax, state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.optim import (
    cast_grads, clip_grad_norm)
from text_guided_face_recognition_tpu_torch.models.layers import BatchNorm
from text_guided_face_recognition_tpu_torch.ops.dropout import (
    draw, draw_seeds)
from text_guided_face_recognition_tpu_torch.parallel import mesh
from text_guided_face_recognition_tpu_torch.parallel.partial_fc import (
    gather_state_for_partial_fc, shard_state_for_partial_fc)
from text_guided_face_recognition_tpu_torch.utils.profiling import nan_guard

__all__ = ["TrainerBase", "fold_seeds", "nan_guard", "MODES"]

MODES = ("data_parallel", "shard_map", "partial_fc")

_FOLD = 0x9E3779B1    # odd; rank r's seeds are xored with r * _FOLD mod 2^31


def fold_seeds(seeds: torch.Tensor, rank: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' int32 stream seeds of rank `rank`: xored with
    (rank * 0x9E3779B1) mod 2^31, so they stay in [0, 2^31) and rank 0
    keeps the drawn ones (the JAX package folds the shard index into its
    dropout key, parallel/spmd.py); into `out` when given."""
    return torch.bitwise_xor(seeds, (rank * _FOLD) & 0x7FFFFFFF, out=out)


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
        train split (no batch of the epoch is made before it); with more
        than one rank over this rank's rows of the coming epoch."""
        if self.feat_cache is not None:
            self.feat_cache.refresh(
                self.train_ds,
                self.train_dl.epoch_rows() if self.world > 1 else None)

    def draw_drop(self, b: int, t: int, out=(None, None)
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """One step's dropout for the text encoder at the local batch
        (b, t), drawn on the device from drop_gen: (host bits, kernel
        seeds), into the tensors `out` when given. BERT in host mode
        (fused_dropout): the bits of every site and no seeds; in prng mode
        the bits of the sites the kernels do not draw, then their int32
        seeds. LSTM/GRU: the embeddings' bits. (None, None) without
        dropout. Data-parallel: the global step's draw (b x world rows),
        of which this rank takes its rows' bits and its folded seeds."""
        enc = self.model.text_encoder
        bg = b * self.world
        n_bits, n_seeds = enc.drop_counts(bg, t)
        if not n_bits:
            return None, None
        if not self.dp:
            bits = draw(n_bits, self.drop_gen, self.device, out=out[0])
            seeds = (draw_seeds(n_seeds, self.drop_gen, self.device,
                                out=out[1]) if n_seeds else None)
            return bits, seeds
        bits = enc.local_bits(draw(n_bits, self.drop_gen, self.device), bg,
                              t, self.rank, self.world, out=out[0])
        seeds = (fold_seeds(draw_seeds(n_seeds, self.drop_gen, self.device),
                            self.rank, out=out[1]) if n_seeds else None)
        return bits, seeds

    # --------------------------------------------- data parallelism --

    def init_parallel(self, post_gather: Sequence[str]) -> None:
        """The data-parallel set-up under a process group (module
        docstring): the rank, the world, global-batch BatchNorm in the
        trained model, and the gradient buckets, one an optimizer group
        and dtype, of every parameter outside the `post_gather` modules:
        (flat, params, views), the parameters' gradients living in views
        of the flat tensor. Without a process group: one rank, nothing
        reduced."""
        self.dp = mesh.active()
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.rank0 = self.rank == 0
        self.mode = "data_parallel"
        self.reduce_clip = 0.0
        self._stats: List[torch.Tensor] = []
        self._make_buckets(post_gather)
        if self.dp:
            mesh.sync_batchnorm(self.model)

    def _make_buckets(self, post_gather: Sequence[str]) -> None:
        self._buckets: List[Tuple[torch.Tensor, List[torch.Tensor],
                                  List[torch.Tensor]]] = []
        self._staging: List[Optional[torch.Tensor]] = []
        if not self.dp:
            return
        after = {id(p) for name in post_gather
                 if getattr(self.model, name, None) is not None
                 for p in getattr(self.model, name).parameters()}
        for params in self.opt.params.values():
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for p in params:
                if id(p) not in after:
                    by_dtype.setdefault(p.dtype, []).append(p)
            for ps in by_dtype.values():
                flat = torch.zeros(sum(p.numel() for p in ps),
                                   dtype=ps[0].dtype, device=self.device)
                views = [v.view_as(p) for v, p in zip(
                    flat.split([p.numel() for p in ps]), ps)]
                self._buckets.append((flat, ps, views))
        self._staging = [None] * len(self._buckets)

    def set_mode(self, mode: str, post_gather: Sequence[str]) -> None:
        """Put the trainer's step into `mode` (module docstring), the
        gradients of the `post_gather` modules kept out of the summed
        buckets; before its first step."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        if self.steps or self._warm or self.graph is not None:
            raise RuntimeError(f"{type(self).__name__}: the step's mode is "
                               "set before the first step")
        self.mode = mode
        self._make_buckets(post_gather)
        if not self.dp:
            return
        per_rank = mode != "data_parallel"
        bns = [m for m in self.model.modules() if isinstance(m, BatchNorm)]
        for m in bns:
            m.sync = not per_rank
        self._stats = ([t for m in bns for t in (m.running_mean,
                                                 m.running_var)]
                       if per_rank else [])
        low = (per_rank and self.args.grads_dtype != "float32")
        self._staging = [torch.empty_like(flat, dtype=torch.bfloat16)
                         if low else None for flat, _, _ in self._buckets]

    def attach_buckets(self) -> None:
        """Before a backward: each bucket zeroed and its parameters'
        gradients made its views, so that the backward accumulates them
        into it (a parameter the backward does not reach keeps zeros, as
        the optimizer would give it) and no copy is made to reduce them.
        Held on two H100s over NVLink: the bucket's fill, the
        accumulation's add and one all-reduce took 2.46 device ms for
        0.445 GB, the gradients flattened into one tensor, all-reduced and
        copied back 3.63, one coalesced NCCL call of the 173 tensors 3.77
        (PERF.md, PR 14)."""
        for flat, params, views in self._buckets:
            flat.zero_()
            for p, v in zip(params, views):
                p.grad = v

    def reduce_grads(self) -> None:
        """Sum the gradients below the gather over the ranks: one
        all-reduce a bucket, in place; with a bfloat16 staging buffer
        (the shard_map modes' grads_dtype bfloat16) the sum is taken in
        bfloat16."""
        for (flat, _, _), low in zip(self._buckets, self._staging):
            if low is None:
                mesh.all_reduce_sum_(flat)
            else:
                low.copy_(flat)
                mesh.all_reduce_sum_(low)
                flat.copy_(low)

    def average_stats(self) -> None:
        """The per-rank modes: every trained BatchNorm's running statistics
        averaged over the ranks (the JAX steps' pmean of batch_stats), one
        all-reduce."""
        if not self._stats:
            return
        with torch.no_grad():
            flat = torch.cat([t.reshape(-1) for t in self._stats])
            mesh.all_reduce_sum_(flat)
            flat.div_(self.world)
            torch._foreach_copy_(self._stats, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in self._stats]), self._stats)])

    def say(self, *args) -> None:
        """print, on rank 0 alone."""
        if self.rank0:
            print(*args)

    def prune(self, save_dir: str) -> None:
        """After an epoch's artifacts: rank 0 prunes to the newest
        `keep_last_ckpts`; every rank waits for it."""
        if self.rank0:
            prune_checkpoints(save_dir, self.args.keep_last_ckpts)
        mesh.barrier()

    def _backward(self, total: torch.Tensor) -> None:
        if self.dp:
            self.attach_buckets()
        total.backward()
        if self.mode != "data_parallel":
            cast_grads(self.opt.all_params(), self.args.grads_dtype)
        if self.dp:
            self.reduce_grads()
        if self.reduce_clip:
            clip_grad_norm(self.opt.params["encoder"], self.reduce_clip,
                           self.args.grads_dtype)

    def _optimizer_step(self) -> None:
        self.opt.step()
        self.average_stats()

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
        self._backward(total)
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
        captured step; the captured step under a process group needs NCCL,
        whose collectives a CUDA graph captures."""
        self.eager = bool(eager) or self.device.type != "cuda"
        if not self.eager and self.dp and mesh.backend() != "nccl":
            raise RuntimeError(
                f"{type(self).__name__}: the captured train step needs the "
                f"NCCL backend, and this process group runs "
                f"{mesh.backend()!r}, whose collectives a CUDA graph cannot "
                "capture (ranks sharing a card run gloo); ask for eager "
                "steps (eager=True, the training CLIs' --eager)")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_replays = 0
        self._warm = 0
        self._capture_stream = (None if self.eager
                                else torch.cuda.Stream(self.device))

    def close(self) -> None:
        """Free the captured step once the card is done with it: the graph
        (and with it the collectives it holds), its static inputs and
        outputs, the capture stream and the gradients; later steps run
        eagerly. A process group must not be left while a graph of its
        NCCL collectives is alive (two ranks hung leaving theirs), so the
        entry points close their trainer first (cli/__init__.py `run`)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.graph, self._capture_stream, self.eager = None, None, True
        for name in ("_static", "_static_drop", "_static_out"):
            self.__dict__.pop(name, None)
        self.opt.zero_grad()

    def _eager_step(self, batch, drop_bits, drop_seeds):
        _, metrics = self.compute_grads(batch, drop_bits, drop_seeds)
        self._optimizer_step()
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
                self._backward(total)
                self._optimizer_step()
        except Exception as e:
            raise RuntimeError(
                f"{type(self).__name__}: capturing the train step in a CUDA "
                f"graph failed (fused_block={self.args.fused_block!r}, "
                f"compute_dtype={self.args.compute_dtype!r}): {e}") from e
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._static_out = {k: v.detach() for k, v in metrics.items()}
        self.graph = graph

    def train_state(self) -> dict:
        """{"model", "optimizer"}: the state dicts of the whole train state.
        In the partial_fc mode the classifier's rows are gathered from every
        rank (a collective: every rank calls it), so the tree is the
        replicated layout's (parallel/partial_fc.py)."""
        tree = {"model": self.model.state_dict(),
                "optimizer": self.opt.state_dict()}
        if self.mode == "partial_fc":
            tree = gather_state_for_partial_fc(tree, self.classifier_shape)
        return tree

    def _own_rows(self, tree):
        """A whole train state's tree (the port's or an exported JAX one)
        cut to this rank's classifier rows in the partial_fc mode."""
        if self.mode != "partial_fc":
            return tree
        return shard_state_for_partial_fc(tree, self.classifier_shape)

    def save_state(self, save_dir: str, epoch: int) -> None:
        """The resumable third artifact: model, optimizer, epoch, LRs
        (rank 0 alone writes it)."""
        tree = self.train_state()
        if not self.rank0:
            return
        save_checkpoint(f"{save_dir}/train_state_{epoch}", {
            **tree, "meta": {"epoch": epoch, "lr": dict(self.lr)}})

    def resume_from(self, path: str) -> None:
        """The model, optimizer, learning rates and epoch of a train state:
        the port's artifact, or a JAX package train state exported to
        `.npz` (its parameters, batch statistics and optimizer state
        through engine/from_jax.py); in the partial_fc mode this rank's
        rows of the classifier and of its optimizer state."""
        if is_jax_export(path):
            tree = load_jax_export(path)
            own = self._own_rows(tree)
            self.model.load_state_dict(state_dict_from_jax(
                own["params"], own.get("batch_stats"), module=self.model))
            self.opt.load_state_dict(optimizer_state_from_jax(
                own.get("opt", {}), self.model, self.opt))
        else:
            tree = load_checkpoint(path, map_location=self.device)
            own = self._own_rows(tree)
            self.model.load_state_dict(own["model"])
            self.opt.load_state_dict(own["optimizer"])
        self.lr = {k: float(v) for k, v in tree["meta"]["lr"].items()}
        self._apply_lrs()
        self.start_epoch = int(tree["meta"]["epoch"]) + 1
        self.say("resumed from", path, "at epoch", self.start_epoch)
