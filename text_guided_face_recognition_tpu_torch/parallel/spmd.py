"""The explicit shard_map train steps of both stages.

Counterpart of text_guided_face_recognition_tpu/parallel/spmd.py. The
default data-parallel step (engine/trainer.py) is the JAX package's jit
over a data mesh: global-batch BatchNorm, one logical batch. These are its
hand-placed-collectives formulation, the reference's nn.DataParallel
semantics (per-replica BatchNorm; the JAX package averages the running
statistics over the replicas, its DEVIATIONS.md #6):

  * each rank runs the towers on its rows, its trained BatchNorms on its
    rows' statistics, and their running statistics are averaged over the
    ranks after the step;
  * the gradients are cast to `grads_dtype` before the collectives, and
    in bfloat16 summed in bfloat16;
  * stage 1 (`make_shardmap_train_step`): the embeddings are gathered
    before every B x B matrix (as in the default step); the gradients of
    the modules before the gather (image_head, text_encoder, text_head)
    are summed over the ranks, and the text encoder's clip
    (`apply_grad_clip`) is applied to the summed gradient (the optimizer
    then applies its own, as the JAX step's optimizer chain does);
  * stage 2 (`make_shardmap_fusion_step`): each rank forms its rows'
    margin logits against the replicated metric_fc; the cross-entropy of
    its rows' mean is averaged over the ranks inside the loss
    (`psum_mean`) and the focal factor is taken on that global mean (a
    per-rank focal would scale each rank's gradient by a different
    factor), so each rank's gradient is 1/N of the global batch's and
    every gradient, metric_fc's among them, is summed.

The JAX steps average the gradients of the modules after the gather
(stage 1) and the metrics over the shards; every rank holds the same
values there (the same loss on the same gathered values), so the port
makes no collective for them (engine/trainer.py).

Each rank draws its own dropout under the port's data-parallel rule: host
bits sliced by rank, the kernels' seeds folded with it. Under NCCL the
step is captured with its collectives, the BatchNorm statistics' all-reduce
among them; under gloo the trainer must be made with eager=True.

A note on the JAX reference: in JAX 0.9 a shard_map with check_vma=False
transposes all_gather to a reduce-scatter and psum to psum, so inside its
per-shard grad each rank's cotangent of a value that every rank consumes
whole is counted once per rank. The JAX steps therefore hand the summed
modules N times the global batch's gradient (stage 1: the modules before
the gather; stage 2 and the class-sharded step: every module); the port
computes the global batch's gradient, which the JAX docstrings state, and
its tests hold it against JAX's with that factor (tests/test_torch_spmd.py).
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.engine.optim import (
    effective_clip)

__all__ = ["make_shardmap_train_step", "make_shardmap_fusion_step"]


def make_shardmap_train_step(trainer):
    """Put a stage-1 trainer (engine/stage1.Stage1Trainer, built under the
    process group, before its first step) into the shard_map mode and
    return its train_step."""
    trainer.set_mode("shard_map", post_gather=trainer.POST_GATHER)
    if not trainer.args.compat_frozen_text:
        trainer.reduce_clip = effective_clip(trainer.args)
    return trainer.train_step


def make_shardmap_fusion_step(trainer):
    """Put a stage-2 trainer (engine/stage2.FusionTrainer, built under the
    process group, before its first step) into the shard_map mode, with
    metric_fc among the summed modules, and return its train_step."""
    trainer.set_mode("shard_map", post_gather=())
    return trainer.train_step
