"""Stage-2 fusion training.

Counterpart of text_guided_face_recognition_tpu/engine/stage2.py
(`FusionTrainer`, en_type BERT, LSTM or GRU, one device or one rank of a
process group): from the stage-1 encoders
(loaded when `text_encoder_path` / `image_encoder_path` name artifacts of
this package's stage-1 trainer, else random), fine-tune the text encoder
and its head, the image head and the fusion net against an ArcFace margin
on the fused embedding (s = 30, m = 0.5 over `fusion_final_dim`), with the
focal loss (`model_type: arcface` and `loss: focal_loss`) or cross entropy.

  * the frozen backbone (eval-mode BN, no gradient) -> ImageHeading in
    train mode (batch statistics; running statistics updated in place);
  * the BERT tower in train mode (dropout from one flat bit draw per step
    and, unless fused_dropout, the fused kernels' int32 seeds, on the
    device, from a torch.Generator seeded with manual_seed + 2) ->
    TextHeading; or the LSTM/GRU encoder with `cap_len` (embedding
    dropout from the same generator), no head (src/fusion_lstm.py);
  * fusion: FCFM(local map, word features, global feature, sentence
    feature) in train mode (its two BatchNorms take batch statistics), or
    LinearFusion(global feature, sentence feature); with an LSTM encoder
    and fcfm, WordLevelCFA_LSTM(local map, word features), 768 wide;
  * the three optimizer groups of engine/optim.py (`make_stage2_tx`) and
    the reference's StepLR triplet applied from the host at epoch edges
    (encoder x0.8 every 10 epochs; cls x0.6 and head x0.97 every 5).

A training step is one forward, one backward and one optimizer step; the
epoch loop keeps the running loss on the device and syncs with the host
once per epoch. A batch may carry precomputed backbone features (`img_gl`,
`img_lc`, NCHW) instead of `img`, as the JAX loss function allows; with
`frozen_feature_cache` every batch does, from the cache refreshed at the
start of each epoch (engine/feature_cache.py). The text
side trains by default; `compat_frozen_text: true` reproduces the
reference's no-gradient text path.

Data parallelism (engine/trainer.py, under a process group): each rank
runs everything up to the fused embedding on its rows (the fusion net's
BatchNorms on global-batch statistics) and gathers the embeddings and
labels before metric_fc, so the margin logits and the focal loss's
batch-mean quirk are the global batch's, as the JAX package's jit over a
data mesh computes them (its parallel/spmd.py says why a per-rank focal
would be wrong); metric_fc comes after the gather. The explicit shard_map step and the
class-sharded (partial FC) step are modes of this trainer (parallel/
spmd.py, parallel/partial_fc.py; engine/trainer.py).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch import ops
from text_guided_face_recognition_tpu_torch.config import check_stage2
from text_guided_face_recognition_tpu_torch.engine import optim
from text_guided_face_recognition_tpu_torch.engine import prepare as prep
from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    save_checkpoint)
from text_guided_face_recognition_tpu_torch.engine.evaluate import run_test
from text_guided_face_recognition_tpu_torch.engine.trainer import (
    TrainerBase, nan_guard)
from text_guided_face_recognition_tpu_torch.models.margins import (
    ArcMarginProduct, xavier_uniform_)
from text_guided_face_recognition_tpu_torch.models.text_bert import TEXT_ARCHS
from text_guided_face_recognition_tpu_torch.parallel.contrastive import (
    gather_global_negatives, psum_mean)
from text_guided_face_recognition_tpu_torch.parallel.partial_fc import (
    sharded_margin_ce)
from text_guided_face_recognition_tpu_torch.utils.logging import MetricLogger
from text_guided_face_recognition_tpu_torch.utils.profiling import (
    maybe_profile)

__all__ = ["FusionModel", "FusionTrainer"]


class FusionModel(nn.Module):
    """The trained modules, named as the JAX trainer's param tree:
    text_encoder, text_head (None with an RNN encoder), image_head,
    fusion_net, metric_fc."""

    def __init__(self, text_encoder: nn.Module,
                 text_head: Optional[nn.Module],
                 image_head: nn.Module, fusion_net: nn.Module,
                 metric_fc: nn.Module):
        super().__init__()
        self.text_encoder = text_encoder
        self.text_head = text_head
        self.image_head = image_head
        self.fusion_net = fusion_net
        self.metric_fc = metric_fc


class FusionTrainer(TrainerBase):
    """Stage-2 trainer for en_type BERT, LSTM or GRU on one device (the
    CUDA card unless `device` is the CPU), or on this rank's under a
    process group."""

    POST_GATHER = ("metric_fc",)

    def __init__(self, args, device: Optional[torch.device] = None,
                 eager: bool = False,
                 logger: Optional[MetricLogger] = None):
        check_stage2(args)
        self.args = args
        self.logger = logger or MetricLogger(echo=True)
        self.device = device if device is not None else \
            prep.resolve_device(bool(args.cpu))
        dev = self.device

        self.train_dl, self.train_ds = prep.prepare_dataloader(args, "train")
        self.train_ds.check_classifier_coverage(args.num_classes)
        self.valid_dl, self.valid_ds = prep.prepare_dataloader(args, "valid")

        # stage-1 artifacts (reference: Fusion.__init__ :42-68)
        self.backbone = prep.prepare_backbone(args, dev)
        self.backbone.requires_grad_(False)
        text_encoder, text_head = prep.prepare_text_encoder(args, dev)
        image_head = prep.prepare_image_head(args, dev)
        fusion_net = prep.prepare_fusion_net(args, dev, load=False)
        metric_fc = ArcMarginProduct(args.fusion_final_dim, args.num_classes,
                                     s=30.0, m=0.5,
                                     easy_margin=bool(args.easy_margin))
        xavier_uniform_(metric_fc.weight,
                        torch.Generator().manual_seed(int(args.manual_seed)))
        self.model = FusionModel(text_encoder, text_head, image_head,
                                 fusion_net, metric_fc)
        self.model.to(dev).train()

        self.opt = optim.make_stage2_tx(
            args, {name: getattr(self.model, name)
                   for name in optim.STAGE2_GROUPS})
        self.lr = {"cls": float(args.lr_image_train), "encoder": 1e-5,
                   "head": float(args.lr_head)}
        self._apply_lrs()
        self.init_parallel(self.POST_GATHER)
        self.is_bert = args.en_type == "BERT"
        self.arch = TEXT_ARCHS[args.bert_type] if self.is_bert else None
        self.drop_gen = torch.Generator(device=dev).manual_seed(
            int(args.manual_seed) + 2)
        self.loss_fn = self.build_loss_fn()
        self.init_feature_cache()
        self.start_epoch = 1
        self.steps = 0
        self.init_step(eager)

    # ---------------------------------------------------------- train step --

    def build_embed_fn(self):
        """The fused-embedding forward, everything up to the margin head:
        embed_fn(batch, drop_bits, drop_seeds) -> (B, fusion_final_dim)
        (reference: get_fusion_output, src/fusion_bert.py:144-155)."""
        args, m = self.args, self.model

        def embed_fn(batch, drop_bits=None, drop_seeds=None):
            if m.text_head is None:
                words_emb, sent_emb = m.text_encoder(
                    batch["caps"], batch["cap_len"], drop_bits)
            else:
                words_raw, _ = m.text_encoder(batch["caps"], batch["mask"],
                                              drop_bits, drop_seeds)
                words_emb, sent_emb = m.text_head(words_raw)
            if args.compat_frozen_text:
                words_emb, sent_emb = words_emb.detach(), sent_emb.detach()
            if "img_gl" in batch:     # precomputed backbone features
                gl, lc = batch["img_gl"], batch["img_lc"]
            else:
                gl, lc = self.image_features(batch["img"])
            img_f, local_f = m.image_head(gl, lc)
            if args.fusion_type == "linear":
                return m.fusion_net(img_f, sent_emb)
            if m.text_head is None:       # WordLevelCFA_LSTM
                return m.fusion_net(local_f, words_emb)
            return m.fusion_net(local_f, words_emb, img_f, sent_emb)

        return embed_fn

    def build_loss_fn(self):
        """The stage-2 margin loss: loss_fn(batch, drop_bits, drop_seeds)
        -> (loss, {"loss": loss}), a batch of device tensors."""
        args, m = self.args, self.model
        use_focal = args.model_type == "arcface" and args.loss == "focal_loss"
        embed_fn = self.build_embed_fn()

        def loss_fn(batch, drop_bits=None, drop_seeds=None):
            label = batch["cls_id"].long()
            emb = embed_fn(batch, drop_bits, drop_seeds)
            if self.mode == "partial_fc":     # W class-sharded over ranks
                loss = sharded_margin_ce(
                    emb, m.metric_fc.weight, label, head="arcface", s=30.0,
                    m=0.5, easy_margin=bool(args.easy_margin),
                    loss_kind="focal" if use_focal else "ce")
                return loss, {"loss": loss}
            if self.dp and self.mode == "data_parallel":
                # the global batch, on every rank
                emb, label = (gather_global_negatives(x) for x in (emb,
                                                                   label))
            logits = m.metric_fc(emb, label)
            if self.mode == "shard_map":      # the global mean CE
                ce = psum_mean(ops.cross_entropy_rows(logits, label))
                loss = (1.0 - torch.exp(-ce)) ** 2.0 * ce if use_focal \
                    else ce
            elif use_focal:
                loss = ops.focal_loss(logits, label, gamma=2.0)
            else:
                loss = ops.cross_entropy_rows(logits, label)
            return loss, {"loss": loss}

        return loss_fn

    # -------------------------------------------------------------- epochs --

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        args = self.args
        n = 0
        t0 = time.time()
        self.refresh_features()       # inside the timed window
        acc = None
        for batch in self.train_dl:
            with maybe_profile(args, n):
                acc = self.train_step(self.to_device(batch), acc=acc)
            n += 1
            if args.max_steps and n >= args.max_steps:
                break
        total = float(acc["loss"]) if acc is not None else 0.0   # one sync
        nan_guard({"loss": total}, n)
        dt = time.time() - t0
        out = {"epoch": epoch, "loss": total / max(n * args.batch_size, 1),
               "steps": n,
               "pairs_per_sec": n * args.batch_size / dt if dt > 0 else 0.0}
        self.logger.log(out)
        return out

    def schedule_epoch_end(self, epoch: int) -> None:
        """The reference's StepLR triplet (src/fusion_bert.py:75-85)."""
        if epoch % 10 == 0:
            self.lr["encoder"] *= 0.8
        if epoch % 5 == 0:
            self.lr["cls"] *= 0.6
            self.lr["head"] *= 0.97
        self._apply_lrs()

    def validate(self) -> Dict[str, float]:
        """run_test on the valid split with the current weights, the
        modules in eval mode for its duration, sharded over the ranks; the
        metrics on rank 0."""
        m = self.model
        self.model.eval()
        try:
            with torch.no_grad():
                return run_test(self.args, self.valid_dl, self.backbone,
                                m.image_head, m.fusion_net, m.text_encoder,
                                m.text_head)
        finally:
            self.model.train()

    def save_dir(self) -> str:
        a = self.args
        return os.path.join(a.checkpoints_path, a.dataset_name,
                            a.CONFIG_NAME, f"{a.en_type}_{a.model_type}",
                            a.fusion_type)

    def save_models(self, save_dir: str, epoch: int) -> None:
        """Two artifacts (reference: src/fusion_bert.py:166-191); an RNN
        encoder's has no head (rank 0 alone writes them)."""
        a, m = self.args, self.model
        if not self.rank0:
            return
        save_checkpoint(
            f"{save_dir}/fusion_{a.fusion_type}_{a.model_type}_{epoch}",
            {"net": m.fusion_net.state_dict(),
             "image_head": m.image_head.state_dict()})
        text = {"model": m.text_encoder.state_dict()}
        if m.text_head is not None:
            text["head"] = m.text_head.state_dict()
        save_checkpoint(
            f"{save_dir}/encoder_{a.en_type}_{a.fusion_type}_{epoch}", text)

    def main(self) -> None:
        """Epoch loop (reference: src/fusion_bert.py:251-274)."""
        args = self.args
        save_dir = self.save_dir()
        if args.resume_model_path and args.resume_epoch > 1:
            self.resume_from(args.resume_model_path)
        self.say("Start Training")
        for epoch in range(self.start_epoch, args.max_epoch + 1):
            args.current_epoch = epoch
            self.train_epoch(epoch)
            self.schedule_epoch_end(epoch)
            if epoch % args.save_interval == 0:
                self.save_models(save_dir, epoch)
                self.save_state(save_dir, epoch)
                self.prune(save_dir)
            if epoch > 20 and args.do_test and \
                    epoch % args.test_interval == 0:
                self.say("\nLet's test the model")
                self.validate()
