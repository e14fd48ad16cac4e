"""Stage-1 FCAM pretraining (encoder alignment).

Counterpart of text_guided_face_recognition_tpu/engine/stage1.py
(`Stage1Trainer`, en_type BERT, LSTM or GRU, one device):

  * the frozen backbone (eval-mode BN, no gradient) -> ImageHeading in
    train mode (batch statistics; running statistics updated in place);
  * the BERT tower in train mode (dropout from one flat bit draw per step
    and, unless fused_dropout, the fused kernels' int32 seeds, on the
    device, from a torch.Generator seeded with manual_seed + 1) ->
    TextHeading; or, with en_type LSTM or GRU (src/train_encoders_lstm.py),
    the RNN encoder in train mode (embedding dropout 0.5 from the same
    generator), no head, and its words masked past each caption's length;
  * the loss cocktail gated by is_DAMSM / is_CLIP / is_ident_loss with the
    reference's weights (DAMSM word + sentence terms, the sentence terms
    off for an RNN encoder, ArcFace focal identity losses on both sides,
    the CLIP-style global loss, for an RNN encoder the InfoNCE clip_loss);
  * the three optimizer groups of engine/optim.py and the reference's
    epoch-edge learning-rate schedule, applied from the host (an RNN
    encoder's rate decays with the head's).

A training step is one forward, one backward and one optimizer step; the
epoch loop keeps running metric sums on the device and syncs with the host
once per epoch. `build_loss_fn` is the step's loss as a function of a batch
on the device; a batch may carry precomputed backbone features (`img_gl`
(B, 512) and `img_lc` (B, 256, S, S), NCHW) instead of `img`, which skips
the backbone, as the JAX loss function allows.

Reference quirks kept as the JAX package keeps them: the text side trains
by default (`compat_frozen_text: true` reproduces the reference's
no-gradient text path), and no gradient clip by default
(`apply_grad_clip`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch import ops
from text_guided_face_recognition_tpu_torch.config import check_stage1
from text_guided_face_recognition_tpu_torch.engine import optim
from text_guided_face_recognition_tpu_torch.engine import prepare as prep
from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    prune_checkpoints, save_checkpoint)
from text_guided_face_recognition_tpu_torch.engine.evaluate import (
    validate_concat)
from text_guided_face_recognition_tpu_torch.engine.trainer import (
    TrainerBase, nan_guard)
from text_guided_face_recognition_tpu_torch.models.margins import (
    xavier_uniform_)
from text_guided_face_recognition_tpu_torch.models.text_bert import TEXT_ARCHS

__all__ = ["ClassWeight", "Stage1Model", "Stage1Trainer"]


class ClassWeight(nn.Module):
    """A margin classifier's class weights, (num_classes, feat)."""

    def __init__(self, num_classes: int, feat: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_classes, feat))


class Stage1Model(nn.Module):
    """The trained modules, named as the JAX trainer's param tree:
    image_head, text_encoder, text_head (None with an RNN encoder),
    image_cls, text_cls."""

    def __init__(self, image_head: nn.Module, text_encoder: nn.Module,
                 text_head: Optional[nn.Module], num_classes: int, feat: int):
        super().__init__()
        self.image_head = image_head
        self.text_encoder = text_encoder
        self.text_head = text_head
        self.image_cls = ClassWeight(num_classes, feat)
        self.text_cls = ClassWeight(num_classes, feat)


class Stage1Trainer(TrainerBase):
    """Stage-1 trainer for en_type BERT, LSTM or GRU on one device (the
    CUDA card unless `device` is the CPU)."""

    def __init__(self, args, device: Optional[torch.device] = None,
                 eager: bool = False):
        check_stage1(args)
        self.args = args
        self.device = device if device is not None else \
            prep.resolve_device(bool(args.cpu))
        dev = self.device

        self.train_dl, self.train_ds = prep.prepare_dataloader(args, "train")
        self.train_ds.check_classifier_coverage(args.num_classes)
        self.valid_dl, self.valid_ds = prep.prepare_dataloader(args, "valid")
        args.len_train_dl = len(self.train_dl)

        self.backbone = prep.prepare_backbone(args, dev)
        self.backbone.requires_grad_(False)
        image_head = prep.prepare_image_head(args, dev)
        text_encoder, text_head = prep.prepare_text_encoder(args, dev)
        feat = args.aux_feat_dim_per_granularity
        self.model = Stage1Model(image_head, text_encoder, text_head,
                                 args.num_classes, feat)
        # class weights: xavier uniform (reference margins: image s=30,
        # text s=35, both m=0.5), from the manual_seed generator
        gen = torch.Generator().manual_seed(int(args.manual_seed))
        for cls in (self.model.image_cls, self.model.text_cls):
            xavier_uniform_(cls.weight, gen)
        self.model.to(dev).train()

        self.is_bert = args.en_type == "BERT"
        make_tx = (optim.make_stage1_bert_tx if self.is_bert
                   else optim.make_stage1_lstm_tx)
        self.opt = make_tx(args, {name: getattr(self.model, name)
                                  for name in optim.GROUPS})
        # initial LRs (reference: src/train_encoders_bert.py:212-222,
        # src/train_encoders_lstm.py:180-189)
        self.lr = {"head": float(args.lr_head),
                   "encoder": float(args.min_lr_bert if self.is_bert
                                    else args.init_lr_lstm), "cls": 0.1}
        self._apply_lrs()
        self.arch = TEXT_ARCHS[args.bert_type] if self.is_bert else None
        self.drop_gen = torch.Generator(device=dev).manual_seed(
            int(args.manual_seed) + 1)
        self.loss_fn = self.build_loss_fn()
        self.start_epoch = 1
        self.steps = 0
        self.init_step(eager)

    # ---------------------------------------------------------- train step --

    def text_forward(self, batch, drop_bits=None, drop_seeds=None):
        """(words (B, D, T'), sentence (B, D), word mask or None) of a
        batch's captions in train mode: BERT through its head (every word
        of the bert_words_num - 2 taken), an RNN with `cap_len` (words at
        t < cap_len taken)."""
        m = self.model
        if m.text_head is not None:
            words_raw, _ = m.text_encoder(batch["caps"], batch["mask"],
                                          drop_bits, drop_seeds)
            return (*m.text_head(words_raw), None)
        words_emb, sent_emb = m.text_encoder(batch["caps"], batch["cap_len"],
                                             drop_bits)
        t = words_emb.shape[-1]
        mask = (torch.arange(t, device=words_emb.device)[None, :]
                < batch["cap_len"].long()[:, None])
        return words_emb, sent_emb, mask

    def build_loss_fn(self):
        """The stage-1 loss cocktail: loss_fn(batch, drop_bits,
        drop_seeds) -> (total, metrics), a batch of device tensors."""
        args = self.args
        g = args.TRAIN.SMOOTH
        m = self.model
        bert = self.is_bert

        def loss_fn(batch, drop_bits=None, drop_seeds=None):
            class_ids = batch["cls_id"].long()
            words_emb, sent_emb, word_mask = self.text_forward(
                batch, drop_bits, drop_seeds)
            if args.compat_frozen_text:
                words_emb, sent_emb = words_emb.detach(), sent_emb.detach()
            if "img_gl" in batch:     # precomputed backbone features
                gl, lc = batch["img_gl"], batch["img_lc"]
            else:
                gl, lc = self.image_features(batch["img"])
            img_f, words_f = m.image_head(gl, lc)
            labels = torch.arange(img_f.shape[0], device=img_f.device)
            total = torch.zeros((), dtype=torch.float32, device=img_f.device)
            metrics: Dict[str, torch.Tensor] = {}
            if args.is_DAMSM:
                w0, w1 = ops.words_loss(words_f, words_emb, labels, g.GAMMA1,
                                        g.GAMMA2, g.GAMMA3,
                                        word_mask=word_mask,
                                        use_pallas=bool(args.use_pallas))
                s0, s1 = ops.sent_loss(img_f, sent_emb, labels, class_ids,
                                       gamma3=g.GAMMA3)
                # ref bert :272-283; lstm :259-270 (sentence terms off)
                damsm = w0 + w1 + s0 + s1 if bert else w0 + w1
                total = total + damsm
                metrics.update(w_loss=w0 + w1, s_loss=s0 + s1,
                               damsm_loss=damsm)
            if args.is_ident_loss:
                t_logits = ops.arc_margin_logits(
                    sent_emb, m.text_cls.weight, class_ids, s=35.0, m=0.5)
                i_logits = ops.arc_margin_logits(
                    img_f, m.image_cls.weight, class_ids, s=30.0, m=0.5)
                idn = args.lambda_id * (ops.focal_loss(t_logits, class_ids)
                                        + ops.focal_loss(i_logits, class_ids))
                total = total + idn
                metrics["idn_loss"] = idn
            if args.is_CLIP:   # ref bert :309-312 / ClipLoss, lstm :288-291
                cl = args.lambda_clip * (
                    ops.global_loss(img_f, sent_emb) if bert
                    else ops.clip_loss(sent_emb, img_f))
                total = total + cl
                metrics["clip_loss"] = cl
            metrics["total_loss"] = total
            return total, metrics

        return loss_fn

    # -------------------------------------------------------------- epochs --

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        args = self.args
        n = 0
        t0 = time.time()
        acc = None
        for batch in self.train_dl:
            acc = self.train_step(self.to_device(batch), acc=acc)
            n += 1
            if args.max_steps and n >= args.max_steps:
                break
        agg = {k: float(v) for k, v in (acc or {}).items()}  # one sync
        nan_guard(agg, n)
        dt = time.time() - t0
        total_len = n * args.batch_size
        out = {k: v / total_len for k, v in agg.items()}
        out.update(epoch=epoch, steps=n,
                   pairs_per_sec=total_len / dt if dt > 0 else 0.0)
        print(json.dumps(out))
        return out

    def schedule_epoch_end(self, epoch: int) -> None:
        """The reference's LR edits: head ExponentialLR(0.98) per epoch
        (src/train_encoders_bert.py:225-226, :406), and an RNN encoder's
        too (src/train_encoders_lstm.py:191-195), cls /10 at epochs 3 and 8
        (:398-411)."""
        self.lr["head"] *= 0.98
        if not self.is_bert:
            self.lr["encoder"] *= 0.98
        if epoch in (3, 8):
            self.lr["cls"] *= 0.1
            print("Learning Rate change to: {:0.5f}".format(self.lr["cls"]))
        self._apply_lrs()

    def validate(self) -> Dict[str, float]:
        """Concat-fusion cosine verification on the valid split
        (reference: Train.test, src/train_encoders_bert.py:348-395)."""
        m = self.model
        return validate_concat(self.args, self.valid_dl, self.backbone,
                               m.image_head, m.text_encoder, m.text_head)

    def save_dir(self) -> str:
        a = self.args
        out = os.path.join(a.checkpoints_path, a.dataset_name,
                           a.CONFIG_NAME, f"{a.en_type}_{a.model_type}")
        return os.path.join(out, a.bert_type) if self.is_bert else out

    def save_encoders(self, save_dir: str, epoch: int) -> None:
        """Two artifacts (reference: src/train_encoders_bert.py:59-80):
        the image head, and the text encoder with its head as
        `{bert_type}_text_encoder_N`, or an RNN encoder alone as
        `{en_type}_text_encoder_N`."""
        a, m = self.args, self.model
        save_checkpoint(f"{save_dir}/{a.model_type}_image_encoder_{epoch}",
                        {"image_head": m.image_head.state_dict()})
        text = {"model": m.text_encoder.state_dict()}
        if self.is_bert:
            text["head"] = m.text_head.state_dict()
        name = a.bert_type if self.is_bert else a.en_type
        save_checkpoint(f"{save_dir}/{name}_text_encoder_{epoch}", text)

    def main(self) -> None:
        """Epoch loop (reference: src/train_encoders_bert.py:398-421)."""
        args = self.args
        if args.resume_model_path and args.resume_epoch > 1:
            self.resume_from(args.resume_model_path)
        save_dir = self.save_dir()
        for epoch in range(self.start_epoch, args.max_epoch + 1):
            args.current_epoch = epoch
            self.train_epoch(epoch)
            self.schedule_epoch_end(epoch)
            if epoch % args.save_interval == 0 or epoch == args.max_epoch:
                print("saving image and text encoder\n")
                self.save_encoders(save_dir, epoch)
                self.save_state(save_dir, epoch)
                prune_checkpoints(save_dir, args.keep_last_ckpts)
            if epoch > 12 and epoch % args.test_interval == 0:
                print("start validating")
                self.validate()
