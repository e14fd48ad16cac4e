"""The trainers' optimizer groups and their learning rates.

Counterpart of the BERT parts of
text_guided_face_recognition_tpu/engine/optim.py (`make_stage1_bert_tx`,
`make_stage2_tx`): three groups over the trainer's top-level modules, as
the reference drives three torch optimizers. Stage 1
(src/train_encoders_bert.py:212-222):

  head     image_head, text_head   Adam(betas (0.5, 0.999))
  encoder  text_encoder            Adam(betas (0.9, 0.999)), coupled L2
                                   `weight_decay` (added to the gradient),
                                   an optional clip first
  cls      image_cls, text_cls     SGD(momentum 0.9, weight decay 5e-5)

Stage 2 (src/fusion_bert.py:118-141):

  cls      metric_fc               plain SGD (momentum 0), weight decay
                                   `weight_decay`
  encoder  text_encoder            Adam(betas (0.9, 0.999)), coupled L2 0.01
  head     text_head, image_head,  Adam(betas (0.9, 0.999)), coupled L2 5e-5
           fusion_net

Learning rates are set per group from the host between epochs
(`set_lr` / `get_lr`). Both Adam groups are `CastAdam`, which stores its
two moments in `adam_moments_dtype` and does the update in f32: with
float32 the math of optax.scale_by_adam, with bfloat16 that of the JAX
package's `_scale_by_adam_cast`. Every parameter steps every
time: a parameter without a gradient gets a zero one, as the JAX package's
gradient tree holds zeros where no loss term reaches (Adam's moments keep
decaying there). With `compat_frozen_text` the encoder group does not step
at all (the JAX package's `optax.set_to_zero`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

__all__ = ["CastAdam", "GroupedOptimizer", "Stage1Optimizer",
           "Stage2Optimizer", "make_stage1_bert_tx", "make_stage2_tx",
           "cast_grads", "clip_grad_norm", "effective_clip", "GROUPS",
           "STAGE2_GROUPS"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GROUPS = {"image_head": "head", "text_head": "head",
          "text_encoder": "encoder", "image_cls": "cls", "text_cls": "cls"}
STAGE2_GROUPS = {"text_encoder": "encoder", "text_head": "head",
                 "image_head": "head", "fusion_net": "head",
                 "metric_fc": "cls"}


class CastAdam(torch.optim.Optimizer):
    """Adam (L2 weight decay coupled, torch semantics) whose two moments
    are stored in `moment_dtype`; every update is computed in f32:
      m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;
      p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.bfloat16,
                 grad_dtype: torch.dtype = torch.float32):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.moment_dtype = moment_dtype
        self.grad_dtype = grad_dtype

    def load_state_dict(self, state_dict) -> None:
        """torch's loader casts floating-point state to each parameter's
        dtype; the moments go back to `moment_dtype` (exactly: they were
        stored in it), so a resumed optimizer runs as the saved one."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = st[k].to(self.moment_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.moment_dtype)
                st["step"] += 1
                t = st["step"]
                g = p.grad.float()
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p.float()
                m = st["exp_avg"].float().mul_(b1).add_(g, alpha=1.0 - b1)
                v = st["exp_avg_sq"].float().mul_(b2).addcmul_(
                    g, g, value=1.0 - b2)
                c1 = 1.0 - b1 ** t
                c2 = 1.0 - b2 ** t
                upd = (m / c1) / ((v / c2).sqrt_() + group["eps"])
                if not group["weight_decay"]:
                    # JAX's dtype promotion: the update keeps the gradients'
                    # dtype unless an f32 weight-decay term widened them
                    upd = upd.to(self.grad_dtype)
                p.add_(upd.to(p.dtype), alpha=-group["lr"])
                st["exp_avg"].copy_(m)
                st["exp_avg_sq"].copy_(v)


def cast_grads(params: Iterable[torch.Tensor], dtype: str) -> None:
    """Round every gradient to `dtype` in place (config `grads_dtype`; the
    JAX package casts its gradient tree at the grad boundary). The
    gradients stay in their parameters' dtype, so the optimizers' f32 math
    then reads the rounded values. No-op for float32."""
    if dtype == "float32":
        return
    dt = _DTYPES[dtype]
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.copy_(p.grad.to(dt))


def clip_grad_norm(params: List[torch.Tensor], max_norm: float) -> None:
    """torch.nn.utils.clip_grad_norm_ semantics as the JAX package writes
    them: scale = min(1, max_norm / max(||g||, 1e-6)), the squared norm
    accumulated in f32."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    with torch.no_grad():
        sq = torch.stack([g.float().square().sum() for g in grads]).sum()
        scale = torch.clamp(max_norm / torch.clamp_min(sq.sqrt(), 1e-6),
                            max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))


def effective_clip(args) -> float:
    """The encoder clip norm: 0 (no clip) unless `apply_grad_clip`, since
    the reference clips after its optimizer step, a no-op (the JAX
    package's DEVIATIONS #3)."""
    return float(args.clip_max_norm) if args.apply_grad_clip else 0.0


class GroupedOptimizer:
    """Three groups (head, encoder, cls) over named modules, stepped
    together; `lr` per group. A subclass names the module -> group map and
    builds the three torch optimizers in `_make`."""

    groups: Dict[str, str] = {}

    def __init__(self, args, modules: Dict[str, torch.nn.Module]):
        missing = sorted(set(self.groups) - set(modules))
        if missing:
            raise ValueError(f"{type(self).__name__}: no module for {missing}")
        md = args.adam_moments_dtype
        # optax.scale_by_adam's f32 moments promote the update to f32;
        # `_scale_by_adam_cast` returns it in the gradients' dtype
        upd = "float32" if md == "float32" else args.grads_dtype

        def adam(params, betas, wd=0.0):
            return CastAdam(params, lr=0.0, betas=betas, eps=1e-8,
                            weight_decay=wd, moment_dtype=_DTYPES[md],
                            grad_dtype=_DTYPES[upd])

        self.params = {g: [] for g in ("head", "encoder", "cls")}
        for name, mod in modules.items():
            self.params[self.groups[name]] += [p for p in mod.parameters()]
        self.frozen_encoder = bool(args.compat_frozen_text)
        self.clip = effective_clip(args)
        self.grads_dtype = args.grads_dtype
        self.opts = self._make(args, adam)

    def _make(self, args, adam) -> Dict[str, torch.optim.Optimizer]:
        raise NotImplementedError

    def set_lr(self, group: str, lr: float) -> None:
        for pg in self.opts[group].param_groups:
            pg["lr"] = float(lr)

    def get_lr(self, group: str) -> float:
        return float(self.opts[group].param_groups[0]["lr"])

    def zero_grad(self) -> None:
        for opt in self.opts.values():
            opt.zero_grad(set_to_none=True)

    def all_params(self) -> List[torch.Tensor]:
        return [p for ps in self.params.values() for p in ps]

    def step(self) -> None:
        """cast -> (encoder clip) -> one step of every group."""
        for p in self.all_params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        cast_grads(self.all_params(), self.grads_dtype)
        if self.clip:
            clip_grad_norm(self.params["encoder"], self.clip)
        for group, opt in self.opts.items():
            if group == "encoder" and self.frozen_encoder:
                continue
            opt.step()

    def state_dict(self) -> Dict[str, dict]:
        return {g: opt.state_dict() for g, opt in self.opts.items()}

    def load_state_dict(self, state: Dict[str, dict]) -> None:
        for g, opt in self.opts.items():
            opt.load_state_dict(state[g])


class Stage1Optimizer(GroupedOptimizer):
    groups = GROUPS

    def _make(self, args, adam):
        return {
            "head": adam(self.params["head"], (0.5, 0.999)),
            "encoder": adam(self.params["encoder"], (0.9, 0.999),
                            float(args.weight_decay)),
            "cls": torch.optim.SGD(self.params["cls"], lr=0.0, momentum=0.9,
                                   weight_decay=5e-5),
        }


class Stage2Optimizer(GroupedOptimizer):
    groups = STAGE2_GROUPS

    def _make(self, args, adam):
        self.clip = 0.0     # the JAX package's stage-2 encoder Adam has none
        return {
            "cls": torch.optim.SGD(self.params["cls"], lr=0.0, momentum=0.0,
                                   weight_decay=float(args.weight_decay)),
            "encoder": adam(self.params["encoder"], (0.9, 0.999), 0.01),
            "head": adam(self.params["head"], (0.9, 0.999), 5e-5),
        }


def make_stage1_bert_tx(args, modules: Dict[str, torch.nn.Module]
                        ) -> Stage1Optimizer:
    """The stage-1 BERT optimizer over {image_head, text_encoder,
    text_head, image_cls, text_cls}; all learning rates start at 0 until
    `set_lr`."""
    return Stage1Optimizer(args, modules)


def make_stage2_tx(args, modules: Dict[str, torch.nn.Module]
                   ) -> Stage2Optimizer:
    """The stage-2 optimizer over {text_encoder, text_head, image_head,
    fusion_net, metric_fc}; all learning rates start at 0 until `set_lr`."""
    return Stage2Optimizer(args, modules)

