"""The trainers' optimizer groups and their learning rates.

Counterpart of text_guided_face_recognition_tpu/engine/optim.py
(`make_stage1_bert_tx`, `make_stage1_lstm_tx`, `make_stage2_tx`): three
groups over the trainer's top-level modules, as the reference drives three
torch optimizers. Stage 1 with BERT (src/train_encoders_bert.py:212-222):

  head     image_head, text_head,  Adam(betas (0.5, 0.999))
           cmp (is_CMP)
  encoder  text_encoder            Adam(betas (0.9, 0.999)), coupled L2
                                   `weight_decay` (added to the gradient),
                                   an optional clip first
  cls      image_cls, text_cls     SGD(momentum 0.9, weight decay 5e-5)

Stage 1 with an LSTM or GRU (src/train_encoders_lstm.py:180-189): the
same, but the encoder's Adam takes betas (0.9, 0.5), and there is no
text_head. Stage 2 (src/fusion_bert.py:118-141; no text_head with an
RNN encoder):

  cls      metric_fc               plain SGD (momentum 0), weight decay
                                   `weight_decay`
  encoder  text_encoder            Adam(betas (0.9, 0.999)), coupled L2 0.01
  head     text_head, image_head,  Adam(betas (0.9, 0.999)), coupled L2 5e-5
           fusion_net

Adam stores its two moments in `adam_moments_dtype` and does the update in
f32: with float32 the math of optax.scale_by_adam, with bfloat16 that of
the JAX package's `_scale_by_adam_cast`. SGD is optax's trace (momentum)
after the coupled weight decay, as the JAX package's `_torch_sgd`. Every
parameter steps every time: a parameter without a gradient gets a zero
one, as the JAX package's gradient tree holds zeros where no loss term
reaches (Adam's moments keep decaying there). With `compat_frozen_text`
the encoder group does not step at all (the JAX package's
`optax.set_to_zero`).

Each group keeps its learning rate as an f32 tensor and its step count as
an int32 tensor on the parameters' device; the bias corrections
1 - b^count are formed there in f32, as the JAX package forms them. So a
step reads nothing from the host and can be captured in a CUDA graph;
`set_lr` writes the rate tensor in place between epochs.

Each operation of the update runs as one multi-tensor launch
(`torch._foreach_*`) over a group's leaves of one dtype, as the JAX
package's default `stacked_optimizer` runs its chain once per same-shape
bucket; `cast_grads` and the encoder clip are multi-tensor passes too.
The JAX package's batching knobs (`stacked_optimizer`, `stack_max_elems`,
`fused_optimizer`) change no value, only how a TPU schedules the work,
and are accepted and ignored (config.py).

`lazy_embedding_adam` gives the encoder group's embedding tables (2-D
leaves of at least EMB_MIN_ROWS rows) the JAX package's row-sparse update
(`_lazy_row_update`): the rows of the `top_k` largest squared gradient
rows, at most `max(256, batch_size * words)`, words `bert_words_num` or,
with en_type LSTM or GRU, `lstm_words_num`, step; rows no token
touched keep parameters and both moments bit-unchanged; their weight decay
applies to touched rows only, and the dense weight decay skips the table.

State: per parameter `exp_avg` and `exp_avg_sq` in
`adam_moments_dtype` (SGD with momentum: `momentum_buffer`), and the
group's `count`; a state written with a per-parameter int `step` (the
torch.optim layout) loads too.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

__all__ = ["AdamGroup", "SgdGroup", "GroupedOptimizer", "Stage1Optimizer",
           "Stage1LstmOptimizer", "Stage2Optimizer", "make_stage1_bert_tx",
           "make_stage1_lstm_tx", "make_stage2_tx",
           "cast_grads", "clip_grad_norm", "effective_clip", "lazy_rows",
           "EMB_MIN_ROWS", "GROUPS", "STAGE2_GROUPS"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GROUPS = {"image_head": "head", "text_head": "head", "cmp": "head",
          "text_encoder": "encoder", "image_cls": "cls", "text_cls": "cls"}
STAGE2_GROUPS = {"text_encoder": "encoder", "text_head": "head",
                 "image_head": "head", "fusion_net": "head",
                 "metric_fc": "cls"}
EMB_MIN_ROWS = 8192   # 2-D leaves with >= this many rows are embedding tables
_F32 = torch.float32


# ---------------------------------------------------------- list ops --
# The update is written over lists of tensors, one multi-tensor launch an
# operation. Each operation rounds once (no fused multiply-adds: scalars
# multiply in operations of their own), as the JAX package's chain does.

def _as(xs: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """xs in `dtype`: the tensors themselves when they already are, else
    rounded copies (one copy pass)."""
    if all(x.dtype == dtype for x in xs):
        return xs
    out = [torch.empty_like(x, dtype=dtype) for x in xs]
    torch._foreach_copy_(out, xs)
    return out


def _round_to(xs: List[torch.Tensor], dtype: torch.dtype) -> None:
    """Round f32 xs to `dtype` in place (a no-op for float32)."""
    if dtype != _F32:
        torch._foreach_copy_(xs, _as(xs, dtype))


def _decayed(gs, ps, wd: float):
    """g + wd p (the coupled L2 term; gs untouched)."""
    if not wd:
        return gs
    out = torch._foreach_mul(_as(ps, _F32), wd)
    torch._foreach_add_(out, gs)
    return out


def _adam_chain(ps, gs, ms, vs, hp: dict, c1, c2, lr, upd_dtype) -> None:
    """One Adam step over lists of parameters, f32 gradients and moments:
    m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g;
    u = (m / c1) / (sqrt(v / c2) + eps), rounded to `upd_dtype` without
    weight decay (JAX's dtype promotion: the update keeps the gradients'
    dtype unless an f32 weight-decay term widened them);  p -= u lr."""
    b1, b2 = hp["betas"]
    wd = hp["weight_decay"]
    g = _decayed(gs, ps, wd)
    m = _as(ms, _F32)
    v = _as(vs, _F32)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
    torch._foreach_mul_(v, b2)
    g2 = torch._foreach_mul(g, 1.0 - b2)
    torch._foreach_mul_(g2, g)
    torch._foreach_add_(v, g2)
    den = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, hp["eps"])
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, den)
    if not wd:
        _round_to(upd, upd_dtype)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(ps, upd)
    if m is not ms:
        torch._foreach_copy_(ms, m)
    if v is not vs:
        torch._foreach_copy_(vs, v)


def _sgd_chain(ps, gs, bufs, hp: dict, lr) -> None:
    """One SGD step: g + wd p; with momentum, buf = momentum buf + g (the
    buffer starts at zero, optax.trace); p -= buf lr (or g lr)."""
    g = _decayed(gs, ps, hp["weight_decay"])
    if hp["momentum"]:
        torch._foreach_mul_(bufs, hp["momentum"])
        torch._foreach_add_(bufs, g)
        g = bufs
    torch._foreach_sub_(ps, torch._foreach_mul(g, lr))


def _lazy_row_update(p, g, m, v, hp: dict, c1, c2, lr, upd_dtype,
                     max_rows: int) -> None:
    """The JAX package's `_lazy_row_update` for one embedding table: the
    k = min(max_rows, rows) rows of largest squared gradient norm (every
    row a token touched, and untouched ones to fill k) step; a selected row
    whose gradient is zero keeps its moments and takes a zero update, so
    every untouched row keeps parameters and moments bit-unchanged. Weight
    decay is added to the touched rows only."""
    b1, b2 = hp["betas"]
    k = int(min(max_rows, g.shape[0]))
    g32 = g.float()
    rowsq = g32.square().sum(1)
    _, idx = torch.topk(rowsq, k)        # unique indices
    touched = (rowsq[idx] > 0.0).to(_F32)[:, None]
    gk = g32[idx]
    if hp["weight_decay"]:
        gk = gk + p[idx].float() * hp["weight_decay"]
    mk, vk = m[idx].float(), v[idx].float()
    mk2 = mk * b1 + gk * (1.0 - b1)
    vk2 = vk * b2 + gk * (1.0 - b2) * gk
    outk = (mk2 / c1) / ((vk2 / c2).sqrt() + hp["eps"])
    keep = 1.0 - touched
    mk2 = touched * mk2 + keep * mk
    vk2 = touched * vk2 + keep * vk
    outk = (outk * touched).to(upd_dtype).to(p.dtype)
    m.index_copy_(0, idx, mk2.to(m.dtype))
    v.index_copy_(0, idx, vk2.to(v.dtype))
    p.index_copy_(0, idx, p[idx] - outk * lr)


# --------------------------------------------------------------- groups --

class _Group:
    """One group's parameters and hyper-parameters, its learning rate (f32)
    and step count (int32) as tensors on the parameters' device."""

    def __init__(self, params: Iterable[torch.Tensor], hp: dict):
        self.params = list(params)
        self.hp = dict(hp)
        dev = self.params[0].device if self.params else torch.device("cpu")
        self.lr = torch.zeros((), dtype=_F32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.lr_value = 0.0
        self.batches: List[List[int]] = []

    def set_lr(self, lr: float) -> None:
        self.lr_value = float(lr)
        self.lr.fill_(self.lr_value)

    def _plan(self, idx: List[int]) -> None:
        """The multi-tensor batches over the leaves `idx`: one a dtype."""
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i in idx:
            by_dtype.setdefault(self.params[i].dtype, []).append(i)
        self.batches = list(by_dtype.values())

    def _run(self, lists, chain) -> None:
        """chain(*lists at a batch's indices) for every batch."""
        for ids in self.batches:
            chain(*[[lst[i] for i in ids] for lst in lists])

    def state_dict(self) -> dict:
        return {"state": {i: self._param_state(i)
                          for i in range(len(self.params))},
                "param_groups": [dict(self.hp, lr=self.lr_value,
                                      params=list(range(len(self.params))))],
                "count": self.count.clone()}

    def load_state_dict(self, sd: dict) -> None:
        """In place (a captured step keeps reading the same tensors); also
        the torch.optim layout, whose per-parameter int `step` is the
        count."""
        for i, st in sd["state"].items():
            for k, t in self._param_state(int(i)).items():
                if k in st:
                    t.copy_(st[k])
        if "count" in sd:
            self.count.copy_(torch.as_tensor(sd["count"]))
        else:
            steps = [int(st["step"]) for st in sd["state"].values()
                     if "step" in st]
            self.count.fill_(max(steps, default=0))
        lr = sd.get("param_groups", [{}])[0].get("lr")
        if lr is not None:
            self.set_lr(lr)

    def _param_state(self, i: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class AdamGroup(_Group):
    """Adam (coupled L2 weight decay, torch semantics) with both moments
    stored in `moment_dtype`, every update computed in f32; `upd_dtype` is
    the update's dtype without weight decay; `lazy_rows` > 0 gives
    embedding tables the row-sparse update."""

    def __init__(self, params, betas, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.bfloat16,
                 upd_dtype: torch.dtype = _F32, lazy_rows: int = 0):
        super().__init__(params, dict(betas=tuple(betas), eps=float(eps),
                                      weight_decay=float(weight_decay)))
        self.upd_dtype = upd_dtype
        self.lazy_rows = int(lazy_rows)
        self.exp_avg = [torch.zeros_like(p, dtype=moment_dtype)
                        for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p, dtype=moment_dtype)
                           for p in self.params]
        dev = self.count.device
        self._b = [torch.tensor(b, dtype=_F32, device=dev) for b in betas]
        self.lazy = [i for i, p in enumerate(self.params)
                     if self.lazy_rows and p.dim() == 2
                     and p.shape[0] >= EMB_MIN_ROWS]
        self._plan([i for i in range(len(self.params))
                    if i not in self.lazy])

    def _param_state(self, i):
        return {"exp_avg": self.exp_avg[i], "exp_avg_sq": self.exp_avg_sq[i]}

    @torch.no_grad()
    def step(self) -> None:
        if not self.params:
            return
        self.count.add_(1)
        c1 = 1.0 - self._b[0] ** self.count
        c2 = 1.0 - self._b[1] ** self.count
        grads = [p.grad for p in self.params]
        for i in self.lazy:
            _lazy_row_update(self.params[i], grads[i], self.exp_avg[i],
                             self.exp_avg_sq[i], self.hp, c1, c2, self.lr,
                             self.upd_dtype, self.lazy_rows)

        def chain(ps, gs, ms, vs):
            _adam_chain(ps, _as(gs, _F32), ms, vs, self.hp, c1, c2, self.lr,
                        self.upd_dtype)

        self._run((self.params, grads, self.exp_avg, self.exp_avg_sq), chain)


class SgdGroup(_Group):
    """SGD with coupled weight decay and optional momentum (optax.trace:
    the buffer starts at zero)."""

    def __init__(self, params, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(momentum=float(momentum),
                                      weight_decay=float(weight_decay)))
        self.momentum_buffer = ([torch.zeros_like(p) for p in self.params]
                                if momentum else [])
        self._plan(list(range(len(self.params))))

    def _param_state(self, i):
        return ({"momentum_buffer": self.momentum_buffer[i]}
                if self.momentum_buffer else {})

    @torch.no_grad()
    def step(self) -> None:
        if not self.params:
            return
        self.count.add_(1)
        lists = [self.params, [p.grad for p in self.params]]
        if self.momentum_buffer:
            lists.append(self.momentum_buffer)

        def chain(ps, gs, bs=None):
            _sgd_chain(ps, _as(gs, _F32), bs, self.hp, self.lr)

        self._run(lists, chain)


# ------------------------------------------------- gradient passes --

def cast_grads(params: Iterable[torch.Tensor], dtype: str) -> None:
    """Round every gradient to `dtype` in place (config `grads_dtype`; the
    JAX package casts its gradient tree at the grad boundary), one
    multi-tensor pass. The gradients stay in their parameters' dtype, so
    the optimizers' f32 math then reads the rounded values. No-op for
    float32."""
    if dtype == "float32":
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        with torch.no_grad():
            _round_to(grads, _DTYPES[dtype])


def clip_grad_norm(params: List[torch.Tensor], max_norm: float,
                   dtype: str = "float32") -> None:
    """torch.nn.utils.clip_grad_norm_ semantics as the JAX package writes
    them: scale = min(1, max_norm / max(||g||, 1e-6)), the squared norm in
    f32 (each gradient's f32 norm by `_foreach_norm`, their squares summed
    in one fixed-order reduction), one multi-tensor scale. With gradients
    in `dtype` bfloat16 the scale and each product are rounded to it, as
    the JAX package multiplies bf16 leaves by the scale cast to bf16."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    dt = _DTYPES[dtype]
    with torch.no_grad():
        norms = torch._foreach_norm(grads, 2, dtype=_F32)
        sq = torch.stack(norms).square().sum()
        scale = torch.clamp(max_norm / torch.clamp_min(sq.sqrt(), 1e-6),
                            max=1.0)
        torch._foreach_mul_(grads, scale.to(dt).to(_F32))
        _round_to(grads, dt)


def effective_clip(args) -> float:
    """The encoder clip norm: 0 (no clip) unless `apply_grad_clip`, since
    the reference clips after its optimizer step, a no-op (the JAX
    package's DEVIATIONS #3)."""
    return float(args.clip_max_norm) if args.apply_grad_clip else 0.0


def lazy_rows(args) -> int:
    """The JAX package's `_lazy_rows`: at most B T distinct tokens touch
    the table in a step (at least 256 rows), T the caption length of the
    en_type; 0 without `lazy_embedding_adam`."""
    if not args.lazy_embedding_adam:
        return 0
    words = (args.bert_words_num if args.en_type == "BERT"
             else args.lstm_words_num)
    return max(256, int(args.batch_size) * int(words or 24))


class GroupedOptimizer:
    """Three groups (head, encoder, cls) over named modules, stepped
    together; `lr` per group. A subclass names the module -> group map and
    builds the three groups in `_make`."""

    groups: Dict[str, str] = {}
    # an LSTM or GRU encoder has no head; `cmp` is there with is_CMP only
    optional = ("text_head", "cmp")

    def __init__(self, args, modules: Dict[str, torch.nn.Module]):
        modules = {k: m for k, m in modules.items() if m is not None}
        missing = sorted(set(self.groups) - set(modules) - set(self.optional))
        if missing:
            raise ValueError(f"{type(self).__name__}: no module for {missing}")
        md = args.adam_moments_dtype
        rows = lazy_rows(args)

        def adam(params, betas, wd=0.0, lazy=0):
            # optax.scale_by_adam's f32 moments promote the update to f32;
            # `_scale_by_adam_cast` and the lazy `_scale_by_adam_mixed`
            # return it in the gradients' dtype
            upd = args.grads_dtype if md != "float32" or lazy else "float32"
            return AdamGroup(params, betas, eps=1e-8, weight_decay=wd,
                             moment_dtype=_DTYPES[md], upd_dtype=_DTYPES[upd],
                             lazy_rows=lazy)

        self.params = {g: [] for g in ("head", "encoder", "cls")}
        for name, mod in modules.items():
            self.params[self.groups[name]] += [p for p in mod.parameters()]
        self.frozen_encoder = bool(args.compat_frozen_text)
        self.clip = effective_clip(args)
        self.grads_dtype = args.grads_dtype
        self.opts = self._make(args, adam, SgdGroup, rows)

    def _make(self, args, adam, sgd, rows) -> Dict[str, _Group]:
        raise NotImplementedError

    def set_lr(self, group: str, lr: float) -> None:
        self.opts[group].set_lr(lr)

    def get_lr(self, group: str) -> float:
        return self.opts[group].lr_value

    def zero_grad(self) -> None:
        for p in self.all_params():
            p.grad = None

    def all_params(self) -> List[torch.Tensor]:
        return [p for ps in self.params.values() for p in ps]

    @torch.no_grad()
    def step(self) -> None:
        """zero gradients where none -> cast -> (encoder clip) -> one step
        of every group."""
        missing = [p for p in self.all_params() if p.grad is None]
        if missing:
            for p in missing:
                p.grad = torch.empty_like(p)
            torch._foreach_zero_([p.grad for p in missing])
        cast_grads(self.all_params(), self.grads_dtype)
        if self.clip:
            clip_grad_norm(self.params["encoder"], self.clip,
                           self.grads_dtype)
        for group, opt in self.opts.items():
            if group == "encoder" and self.frozen_encoder:
                continue
            opt.step()

    def state_dict(self) -> Dict[str, dict]:
        return {g: opt.state_dict() for g, opt in self.opts.items()}

    def resize_state(self, state: Dict[str, dict]) -> None:
        """Take each per-parameter state tensor whose shape `state` changes
        (a class-sharded rank's rows of the classifier's state, parallel/
        partial_fc.py) as a copy of the given one; the parameters must
        have that shape already."""
        for g, opt in self.opts.items():
            for i, st in state[g]["state"].items():
                for k, t in opt._param_state(int(i)).items():
                    if k in st and tuple(st[k].shape) != tuple(t.shape):
                        getattr(opt, k)[int(i)] = st[k].to(
                            t.device, t.dtype).clone()

    def load_state_dict(self, state: Dict[str, dict]) -> None:
        for g, opt in self.opts.items():
            opt.load_state_dict(state[g])
        # a torch.optim SGD state holds no step: its count is the Adam
        # groups' (every group steps every time)
        for g, opt in self.opts.items():
            if "count" not in state[g] and not any(
                    "step" in st for st in state[g]["state"].values()):
                opt.count.fill_(max(int(o.count) for o in self.opts.values()))


class Stage1Optimizer(GroupedOptimizer):
    groups = GROUPS
    encoder_betas = (0.9, 0.999)

    def _make(self, args, adam, sgd, rows):
        return {
            "head": adam(self.params["head"], (0.5, 0.999)),
            "encoder": adam(self.params["encoder"], self.encoder_betas,
                            float(args.weight_decay), rows),
            "cls": sgd(self.params["cls"], 0.9, 5e-5),
        }


class Stage1LstmOptimizer(Stage1Optimizer):
    encoder_betas = (0.9, 0.5)


class Stage2Optimizer(GroupedOptimizer):
    groups = STAGE2_GROUPS

    def _make(self, args, adam, sgd, rows):
        self.clip = 0.0     # the JAX package's stage-2 encoder Adam has none
        return {
            "cls": sgd(self.params["cls"], 0.0, float(args.weight_decay)),
            "encoder": adam(self.params["encoder"], (0.9, 0.999), 0.01, rows),
            "head": adam(self.params["head"], (0.9, 0.999), 5e-5),
        }


def make_stage1_bert_tx(args, modules: Dict[str, torch.nn.Module]
                        ) -> Stage1Optimizer:
    """The stage-1 BERT optimizer over {image_head, text_encoder,
    text_head, image_cls, text_cls, cmp}; all learning rates start at 0
    until `set_lr`."""
    return Stage1Optimizer(args, modules)


def make_stage1_lstm_tx(args, modules: Dict[str, torch.nn.Module]
                        ) -> Stage1LstmOptimizer:
    """The stage-1 LSTM/GRU optimizer over {image_head, text_encoder,
    image_cls, text_cls, cmp}; all learning rates start at 0 until
    `set_lr`."""
    return Stage1LstmOptimizer(args, modules)


def make_stage2_tx(args, modules: Dict[str, torch.nn.Module]
                   ) -> Stage2Optimizer:
    """The stage-2 optimizer over {text_encoder, text_head, image_head,
    fusion_net, metric_fc}; all learning rates start at 0 until `set_lr`."""
    return Stage2Optimizer(args, modules)
