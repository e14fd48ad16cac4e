"""The weight bridge: JAX package variables -> a port module's state_dict.

The port names its submodules after the JAX package's flax modules, so a
flax path `a/b/kernel` lands on the port key `a.b.weight`. The leaf
transforms:

  Dense `kernel` (in, out)      -> `weight` (out, in)
  Conv  `kernel` HWIO           -> `weight` OIHW
  Embed `embedding`             -> `weight`
  LayerNorm / BatchNorm `scale` -> `weight`   (`bias` keeps its name)
  LayerNormCHW (H, W, C)        -> (C, H, W), scale and bias alike
  batch_stats `mean` / `var`    -> `running_mean` / `running_var`
  margin_stats `iter`,
  `batch_mean`, `batch_std`     -> the buffers of those names (the
                                   SphereProduct and AdaFaceHead heads)
  PReLU `alpha`                 -> `alpha`
  a bare `weight` (the trainers'
  image_cls / text_cls /
  metric_fc class weights)      -> `weight`, unchanged
  `W` (stage 1's `cmp`
  projection, (feat, classes),
  normalised over axis 0)       -> `W`, unchanged (not transposed)
  RNN gate `i{g}` / `h{g}`
  `kernel` (in, h), `bias`      -> the gate's `weight` (h, in), `bias`
                                   (models/text_rnn.py keeps flax's gates,
                                   LSTM i, f, g, o, GRU r, z, n, one each)

The scale-free `features` BN has no scale on either side. A whole trainer
bridges at once: the stage-1 params tree {image_head, text_encoder,
text_head, image_cls, text_cls, and `cmp` with is_CMP} with batch_stats
{image_head} onto engine/stage1.Stage1Model, and the stage-2 tree
{text_encoder, text_head, image_head, fusion_net, metric_fc} with
batch_stats {image_head, fusion_net} onto engine/stage2.FusionModel; with an
LSTM or GRU encoder neither tree nor model has a text_head. The text tower's
tree is the same under every `fused_block`, `tower` included. Inputs are
nested dicts of numpy arrays (the tests get them with `jax.device_get`, a
resume from tools/export_jax_checkpoint.py's `.npz`); this module imports
nothing of JAX.

`optimizer_state_from_jax` carries an exported optimizer state onto the
port's grouped optimizer (engine/optim.py): per group its step count and,
per parameter, Adam's `mu` / `nu` (`exp_avg` / `exp_avg_sq`) or SGD's
`trace` (`momentum_buffer`), each moment through its parameter's leaf
transform, in the optimizer's storage dtype. A rank of the class-sharded
stage-2 step (parallel/partial_fc.py) takes an exported state through
`shard_state_for_partial_fc` first, which cuts metric_fc's weight and its
optimizer state to the rank's rows (engine/trainer.py `resume_from`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.models.layers import LayerNormCHW

__all__ = ["state_dict_from_jax", "optimizer_state_from_jax"]

_PARAM_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "weight": "weight", "bias": "bias", "alpha": "alpha",
               "W": "W"}
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}
_MARGIN_LEAF = {k: k for k in ("iter", "batch_mean", "batch_std")}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _convert(owner: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if isinstance(owner, LayerNormCHW):
        return value.transpose(2, 0, 1)          # (H, W, C) -> (C, H, W)
    if leaf == "kernel" and value.ndim == 2:
        return value.T                           # (in, out) -> (out, in)
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)       # HWIO -> OIHW
    return value


def _leaves(tree: Mapping, names: Mapping, owners, target):
    """(JAX path, port key, value in the port's layout) of every leaf of
    `tree`; raises KeyError on a leaf with no port key and ValueError on
    a shape mismatch."""
    for path, value in _flatten(tree).items():
        owner_path, _, leaf = path.rpartition(".")
        if leaf not in names:
            raise KeyError(f"JAX leaf {path!r}: unknown leaf name")
        key = f"{owner_path}.{names[leaf]}" if owner_path else names[leaf]
        if key not in target or owner_path not in owners:
            raise KeyError(f"JAX leaf {path!r} has no port key {key!r}")
        arr = _convert(owners[owner_path], leaf, value)
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"{path!r} -> {key!r}: shape {arr.shape} "
                             f"!= {tuple(target[key].shape)}")
        yield path, key, arr


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32)).to(like.dtype)


def state_dict_from_jax(params: Mapping,
                        batch_stats: Optional[Mapping] = None,
                        module: Optional[nn.Module] = None,
                        margin_stats: Optional[Mapping] = None
                        ) -> "OrderedDict[str, torch.Tensor]":
    """The `state_dict` of `module` holding the JAX variables.

    params / batch_stats / margin_stats: the flax `params`, `batch_stats`
    and `margin_stats` collections as nested dicts of numpy arrays. Raises
    KeyError when a JAX leaf has no port key or a port parameter or buffer
    gets no JAX leaf, and ValueError on a shape mismatch, so a bridge that
    loads is complete.
    """
    if module is None:
        raise ValueError("state_dict_from_jax needs the port module")
    owners = dict(module.named_modules())
    target = module.state_dict()
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sources = [(params, _PARAM_LEAF), (batch_stats or {}, _STATS_LEAF),
               (margin_stats or {}, _MARGIN_LEAF)]
    for tree, names in sources:
        for _, key, arr in _leaves(tree, names, owners, target):
            out[key] = _tensor(arr, target[key])
    missing = [k for k in target if k not in out]
    if missing:
        raise KeyError(f"port keys with no JAX leaf: {missing}")
    return OrderedDict((k, out[k]) for k in target)


def optimizer_state_from_jax(opt: Mapping, module: nn.Module, optimizer
                             ) -> Dict[str, dict]:
    """The state_dict of `optimizer` (engine/optim.GroupedOptimizer over
    `module`'s parameters) holding an exported JAX optimizer state.

    opt: {group: {"count": int, "mu" / "nu" / "trace": params-shaped
    trees}} as numpy, the `opt/` part of an exported train state (tools/
    export_jax_checkpoint.py). Each moment takes its parameter's leaf
    transform. Raises KeyError when a group's moments miss a parameter the
    port's group steps, or name one it does not hold, so a state that
    loads is complete; a group absent from `opt` (a frozen encoder, whose
    JAX state is empty) keeps the port's fresh state."""
    owners = dict(module.named_modules())
    target = dict(module.named_parameters())
    where = {}
    for g, params in optimizer.params.items():
        for i, p in enumerate(params):
            where[id(p)] = (g, i)
    sd = optimizer.state_dict()
    for g, gst in opt.items():
        if g not in sd:
            raise KeyError(f"JAX optimizer group {g!r}: the port has "
                           f"{sorted(sd)}")
        state = sd[g]["state"]
        if "count" in gst:
            sd[g]["count"] = torch.as_tensor(
                np.asarray(gst["count"]), dtype=torch.int32)
        for jname, pname in _MOMENTS.items():
            if jname not in gst:
                continue
            seen = set()
            for path, key, arr in _leaves(gst[jname], _PARAM_LEAF, owners,
                                          target):
                grp, i = where[id(target[key])]
                if grp != g or pname not in state[i]:
                    raise KeyError(f"JAX {g}/{jname} leaf {path!r}: the "
                                   f"port's {key!r} is in group {grp!r} "
                                   f"with {sorted(sd[grp]['state'][i])}")
                state[i][pname] = _tensor(arr, state[i][pname])
                seen.add(i)
            missing = [i for i in state if pname in state[i]
                       and i not in seen]
            if missing:
                raise KeyError(f"JAX {g}/{jname}: no moment for the port's "
                               f"parameters {missing} of group {g!r}")
    return sd
