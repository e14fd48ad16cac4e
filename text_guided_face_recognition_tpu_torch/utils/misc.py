"""Small shared helpers (reference: utils/utils.py:12-50).

Copy of text_guided_face_recognition_tpu/utils/misc.py: the port keeps its
own, so that it imports nothing of the JAX package. `params_count` counts
an nn.Module's parameters (a bridged model gives the JAX params tree's
count: BatchNorm running statistics are buffers here and batch_stats
there, in neither count) or every tensor of a state dict or nested
mapping.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Mapping

import numpy as np
import torch
import yaml

__all__ = ["mkdir_p", "get_time_stamp", "save_args", "params_count"]


def mkdir_p(path: str) -> None:
    """reference: utils/utils.py:16-23."""
    os.makedirs(path, exist_ok=True)


def get_time_stamp() -> str:
    """reference: utils/utils.py:26-29."""
    return datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")


def save_args(save_path: str, args: Any) -> None:
    """Dump the run config next to its artifacts (reference:
    utils/utils.py:47-50): the scalar, string and list fields."""
    d = args.to_dict() if hasattr(args, "to_dict") else dict(vars(args))
    with open(save_path, "w") as fp:
        yaml.safe_dump({k: v for k, v in d.items()
                        if isinstance(v, (int, float, str, bool, list))}, fp)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def params_count(params) -> int:
    """Total parameter count (reference: utils/utils.py:12-13): of an
    nn.Module its parameters, of a state dict or nested mapping every
    tensor or array in it."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return int(sum(np.prod(tuple(x.shape)) for x in _leaves(params)
                   if hasattr(x, "shape")))
