"""Shared helpers for the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): small shapes, JAX variables as numpy, and
the weight bridge into port modules.

Inputs are made with numpy from a seed and handed to both sides; JAX runs
on the CPU, its Pallas kernels in interpret mode (the model wiring picks
that itself off-TPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb

# The first call of ATen's vectorised exp in a process can be off by up to
# 1.6e-4 relative on one OpenMP thread's chunk under contended cores
# (tests/test_torch_ops.py); every later call is exact. Taken here, at
# import, before any comparison.
torch.exp(torch.linspace(-4.0, 4.0, 1 << 16))
torch.erf(torch.linspace(-4.0, 4.0, 1 << 16))

# Small post-LN BERT: d_head = 64, which the fused paths of both packages
# require; 2 layers, intermediate 256; bert's vocabulary, which the
# synthetic captions index.
TINY = dict(vocab_size=30522, hidden=128, layers=2, heads=2, intermediate=256,
            max_positions=64)


@pytest.fixture
def tiny_arch(monkeypatch):
    """Registers the small arch as bert_type "tiny" on both sides."""
    monkeypatch.setitem(jtb.TEXT_ARCHS, "tiny", jtb.TextArch(**TINY))
    monkeypatch.setitem(ptb.TEXT_ARCHS, "tiny", ptb.TextArch(**TINY))
    return "tiny"


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def randomize_stats(variables, seed: int = 0):
    """Non-trivial BatchNorm running statistics, so eval-mode BN is tested
    beyond the identity."""
    rng = np.random.default_rng(seed)
    if "batch_stats" not in variables:
        return variables

    def fill(path, x):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.normal(0, 0.2, x.shape), x.dtype)
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)

    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        fill, variables["batch_stats"])
    return out


def bridge(port_module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load the JAX variables into the port module (strict) and set eval."""
    v = to_numpy(variables)
    sd = state_dict_from_jax(v["params"], v.get("batch_stats"),
                             module=port_module)
    port_module.load_state_dict(sd, strict=True)
    return port_module.eval()


def ragged_mask(b: int, t: int, seed: int = 0) -> np.ndarray:
    """(b, t) int32 key masks with ragged lengths >= 2; row 0 full."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, t + 1, size=b)
    lens[0] = t
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)


def t(x, dtype=None) -> torch.Tensor:
    """numpy -> torch (CPU), optionally cast."""
    out = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return out if dtype is None else out.to(dtype)


def close(port, ref, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(
        np.asarray(port.detach().float().numpy() if torch.is_tensor(port)
                   else port, np.float32),
        np.asarray(ref, np.float32), rtol=tol, atol=tol, err_msg=what)


def reference_oracle(model_type: str, seed: int = 0) -> torch.nn.Module:
    """The torch oracle of a backbone (tests/test_convert.py: TorchIR18 for
    adaface, else TorchIResNet18) from torch's generator at `seed`, in eval
    mode, with random BN statistics and affines; `features.weight` stays
    off 1, so loading it takes the scale fold."""
    from test_convert import TorchIR18, TorchIResNet18, _randomize_bn_stats
    torch.manual_seed(seed)
    model = (TorchIR18 if model_type == "adaface" else TorchIResNet18)()
    _randomize_bn_stats(model.eval(), np.random.default_rng(seed))
    return model


def write_reference_backbone(path, model_type: str, seed: int = 0,
                             prefix: str = "") -> torch.nn.Module:
    """Write a backbone file at `path` in the reference's layout and return
    its oracle: ArcFace's bare state_dict (keys under `prefix`), MagFace's
    {'state_dict': module.features.* + the margin head's module.fc.weight},
    AdaFace's Lightning checkpoint {'state_dict': model.* + head.*,
    'hyper_parameters' (an object weights_only=True refuses), 'epoch'}."""
    import argparse
    import os
    oracle = reference_oracle(model_type, seed)
    sd = oracle.state_dict()
    if model_type == "adaface":
        sd = {"model." + k: v for k, v in sd.items()}
        sd["head.kernel"] = torch.randn(512, 16)
        obj = {"state_dict": sd, "epoch": 25,
               "hyper_parameters": argparse.Namespace(arch="ir_18", m=0.4)}
    elif model_type == "magface":
        sd = {"module.features." + k: v for k, v in sd.items()}
        sd["module.fc.weight"] = torch.randn(512, 16)
        obj = {"state_dict": sd}
    else:
        obj = {prefix + k: v for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, str(path))
    return oracle


def write_cfg(directory, name: str, **changes) -> str:
    """The shipped cfg/<name> with `changes`, written into `directory`;
    returns its path (for a CLI's --cfg)."""
    import os
    import yaml
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "cfg", name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(changes)
    out = os.path.join(str(directory), name)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return out
