"""The weight bridge (engine/from_jax.py): every leaf of the JAX `params`
and `batch_stats` trees is consumed, every port parameter and buffer is
filled, and each leaf lands transformed as documented (Dense transposed,
conv HWIO -> OIHW, LayerNormCHW (H, W, C) -> (C, H, W))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu import models as JM
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)

from _torch_port import randomize_stats, to_numpy
from _torch_port import tiny_arch  # noqa: F401  (fixture)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _twins(name, arch):
    """(JAX module, its init inputs, port module) per bridged module."""
    z = jnp.zeros
    return {
        "text_encoder": (
            JM.TextEncoder(bert_type=arch),
            (z((2, 8), jnp.int32), jnp.ones((2, 8), jnp.int32)),
            PM.TextEncoder(bert_type=arch)),
        "text_heading": (JM.TextHeading(feat_dim=64), (z((2, 7, 128)),),
                         PM.TextHeading(hidden=128, feat_dim=64)),
        "iresnet": (JM.IResNet(layers=(1, 1, 1, 1)), (z((1, 112, 112, 3)),),
                    PM.IResNet(layers=(1, 1, 1, 1))),
        "image_heading": (JM.ImageHeading(), (z((1, 512)),
                                              z((1, 14, 14, 256))),
                          PM.ImageHeading()),
        "fcfm": (JM.FCFM(), (z((1, 14, 14, 256)), z((1, 256, 22)),
                             z((1, 256)), z((1, 256))), PM.FCFM()),
        "linear_fusion": (JM.LinearFusion(), (z((1, 256)), z((1, 256))),
                          PM.LinearFusion(512, 640)),
    }[name]


@pytest.mark.parametrize("name", ["text_encoder", "text_heading", "iresnet",
                                  "image_heading", "fcfm", "linear_fusion"])
def test_bridge_is_complete(tiny_arch, name):
    j_mod, inputs, p_mod = _twins(name, tiny_arch)
    variables = to_numpy(randomize_stats(
        j_mod.init(jax.random.PRNGKey(0), *inputs)))
    params, stats = variables["params"], variables.get("batch_stats")
    sd = state_dict_from_jax(params, stats, module=p_mod)
    target = p_mod.state_dict()
    # one port key per JAX leaf, and every port key filled
    assert len(sd) == len(_leaves(params)) + len(_leaves(stats or {}))
    assert list(sd) == list(target)
    missing, unexpected = p_mod.load_state_dict(sd, strict=True)
    assert not missing and not unexpected


def test_bridge_transforms(tiny_arch):
    j_mod, inputs, p_mod = _twins("fcfm", tiny_arch)
    v = to_numpy(randomize_stats(j_mod.init(jax.random.PRNGKey(0), *inputs)))
    ln_scale = np.random.default_rng(0).normal(size=(6, 6, 36))
    v["params"]["ln"]["scale"] = ln_scale.astype(np.float32)
    sd = state_dict_from_jax(v["params"], v["batch_stats"], module=p_mod)
    np.testing.assert_array_equal(sd["linear.weight"].numpy(),
                                  v["params"]["linear"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["conv.weight"].numpy(),
        v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["ln.weight"].numpy(),
                                  ln_scale.transpose(2, 0, 1)
                                  .astype(np.float32))
    np.testing.assert_array_equal(sd["bn_img.running_var"].numpy(),
                                  v["batch_stats"]["bn_img"]["var"])
    assert sd["ln_sent.weight"].dtype == torch.float32


def test_bridge_refuses_incomplete_or_foreign_trees(tiny_arch):
    j_mod, inputs, p_mod = _twins("linear_fusion", tiny_arch)
    params = to_numpy(j_mod.init(jax.random.PRNGKey(0), *inputs))["params"]
    with pytest.raises(KeyError, match="no JAX leaf"):
        state_dict_from_jax({"fc1": {"kernel": params["fc1"]["kernel"]}},
                            module=p_mod)
    with pytest.raises(KeyError, match="no port key"):
        state_dict_from_jax({**params, "extra": {"bias": np.zeros(3)}},
                            module=p_mod)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax({"fc1": {"kernel": params["fc1"]["kernel"].T,
                                     "bias": params["fc1"]["bias"]}},
                            module=p_mod)
