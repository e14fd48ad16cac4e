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


def _stage1_trees(arch):
    """The JAX stage-1 trainer's params and batch_stats trees (its layout,
    engine/stage1.py) for the tiny arch, from module inits."""
    z = jnp.zeros
    key = jax.random.PRNGKey
    ih = randomize_stats(JM.ImageHeading().init(key(0), z((1, 512)),
                                                z((1, 14, 14, 256))), 3)
    te = JM.TextEncoder(bert_type=arch).init(
        key(1), z((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    th = JM.TextHeading().init(key(2), z((1, 7, 128)))
    xavier = jax.nn.initializers.xavier_uniform()
    params = {"image_head": ih["params"], "text_encoder": te["params"],
              "text_head": th["params"],
              "image_cls": {"weight": xavier(key(3), (16, 256))},
              "text_cls": {"weight": xavier(key(4), (16, 256))}}
    return to_numpy(params), to_numpy({"image_head": ih["batch_stats"]})


def _stage1_model(arch):
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Model)
    return Stage1Model(PM.ImageHeading(), PM.TextEncoder(bert_type=arch),
                       PM.TextHeading(hidden=128, feat_dim=256), 16, 256)


def test_bridge_carries_the_stage1_trees(tiny_arch):
    params, stats = _stage1_trees(tiny_arch)
    model = _stage1_model(tiny_arch)
    sd = state_dict_from_jax(params, stats, module=model)
    assert len(sd) == len(_leaves(params)) + len(_leaves(stats))
    assert not any(model.load_state_dict(sd, strict=True))
    # class weights land unchanged, (num_classes, feat)
    np.testing.assert_array_equal(sd["image_cls.weight"].numpy(),
                                  params["image_cls"]["weight"])
    np.testing.assert_array_equal(sd["text_cls.weight"].numpy(),
                                  params["text_cls"]["weight"])
    np.testing.assert_array_equal(
        sd["image_head.imim.bn_img.running_var"].numpy(),
        stats["image_head"]["imim"]["bn_img"]["var"])


def test_bridge_refuses_incomplete_or_foreign_stage1_trees(tiny_arch):
    params, stats = _stage1_trees(tiny_arch)
    model = _stage1_model(tiny_arch)
    missing = {k: v for k, v in params.items() if k != "text_cls"}
    with pytest.raises(KeyError, match="no JAX leaf"):
        state_dict_from_jax(missing, stats, module=model)
    with pytest.raises(KeyError, match="no JAX leaf"):
        state_dict_from_jax(params, {}, module=model)
    extra = {**params, "cmp": {"Q": np.zeros((256, 16), np.float32)}}
    with pytest.raises(KeyError, match="unknown leaf"):
        state_dict_from_jax(extra, stats, module=model)
    # is_CMP's projection, on a model built without it
    extra = {**params, "cmp": {"W": np.zeros((256, 16), np.float32)}}
    with pytest.raises(KeyError, match="no port key"):
        state_dict_from_jax(extra, stats, module=model)
    extra = {**params, "cmp": {"weight": np.zeros((256, 16), np.float32)}}
    with pytest.raises(KeyError, match="no port key"):
        state_dict_from_jax(extra, stats, module=model)


def _stage2_trees(arch):
    """The JAX stage-2 trainer's trees: params {text_encoder, text_head,
    image_head, fusion_net, metric_fc} and batch_stats {image_head,
    fusion_net}, the fusion net's statistics as train mode updates them."""
    z = jnp.zeros
    key = jax.random.PRNGKey
    ih = randomize_stats(JM.ImageHeading().init(key(0), z((1, 512)),
                                                z((1, 14, 14, 256))), 3)
    fn = randomize_stats(JM.FCFM(channel_dim=36).init(
        key(5), z((1, 14, 14, 256)), z((1, 256, 10)), z((1, 256)),
        z((1, 256))), 4)
    te = JM.TextEncoder(bert_type=arch).init(
        key(1), z((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    th = JM.TextHeading().init(key(2), z((1, 7, 128)))
    xavier = jax.nn.initializers.xavier_uniform()
    params = {"image_head": ih["params"], "text_encoder": te["params"],
              "text_head": th["params"], "fusion_net": fn["params"],
              "metric_fc": {"weight": xavier(key(3), (16, 640))}}
    stats = {"image_head": ih["batch_stats"], "fusion_net": fn["batch_stats"]}
    return to_numpy(params), to_numpy(stats)


def _stage2_model(arch):
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionModel)
    return FusionModel(PM.TextEncoder(bert_type=arch),
                       PM.TextHeading(hidden=128, feat_dim=256),
                       PM.ImageHeading(), PM.FCFM(channel_dim=36),
                       PM.ArcMarginProduct(640, 16))


def test_bridge_carries_the_stage2_trees(tiny_arch):
    params, stats = _stage2_trees(tiny_arch)
    model = _stage2_model(tiny_arch)
    sd = state_dict_from_jax(params, stats, module=model)
    assert len(sd) == len(_leaves(params)) + len(_leaves(stats))
    assert not any(model.load_state_dict(sd, strict=True))
    np.testing.assert_array_equal(sd["metric_fc.weight"].numpy(),
                                  params["metric_fc"]["weight"])
    for bn in ("bn_img", "bn_word"):
        np.testing.assert_array_equal(
            sd[f"fusion_net.{bn}.running_mean"].numpy(),
            stats["fusion_net"][bn]["mean"])
        np.testing.assert_array_equal(
            sd[f"fusion_net.{bn}.running_var"].numpy(),
            stats["fusion_net"][bn]["var"])
    # FCFM's convolution: HWIO -> OIHW
    np.testing.assert_array_equal(
        sd["fusion_net.conv.weight"].numpy(),
        params["fusion_net"]["conv"]["kernel"].transpose(3, 2, 0, 1))


def test_bridge_refuses_incomplete_or_foreign_stage2_trees(tiny_arch):
    params, stats = _stage2_trees(tiny_arch)
    model = _stage2_model(tiny_arch)
    with pytest.raises(KeyError, match="no JAX leaf"):
        state_dict_from_jax({k: v for k, v in params.items()
                             if k != "metric_fc"}, stats, module=model)
    with pytest.raises(KeyError, match="no JAX leaf"):      # train mode's
        state_dict_from_jax(params, {"image_head": stats["image_head"]},
                            module=model)                   # fusion stats
    extra = {**params, "image_cls": {"weight": np.zeros((16, 256),
                                                        np.float32)}}
    with pytest.raises(KeyError, match="no port key"):
        state_dict_from_jax(extra, stats, module=model)
    wrong = {**params, "metric_fc": {"weight": np.zeros((640, 16),
                                                        np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(wrong, stats, module=model)
