"""The port's models against their JAX twins on bridged weights.

Each JAX module is initialised from a seed, its variables (with non-trivial
BatchNorm statistics) are carried into the port module by
engine/from_jax.py, and both run the same numpy inputs in f32. Layouts:
the JAX package is NHWC, the port NCHW; the tests permute.

Tolerance 1e-4 (assert_allclose, rtol = atol): the two frameworks sum in
other orders (GEMMs, convolutions, softmax and norm reductions), and the
JAX fused kernels use the Abramowitz-Stegun erf (7.2e-7 from erf) where the
port uses erf; through two layers, heads and l2 normalisations those stay
well below 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu import models as JM
from text_guided_face_recognition_tpu_torch import models as PM

from _torch_port import bridge, close, randomize_stats, ragged_mask, t
from _torch_port import tiny_arch  # noqa: F401  (fixture)

TOL = 1e-4
B, T = 3, 10


def _captions(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000 // 2, 1000, size=(B, T)).astype(np.int32)
    return ids, ragged_mask(B, T, seed)


@pytest.mark.parametrize("fused_ln", [False, True])
@pytest.mark.parametrize("fused_block", ["none", "ffn", "attn", "both"])
def test_text_encoder_and_heading_match_jax(tiny_arch, fused_block, fused_ln):
    ids, mask = _captions()
    # the fused and unfused flax trees are identical: init once, unfused
    j_init = JM.TextEncoder(bert_type=tiny_arch, dtype=jnp.float32)
    enc_vars = j_init.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                           jnp.asarray(mask))
    j_enc = JM.TextEncoder(bert_type=tiny_arch, dtype=jnp.float32,
                           fused_ln=fused_ln, fused_block=fused_block)
    j_words, j_sent = j_enc.apply(enc_vars, jnp.asarray(ids),
                                  jnp.asarray(mask))
    j_head = JM.TextHeading(feat_dim=64, dtype=jnp.float32)
    head_vars = j_head.init(jax.random.PRNGKey(1), j_words)
    j_w, j_s = j_head.apply(head_vars, j_words)

    p_enc = bridge(PM.TextEncoder(bert_type=tiny_arch, dtype=torch.float32,
                                  fused_ln=fused_ln, fused_block=fused_block),
                   enc_vars)
    p_head = bridge(PM.TextHeading(hidden=128, feat_dim=64), head_vars)
    with torch.no_grad():
        p_words, p_sent = p_enc(t(ids), t(mask))
        p_w, p_s = p_head(p_words)
    close(p_words, j_words, TOL, "words_emb")
    close(p_sent, j_sent, TOL, "sent_emb")
    assert p_w.shape == (B, 64, T - 2) and p_w.dtype == torch.float32
    close(p_w, j_w, TOL, "head words (B, F, T-2)")
    close(p_s, j_s, TOL, "head sent")


def test_text_encoder_refuses_unported_archs():
    # the whole-tower kernel is ported: `tower` constructs, with the tree of
    # every other mode; heads of another width than 64 (blip: 96) still raise
    enc = PM.TextEncoder(bert_type="bert", fused_block="tower")
    assert enc.model.fused_block == "tower"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PM.TextEncoder(bert_type="blip", fused_block="tower")
    for arch in ("clip", "groupvit", "falva"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PM.TextEncoder(bert_type=arch)


@pytest.mark.parametrize("fused_block", ["ffn", "attn", "both", "tower"])
def test_fused_block_refuses_other_head_widths(fused_block):
    # blip has 8 heads of 96: the kernels take heads of 64, and the port
    # raises where the JAX package would quietly run the unfused tower
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PM.TextEncoder(bert_type="blip", fused_block=fused_block)


def _image(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, 112, 112, 3)).astype(np.float32)


def test_iresnet_matches_jax():
    x = _image()
    j_net = JM.IResNet(layers=(1, 1, 1, 1), dtype=jnp.float32)
    variables = randomize_stats(j_net.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)))
    j_g, j_l = j_net.apply(variables, jnp.asarray(x), train=False)
    p_net = bridge(PM.IResNet(layers=(1, 1, 1, 1)), variables)
    with torch.no_grad():
        p_g, p_l = p_net(t(x).permute(0, 3, 1, 2))
    assert p_l.shape == (2, 256, 14, 14)
    close(p_g, j_g, TOL, "global feature")
    close(p_l.permute(0, 2, 3, 1), j_l, TOL, "layer-3 local map")


def test_image_heading_matches_jax():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(2, 512)).astype(np.float32)
    loc = rng.normal(size=(2, 14, 14, 256)).astype(np.float32)
    j_head = JM.ImageHeading(feat_dim=256, dtype=jnp.float32)
    variables = randomize_stats(j_head.init(jax.random.PRNGKey(0),
                                            jnp.asarray(g), jnp.asarray(loc)))
    j_p, j_q = j_head.apply(variables, jnp.asarray(g), jnp.asarray(loc),
                            train=False)
    p_head = bridge(PM.ImageHeading(feat_dim=256), variables)
    with torch.no_grad():
        p_p, p_q = p_head(t(g), t(loc).permute(0, 3, 1, 2))
    close(p_p, j_p, TOL, "global projection")
    close(p_q.permute(0, 2, 3, 1), j_q, TOL, "IMIM local map")


def test_fcfm_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 14, 14, 256)).astype(np.float32)
    word = rng.normal(size=(2, 256, 22)).astype(np.float32)
    gl = rng.normal(size=(2, 256)).astype(np.float32)
    sent = rng.normal(size=(2, 256)).astype(np.float32)
    j_net = JM.FCFM(channel_dim=36, dtype=jnp.float32)
    args = [jnp.asarray(a) for a in (img, word, gl, sent)]
    variables = j_net.init(jax.random.PRNGKey(0), *args)
    variables = randomize_stats(variables)
    # non-trivial LayerNorm affines, so the (H, W, C) -> (C, H, W) move of
    # LayerNormCHW is exercised
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * jnp.asarray(
            rng.normal(size=x.shape), x.dtype)
        if path[-1].key in ("scale", "bias") else x, variables)
    j_out = j_net.apply(variables, *args, train=False)
    p_net = bridge(PM.FCFM(channel_dim=36), variables)
    with torch.no_grad():
        p_out = p_net(t(img).permute(0, 3, 1, 2), t(word), t(gl), t(sent))
    assert p_out.shape == (2, 640)
    close(p_out, j_out, TOL, "FCFM 640-d")


def test_linear_fusion_matches_jax():
    rng = np.random.default_rng(0)
    img, sent = (rng.normal(size=(2, 256)).astype(np.float32)
                 for _ in range(2))
    j_net = JM.LinearFusion(fusion_final_dim=640, dtype=jnp.float32)
    variables = j_net.init(jax.random.PRNGKey(0), jnp.asarray(img),
                           jnp.asarray(sent))
    j_out = j_net.apply(variables, jnp.asarray(img), jnp.asarray(sent))
    p_net = bridge(PM.LinearFusion(512, 640), variables)
    with torch.no_grad():
        close(p_net(t(img), t(sent)), j_out, TOL, "linear fusion")
