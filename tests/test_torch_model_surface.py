"""The model surface off the main path against the JAX package: the margin
math and heads (CosFace, SphereFace, AdaFace, MagFace), MagFace's trainable
model and loss, the iResNets at every depth, AdaFace's GNAP and GDC heads
and build_model names, the sequence attention layers, ParagraphLevelCFA,
ConcatAttention and the AttnGAN attention modules, each on bridged weights
(engine/from_jax.py) and numpy inputs from a seed.

Tolerance: f32 1e-4 (rtol = atol), the port's modules against the JAX
package's (summation order); the margin state (SphereFace's counter,
AdaFace's EMA statistics) 1e-6. Layouts: the JAX package is NHWC, the port
NCHW; the tests permute. One deeper iResNet runs a forward (iresnet34, B 1,
112 x 112); the other depths are held by their parameter trees, made by
jax.eval_shape with no compute, loading strictly into the port's modules.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu import models as JM
from text_guided_face_recognition_tpu.engine import convert as jconv
from text_guided_face_recognition_tpu.models import irnet as jirnet
from text_guided_face_recognition_tpu.models import magface as jmag
from text_guided_face_recognition_tpu.ops import margins as jmargins
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.engine import convert as pconv
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.models import irnet as pirnet
from text_guided_face_recognition_tpu_torch.models import magface as pmag
from text_guided_face_recognition_tpu_torch.ops import margins as pmargins

from _torch_port import bridge, close, randomize_stats, t, to_numpy

TOL = 1e-4
N, D, C = 6, 16, 10


def _data(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    emb = (rng.normal(size=(N, D)) * scale).astype(np.float32)
    w = rng.normal(size=(C, D)).astype(np.float32)
    label = rng.integers(0, C, N).astype(np.int32)
    return emb, w, label


def _both(fn_name, *args, **kw):
    """(JAX result, port result) of the margin function `fn_name`."""
    j = getattr(jmargins, fn_name)(*(jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args), **kw)
    p = getattr(pmargins, fn_name)(*(t(a) if isinstance(a, np.ndarray)
                                     else a for a in args), **kw)
    return j, p


def _close_tree(p, j, tol=TOL, what=""):
    if isinstance(p, (tuple, list)):
        assert len(p) == len(j)
        for i, (a, b) in enumerate(zip(p, j)):
            _close_tree(a, b, tol, f"{what}[{i}]")
    else:
        close(p, np.asarray(j), tol, what)


# --------------------------------------------------------------- margins --

@pytest.mark.parametrize("case", ["add", "sphere", "adaface", "mag_easy",
                                  "mag_hard", "mag_loss_g"])
def test_margin_math_matches_jax(case):
    emb, w, label = _data(scale=20.0 if case.startswith("mag") else 1.0)
    if case == "add":
        j, p = _both("add_margin_logits", emb, w, label, 30.0, 0.4)
    elif case == "sphere":
        j, p = _both("sphere_margin_logits", emb, w, label, 7, 4)
        _close_tree(p[1], j[1], 1e-6, "iteration + 1")
        j, p = j[0], p[0]
    elif case == "adaface":
        norms = np.linalg.norm(emb, axis=1, keepdims=True).astype(np.float32)
        unit = (emb / norms).astype(np.float32)
        j, p = _both("adaface_logits", unit, w.T.copy(), norms, label,
                     np.float32(20.0), np.float32(100.0), t_alpha=0.01)
        _close_tree(p[1:], j[1:], 1e-6, "EMA statistics")
        j, p = j[0], p[0]
    elif case.startswith("mag"):
        fn = dict(l_margin=0.45, u_margin=0.8, l_a=10.0, u_a=110.0)
        j = jmargins.mag_margin_logits(
            jnp.asarray(emb), jnp.asarray(w.T), jmargins.linear_margin_fn(
                **fn), easy_margin=case == "mag_easy")
        p = pmargins.mag_margin_logits(
            t(emb), t(w.T.copy()), pmargins.linear_margin_fn(**fn),
            easy_margin=case == "mag_easy")
        if case == "mag_loss_g":
            j, p = _both("mag_loss_g", np.asarray(j[1]), 110.0)
    else:
        raise AssertionError(case)
    _close_tree(p, j, TOL, case)


def _bridge_margin(port, variables):
    v = to_numpy(variables)
    port.load_state_dict(state_dict_from_jax(
        v["params"], module=port, margin_stats=v.get("margin_stats")))
    return port


@pytest.mark.parametrize("head", ["AddMarginProduct", "SphereProduct",
                                  "AdaFaceHead", "MagLinear"])
def test_margin_heads_match_jax(head):
    """Each head on the JAX init; the stateful ones twice, their state
    carried by both sides (JAX's margin_stats, the port's buffers)."""
    emb, _, label = _data(1, 20.0 if head == "MagLinear" else 1.0)
    norms = np.linalg.norm(emb, axis=1, keepdims=True).astype(np.float32)
    args = {"AdaFaceHead": (emb / norms, norms, label),
            "MagLinear": (emb,)}.get(head, (emb, label))
    jmod = {"AddMarginProduct": lambda: JM.AddMarginProduct(D, C),
            "SphereProduct": lambda: JM.SphereProduct(D, C),
            "AdaFaceHead": lambda: JM.AdaFaceHead(D, C, t_alpha=0.5),
            "MagLinear": lambda: JM.MagLinear(D, C)}[head]()
    pmod = {"AddMarginProduct": lambda: PM.AddMarginProduct(D, C),
            "SphereProduct": lambda: PM.SphereProduct(D, C),
            "AdaFaceHead": lambda: PM.AdaFaceHead(D, C, t_alpha=0.5),
            "MagLinear": lambda: PM.MagLinear(D, C)}[head]()
    jargs = [jnp.asarray(a) for a in args]
    variables = jmod.init(jax.random.PRNGKey(0), *jargs)
    _bridge_margin(pmod, variables)
    for step in range(2):
        if "margin_stats" in variables:
            j_out, upd = jmod.apply(variables, *jargs,
                                    mutable=["margin_stats"])
            variables = {**variables, **upd}
        else:
            j_out = jmod.apply(variables, *jargs)
        p_out = pmod(*(t(a) for a in args))
        _close_tree(p_out, j_out, TOL, f"{head} step {step}")
    for name, want in to_numpy(variables.get("margin_stats", {})).items():
        close(getattr(pmod, name), want, 1e-6, name)


def test_magface_softmax_builder_and_loss_match_jax():
    """SoftmaxBuilder (iresnet18 features + MagLinear) in eval mode and
    mag_loss."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    target = np.array([3, 7], np.int32)
    jmod = jmag.SoftmaxBuilder(last_fc_size=C)
    variables = randomize_stats(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    pmod = bridge(pmag.SoftmaxBuilder(last_fc_size=C), variables)
    (j_pair, j_norm) = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        p_pair, p_norm = pmod(t(x).permute(0, 3, 1, 2))
    _close_tree(p_pair, j_pair, TOL, "logit pair")
    close(p_norm, np.asarray(j_norm), TOL, "x_norm")
    j_loss = jmag.mag_loss(j_pair, jnp.asarray(target), j_norm)
    p_loss = pmag.mag_loss(p_pair, t(target), p_norm)
    _close_tree(p_loss, j_loss, TOL, "mag_loss")


def _tree_of_shapes(module, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize("arch", ["iresnet18", "iresnet34", "iresnet50",
                                  "iresnet100", "iresnet200"])
def test_iresnet_depths_carry_the_jax_trees(arch):
    """network_builder at every depth of the JAX package's table: the JAX
    tree (shapes only, no compute) loads strictly into the port's."""
    tree = _tree_of_shapes(jmag.network_builder(arch),
                           jnp.zeros((1, 112, 112, 3)))
    net = pmag.network_builder(arch)
    net.load_state_dict(state_dict_from_jax(tree["params"],
                                            tree["batch_stats"], module=net))
    n_blocks = sum(1 for k in tree["params"] if k.startswith("layer"))
    assert n_blocks == sum(PM.iresnet.IRESNET_LAYERS[arch])
    with pytest.raises(ValueError, match="not one of"):
        pmag.network_builder("iresnet99")


def test_iresnet34_reference_file_converts_and_runs_like_jax():
    """The reference's iresnet34 layout through both converters (equal
    trees), then one forward of the port's and the JAX package's iresnet34
    on it, against the torch oracle too."""
    from test_convert import TorchIResNet18, _randomize_bn_stats
    layers = PM.iresnet.IRESNET_LAYERS["iresnet34"]
    torch.manual_seed(5)
    oracle = TorchIResNet18()
    oracle.inplanes = 64
    for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), 1):
        setattr(oracle, f"layer{i}", oracle._make_layer(planes, n))
    _randomize_bn_stats(oracle.eval(), np.random.default_rng(5))
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    jt, pt = jconv.convert_iresnet(sd, layers), pconv.convert_iresnet(
        sd, layers)
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    pl = jax.tree_util.tree_flatten_with_path(pt)[0]
    assert [k for k, _ in jl] == [k for k, _ in pl]
    for (k, a), (_, b) in zip(jl, pl):
        np.testing.assert_array_equal(b, a, err_msg=str(k))
    x = np.random.default_rng(5).uniform(-1, 1, (1, 112, 112, 3)).astype(
        np.float32)
    net = PM.iresnet34()
    net.load_state_dict(state_dict_from_jax(pt["params"], pt["batch_stats"],
                                            module=net))
    with torch.no_grad():
        p_g, p_l = net.eval()(t(x).permute(0, 3, 1, 2))
        o_g, o_l = oracle(t(x).permute(0, 3, 1, 2))
    j_g, j_l = jax.jit(JM.iresnet34().apply)(jt, jnp.asarray(x))
    close(p_g, np.asarray(j_g), TOL, "global")
    close(p_l.permute(0, 2, 3, 1), np.asarray(j_l), TOL, "local")
    close(p_g, o_g.numpy(), TOL, "global against the torch oracle")


# ------------------------------------------------------------ AdaFace heads --

@pytest.mark.parametrize("head", ["GNAP", "GDC"])
@pytest.mark.parametrize("train", [False, True])
def test_gnap_and_gdc_match_jax(head, train):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 7, 7, 32)).astype(np.float32)
    jmod = jirnet.GNAP() if head == "GNAP" else jirnet.GDC(embedding_size=24)
    pmod = (pirnet.GNAP(32) if head == "GNAP"
            else pirnet.GDC(32, embedding_size=24))
    variables = randomize_stats(jmod.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    v = to_numpy(variables)       # GNAP has statistics and no parameters
    pmod.load_state_dict(state_dict_from_jax(
        v.get("params", {}), v["batch_stats"], module=pmod))
    pmod.train(train)
    if train:
        j_out, upd = jmod.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    else:
        j_out = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        p_out = pmod(t(x).permute(0, 3, 1, 2))
    close(p_out, np.asarray(j_out), TOL, head)
    if train:
        want = state_dict_from_jax(v.get("params", {}),
                                   to_numpy(upd["batch_stats"]), module=pmod)
        for k, v in pmod.state_dict().items():
            if "running_" in k:
                close(v, want[k].numpy(), TOL, k)


@pytest.mark.parametrize("name", ["ir_34", "ir_se_50", "ir_152"])
def test_build_model_names_carry_the_jax_trees(name):
    """build_model's names at the depths and modes the iR-18 tests leave
    (basic blocks, SE, bottlenecks): the JAX tree loads strictly."""
    jnet = jirnet.build_model(name)
    tree = _tree_of_shapes(jnet, jnp.zeros((1, 112, 112, 3)))
    pnet = pirnet.build_model(name)
    pnet.load_state_dict(state_dict_from_jax(tree["params"],
                                             tree["batch_stats"],
                                             module=pnet))


# ------------------------------------------------------- attention layers --

def _seq(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("layer", ["ScaledDotProductAttention",
                                   "DotProductAttention",
                                   "MultiHeadAttention",
                                   "TorchMultiheadAttention"])
def test_attention_layers_match_jax(layer):
    q, k, v = _seq(4, (2, 5, 32), (2, 7, 32), (2, 7, 32))
    mask = np.zeros((2, 5, 7), bool)
    mask[1, :, 5:] = True
    if layer == "ScaledDotProductAttention":
        jmod, pmod = JM.ScaledDotProductAttention(32), \
            PM.ScaledDotProductAttention(32)
        args = (q, k, v, mask)
    elif layer == "DotProductAttention":
        jmod, pmod = JM.DotProductAttention(), PM.DotProductAttention()
        args = (q, v)
    elif layer == "MultiHeadAttention":
        jmod = JM.MultiHeadAttention(d_model=32, num_heads=4)
        pmod = PM.MultiHeadAttention(d_model=32, num_heads=4)
        args = (q, k, v, mask)
    else:
        jmod = JM.TorchMultiheadAttention(32, 4)
        pmod = PM.TorchMultiheadAttention(32, 4)
        args = (q, k, v)
    variables = jmod.init(jax.random.PRNGKey(0),
                          *(jnp.asarray(a) for a in args))
    if variables:
        bridge(pmod, variables)
    j_out = jmod.apply(variables, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        p_out = pmod(*(t(a) for a in args))
    _close_tree(p_out, j_out, TOL, layer)


@pytest.mark.parametrize("module", ["ParagraphLevelCFA", "ConcatAttention"])
def test_cfa_modules_match_jax(module):
    img, sent = _seq(5, (3, 512), (3, 256))
    jmod, pmod = getattr(JM, module)(), getattr(PM, module)()
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(img),
                          jnp.asarray(sent))
    bridge(pmod, variables)
    j_out = jmod.apply(variables, jnp.asarray(img), jnp.asarray(sent))
    with torch.no_grad():
        p_out = pmod(t(img), t(sent))
    assert p_out.shape == j_out.shape
    close(p_out, np.asarray(j_out), TOL, module)


def test_spatial_and_channel_attention_match_jax():
    img, ctx = _seq(6, (2, 4, 4, 16), (2, 5, 24))
    mask = np.zeros((2, 5), bool)
    mask[1, 3:] = True
    js, ps = JM.SpatialAttention(16), PM.SpatialAttention(16, 24)
    sv = js.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(ctx),
                 jnp.asarray(mask))
    bridge(ps, sv)
    j_w, j_a = js.apply(sv, jnp.asarray(img), jnp.asarray(ctx),
                        jnp.asarray(mask))
    with torch.no_grad():
        p_w, p_a = ps(t(img).permute(0, 3, 1, 2), t(ctx), t(mask))
    close(p_w, np.asarray(j_w), TOL, "spatial weighted context")
    close(p_a.permute(0, 2, 3, 1), np.asarray(j_a), TOL, "spatial attn")

    jc, pc = JM.ChannelAttention(16), PM.ChannelAttention(16, 24, 4, 4)
    cv = jc.init(jax.random.PRNGKey(1), j_w, jnp.asarray(ctx), 4, 4)
    bridge(pc, cv)
    j_wc, j_ac = jc.apply(cv, j_w, jnp.asarray(ctx), 4, 4)
    with torch.no_grad():
        p_wc, p_ac = pc(p_w, t(ctx))
    close(p_wc.permute(0, 2, 3, 1), np.asarray(j_wc), TOL,
          "channel weighted")
    close(p_ac, np.asarray(j_ac), TOL, "channel attn")
