"""Every text arch of `bert_type` through the port against the JAX package:
the encoder and its head, train-mode gradients, each `fused_block` mode,
the HF converters and factories, the tokenizer, one stage-1 and one
stage-2 step, run_test, the CLIs and two gloo ranks.

Small archs, registered under the real names on both sides (`small_archs`)
so that the converters, factories, tokenizer and CLIs dispatch on them as
on the full ones: one per style, 2 layers each.
  clip      pre-LN, causal, quick-GELU, no embedding LayerNorm, final_ln,
            eps 1e-5; heads 32 wide; the real 49408-row token table
  groupvit  the same layout at hidden 32 (heads 16 wide)
  falva     pre-LN over BERT's embeddings (type_emb, emb_ln), final_ln
  blip      post-LN with heads 96 wide and no token-type embeddings
None of them takes the block kernels: a `fused_block` other than none runs
the unfused tower with the JAX package's warning. JAX runs its
FusedLayerNorm in Pallas interpret mode; the port's wrappers their plain
versions. Inputs come from numpy seeds.

Tolerances (rtol = atol unless stated): f32 1e-4 for modules and
embeddings, 1e-5 for pair scores, bf16 2e-2 (tests/test_torch_ops.py);
gradients |g_p - g_j| <= 1e-4 max |g_j| + 1e-6 G per parameter, G the
model's largest gradient element (tests/test_torch_stage1.py); loss and
metrics rtol 1e-5; the HF modules' last_hidden_state 1e-4.
"""

import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu import models as JM
from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.data import tokenizers as jtok
from text_guided_face_recognition_tpu.engine import convert as jconv
from text_guided_face_recognition_tpu.engine import evaluate as jev
from text_guided_face_recognition_tpu.engine import optim as joptim
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.engine import stage1 as jstage1
from text_guided_face_recognition_tpu.engine import stage2 as jstage2
from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu_torch import config as pconfig
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig)
from text_guided_face_recognition_tpu_torch.data import tokenizers as ptok
from text_guided_face_recognition_tpu_torch.engine import convert as pconv
from text_guided_face_recognition_tpu_torch.engine import evaluate as pev
from text_guided_face_recognition_tpu_torch.engine import optim as poptim
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer)
from text_guided_face_recognition_tpu_torch.engine.stage2 import (
    FusionTrainer)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb

from _torch_port import bridge, close, ragged_mask, randomize_stats, t
from _torch_port import to_numpy

# the HF models are built with torch alone: transformers imports no
# TensorFlow for them (seconds a worker)
os.environ.setdefault("USE_TF", "0")

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "clip": dict(vocab_size=49408, hidden=64, layers=2, heads=2,
                 intermediate=128, max_positions=77, style="preln",
                 causal=True, act="quick_gelu", type_vocab=0, dropout=0.0,
                 emb_ln=False, final_ln=True, ln_eps=1e-5),
    "groupvit": dict(vocab_size=49408, hidden=32, layers=2, heads=2,
                     intermediate=64, max_positions=77, style="preln",
                     causal=True, act="quick_gelu", type_vocab=0,
                     dropout=0.0, emb_ln=False, final_ln=True, ln_eps=1e-5),
    "falva": dict(vocab_size=30522, hidden=64, layers=2, heads=4,
                  intermediate=128, max_positions=64, style="preln",
                  dropout=0.0, final_ln=True),
    "blip": dict(vocab_size=30524, hidden=192, layers=2, heads=2,
                 intermediate=256, max_positions=64, type_vocab=0,
                 dropout=0.0),
}
STYLES = ["clip", "falva", "blip"]          # one arch per layout
B, T = 3, 10
FALLBACK = "falling back to the unfused path"


@pytest.fixture
def small_archs(monkeypatch):
    """The small archs under the real bert_type names, on both sides."""
    for name, kw in SMALL.items():
        monkeypatch.setitem(jtb.TEXT_ARCHS, name, jtb.TextArch(**kw))
        monkeypatch.setitem(ptb.TEXT_ARCHS, name, ptb.TextArch(**kw))
    return SMALL


def _captions(b=B, tt=T, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 30000, (b, tt)).astype(np.int32)
    ids[:, 0] = 101
    return ids, ragged_mask(b, tt, seed)


def _jax_encoder(arch, dtype=jnp.float32, **kw):
    ids, mask = _captions()
    enc = JM.TextEncoder(bert_type=arch, dtype=dtype, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        v = JM.TextEncoder(bert_type=arch).init(
            jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    return enc, v


# ----------------------------------------------------------- the towers --

# fused_ln off runs in test_fused_block_runs_the_unfused_tower_as_jax
@pytest.mark.parametrize("dtype,fused_ln", [
    ("float32", True), ("bfloat16", True)])
@pytest.mark.parametrize("arch", STYLES)
def test_encoder_and_heading_match_jax(small_archs, arch, dtype, fused_ln):
    ids, mask = _captions()
    tol = 1e-4 if dtype == "float32" else 2e-2
    j_enc, v = _jax_encoder(arch, getattr(jnp, dtype), fused_ln=fused_ln)
    j_w, j_s = j_enc.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    j_head = JM.TextHeading(feat_dim=32, dtype=getattr(jnp, dtype))
    hv = j_head.init(jax.random.PRNGKey(1), j_w)
    j_hw, j_hs = j_head.apply(hv, j_w)
    p_enc = bridge(PM.TextEncoder(arch, getattr(torch, dtype), fused_ln),
                   v)
    p_head = bridge(PM.TextHeading(SMALL[arch]["hidden"], 32,
                                   getattr(torch, dtype)), hv)
    with torch.no_grad():
        p_w, p_s = p_enc(t(ids), t(mask))
        p_hw, p_hs = p_head(p_w)
    assert p_w.dtype == getattr(torch, dtype)
    assert p_w.shape == (B, T - 1, SMALL[arch]["hidden"])
    close(p_w, j_w, tol, "words_emb")
    close(p_s, j_s, tol, "sent_emb")
    close(p_hw, j_hw, tol, "head words")
    close(p_hs, j_hs, tol, "head sent")


def _grad_check(got: dict, want: dict) -> None:
    big = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        assert err <= 1e-4 * np.abs(w).max() + 1e-6 * big, (name, err)


@pytest.mark.parametrize("arch", STYLES)
def test_train_mode_gradients_match_jax(small_archs, arch):
    """Gradients of every parameter of the train-mode tower (fused_ln: the
    LayerNorm backward's plain version against JAX's interpret kernel) of
    one scalar of both outputs."""
    ids, mask = _captions()
    rng = np.random.default_rng(1)
    h = SMALL[arch]["hidden"]
    rw = rng.normal(size=(B, T - 1, h)).astype(np.float32)
    rs = rng.normal(size=(B, h)).astype(np.float32)
    j_enc, v = _jax_encoder(arch, fused_ln=True)

    def loss(params):
        w, s = j_enc.apply({"params": params}, jnp.asarray(ids),
                           jnp.asarray(mask), deterministic=False)
        return jnp.sum(w * rw) + jnp.sum(s * rs)

    jg = jax.jit(jax.grad(loss))(v["params"])
    p_enc = bridge(PM.TextEncoder(arch, fused_ln=True), v).train()
    p_w, p_s = p_enc(t(ids), t(mask))
    ((p_w * t(rw)).sum() + (p_s * t(rs)).sum()).backward()
    want = {k: x.numpy() for k, x in state_dict_from_jax(
        to_numpy(jg), module=p_enc).items()}
    _grad_check({n: p.grad.numpy() for n, p in p_enc.named_parameters()},
                want)


@pytest.mark.parametrize("mode", ["ffn", "attn", "both", "tower"])
@pytest.mark.parametrize("arch", ["clip", "falva"])
def test_fused_block_runs_the_unfused_tower_as_jax(small_archs, arch, mode):
    """The pre-LN archs under every fused_block: the JAX package's warning,
    the unfused tower in effect, the JAX package's output."""
    ids, mask = _captions()
    with pytest.warns(UserWarning, match=FALLBACK):
        p_enc = PM.TextEncoder(arch, fused_block=mode)
    assert p_enc.fused_block_effective == "none"
    assert p_enc.model.fused_block == mode
    assert p_enc.drop_counts(B, T) == (0, 0)
    j_enc, v = _jax_encoder(arch, fused_block=mode)
    with pytest.warns(UserWarning, match=FALLBACK):
        j_w, j_s = j_enc.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    bridge(p_enc, v)
    with torch.no_grad():
        p_w, p_s = p_enc(t(ids), t(mask))
    close(p_w, j_w, 1e-4, "words_emb")
    close(p_s, j_s, 1e-4, "sent_emb")


def test_captions_past_the_position_table_are_refused(small_archs):
    """The JAX package reads NaN rows past `max_positions` (77 for clip);
    the port refuses at the configuration check, before any step, and the
    tower refuses a longer input."""
    cfg = PConfig().replace(bert_type="clip", fused_block="both",
                            bert_words_num=77)
    pconfig.check_stage1(cfg)
    pconfig.check_serving(cfg)
    for check in (pconfig.check_stage1, pconfig.check_stage2,
                  pconfig.check_serving):
        with pytest.raises(ValueError, match="has 77 positions"):
            check(cfg.replace(bert_words_num=78, fusion_type="fcfm"))
    ids, mask = _captions(1, 78)
    with pytest.warns(UserWarning, match=FALLBACK):
        enc = PM.TextEncoder("clip", fused_block="both")
    with pytest.raises(ValueError, match="77 positions"):
        enc(t(ids), t(mask))
    j_enc, v = _jax_encoder("clip")
    j_w, _ = j_enc.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    assert np.isnan(np.asarray(j_w)[:, 76:]).all()


def test_bridge_carries_each_archs_tree_and_refuses_another(small_archs):
    """engine/from_jax.py on every arch's JAX tree: final_ln where the arch
    has it, no emb_ln or type_emb where it has none; a tree with a leaf
    missing, or another arch's tree, is refused."""
    trees = {}
    for arch in SMALL:
        _, v = _jax_encoder(arch)
        trees[arch] = to_numpy(v["params"])
        enc = PM.TextEncoder(arch)
        sd = state_dict_from_jax(trees[arch], module=enc)
        a = SMALL[arch]
        assert ("model.final_ln.weight" in sd) == a.get("final_ln", False)
        assert ("model.emb_ln.weight" in sd) == a.get("emb_ln", True)
        assert ("model.type_emb.weight" in sd) == bool(a.get("type_vocab",
                                                             2))
    clip = trees["clip"]
    no_final = {"model": {k: v for k, v in clip["model"].items()
                          if k != "final_ln"}}
    with pytest.raises(KeyError, match="final_ln"):
        state_dict_from_jax(no_final, module=PM.TextEncoder("clip"))
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax(trees["falva"], module=PM.TextEncoder("clip"))
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax(clip, module=PM.TextEncoder("groupvit"))


# ------------------------------------------------------ weights, tokens --

def _hf_model(arch: str, seed: int):
    """A small HF text model of `arch`'s layout, built offline, with its
    LayerNorm affines off their init."""
    import transformers as tf
    a = SMALL[arch]
    torch.manual_seed(seed)
    common = dict(vocab_size=a["vocab_size"], hidden_size=a["hidden"],
                  num_hidden_layers=a["layers"],
                  num_attention_heads=a["heads"],
                  intermediate_size=a["intermediate"],
                  max_position_embeddings=a["max_positions"])
    if arch == "falva":
        model = tf.FlavaTextModel(tf.FlavaTextConfig(
            **common, hidden_act="gelu", layer_norm_eps=1e-12,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    else:
        cls = {"clip": (tf.CLIPTextModel, tf.CLIPTextConfig),
               "groupvit": (tf.GroupViTTextModel, tf.GroupViTTextConfig)}
        model_cls, cfg_cls = cls[arch]
        model = model_cls(cfg_cls(**common, hidden_act="quick_gelu",
                                  layer_norm_eps=1e-5, attention_dropout=0.0,
                                  dropout=0.0))
    model.eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name.lower():
                p.add_(0.1 * torch.randn_like(p))
    return model


def _cfgs(**kw):
    base = dict(en_type="BERT", synthetic=True, batch_size=8, num_workers=2,
                compute_dtype="float32", fusion_type="fcfm",
                fusion_final_dim=640, captions_per_image=2, manual_seed=0,
                is_ident=False, is_roc=False, checkpoints_path="",
                num_classes=16, aux_feat_dim_per_granularity=256)
    base.update(kw)
    return (JConfig().replace(**base, num_devices=1),
            PConfig().replace(**base))


@pytest.mark.parametrize("arch", ["clip", "groupvit", "falva"])
def test_hf_text_model_loads_like_jax_and_hf(small_archs, tmp_path, arch):
    """A raw HF state_dict: the port's converter gives the JAX converter's
    tree leaf for leaf; through the factories both encoders agree, and the
    port's hidden states are the HF module's own last_hidden_state."""
    pytest.importorskip("transformers")
    hf = _hf_model(arch, 3)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    jt, pt = jconv.convert_hf_text_model(sd, arch), \
        pconv.convert_hf_text_model(sd, arch)
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    pl = jax.tree_util.tree_flatten_with_path(pt)[0]
    assert [k for k, _ in jl] == [k for k, _ in pl]
    for (k, a), (_, b) in zip(jl, pl):
        np.testing.assert_array_equal(b, a, err_msg=str(k))
    path = str(tmp_path / f"{arch}.pth")
    torch.save(hf.state_dict(), path)
    jargs, pargs = _cfgs(bert_type=arch, text_encoder_path=path,
                         bert_words_num=12)
    jte, _ = jprep.prepare_text_encoder(jargs)
    with pytest.warns(UserWarning, match="raw HF text model"):
        pte, pth = pprep.prepare_text_encoder(pargs, CPU)
    assert pth.bwm.conv_k2.weight.shape[1] == 2 * SMALL[arch]["hidden"]
    ids, mask = _captions(2, 12, seed=3)
    j_w, j_s = jte.module.apply(jte.variables, jnp.asarray(ids),
                                jnp.asarray(mask))
    with torch.no_grad():
        p_w, p_s = pte(t(ids), t(mask))
        ref = hf(t(ids).long(), attention_mask=t(mask).long()
                 ).last_hidden_state.numpy()
    close(p_w, j_w, 1e-4, "words")
    close(p_s, j_s, 1e-4, "sent")
    hidden = torch.cat([p_s[:, None], p_w], dim=1).numpy()
    n = int(mask[1].sum())
    np.testing.assert_allclose(hidden[0], ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hidden[1, :n], ref[1, :n], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["clip", "falva"])
def test_text_bundle_and_port_artifact_load_like_jax(small_archs, tmp_path,
                                                      arch):
    """The reference's {'model', 'head'} bundle of an HF text model of
    `arch` (under 'model.'), then the port's own artifact written from it;
    a file of another arch's layout is refused naming both layouts."""
    hf = _hf_model(arch, 4)
    gen = torch.Generator().manual_seed(4)
    h = SMALL[arch]["hidden"]
    head = {}
    for i, k in enumerate((2, 3, 4)):
        head[f"bwm.convs1.{i}.weight"] = 0.05 * torch.randn(
            256, 1, k, h, generator=gen)
        head[f"bwm.convs1.{i}.bias"] = 0.1 * torch.randn(256, generator=gen)
    bundle = {"model": {"model." + k: v for k, v in hf.state_dict().items()},
              "head": head}
    path = str(tmp_path / f"{arch}_text_encoder_1")
    torch.save(bundle, path)
    jargs, pargs = _cfgs(bert_type=arch, text_encoder_path=path,
                         bert_words_num=12)
    jte, jth = jprep.prepare_text_encoder(jargs)
    pte, pth = pprep.prepare_text_encoder(pargs, CPU)
    ids, mask = _captions(3, 12, seed=4)
    j_w, j_s = jte.module.apply(jte.variables, jnp.asarray(ids),
                                jnp.asarray(mask))
    jw2, js2 = jth.module.apply(jth.variables, j_w)
    with torch.no_grad():
        p_w, p_s = pte(t(ids), t(mask))
        pw2, ps2 = pth(p_w)
    close(p_w, j_w, 1e-4, "words")
    close(p_s, j_s, 1e-4, "sent")
    close(pw2, jw2, 1e-4, "head words")
    close(ps2, js2, 1e-4, "head sent")

    own = str(tmp_path / "own")
    torch.save({"model": pte.state_dict(), "head": pth.state_dict()}, own)
    back, _ = pprep.prepare_text_encoder(pargs.replace(text_encoder_path=own),
                                         CPU)
    for k, v in pte.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)

    other = "groupvit" if arch == "falva" else "falva"
    with pytest.raises(ValueError, match="neither layout"):
        pprep.prepare_text_encoder(pargs.replace(bert_type=other), CPU)


@pytest.mark.parametrize("arch", ["clip", "groupvit"])
def test_tokenizer_ids_match_jax(tmp_path, arch):
    """The hash fallback (no corpus) and a WordPiece vocabulary on disk give
    the JAX package's ids, inside clip's 49408-row table."""
    caps = ["a smiling man with glasses", "She has long blond hair and "
            "wears heavy makeup; her eyebrows are arched."]
    kw = dict(bert_type=arch, data_dir=str(tmp_path / "none"),
              bert_words_num=77)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        j = jtok.get_bert_tokenizer(JConfig().replace(**kw, num_devices=1))
    with pytest.warns(UserWarning, match="HashTokenizer"):
        p = ptok.get_bert_tokenizer(PConfig().replace(**kw))
    assert j.cache_tag == p.cache_tag == "-hash"
    wp_dir = tmp_path / "wp"
    wp_dir.mkdir()
    (wp_dir / "wordpiece_vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "man", "with",
         "she", "has", "long", "hair", "and", "her", "are", "smil", "##ing",
         "glass", "##es", "eye", "##brow", "##s", ";", "."]) + "\n")
    kw["data_dir"] = str(wp_dir)
    with pytest.warns(UserWarning, match="WordPiece"):
        jw = jtok.get_bert_tokenizer(JConfig().replace(**kw, num_devices=1))
    with pytest.warns(UserWarning, match="WordPiece"):
        pw = ptok.get_bert_tokenizer(PConfig().replace(**kw))
    assert jw.cache_tag == pw.cache_tag == "-wordpiece"
    for jf, pf in ((j, p), (jw, pw)):
        for cap in caps:
            for a, b in zip(jf(cap, 77), pf(cap, 77)):
                np.testing.assert_array_equal(b, a)
            ids, mask = pf(cap, 77)
            assert ids.max() < 49408 and mask.sum() > 2


# ------------------------------------------------------- the two stages --

def _stage_batch(hidden_lc=256, b=4, tt=12):
    rng = np.random.default_rng(0)
    caps = rng.integers(1000, 30000, (b, tt)).astype(np.int32)
    caps[:, 0] = 101
    mask = np.ones((b, tt), np.int32)
    mask[1, 9:] = 0
    mask[2, 6:] = 0
    cls = np.array([0, 3, 3, 7], np.int32)[:b]
    gl = rng.normal(size=(b, 512)).astype(np.float32)
    lc = rng.normal(size=(b, 14, 14, hidden_lc)).astype(np.float32)
    np_b = dict(caps=caps, mask=mask, cls_id=cls, img_gl=gl, img_lc=lc)
    jb = {k: jnp.asarray(v) for k, v in np_b.items()}
    pb = {k: torch.from_numpy(v) for k, v in np_b.items()}
    pb["img_lc"] = torch.from_numpy(np.ascontiguousarray(
        lc.transpose(0, 3, 1, 2)))
    return np_b, jb, pb


def _stage_cfg(stage: int, arch: str, **kw):
    base = dict(en_type="BERT", synthetic=True, batch_size=4, num_workers=2,
                compute_dtype="float32", bert_type=arch, captions_per_image=2,
                manual_seed=0, num_classes=16, bert_words_num=12,
                checkpoints_path="", fused_block="both", fused_ln=True,
                adam_moments_dtype="float32")
    if stage == 1:
        base.update(use_pallas=True, lr_head=1e-3, min_lr_bert=2e-5)
    else:
        base.update(fusion_type="fcfm", loss="focal_loss",
                    text_encoder_path="", image_encoder_path="",
                    lr_head=1e-3, lr_image_train=0.01, weight_decay=5e-4)
    base.update(kw)
    return (JConfig().replace(**base, num_devices=1),
            PConfig().replace(**base))


def _twins(stage, arch, monkeypatch, **kw):
    """The JAX trainer (its backbone stubbed: the batches carry backbone
    features) and the port's, holding the JAX init; both warn that the arch
    runs unfused under fused_block both."""
    jargs, pargs = _stage_cfg(stage, arch, **kw)
    monkeypatch.setattr(jprep, "prepare_backbone",
                        lambda args: jprep.Bundle(None, {}))
    jcls, pcls = ((jstage1.Stage1Trainer, Stage1Trainer) if stage == 1
                  else (jstage2.FusionTrainer, FusionTrainer))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jcls(jargs)
    with pytest.warns(UserWarning, match=FALLBACK):
        p = pcls(pargs, CPU)
    assert p.model.text_encoder.fused_block_effective == "none"
    p.model.load_state_dict(state_dict_from_jax(
        to_numpy(j.state.params), to_numpy(j.state.batch_stats),
        module=p.model))
    return j, p


def _jax_loss_and_grads(j, jb):
    """Loss, the BatchNorm statistics after the step as a whole tree,
    metrics and gradients of the JAX trainer's loss, jitted."""
    loss_fn = j.build_loss_fn()

    def f(params, stats):
        return jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, jb, {}, jax.random.PRNGKey(0))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (loss, (stats, metrics)), grads = jax.jit(f)(j.state.params,
                                                     j.state.batch_stats)
    if isinstance(j, jstage1.Stage1Trainer):    # the image head's alone
        stats = {"image_head": stats}
    return float(loss), stats, metrics, grads


def _check_step(j, p, jb, pb):
    loss_j, stats_j, metrics_j, grads_j = _jax_loss_and_grads(j, jb)
    assert p.model.text_encoder.drop_counts(4, 12) == (0, 0)
    loss_p, metrics_p = p.compute_grads(pb)
    np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
    if isinstance(metrics_j, dict):
        for k, v in metrics_p.items():
            np.testing.assert_allclose(float(v), float(metrics_j[k]),
                                       rtol=1e-5, err_msg=k)
    gsd = state_dict_from_jax(to_numpy(grads_j), to_numpy(stats_j),
                              module=p.model)
    _grad_check({n: (p_.grad if p_.grad is not None
                     else torch.zeros_like(p_)).numpy()
                 for n, p_ in p.model.named_parameters()},
                {n: gsd[n].numpy() for n, _ in p.model.named_parameters()})
    return grads_j, stats_j, gsd


@pytest.mark.parametrize("arch", STYLES)
def test_stage1_step_matches_jax(small_archs, monkeypatch, arch):
    """Loss, metrics and every gradient of one stage-1 step (fused_block
    both in effect as none, fused_ln, use_pallas: K9's plain version); for
    clip with lazy_embedding_adam, the parameters after the three groups'
    update, the 49408-row token table's row-sparse one included."""
    lazy = arch == "clip"
    j, p = _twins(1, arch, monkeypatch, lazy_embedding_adam=lazy)
    _, jb, pb = _stage_batch()
    grads_j, stats_j, gsd = _check_step(j, p, jb, pb)
    if not lazy:
        return
    assert p.model.text_encoder.model.tok_emb.weight.shape[0] == 49408
    tx = joptim.make_stage1_bert_tx(j.args)
    lrs = {"head": 1e-3, "encoder": 2e-5, "cls": 0.1}
    opt_state = jax.jit(tx.init)(j.state.params)
    for group, lr in lrs.items():
        opt_state = joptim.set_lr(opt_state, group, lr)

    @jax.jit
    def update(grads, opt_state, params):
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates)

    new = state_dict_from_jax(
        to_numpy(update(grads_j, opt_state, j.state.params)),
        to_numpy(stats_j), module=p.model)
    old = {k: v.clone() for k, v in p.model.state_dict().items()}
    opt = poptim.make_stage1_bert_tx(
        p.args, {n: getattr(p.model, n) for n in poptim.GROUPS})
    assert poptim.lazy_rows(p.args) > 0
    for group, lr in lrs.items():
        opt.set_lr(group, lr)
    opt.step()
    got = p.model.state_dict()
    big = max(float(np.abs(gsd[n].numpy()).max())
              for n, _ in p.model.named_parameters())
    for name, want in new.items():
        if "running_" in name:
            continue
        group = poptim.GROUPS[name.split(".")[0]]
        err = np.abs(got[name].numpy() - want.numpy())
        g = gsd[name].numpy() + (0.01 * old[name].numpy()
                                 if group == "encoder" else 0)
        if group == "cls":
            bound = 1e-6 + lrs[group] * (1e-4 * np.abs(g).max() + 1e-6 * big)
            assert (err <= bound).all(), name
            continue
        # Adam: a clearly signed gradient gives the same step; a noise-level
        # one moves an element by at most lr either way
        signed = np.abs(g) > max(1e-4 * np.abs(g).max(), 1e-6 * big)
        assert (err[signed] <= 1e-6 + 1e-6 * np.abs(want.numpy()[signed])
                ).all(), name
        assert (err[~signed] <= 2.0 * lrs[group] + 1e-6).all(), name


@pytest.mark.parametrize("arch", STYLES)
def test_stage2_step_matches_jax(small_archs, monkeypatch, arch):
    """Loss and every gradient of one stage-2 step (FCFM, focal loss)."""
    j, p = _twins(2, arch, monkeypatch)
    _, jb, pb = _stage_batch()
    _check_step(j, p, jb, pb)


# --------------------------------------------------- serving, the CLIs --

def test_run_test_scores_match_jax(small_archs, tmp_path):
    """run_test's pair scores and metrics with a clip encoder (fused_block
    both in effect as none, fused_ln) against the JAX package's."""
    jargs, pargs = _cfgs(bert_type="clip", bert_words_num=16, is_roc=True,
                         fused_block="both", fused_ln=True, test_sub=4)
    jargs = jargs.replace(roc_file=str(tmp_path / "jax"))
    pargs = pargs.replace(roc_file=str(tmp_path / "port"))
    z, key = jnp.zeros, jax.random.PRNGKey
    h = SMALL["clip"]["hidden"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmods = [JM.IResNet(layers=(1, 1, 1, 1)), JM.ImageHeading(),
                 JM.TextEncoder(bert_type="clip", fused_ln=True,
                                fused_block="both"),
                 JM.TextHeading(feat_dim=256), JM.FCFM(channel_dim=36)]
        jv = [randomize_stats(jmods[0].init(key(0), z((1, 112, 112, 3))), 0),
              randomize_stats(jmods[1].init(key(1), z((1, 512)),
                                            z((1, 14, 14, 256))), 1),
              jmods[2].init(key(2), z((1, 16), jnp.int32),
                            jnp.ones((1, 16), jnp.int32)),
              jmods[3].init(key(3), z((1, 15, h))),
              randomize_stats(jmods[4].init(key(4), z((1, 14, 14, 256)),
                                            z((1, 256, 14)), z((1, 256)),
                                            z((1, 256))), 2)]
    with pytest.warns(UserWarning, match=FALLBACK):
        te = PM.TextEncoder("clip", fused_ln=True, fused_block="both")
    ports = [bridge(m, v) for m, v in zip(
        [PM.IResNet(layers=(1, 1, 1, 1)), PM.ImageHeading(), te,
         PM.TextHeading(hidden=h, feat_dim=256), PM.FCFM(channel_dim=36)],
        jv)]
    jdl, jds = jprep.prepare_dataloader(jargs, "test")
    pdl, pds = pprep.prepare_dataloader(pargs, "test")
    for ds in (jds, pds):       # one pair batch keeps the JAX side quick
        ds.imgs_pair, ds.pair_label = ds.imgs_pair[:8], ds.pair_label[:8]
    bundles = [jprep.Bundle(m, v) for m, v in zip(jmods, jv)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_metrics = jev.run_test(jargs, jdl, bundles[0], bundles[1],
                                 bundles[4], bundles[2], bundles[3])
    p_bb, p_ih, p_te, p_th, p_fu = ports
    p_metrics = pev.run_test(pargs, pdl, p_bb, p_ih, p_fu, p_te, p_th)
    scores = {}
    for side in ("jax", "port"):
        with open(tmp_path / f"{side}.npy", "rb") as f:
            scores[side] = (np.load(f), np.load(f))
    np.testing.assert_array_equal(scores["port"][0], scores["jax"][0])
    close(scores["port"][1], scores["jax"][1], 1e-5, "pair scores")
    assert p_metrics == pytest.approx(j_metrics, abs=1e-9)


def test_cli_both_stages_with_bert_type_clip(small_archs, monkeypatch,
                                            tmp_path):
    """`--bert_type clip` on the stage-1 and stage-2 entry points: the
    stage-1 artifacts are named for the arch, and stage 2 loads them."""
    from text_guided_face_recognition_tpu_torch.cli import fusion_bert
    from text_guided_face_recognition_tpu_torch.cli import (
        train_encoders_bert)
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    monkeypatch.chdir(tmp_path)
    common = ["--cpu", "--synthetic", "--bert_type", "clip", "--batch_size",
              "4", "--compute_dtype", "float32", "--fused_block", "both",
              "--fused_ln", "--max_steps", "1", "--max_epoch", "1"]
    with pytest.warns(UserWarning, match=FALLBACK):
        tr = train_encoders_bert.main(common + [
            "--use_pallas", "--checkpoints_path", str(tmp_path / "s1")])
    assert tr.steps == 1 and tr.args.bert_type == "clip"
    assert tr.model.text_encoder.model.arch.causal
    names = os.listdir(tr.save_dir())
    assert "clip_text_encoder_1" in names, names
    d1 = tr.save_dir()
    with pytest.warns(UserWarning, match=FALLBACK):
        fu = fusion_bert.main(common + [
            "--checkpoints_path", str(tmp_path / "s2"),
            "--text_encoder_path", f"{d1}/clip_text_encoder_1",
            "--image_encoder_path", f"{d1}/arcface_image_encoder_1"])
    assert fu.steps == 1 and fu.args.bert_type == "clip"
    for name in ("text_encoder", "text_head", "image_head"):
        want = getattr(tr.model, name).state_dict()
        got = getattr(fu.model, name).state_dict() if fu.steps == 0 else None
        assert got is None or all(torch.equal(got[k], v)
                                  for k, v in want.items())


def test_two_gloo_ranks_take_the_clip_stage1_step_as_jax(small_archs,
                                                        monkeypatch,
                                                        tmp_path):
    """One stage-1 step of the pre-LN clip arch on two gloo ranks
    (tests/_torch_dp_archs.py, through tests/_torch_dp_worker.py's step):
    each rank's gradients, summed over the ranks, and its loss are the
    JAX trainer's on the global batch."""
    j, _ = _twins(1, "clip", monkeypatch)
    np_b, jb, _ = _stage_batch()
    np_b["img_lc"] = np.ascontiguousarray(np_b["img_lc"].transpose(0, 3, 1, 2))
    _, pargs = _stage_cfg(1, "clip")
    cfg = {k: v for k, v in pargs.to_dict().items() if k in (
        "en_type", "synthetic", "batch_size", "num_workers", "compute_dtype",
        "bert_type", "captions_per_image", "manual_seed", "num_classes",
        "bert_words_num", "checkpoints_path", "fused_block", "fused_ln",
        "adam_moments_dtype", "use_pallas", "lr_head", "min_lr_bert")}
    torch.save({"bert_type": "clip", "arch": SMALL["clip"],
                "stage1": dict(cfg=dict(cfg, num_devices=2), batch=np_b,
                               params=to_numpy(j.state.params),
                               stats=to_numpy(j.state.batch_stats))},
               tmp_path / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
        "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_dp_archs.py"),
         str(r), "2", port, str(tmp_path)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        loss_j, stats_j, _, grads_j = _jax_loss_and_grads(j, jb)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "DP_ARCHS_OK" in out, out[-4000:]
    with pytest.warns(UserWarning, match=FALLBACK):
        model = Stage1Trainer(pargs, CPU).model
    gsd = state_dict_from_jax(to_numpy(grads_j), to_numpy(stats_j),
                              module=model)
    names = [n for n, _ in model.named_parameters()]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        np.testing.assert_allclose(got["loss"], loss_j, rtol=1e-5)
        _grad_check({n: got["grads"][n].numpy() for n in names},
                    {n: gsd[n].numpy() for n in names})
