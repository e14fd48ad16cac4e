"""The stage options the port took last (is_CMP, is_WRA,
frozen_feature_cache) against the JAX package on the CPU.

* The four losses of ops/losses.py (cmpc_loss, cmpm_loss, clip_soft_loss,
  kl_loss) and the WRA loss of ops/wra.py: values and the gradients of
  every input within f32 1e-5 (rtol and atol), WRA over masks with 1, 2
  and all words valid and over tied saliency weights.
* One stage-1 step with is_CMP, with is_WRA and with both, from the JAX
  init bridged into the port, unfused and with the tiny arch's dropout at
  0: loss and every metric rtol 1e-5, every gradient as
  tests/test_torch_stage1.py checks it.
* The frozen-feature cache, each against its JAX twin in
  tests/test_feature_cache.py: peek equals the next __getitem__ and counts
  no visit; caption draws with the cache equal those without it (BERT and
  LSTM, two epochs) and equal JAX's; the refresh equals a direct forward
  (chunks of 24 over the 64 synthetic images: a short last chunk) within
  1e-5; a stage-1 and a stage-2 epoch (max_steps 2) with the cache equal
  the epoch without it and JAX's cached epoch, rtol 2e-5 (the tolerance of
  the JAX package's own cached-epoch check: the backbone at another batch
  size rounds otherwise).

Small sizes: the tiny BERT of _torch_port.py (one layer, dropout 0, in
the step and epoch tests), a one-block-per-stage iresnet on both sides in
the cache tests (its features feed the heads as the full one's do), batch
4, f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu import ops as jops
from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.models import iresnet as jiresnet
from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu.ops import wra as jwra
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch import ops as pops
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig)
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep
from text_guided_face_recognition_tpu_torch.engine.feature_cache import (
    FrozenFeatureCache)
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb

from _torch_port import TINY, to_numpy
from _torch_port import tiny_arch  # noqa: F401  (fixture)
from test_torch_stage1 import _Twins, _batch, _check_grads

CPU = torch.device("cpu")


def _grads_close(fj, fp, inputs, tol=1e-5):
    """fj(jax arrays) and fp(torch tensors) on the same numpy inputs:
    values and every input's gradient within tol (rtol and atol)."""
    jx = [jnp.asarray(x) for x in inputs]
    vj, gj = jax.jit(jax.value_and_grad(fj, argnums=tuple(range(len(jx)))))(
        *jx)
    px = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    vp = fp(*px)
    vp.backward()
    np.testing.assert_allclose(float(vp), float(vj), rtol=tol, atol=tol)
    for i, (a, b) in enumerate(zip(px, gj)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=f"input {i}")


LOSSES = {
    "cmpc": (lambda t, i, w: jops.cmpc_loss(t, i, LABELS, w),
             lambda t, i, w: pops.cmpc_loss(t, i, torch.from_numpy(LABELS),
                                            w), 3),
    "cmpm": (lambda t, i: jops.cmpm_loss(t, i, LABELS),
             lambda t, i: pops.cmpm_loss(t, i, torch.from_numpy(LABELS)), 2),
    "clip_soft": (lambda t, i: jops.clip_soft_loss(t, i, 0.5),
                  lambda t, i: pops.clip_soft_loss(t, i, 0.5), 2),
    "kl": (jops.kl_loss, pops.kl_loss, 2),
}
LABELS = np.array([0, 3, 3, 7, 1, 0], np.int32)   # shared classes


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    fj, fp, n_in = LOSSES[name]
    rng = np.random.default_rng(1)
    inputs = [rng.normal(size=(6, 8)).astype(np.float32)
              for _ in range(min(n_in, 2))]
    if name == "cmpc":
        inputs.append(rng.normal(size=(8, 10)).astype(np.float32))
    if name == "kl":
        inputs[1] *= 0.5                                  # logvar
    _grads_close(fj, fp, inputs)


@pytest.mark.parametrize("case", ["none", "ragged", "valid1", "valid2",
                                  "tied"])
def test_wra_matches_jax(case):
    """WRA's value and its gradients to the words and the regions; the
    saliency takes none on either side."""
    b, t, r, d = 3, 7, 5, 8
    rng = np.random.default_rng(2)
    words = rng.normal(size=(b, t, d)).astype(np.float32)
    regions = rng.normal(size=(b, r, d)).astype(np.float32)
    attn = rng.uniform(0.0, 1.0, (b, t)).astype(np.float32)
    lens = {"none": None, "ragged": [7, 4, 3], "valid1": [1, 1, 5],
            "valid2": [2, 2, 2], "tied": [7, 5, 6]}[case]
    if case == "tied":                  # ties at and around the percentiles
        attn[:, :4] = 0.25
        attn[1, :] = 0.5
    mask = (None if lens is None else
            np.arange(t)[None, :] < np.asarray(lens)[:, None])
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)

    def fj(w, rg):
        return jwra.word_region_alignment_loss(w, rg, jnp.asarray(attn), jm)

    def fp(w, rg):
        return pops.word_region_alignment_loss(w, rg,
                                               torch.from_numpy(attn), pm)

    _grads_close(fj, fp, [words, regions])
    # the percentiles alone, JAX's formula (not torch.quantile)
    from text_guided_face_recognition_tpu_torch.ops.wra import (
        _masked_percentile)
    m = np.ones((b, t), np.float32) if mask is None else mask.astype(
        np.float32)
    for q in (10.0, 90.0):
        np.testing.assert_array_equal(
            _masked_percentile(torch.from_numpy(attn), torch.from_numpy(m),
                               q).numpy(),
            np.asarray(jwra._masked_percentile(jnp.asarray(attn),
                                               jnp.asarray(m), q)))


@pytest.fixture
def tiny0(monkeypatch):
    """The tiny arch at one layer with its dropout rate at 0, as bert_type
    "tiny0" on both sides: a step or an epoch then needs no shared dropout
    bits (and the JAX side compiles faster)."""
    arch = dict(TINY, layers=1, dropout=0.0)
    monkeypatch.setitem(jtb.TEXT_ARCHS, "tiny0", jtb.TextArch(**arch))
    monkeypatch.setitem(ptb.TEXT_ARCHS, "tiny0", ptb.TextArch(**arch))
    return "tiny0"


@pytest.mark.parametrize("change", [
    dict(is_CMP=True), dict(is_WRA=True), dict(is_CMP=True, is_WRA=True)])
def test_stage1_step_with_options_matches_jax(tiny0, monkeypatch, change):
    """One stage-1 step with the option(s) on, unfused and without dropout
    (the fused kernels and the dropout bits are held with these losses
    off in tests/test_torch_stage1.py; WRA and CMP read the heads'
    outputs only): the port's loss, metrics (wra_loss, cmp_loss among
    them) and gradients (cmp.W's too) against JAX's."""
    tw = _Twins(monkeypatch, bert_type=tiny0, fused_block="none",
                fused_ln=False, use_pallas=False, **change)
    jb, pb = _batch()
    (loss_j, (_, metrics_j)), grads_j = jax.jit(jax.value_and_grad(
        tw.loss_fn, has_aux=True))(tw.j.state.params, tw.j.state.batch_stats,
                                   jb, {}, jax.random.PRNGKey(0))
    assert not tw.bits
    loss_p, metrics_p = tw.p.compute_grads(pb)
    for k, on in (("cmp_loss", "is_CMP"), ("wra_loss", "is_WRA")):
        assert (k in metrics_p) == bool(change.get(on))
    assert set(metrics_p) == set(metrics_j)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    for k, v in metrics_p.items():
        np.testing.assert_allclose(float(v), float(metrics_j[k]), rtol=1e-5,
                                   err_msg=k)
    assert (tw.p.model.cmp is not None) == bool(change.get("is_CMP"))
    _check_grads(tw.p.model, tw.sd(grads_j, tw.j.state.batch_stats))


def test_stage1_options_epoch_in_bf16(tiny_arch, monkeypatch):
    """The port alone: one stage-1 epoch of 2 steps in bf16 (64 x 64
    images, an 8 x 8 local map) with is_CMP, is_WRA and the cache, through
    the flagship switches (fused_block both, fused_ln, use_pallas; their
    plain versions here): the bf16 words and local map meet in WRA's
    attention (its operands promoted to their common dtype, as jnp.einsum
    does) and every metric is finite."""
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    _, pa = _args(en_type="BERT", bert_type=tiny_arch, bert_words_num=12,
                  compute_dtype="bfloat16", fused_block="both",
                  fused_ln=True, use_pallas=True, is_CMP=True, is_WRA=True,
                  frozen_feature_cache=True, max_steps=2, img_size=64)
    out = Stage1Trainer(pa, CPU).train_epoch(1)
    assert {"wra_loss", "cmp_loss"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())


# ------------------------------------------------------ the feature cache --

def _args(**kw):
    base = dict(en_type="LSTM", synthetic=True, batch_size=4, num_workers=2,
                max_epoch=1, compute_dtype="float32", num_classes=16,
                lstm_words_num=8, captions_per_image=2, manual_seed=0,
                is_DAMSM=True, is_CLIP=True, is_ident_loss=True,
                checkpoints_path="")
    base.update(kw)
    return JConfig().replace(**base), PConfig().replace(**base)


def _train_ds(args):
    return pprep.prepare_dataloader(args, "train")[1]


def test_peek_matches_getitem_and_keeps_visits():
    ja, pa = _args()
    ds, jds = _train_ds(pa), jprep.prepare_dataloader(ja, "train")[1]
    p1 = ds.peek_augmented_image(3)
    np.testing.assert_array_equal(p1, ds.peek_augmented_image(3))
    np.testing.assert_array_equal(p1, jds.peek_augmented_image(3))
    assert 3 not in ds._visits
    np.testing.assert_array_equal(p1, ds[3]["img"])
    p3 = ds.peek_augmented_image(3)
    assert ds._visits[3] == 0
    np.testing.assert_array_equal(p3, ds[3]["img"])


@pytest.mark.parametrize("en_type", ["LSTM", "BERT"])
def test_cache_mode_caption_draws_identical(en_type, tiny_arch):
    ja, pa = _args(en_type=en_type, bert_type=tiny_arch, bert_words_num=12)
    plain, cached = _train_ds(pa), _train_ds(pa)
    jcached = jprep.prepare_dataloader(ja, "train")[1]
    n = len(cached)
    fake = {"gl": torch.arange(n, dtype=torch.float32)[:, None] * 2.0,
            "lc": torch.arange(n, dtype=torch.bfloat16)[:, None] * 3.0}
    cached.set_feature_cache(fake)
    jcached.set_feature_cache({k: np.asarray(v.float()) for k, v in
                               fake.items()})
    extra = "cap_len" if en_type == "LSTM" else "mask"
    for _epoch in range(2):        # the visit counts advance alike
        for i in range(n):
            ref, got, jgot = plain[i], cached[i], jcached[i]
            assert "img" not in got
            assert torch.equal(got["img_gl"], fake["gl"][i])
            assert torch.equal(got["img_lc"], fake["lc"][i])
            for k in ("caps", extra, "cls_id"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
                np.testing.assert_array_equal(got[k], jgot[k], err_msg=k)


@pytest.fixture(scope="module")
def small_jax_backbone():
    """A one-block-per-stage JAX iresnet at 112 x 112, initialised once
    under jit (its eager init takes seconds)."""
    net = jiresnet.IResNet(layers=(1, 1, 1, 1))
    return jprep.Bundle(net, jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3))))


@pytest.fixture
def small_backbone(monkeypatch, small_jax_backbone):
    """That iresnet as the backbone on both sides."""
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    monkeypatch.setattr(jprep, "prepare_backbone",
                        lambda args: small_jax_backbone)


def test_refresh_matches_direct_forward(small_backbone):
    """The refresh in chunks of 24 over 64 images (a short last chunk; 64 x
    64 images, an 8 x 8 local map) against one forward of all 64 peeked
    images, 1e-5, and the host bytes it holds. (JAX's refresh is held end
    to end by the cached epochs.)"""
    _, pa = _args(feature_cache_batch=24, img_size=64)
    ds = _train_ds(pa)
    backbone = pprep.prepare_backbone(pa, CPU)
    cache = FrozenFeatureCache(backbone, pa, CPU)
    cache.refresh(ds)
    n = len(ds)
    assert ds._feature_cache is not None and cache.gl.shape[0] == n
    assert cache.host_bytes() == n * (512 + 256 * 8 * 8) * 4
    imgs = np.stack([ds.peek_augmented_image(i) for i in range(n)])
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        backbone_features)
    with torch.no_grad():
        gl, lc = backbone_features(backbone, "arcface", torch.from_numpy(imgs))
    torch.testing.assert_close(cache.gl, gl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cache.lc, lc, rtol=1e-5, atol=1e-5)
    assert torch.equal(ds[5]["img_lc"], cache.lc[5])


def _epoch_trainers(stage, arch, **kw):
    """(JAX trainer with the cache, port trainer with it, port trainer
    without it) of one stage, the JAX init bridged into both port ones,
    dropout off (`arch` at rate 0, so a whole epoch needs no shared
    bits)."""
    from text_guided_face_recognition_tpu.engine import stage1 as js1
    from text_guided_face_recognition_tpu.engine import stage2 as js2
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)
    ja, pa = _args(en_type="BERT", bert_type=arch, bert_words_num=12,
                   frozen_feature_cache=True, feature_cache_batch=24,
                   max_steps=2, adam_moments_dtype="float32", **kw)
    jcls, pcls = ((js1.Stage1Trainer, Stage1Trainer) if stage == 1
                  else (js2.FusionTrainer, FusionTrainer))
    j = jcls(ja)
    jv = to_numpy(j.backbone.variables)
    ports = []
    for cached in (True, False):
        p = pcls(pa.replace(frozen_feature_cache=cached), CPU)
        p.model.load_state_dict(state_dict_from_jax(
            to_numpy(j.state.params), to_numpy(j.state.batch_stats),
            module=p.model))
        p.backbone.load_state_dict(state_dict_from_jax(
            jv["params"], jv["batch_stats"], module=p.backbone))
        ports.append(p)
    return (j, *ports)


@pytest.mark.parametrize("stage", [1, 2])
def test_epoch_with_cache_matches(stage, tiny0, small_backbone):
    """One epoch of 2 steps: the port with the cache against the port
    without it and against JAX with it (each from the same init, the same
    batches), every reported metric rtol 2e-5."""
    kw = {} if stage == 1 else dict(fusion_type="linear",
                                    CONFIG_NAME="Fusion", loss="focal_loss")
    j, p, plain = _epoch_trainers(stage, tiny0, **kw)
    got, ref, jgot = p.train_epoch(1), plain.train_epoch(1), j.train_epoch(1)
    assert p.feat_cache is not None and plain.feat_cache is None
    keys = [k for k in got if k.endswith("loss")]
    assert keys and set(keys) <= set(jgot)
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[k], jgot[k], rtol=2e-5, err_msg=k)
