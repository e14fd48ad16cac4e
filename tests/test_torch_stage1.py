"""The stage-1 trainer as a whole (engine/stage1.py) against the JAX
package's: one training step (loss, every metric, every gradient, the
parameters and BN statistics after the step) with Adam moments in f32 and
in bf16, and a 3-step loss trajectory, from the JAX init bridged into the
port.

Small sizes: the tiny post-LN BERT of _torch_port.py (2 layers, H 128,
heads 64 wide, I 256) with T = 12, batch 4, 16 classes, the full
ImageHeading and the 14 x 14 x 256 local map. f32 compute. Both trainers
run the flagship switches (fused_block both, fused_ln, use_pallas) with
fused_dropout, so every dropout site takes host bits: JAX its Pallas
kernels in interpret mode with the plan's bits, the port its kernels'
plain versions (prng mode: tests/test_torch_prng_train.py). The batch carries
precomputed backbone features (img_gl, img_lc), so the frozen backbone
(already held against JAX in the serving tests) is skipped on both sides.
Dropout is on (rate 0.1): the JAX loss function runs eagerly, a recording
`_DropPlan` captures its concrete bits, and the port takes the same bits.

Tolerances (each stated where it is checked): loss and metrics rtol 1e-5
(f32, summation order); gradients |g_p - g_j| <= 1e-4 max |g_j| + 1e-6 G
per parameter, G the largest gradient element of the model (the second
term holds gradients that are zero in exact arithmetic, like the query bias
of IMIM's softmax over queries, to their rounding noise); parameters after
the step: 1e-6 (+ 1e-6 relative) for the BN statistics, plus lr times the
gradient tolerance for the SGD group, and for every Adam element whose effective gradient (the encoder's weight decay
added) is clearly signed (above 1e-4 of its parameter's largest and 1e-6
G); the other Adam elements within 2 lr (Adam's first step moves an
element by lr g / (|g| + eps), at most lr, whatever the sign of a
noise-level gradient); the 3-step trajectory's total loss rtol 1e-5 per
step.
"""

import copy
import os

import numpy as np
import optax
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.engine import optim as joptim
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.engine import stage1 as jstage1
from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig, check_stage1)
from text_guided_face_recognition_tpu_torch.engine import optim as poptim
from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    prune_checkpoints)
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer as PTrainer)

from text_guided_face_recognition_tpu_torch.models import irnet as pirnet
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb

from _torch_port import (TINY, close, to_numpy, write_cfg,
                         write_reference_backbone)
from _torch_port import tiny_arch  # noqa: F401  (fixture)

B, T, CLASSES = 4, 12, 16
LR = {"head": 1e-3, "encoder": 2e-5, "cls": 0.1}


def _cfg(**kw):
    base = dict(en_type="BERT", synthetic=True, batch_size=B, num_workers=2,
                compute_dtype="float32", bert_type="tiny",
                captions_per_image=2, manual_seed=0, num_classes=CLASSES,
                bert_words_num=T, checkpoints_path="", fused_block="both",
                fused_ln=True, use_pallas=True,
                adam_moments_dtype="float32", lr_head=LR["head"],
                min_lr_bert=LR["encoder"])
    base.update(kw)
    return (JConfig().replace(**base, fused_dropout=True, num_devices=1),
            PConfig().replace(**base, fused_dropout=True))


def _batch():
    rng = np.random.default_rng(0)
    caps = rng.integers(1000, 30000, (B, T)).astype(np.int32)
    caps[:, 0] = 101
    mask = np.ones((B, T), np.int32)
    mask[1, 9:] = 0
    mask[2, 6:] = 0
    cls = np.array([0, 3, 3, 7], np.int32)      # a shared class: -inf pairs
    gl = rng.normal(size=(B, 512)).astype(np.float32)
    lc = rng.normal(size=(B, 14, 14, 256)).astype(np.float32)   # NHWC
    jb = dict(caps=jnp.asarray(caps), mask=jnp.asarray(mask),
              cls_id=jnp.asarray(cls), img_gl=jnp.asarray(gl),
              img_lc=jnp.asarray(lc))
    pb = dict(caps=torch.from_numpy(caps), mask=torch.from_numpy(mask),
              cls_id=torch.from_numpy(cls), img_gl=torch.from_numpy(gl),
              img_lc=torch.from_numpy(np.ascontiguousarray(
                  lc.transpose(0, 3, 1, 2))))
    return jb, pb


class _Twins:
    """A JAX Stage1Trainer (its backbone stubbed, the batches carrying
    backbone features, unless `cfg` names a backbone) and a port
    Stage1Trainer holding the JAX init."""

    def __init__(self, monkeypatch, **cfg):
        jargs, pargs = _cfg(**cfg)
        if "model_type" not in cfg:
            monkeypatch.setattr(jprep, "prepare_backbone",
                                lambda args: jprep.Bundle(None, {}))
        self.bits = []
        rec = self.bits

        class Recording(jtb._DropPlan):
            def __init__(self, bits, rate):
                super().__init__(bits, rate)
                rec.append(np.asarray(bits))

        monkeypatch.setattr(jtb, "_DropPlan", Recording)
        self.j = jstage1.Stage1Trainer(jargs)
        self.p = PTrainer(pargs, torch.device("cpu"))
        self.p.model.load_state_dict(self.sd(self.j.state.params,
                                             self.j.state.batch_stats))
        self.loss_fn = self.j.build_loss_fn()

    def sd(self, params, stats):
        """JAX trees -> the port model's state_dict layout."""
        return state_dict_from_jax(to_numpy(params), to_numpy(stats),
                                   module=self.p.model)

    def jax_grads(self, state, batch, seed, frozen=None):
        """Eager JAX loss and gradients; records the step's bits. `frozen`:
        the backbone's variables, for batches of images."""
        (loss, (stats, metrics)), grads = jax.value_and_grad(
            self.loss_fn, has_aux=True)(state.params, state.batch_stats,
                                        batch, frozen or {},
                                        jax.random.PRNGKey(seed))
        return float(loss), {"image_head": stats}, metrics, grads

    def port_bits(self):
        return torch.from_numpy(self.bits[-1].view(np.int32).copy())

    def jax_tx(self, moments_dtype):
        """The JAX optimizer with this test's learning rates: (jitted
        update, initial state). Jitting the update leaves the values as
        they are and saves its op-by-op compiles."""
        tx = joptim.make_stage1_bert_tx(self.j.args.replace(
            adam_moments_dtype=moments_dtype))
        opt_state = jax.jit(tx.init)(self.j.state.params)
        for group, lr in LR.items():
            opt_state = joptim.set_lr(opt_state, group, lr)

        @jax.jit
        def update(grads, opt_state, params):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        return update, opt_state


def _check_grads(port_model, gsd):
    named = dict(port_model.named_parameters())
    big = max(float(np.abs(gsd[n].numpy()).max()) for n in named)
    for name, p in named.items():
        g_j = gsd[name].numpy()
        err = np.abs(p.grad.numpy() - g_j).max()
        assert err <= 1e-4 * np.abs(g_j).max() + 1e-6 * big, (name, err)


def _check_params_after(pmodel, new_sd, old_sd, gsd):
    """Parameters after one step (module docstring): the SGD group and
    every element whose effective gradient (+ the encoder's weight decay)
    is clearly signed within 1e-6; the other Adam elements within 2 lr."""
    got = pmodel.state_dict()
    big = max(float(np.abs(gsd[n].numpy()).max())
              for n, _ in pmodel.named_parameters())
    for name, want in new_sd.items():
        w, g = want.numpy(), got[name].numpy()
        err = np.abs(g - w)
        tight = 1e-6 + 1e-6 * np.abs(w)
        group = poptim.GROUPS[name.split(".")[0]]
        if "running_" in name:                       # BN statistics
            assert (err <= tight).all(), (name, err.max())
            continue
        old = old_sd[name].numpy()
        if group == "cls":      # SGD: lr times the gradients' tolerance
            gmax = np.abs(gsd[name].numpy()).max()
            assert (err <= tight + LR[group] * (1e-4 * gmax + 1e-6 * big)
                    ).all(), (name, err.max())
            continue
        geff = gsd[name].numpy() + (0.01 * old if group == "encoder" else 0)
        signed = np.abs(geff) > max(1e-4 * np.abs(geff).max(), 1e-6 * big)
        assert (err[signed] <= tight[signed]).all(), (name, err.max())
        assert (err[~signed] <= 2.0 * LR[group] + 1e-6).all(), name


def test_stage1_step_and_trajectory_match_jax(tiny_arch, monkeypatch):
    tw = _Twins(monkeypatch)
    jb, pb = _batch()
    state = tw.j.state
    old_sd = {k: v.clone() for k, v in tw.p.model.state_dict().items()}

    # --- step 1: loss, metrics, gradients
    loss_j, stats_j, metrics_j, grads_j = tw.jax_grads(state, jb, 0)
    assert tw.bits and tw.bits[-1].shape == (
        jtb._DropPlan.total_elems(jtb.TEXT_ARCHS["tiny"], B, T),)
    loss_p, metrics_p = tw.p.compute_grads(pb, tw.port_bits())
    np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
    assert set(metrics_p) == set(metrics_j)
    for k, v in metrics_p.items():
        np.testing.assert_allclose(float(v), float(metrics_j[k]), rtol=1e-5,
                                   err_msg=k)
    gsd = tw.sd(grads_j, stats_j)
    _check_grads(tw.p.model, gsd)
    grads_p = {n: p.grad.clone() for n, p in tw.p.model.named_parameters()}
    stats_p = {k: v.clone() for k, v in tw.p.model.state_dict().items()
               if "running_" in k}

    # --- the update, with Adam moments in f32 and then in bf16
    for md in ("float32", "bfloat16"):
        update, opt_state = tw.jax_tx(md)
        new_sd = tw.sd(update(grads_j, opt_state, state.params)[0], stats_j)

        tw.p.model.load_state_dict({**old_sd, **stats_p})
        opt = poptim.make_stage1_bert_tx(
            tw.p.args.replace(adam_moments_dtype=md),
            {n: getattr(tw.p.model, n) for n in poptim.GROUPS})
        for group, lr in LR.items():
            opt.set_lr(group, lr)
        for n, p in tw.p.model.named_parameters():
            p.grad = grads_p[n].clone()
        opt.step()
        _check_params_after(tw.p.model, new_sd, old_sd, gsd)

    # --- a 3-step loss trajectory (bf16 moments, the default), each side
    # from the same init on its own trajectory, the same bits per step;
    # step 0 is the step above
    tw.p.model.load_state_dict(old_sd)
    tw.p.opt = poptim.make_stage1_bert_tx(
        tw.p.args.replace(adam_moments_dtype="bfloat16"),
        {n: getattr(tw.p.model, n) for n in poptim.GROUPS})
    tw.p._apply_lrs()
    update, opt_state = tw.jax_tx("bfloat16")
    params = state.params
    for step in range(3):
        if step:
            loss_j, stats_j, _, grads_j = tw.jax_grads(
                state.replace(params=params, batch_stats=stats_j), jb, step)
        params, opt_state = update(grads_j, opt_state, params)
        metrics_p = tw.p.train_step(pb, tw.port_bits())
        np.testing.assert_allclose(float(metrics_p["total_loss"]), loss_j,
                                   rtol=1e-5, err_msg=f"step {step}")


def test_stage1_step_with_adaface_matches_jax(tiny_arch, monkeypatch,
                                             tmp_path):
    """One step with model_type adaface: both trainers load the same
    reference Lightning checkpoint. The frozen ir_18's features against
    JAX's at 1e-4 (global and local). The port's batch then carries uint8
    images (the BGR flip on the device), so its backbone runs inside the
    step; the JAX batch carries the port's own features, so both heads see
    the same input: the loss and metrics at rtol 1e-5, every gradient as
    above (k = 1e-6).

    On this backbone's local map (a channel whose mean is 20 of its
    deviations) the batch-statistics BN's E[x^2] - E[x]^2 moves IMIM's
    bottleneck pre-activations by rounding, and a few of them lie that
    close to 0: the two sides may take the other side of a ReLU kink, a
    choice the gradient does not define. So the JAX step takes the port's
    ReLU masks for those two convs (its forward moves by less than the
    rounding that flipped them); no other leaf changes."""
    path = tmp_path / "adaface_ir18.ckpt"
    write_reference_backbone(path, "adaface", 5)
    tw = _Twins(monkeypatch, model_type="adaface", weights_adaface=str(path),
                uint8_images=True)
    assert isinstance(tw.p.backbone, pirnet.IRBackbone)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (B, 112, 112, 3)).astype(np.uint8)
    j_gl, j_lc = tw.j._image_forward(tw.j.backbone.variables,
                                     jnp.asarray(img))
    p_gl, p_lc = tw.p.image_features(torch.from_numpy(img))
    close(p_gl, j_gl, 1e-4, "global")
    close(p_lc.permute(0, 2, 3, 1), j_lc, 1e-4, "local")
    jb, pb = _batch()
    del pb["img_gl"], pb["img_lc"]
    pb["img"] = torch.from_numpy(img)
    jb["img_gl"] = jnp.asarray(p_gl.numpy())
    jb["img_lc"] = jnp.asarray(p_lc.permute(0, 2, 3, 1).numpy())

    # the port's masks, from its image head's train-mode forward on the
    # same features, in a copy (the step's BN updates its statistics)
    head = copy.deepcopy(tw.p.model.image_head)
    masks = {}                            # NHWC shape -> the port's mask

    def keep_mask(_module, _inputs, out):
        m = (out > 0).permute(0, 2, 3, 1).numpy()
        masks[m.shape] = jnp.asarray(m)

    for conv in (head.imim.conv1x1_1, head.imim.conv1x1_2):
        conv.register_forward_hook(keep_mask)
    with torch.no_grad():
        head(p_gl, p_lc)
    assert len(masks) == 2
    used = []
    relu = flax.linen.relu

    def port_masked_relu(x):
        if x.shape not in masks:
            return relu(x)
        used.append(x.shape)
        return jnp.where(masks[x.shape], x, 0.0)

    with monkeypatch.context() as m:
        m.setattr(flax.linen, "relu", port_masked_relu)
        loss_j, _, metrics_j, grads_j = tw.jax_grads(tw.j.state, jb, 0)
    assert sorted(used) == sorted(masks)
    loss_p, metrics_p = tw.p.compute_grads(pb, tw.port_bits())
    np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
    assert set(metrics_p) == set(metrics_j)
    for k, v in metrics_p.items():
        np.testing.assert_allclose(float(v), float(metrics_j[k]), rtol=1e-5,
                                   err_msg=k)
    _check_grads(tw.p.model, tw.sd(grads_j, tw.j.state.batch_stats))


@pytest.mark.parametrize("change", [
    dict(is_CMP=True), dict(is_WRA=True),
    dict(frozen_feature_cache=True), dict(num_devices=2)])
def test_stage1_refuses_unported_options(change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_stage1(PConfig().replace(**change))


@pytest.fixture
def small_train_cli(monkeypatch, tmp_path):
    """The training CLI at a small size on the CPU: the tiny arch under the
    name "bert", a one-block-per-stage backbone, checkpoints under tmp."""
    monkeypatch.setitem(ptb.TEXT_ARCHS, "bert", ptb.TextArch(**TINY))
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    monkeypatch.chdir(tmp_path)
    return ["--synthetic", "--batch_size", "4", "--compute_dtype", "float32",
            "--fused_block", "both", "--fused_ln", "--use_pallas",
            "--checkpoints_path", str(tmp_path / "ckpt")]


def test_train_cli_runs_on_cpu_saves_and_resumes(small_train_cli):
    """Three epochs of one step: the reference's LR schedule (head x0.98 per
    epoch, cls /10 at epoch 3), the three artifacts per epoch, pruning, and
    a resume that restores the model, the optimizer and the LRs."""
    from text_guided_face_recognition_tpu_torch.cli import (
        train_encoders_bert as cli)
    tr = cli.main(["--cpu"] + small_train_cli + ["--max_steps", "1",
                                                 "--max_epoch", "3"])
    assert tr.steps == 3 and tr.device.type == "cpu"
    np.testing.assert_allclose(tr.lr["head"], 1e-3 * 0.98 ** 3, rtol=1e-12)
    np.testing.assert_allclose(tr.lr["cls"], 0.01, rtol=1e-12)
    assert tr.opt.get_lr("cls") == tr.lr["cls"]
    assert tr.opt.get_lr("encoder") == tr.lr["encoder"] == 2e-5
    save_dir = tr.save_dir()
    names = {f"{a}_{e}" for e in (1, 2, 3) for a in (
        "arcface_image_encoder", "bert_text_encoder", "train_state")}
    assert set(os.listdir(save_dir)) == names

    args = tr.args.replace(resume_model_path=f"{save_dir}/train_state_3",
                           resume_epoch=3)
    back = PTrainer(args, torch.device("cpu"))
    back.main()                        # resumes at epoch 4 > max_epoch: no step
    assert back.start_epoch == 4 and back.steps == 0 and back.lr == tr.lr
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(back.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    assert back.opt.get_lr("head") == tr.opt.get_lr("head")
    state = back.opt.state_dict()["head"]["state"]
    want = tr.opt.state_dict()["head"]["state"]
    assert state.keys() == want.keys() and all(
        torch.equal(state[i]["exp_avg"], want[i]["exp_avg"]) for i in state)
    # the resumed Adam moments keep their storage dtype (bf16 here)
    assert all(state[i][k].dtype == want[i][k].dtype == torch.bfloat16
               for i in state for k in ("exp_avg", "exp_avg_sq"))

    prune_checkpoints(save_dir, 1)
    assert set(os.listdir(save_dir)) == {n for n in names if n.endswith("_3")}


@pytest.mark.parametrize("model_type", ["adaface", "magface"])
def test_train_cli_other_backbones_on_cpu(small_train_cli, tmp_path, capsys,
                                          model_type):
    """One stage-1 step through the CLI with the AdaFace and MagFace
    backbones, each from its reference file at the config's path."""
    from text_guided_face_recognition_tpu_torch.cli import (
        train_encoders_bert as cli)
    rel = {"adaface": "weights/pretrained/adaface_ir18_webface4m.ckpt",
           "magface": "weights/pretrained/magface_iresnet18_casia_dp.pth"}
    write_reference_backbone(tmp_path / rel[model_type], model_type, 6)
    tr = cli.main(["--cpu"] + small_train_cli + [
        "--cfg", write_cfg(tmp_path, "train_bert.yml", model_type=model_type),
        "--max_steps", "1", "--max_epoch", "1"])
    assert f"loading pretrained {model_type} backbone" in capsys.readouterr(
        ).out
    assert tr.steps == 1
    assert f"{model_type}_image_encoder_1" in os.listdir(tr.save_dir())


def test_train_cli_without_cpu_needs_cuda(small_train_cli, monkeypatch):
    from text_guided_face_recognition_tpu_torch.cli import (
        train_encoders_bert as cli)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(small_train_cli + ["--max_steps", "1", "--max_epoch", "1"])


@pytest.mark.parametrize("change,tol", [
    (dict(apply_grad_clip=True, clip_max_norm=0.05), 1e-6),
    (dict(grads_dtype="bfloat16", adam_moments_dtype="bfloat16"), 1e-6),
    (dict(grads_dtype="bfloat16"), 1e-2 * 2 ** -6),
    (dict(compat_frozen_text=True), 1e-6)])
def test_stage1_optimizer_options_match_jax(change, tol):
    """Two updates of the three groups against the JAX optimizer with the
    encoder clip, bf16 gradients (cast as the JAX train step casts them)
    with bf16 or f32 moments, or the frozen text encoder. Tolerance 1e-6 on
    the f32 values, but lr 2^-6 with bf16 gradients and f32 moments: there
    optax.scale_by_adam forms (1 - b1) g and (1 - b2) g^2 in bf16 before
    its f32 moments, where the port forms them in f32, and an element's
    update (at most lr) moves by a few bf16 steps (ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(0)
    shapes = {"image_head": {"kernel": (6, 4)}, "text_head": {"bias": (5,)},
              "text_encoder": {"kernel": (8, 3), "bias": (3,)},
              "image_cls": {"weight": (7, 4)}, "text_cls": {"weight": (7, 4)}}
    params, grads = ({g: {k: rng.normal(size=s).astype(np.float32)
                          for k, s in d.items()} for g, d in shapes.items()}
                     for _ in range(2))
    lrs = {"head": 1e-2, "encoder": 1e-2, "cls": 0.1}
    base = dict(adam_moments_dtype="float32")
    base.update(change)

    jargs = JConfig().replace(**base)
    tx = joptim.make_stage1_bert_tx(jargs)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    for group, lr in lrs.items():
        opt_state = joptim.set_lr(opt_state, group, lr)
    jgrads = joptim.cast_grads(jax.tree_util.tree_map(jnp.asarray, grads),
                               jargs.grads_dtype)
    for _ in range(2):       # the second step reads the stored moments
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    want = to_numpy(jparams)

    modules = {g: torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in d.items()}) for g, d in params.items()}
    opt = poptim.make_stage1_bert_tx(PConfig().replace(**base), modules)
    for group, lr in lrs.items():
        opt.set_lr(group, lr)
    for g, mod in modules.items():
        for k, p in mod.items():
            p.grad = torch.from_numpy(grads[g][k].copy())
    opt.step()
    opt.step()
    for g, mod in modules.items():
        for k, p in mod.items():
            np.testing.assert_allclose(p.detach().numpy(), want[g][k],
                                       rtol=1e-6, atol=tol, err_msg=f"{g}.{k}")
    if change.get("compat_frozen_text"):
        np.testing.assert_array_equal(
            modules["text_encoder"]["kernel"].detach().numpy(),
            params["text_encoder"]["kernel"])
