"""The stage-2 trainer as a whole (engine/stage2.py) against the JAX
package's `FusionTrainer`: one training step (loss, every gradient, the
parameters and BatchNorm statistics after the step) with Adam moments in
f32 and in bf16, and a 3-step loss trajectory, from the JAX init bridged
into the port, with `fused_block` none and tower.

Small sizes: the tiny post-LN BERT of _torch_port.py (2 layers, H 128,
heads 64 wide, I 256) with T = 12, batch 4, 16 classes, the full
ImageHeading and FCFM on the 14 x 14 x 256 local map. f32 compute. JAX runs
its Pallas tower in interpret mode with the plan's host bits, the port its
kernels' plain versions. The batch carries precomputed backbone features
(img_gl, img_lc), so the frozen backbone (already held against JAX in the
serving tests) is skipped on both sides. Dropout is on (rate 0.1) with
fused_dropout on both sides, so every site takes host bits (prng mode:
tests/test_torch_prng_train.py): the JAX loss function runs eagerly, a
recording `_DropPlan` captures its concrete bits, and the port takes the
same bits.

Tolerances (each stated where it is checked): loss rtol 1e-5 (f32,
summation order); gradients |g_p - g_j| <= 1e-4 max |g_j| + 1e-6 G per
parameter, G the largest gradient element of the model; parameters after
the step: 1e-6 (+ 1e-6 relative) for the BN statistics, plus lr times the
gradient tolerance for metric_fc's plain SGD, and for every Adam element
whose effective gradient (the group's weight decay added) is clearly signed
(above 1e-4 of its parameter's largest and 1e-6 G); the other Adam elements
within 2 lr (Adam's first step moves an element by at most lr, whatever the
sign of a noise-level gradient); the 3-step trajectory's loss rtol 1e-5 at
steps 0 and 1 and 2e-4 at step 2. The third loss is the first to feel
the first update's unsigned elements: Adam moved each by lr whatever the
sign of its noise-level gradient (a bias of FCFM's convolution among them),
so the two sides stand up to 2 lr apart there, and the gradients of step 1
then differ by a few percent in those parameters (7.9e-5 on the loss as
measured, with f32 and with bf16 moments alike).
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.engine import optim as joptim
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.engine import stage2 as jstage2
from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig, check_stage2)
from text_guided_face_recognition_tpu_torch.engine import optim as poptim
from text_guided_face_recognition_tpu_torch.engine.checkpoint import (
    prune_checkpoints)
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer)
from text_guided_face_recognition_tpu_torch.engine.stage2 import (
    FusionTrainer as PTrainer)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb

from _torch_port import TINY, to_numpy
from _torch_port import tiny_arch  # noqa: F401  (fixture)

B, T, CLASSES = 4, 12, 16
# metric_fc's rate is a tenth of the configuration's 0.1: at 0.1 three steps
# on one batch of 4 drive the focal loss to 1e-3, where (1 - p)^2 turns f32
# noise into a relative error of 5e-3
LR = {"cls": 0.01, "encoder": 1e-5, "head": 1e-3}
WD = {"cls": 5e-4, "encoder": 0.01, "head": 5e-5}
TRAJECTORY_RTOL = (1e-5, 1e-5, 2e-4)


def _cfg(**kw):
    base = dict(en_type="BERT", synthetic=True, batch_size=B, num_workers=2,
                compute_dtype="float32", bert_type="tiny",
                captions_per_image=2, manual_seed=0, num_classes=CLASSES,
                bert_words_num=T, checkpoints_path="", fused_block="tower",
                fused_ln=True, adam_moments_dtype="float32",
                lr_head=LR["head"], lr_image_train=LR["cls"],
                weight_decay=WD["cls"], fusion_type="fcfm",
                loss="focal_loss", text_encoder_path="",
                image_encoder_path="")
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
    cls = np.array([0, 3, 3, 7], np.int32)
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
    """A JAX FusionTrainer (its backbone stubbed: the batches carry
    backbone features) and a port FusionTrainer holding the JAX init."""

    def __init__(self, monkeypatch, **kw):
        jargs, pargs = _cfg(**kw)
        monkeypatch.setattr(jprep, "prepare_backbone",
                            lambda args: jprep.Bundle(None, {}))
        self.bits = []
        rec = self.bits

        class Recording(jtb._DropPlan):
            def __init__(self, bits, rate):
                super().__init__(bits, rate)
                rec.append(np.asarray(bits))

        monkeypatch.setattr(jtb, "_DropPlan", Recording)
        self.j = jstage2.FusionTrainer(jargs)
        self.p = PTrainer(pargs, torch.device("cpu"))
        self.p.model.load_state_dict(self.sd(self.j.state.params,
                                             self.j.state.batch_stats))
        self.loss_fn = self.j.build_loss_fn()

    def sd(self, params, stats):
        return state_dict_from_jax(to_numpy(params), to_numpy(stats),
                                   module=self.p.model)

    def jax_grads(self, params, stats, batch, seed):
        (loss, (new_stats, _)), grads = jax.value_and_grad(
            self.loss_fn, has_aux=True)(params, stats, batch, {},
                                        jax.random.PRNGKey(seed))
        return float(loss), new_stats, grads

    def port_bits(self):
        """The step's recorded bits as the port takes them. The JAX
        unfused attention draws its probability bits as (B, heads, T, T);
        the port's modules read every layout as the kernels' (heads, B, T,
        T), so under fused_block none those slices are transposed (which
        element a bit lands on is free; that both sides use the same bit
        for the same element is what the comparison needs)."""
        bits = self.bits[-1].view(np.int32).copy()
        if self.j.args.fused_block == "none":
            a = jtb.TEXT_ARCHS["tiny"]
            n_h, n_p = B * T * a.hidden, B * a.heads * T * T
            for layer in range(a.layers):
                ofs = n_h + layer * (n_p + 2 * n_h)
                bits[ofs:ofs + n_p] = bits[ofs:ofs + n_p].reshape(
                    B, a.heads, T, T).transpose(1, 0, 2, 3).reshape(-1)
        return torch.from_numpy(bits)

    def jax_tx(self, moments_dtype):
        tx = joptim.make_stage2_tx(self.j.args.replace(
            adam_moments_dtype=moments_dtype))
        opt_state = jax.jit(tx.init)(self.j.state.params)
        for group, lr in LR.items():
            opt_state = joptim.set_lr(opt_state, group, lr)

        @jax.jit
        def update(grads, opt_state, params):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        return update, opt_state

    def port_opt(self, moments_dtype):
        opt = poptim.make_stage2_tx(
            self.p.args.replace(adam_moments_dtype=moments_dtype),
            {n: getattr(self.p.model, n) for n in poptim.STAGE2_GROUPS})
        for group, lr in LR.items():
            opt.set_lr(group, lr)
        return opt


def _check_grads(port_model, gsd):
    named = dict(port_model.named_parameters())
    big = max(float(np.abs(gsd[n].numpy()).max()) for n in named)
    for name, p in named.items():
        g_j = gsd[name].numpy()
        # no path to the loss: no gradient here, zeros in the JAX tree
        g_p = np.zeros_like(g_j) if p.grad is None else p.grad.numpy()
        err = np.abs(g_p - g_j).max()
        assert err <= 1e-4 * np.abs(g_j).max() + 1e-6 * big, (name, err)


def _check_params_after(pmodel, new_sd, old_sd, gsd):
    got = pmodel.state_dict()
    big = max(float(np.abs(gsd[n].numpy()).max())
              for n, _ in pmodel.named_parameters())
    for name, want in new_sd.items():
        w, g = want.numpy(), got[name].numpy()
        err = np.abs(g - w)
        tight = 1e-6 + 1e-6 * np.abs(w)
        if "running_" in name:                       # BN statistics
            assert (err <= tight).all(), (name, err.max())
            continue
        group = poptim.STAGE2_GROUPS[name.split(".")[0]]
        if group == "cls":      # SGD: lr times the gradients' tolerance
            gmax = np.abs(gsd[name].numpy()).max()
            assert (err <= tight + LR[group] * (1e-4 * gmax + 1e-6 * big)
                    ).all(), (name, err.max())
            continue
        geff = gsd[name].numpy() + WD[group] * old_sd[name].numpy()
        signed = np.abs(geff) > max(1e-4 * np.abs(geff).max(), 1e-6 * big)
        assert (err[signed] <= tight[signed]).all(), (name, err.max())
        assert (err[~signed] <= 2.0 * LR[group] + 1e-6).all(), name


@pytest.mark.parametrize("fused_block", ["none", "tower"])
def test_stage2_step_and_trajectory_match_jax(tiny_arch, monkeypatch,
                                              fused_block):
    tw = _Twins(monkeypatch, fused_block=fused_block)
    jb, pb = _batch()
    params, stats = tw.j.state.params, tw.j.state.batch_stats
    old_sd = {k: v.clone() for k, v in tw.p.model.state_dict().items()}

    # --- step 1: loss and gradients
    loss_j, stats_j, grads_j = tw.jax_grads(params, stats, jb, 0)
    assert tw.bits and tw.bits[-1].shape == (
        jtb._DropPlan.total_elems(jtb.TEXT_ARCHS["tiny"], B, T),)
    loss_p, metrics_p = tw.p.compute_grads(pb, tw.port_bits())
    np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
    assert set(metrics_p) == {"loss"}
    gsd = tw.sd(grads_j, stats_j)
    _check_grads(tw.p.model, gsd)
    grads_p = {n: p.grad.clone() for n, p in tw.p.model.named_parameters()}
    stats_p = {k: v.clone() for k, v in tw.p.model.state_dict().items()
               if "running_" in k}
    assert any(k.startswith("fusion_net.") for k in stats_p)

    # metric_fc: plain SGD without momentum, its first step is exactly
    # w - lr (g + wd w)
    w0 = old_sd["metric_fc.weight"]
    want_fc = w0 - LR["cls"] * (grads_p["metric_fc.weight"] + WD["cls"] * w0)

    # --- the update, with Adam moments in f32 and then in bf16
    for md in ("float32", "bfloat16"):
        update, opt_state = tw.jax_tx(md)
        new_sd = tw.sd(update(grads_j, opt_state, params)[0], stats_j)
        tw.p.model.load_state_dict({**old_sd, **stats_p})
        opt = tw.port_opt(md)
        for n, p in tw.p.model.named_parameters():
            p.grad = grads_p[n].clone()
        opt.step()
        _check_params_after(tw.p.model, new_sd, old_sd, gsd)
        torch.testing.assert_close(tw.p.model.metric_fc.weight.detach(),
                                   want_fc, rtol=0, atol=1e-7)

    # --- a 3-step loss trajectory (bf16 moments, the default), the same
    # bits per step; step 0 is the step above
    tw.p.model.load_state_dict(old_sd)
    tw.p.opt = tw.port_opt("bfloat16")
    update, opt_state = tw.jax_tx("bfloat16")
    losses = []
    for step in range(3):
        if step:
            loss_j, stats_j, grads_j = tw.jax_grads(params, stats_j, jb, step)
        params, opt_state = update(grads_j, opt_state, params)
        metrics_p = tw.p.train_step(pb, tw.port_bits())
        np.testing.assert_allclose(float(metrics_p["loss"]), loss_j,
                                   rtol=TRAJECTORY_RTOL[step],
                                   err_msg=f"step {step}")
        losses.append(loss_j)
    assert losses[-1] > 0.1, losses      # still a loss worth comparing


def test_stage2_cross_entropy_and_linear_fusion_match_jax(tiny_arch,
                                                          monkeypatch):
    """`loss` other than focal_loss takes the cross entropy; fusion_type
    linear takes LinearFusion(global image feature, sentence feature)."""
    tw = _Twins(monkeypatch, loss="softmax", fusion_type="linear",
                fused_block="none")
    jb, pb = _batch()
    loss_j, stats_j, grads_j = tw.jax_grads(tw.j.state.params,
                                            tw.j.state.batch_stats, jb, 0)
    loss_p, _ = tw.p.compute_grads(pb, tw.port_bits())
    np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
    _check_grads(tw.p.model, tw.sd(grads_j, stats_j))


def _port_trainer(**kw):
    return PTrainer(_cfg(**kw)[1], torch.device("cpu"))


def test_stage2_compat_frozen_text_gives_no_text_gradient(tiny_arch):
    """The reference's no-gradient text path: the tower and the text head
    get no gradient, and the encoder group does not step (no weight decay
    either)."""
    tr = _port_trainer(compat_frozen_text=True, fused_block="tower")
    _, pb = _batch()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train_step(pb)
    for name, p in tr.model.named_parameters():
        top = name.split(".")[0]
        if top in ("text_encoder", "text_head"):
            assert p.grad is None or not p.grad.abs().any(), name
        if top == "text_encoder":
            torch.testing.assert_close(p.detach(), before[name], rtol=0,
                                       atol=0)
    assert not torch.equal(tr.model.metric_fc.weight.detach(),
                           before["metric_fc.weight"])
    assert tr.model.fusion_net.conv.weight.grad.abs().any()


def test_stage2_schedule_epoch_end(tiny_arch):
    """StepLR triplet: encoder x0.8 every 10 epochs, cls x0.6 and head
    x0.97 every 5."""
    tr = _port_trainer(lr_image_train=0.1)
    assert tr.lr == {"cls": 0.1, "encoder": 1e-5, "head": 1e-3}
    for epoch in range(1, 11):
        tr.schedule_epoch_end(epoch)
        if epoch == 4:
            assert tr.lr == {"cls": 0.1, "encoder": 1e-5, "head": 1e-3}
        if epoch == 5:
            np.testing.assert_allclose(
                [tr.lr["cls"], tr.lr["encoder"], tr.lr["head"]],
                [0.06, 1e-5, 0.97e-3], rtol=1e-12)
    np.testing.assert_allclose(
        [tr.lr["cls"], tr.lr["encoder"], tr.lr["head"]],
        [0.1 * 0.36, 0.8e-5, 1e-3 * 0.97 ** 2], rtol=1e-12)
    assert tr.opt.get_lr("cls") == tr.lr["cls"]
    assert tr.opt.get_lr("encoder") == tr.lr["encoder"]
    assert tr.opt.get_lr("head") == tr.lr["head"]


@pytest.mark.parametrize("change", [dict(num_devices=2)])
def test_stage2_refuses_unported_options(change):
    """num_devices above the world size (one process here) is refused before
    any step: launch that many ranks with torchrun."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        check_stage2(PConfig().replace(**change))


def test_stage2_refuses_concat():
    with pytest.raises(ValueError, match="linear|fcfm"):
        check_stage2(PConfig().replace(fusion_type="concat"))


def test_stage2_optimizer_needs_every_module():
    with pytest.raises(ValueError, match="metric_fc"):
        poptim.make_stage2_tx(PConfig(), {
            n: torch.nn.Linear(2, 2) for n in poptim.STAGE2_GROUPS
            if n != "metric_fc"})


@pytest.fixture
def small_cli(monkeypatch, tmp_path):
    """The CLIs at a small size on the CPU: the tiny arch under the name
    "bert", a one-block-per-stage backbone, checkpoints under tmp."""
    monkeypatch.setitem(ptb.TEXT_ARCHS, "bert", ptb.TextArch(**TINY))
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
    monkeypatch.chdir(tmp_path)
    return ["--synthetic", "--batch_size", "4", "--compute_dtype", "float32",
            "--fused_block", "tower", "--fused_ln",
            "--checkpoints_path", str(tmp_path / "ckpt")]


def test_fusion_cli_runs_on_cpu_saves_resumes_and_prunes(small_cli):
    from text_guided_face_recognition_tpu_torch.cli import fusion_bert as cli
    tr = cli.main(["--cpu"] + small_cli + ["--max_steps", "2", "--max_epoch",
                                           "2"])
    assert tr.steps == 4 and tr.device.type == "cpu"
    save_dir = tr.save_dir()
    assert save_dir.endswith(os.path.join("Fusion", "BERT_arcface", "fcfm"))
    names = {f"{a}_{e}" for e in (1, 2) for a in (
        "fusion_fcfm_arcface", "encoder_BERT_fcfm", "train_state")}
    assert set(os.listdir(save_dir)) == names

    back = cli.main(["--cpu"] + small_cli + [
        "--max_steps", "2", "--max_epoch", "2", "--resume_epoch", "2",
        "--resume_model_path", f"{save_dir}/train_state_2"])
    assert back.start_epoch == 3 and back.steps == 0 and back.lr == tr.lr
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(back.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    state = back.opt.state_dict()["head"]["state"]
    want = tr.opt.state_dict()["head"]["state"]
    assert state.keys() == want.keys() and all(
        torch.equal(state[i]["exp_avg"], want[i]["exp_avg"]) for i in state)

    # the stage-2 artifacts serve: the eval factories load them back
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    args = tr.args.replace(
        fusion_net_path=f"{save_dir}/fusion_fcfm_arcface_2",
        image_encoder_path=f"{save_dir}/fusion_fcfm_arcface_2",
        text_encoder_path=f"{save_dir}/encoder_BERT_fcfm_2")
    cpu = torch.device("cpu")
    net = prep.prepare_fusion_net(args, cpu)
    enc, head = prep.prepare_text_encoder(args, cpu)
    ih = prep.prepare_image_head(args, cpu)
    for got, want in ((net, tr.model.fusion_net), (enc, tr.model.text_encoder),
                      (head, tr.model.text_head), (ih, tr.model.image_head)):
        for k, v in want.state_dict().items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)

    prune_checkpoints(save_dir, 1)
    assert set(os.listdir(save_dir)) == {n for n in names if n.endswith("_2")}


def test_fusion_cli_without_cpu_needs_cuda(small_cli, monkeypatch):
    from text_guided_face_recognition_tpu_torch.cli import fusion_bert as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(small_cli + ["--max_steps", "1", "--max_epoch", "1"])


def test_stage1_encoders_load_into_stage2(small_cli, tmp_path):
    """The hand-off: the encoders the stage-1 trainer saves are what the
    stage-2 trainer starts from; a path that is neither such an artifact
    nor a reference file (not even a torch file) is refused."""
    from text_guided_face_recognition_tpu_torch.cli import (
        fusion_bert, train_encoders_bert)
    s1 = train_encoders_bert.main(["--cpu"] + small_cli + [
        "--max_steps", "1", "--max_epoch", "1", "--use_pallas"])
    d1 = s1.save_dir()
    s2 = fusion_bert.main(["--cpu"] + small_cli + [
        "--max_steps", "1", "--max_epoch", "0",
        "--text_encoder_path", f"{d1}/bert_text_encoder_1",
        "--image_encoder_path", f"{d1}/arcface_image_encoder_1"])
    assert isinstance(s1, Stage1Trainer) and s2.steps == 0
    for name in ("text_encoder", "text_head", "image_head"):
        want = getattr(s1.model, name).state_dict()
        for k, v in getattr(s2.model, name).state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    other = tmp_path / "not_a_checkpoint"
    other.write_bytes(b"reference weights")
    with pytest.raises(ValueError, match="not a torch file"):
        fusion_bert.main(["--cpu"] + small_cli + [
            "--max_epoch", "0", "--text_encoder_path", str(other)])
