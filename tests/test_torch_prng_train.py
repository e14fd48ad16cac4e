"""The prng-mode training slice as a whole against the JAX trainers: one
stage-1 step (`fused_block: both`) and one stage-2 step (`tower`) with
`fused_dropout: false` in the port, the JAX package's default, where the
fused kernels draw their own dropout bits from seeds.

The JAX trainer's prng mode draws the Mosaic PRNG, which has no CPU
lowering; on the CPU it takes the `_DropPlan` path (`fused_dropout=True`)
instead. So the port's step draws its host bits (the embeddings) and its
kernel seeds, and the JAX step's `_DropPlan` is handed the port's composed
stream (ops/philox.py `compose_drop_bits`): the embeddings' bits and
the dumps of the seeds' streams (ops/philox.py, K10-K12), in the plan's
site order. Everything else is tests/test_torch_stage1.py's and
tests/test_torch_stage2.py's set-up (the tiny arch, the batch, the bridged
JAX init), and so are the tolerances: loss and metrics rtol 1e-5 (f32);
gradients 1e-4 of each parameter's largest element plus 1e-6 G; the
parameters after the step per their `_check_params_after`.
"""

import numpy as np
import torch

import jax.numpy as jnp

from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer)
from text_guided_face_recognition_tpu_torch.engine.stage2 import (
    FusionTrainer)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
from text_guided_face_recognition_tpu_torch.ops import philox

import test_torch_stage1 as s1
import test_torch_stage2 as s2
from _torch_port import tiny_arch  # noqa: F401  (fixture)


def _prng_twins(twins, trainer_cls, monkeypatch, fused_block):
    """The module's JAX/port twins with the port trainer switched to prng
    mode (same weights), the step's dropout drawn by the port, and the JAX
    plan handed the composed stream. Returns (bits, seeds)."""
    tw = twins
    tw.p = trainer_cls(tw.p.args.replace(fused_dropout=False),
                       torch.device("cpu"))
    tw.p.model.load_state_dict(tw.sd(tw.j.state.params,
                                     tw.j.state.batch_stats))
    arch = ptb.TEXT_ARCHS["tiny"]
    bits, seeds = tw.p.draw_drop(s1.B, s1.T)
    assert bits.numel() == s1.B * s1.T * arch.hidden      # embeddings only
    assert seeds.dtype == torch.int32 and seeds.shape == (
        (1,) if fused_block == "tower" else (arch.layers,))
    stream = philox.compose_drop_bits(arch, s1.B, s1.T, fused_block, bits,
                                   seeds).numpy().view(np.uint32)
    plan_cls = s1.jtb._DropPlan

    class Composed(plan_cls):
        def __init__(self, bits_, rate):
            assert bits_.shape == stream.shape
            super().__init__(jnp.asarray(stream), rate)

    monkeypatch.setattr(s1.jtb, "_DropPlan", Composed)
    return bits, seeds


def test_stage1_prng_step_matches_jax(tiny_arch, monkeypatch):
    tw = s1._Twins(monkeypatch)
    bits, seeds = _prng_twins(tw, Stage1Trainer, monkeypatch, "both")
    jb, pb = s1._batch()
    old_sd = {k: v.clone() for k, v in tw.p.model.state_dict().items()}
    loss_j, stats_j, metrics_j, grads_j = tw.jax_grads(tw.j.state, jb, 0)
    loss_p, metrics_p = tw.p.compute_grads(pb, bits, seeds)
    np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
    assert set(metrics_p) == set(metrics_j)
    for k, v in metrics_p.items():
        np.testing.assert_allclose(float(v), float(metrics_j[k]), rtol=1e-5,
                                   err_msg=k)
    gsd = tw.sd(grads_j, stats_j)
    s1._check_grads(tw.p.model, gsd)
    # the update (the configuration's f32 Adam moments)
    update, opt_state = tw.jax_tx("float32")
    new_sd = tw.sd(update(grads_j, opt_state, tw.j.state.params)[0], stats_j)
    tw.p.opt.step()
    s1._check_params_after(tw.p.model, new_sd, old_sd, gsd)


def test_stage2_prng_step_matches_jax(tiny_arch, monkeypatch):
    tw = s2._Twins(monkeypatch, fused_block="tower")
    bits, seeds = _prng_twins(tw, FusionTrainer, monkeypatch, "tower")
    jb, pb = s2._batch()
    params, stats = tw.j.state.params, tw.j.state.batch_stats
    old_sd = {k: v.clone() for k, v in tw.p.model.state_dict().items()}
    loss_j, stats_j, grads_j = tw.jax_grads(params, stats, jb, 0)
    loss_p, metrics_p = tw.p.compute_grads(pb, bits, seeds)
    np.testing.assert_allclose(float(loss_p), loss_j, rtol=1e-5)
    gsd = tw.sd(grads_j, stats_j)
    s2._check_grads(tw.p.model, gsd)
    update, opt_state = tw.jax_tx("float32")
    new_sd = tw.sd(update(grads_j, opt_state, params)[0], stats_j)
    tw.port_opt("float32").step()
    s2._check_params_after(tw.p.model, new_sd, old_sd, gsd)
