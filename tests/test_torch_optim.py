"""The port's optimizer (engine/optim.py) on its own: against the JAX
package's optimizer, the row-sparse embedding update, and the state across
layouts.

Small modules: a few leaves of repeated shapes per module, a 200 x 200
leaf (above the JAX package's default `stack_max_elems`, so JAX updates it
in a bucket of its own), and in the encoder one 8192-row embedding table
whose gradient touches a few rows a step. Five steps with gradients drawn
from a seed, the learning rates changed after the second.

  * Against the JAX package: `make_stage1_bert_tx` / `make_stage2_tx` with
    `stacked_optimizer` true and false, from the same numpy parameters and
    gradients, the gradients cast as the JAX train step casts them, for
    the stage-1 and stage-2 groups, Adam moments in f32 and bf16,
    gradients rounded to f32 and bf16, the encoder clip on and off
    (stage 1; stage 2 has none) and `lazy_embedding_adam` on.
    Tolerance 1e-6 absolute and relative, as the stage-1 optimizer test
    states it, but with bf16 gradients and f32 moments outside the lazy
    update that test's bound of 2^-6 lr an update, summed over the five
    updates: optax.scale_by_adam forms (1 - b1) g and (1 - b2) g^2 in bf16
    there, the port in f32, and an element's update (at most lr) moves by a
    few bf16 steps. With bf16 moments, or bf16 gradients otherwise (the
    update itself is then rounded to bf16), 2^-7 lr an update, summed: the
    two sides' f32 values may differ in their last bits (XLA orders and
    fuses the f32 operations its own way), so now and then one rounds to a
    bf16 value a step (2^-8 relative) away from the other's, and the
    update moves by that share.
  * `lazy_embedding_adam` against the JAX package's `_scale_by_adam_mixed`
    (the same optimizers with the switch on), and rows with a zero
    gradient keep parameters and both moments bit-unchanged at every step.
  * State: written after two steps and loaded into a fresh optimizer, then
    stepped, it gives the uninterrupted run bit for bit; so does a state in
    the torch.optim layout (a per-parameter int `step`, SGD's state without
    one), as the trainers wrote it before the counts moved to the device.

The `cuda` case holds the captured stage-1 step (engine/trainer.py)
against eager steps on the card and skips without one; the JAX package is
imported inside the tests, so on a card's host without it it runs alone:
  python -m pytest tests/test_torch_optim.py -m cuda --noconftest -q
"""

import copy

import numpy as np
import pytest
import torch

from text_guided_face_recognition_tpu_torch.config import TGFRConfig as PConfig
from text_guided_face_recognition_tpu_torch.engine import optim as poptim

STEPS = 5
LRS = ({"head": 1e-2, "encoder": 1e-2, "cls": 0.1},
       {"head": 5e-3, "encoder": 2e-2, "cls": 0.05})
EMB = (8192, 8)
SHAPES = {
    "image_head": {"k0": (8, 4), "k1": (8, 4), "k2": (8, 4), "b0": (4,),
                   "b1": (4,)},
    "text_head": {"k0": (8, 4), "k1": (8, 4), "b0": (4,), "big": (200, 200)},
    "text_encoder": {"emb": EMB, "w0": (16, 16), "w1": (16, 16),
                     "w2": (16, 16), "b0": (16,), "b1": (16,), "b2": (16,)},
    "image_cls": {"weight": (7, 4)}, "text_cls": {"weight": (7, 4)},
}
STAGE2 = {"text_encoder": SHAPES["text_encoder"],
          "text_head": SHAPES["text_head"], "image_head": SHAPES["image_head"],
          "fusion_net": {"k0": (8, 4), "k1": (8, 4), "b0": (4,)},
          "metric_fc": {"weight": (7, 4)}}
B, T = 4, 12          # lazy rows: max(256, B T) = 256


def _shapes(stage):
    return SHAPES if stage == 1 else STAGE2


def _data(stage, seed=0):
    """(params, [grads per step]) as numpy trees; the table's gradient
    touches 20 rows a step (a few of them again), the others are zero."""
    rng = np.random.default_rng(seed)
    shapes = _shapes(stage)
    params = {m: {k: rng.normal(size=s).astype(np.float32)
                  for k, s in d.items()} for m, d in shapes.items()}
    grads = []
    for _ in range(STEPS):
        g = {m: {k: rng.normal(size=s).astype(np.float32)
                 for k, s in d.items()} for m, d in shapes.items()}
        emb = np.zeros(EMB, np.float32)
        rows = rng.choice(64, size=20, replace=False)
        emb[rows] = rng.normal(size=(20, EMB[1]))
        g["text_encoder"]["emb"] = emb
        grads.append(g)
    return params, grads


def _cfg(**kw):
    base = dict(adam_moments_dtype="float32", grads_dtype="float32",
                batch_size=B, bert_words_num=T, weight_decay=0.01,
                lr_image_train=0.1)
    base.update(kw)
    return base


def _port(stage, params, cfg):
    modules = {m: torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in d.items()}) for m, d in params.items()}
    make = poptim.make_stage1_bert_tx if stage == 1 else poptim.make_stage2_tx
    return modules, make(PConfig().replace(**cfg), modules)


def _set_grads(modules, g):
    for m, mod in modules.items():
        for k, p in mod.items():
            p.grad = torch.from_numpy(g[m][k].copy())


def _run_port(stage, cfg, steps=range(STEPS), state=None, seed=0):
    """The port's optimizer over `steps`, from `state` (a state_dict) when
    given: (modules, optimizer)."""
    params, grads = _data(stage, seed)
    modules, opt = _port(stage, params, cfg)
    if state is not None:
        params_at, opt_state = state
        for m, mod in modules.items():
            for k, p in mod.items():
                p.data.copy_(params_at[m][k])
        opt.load_state_dict(opt_state)
    for s in steps:
        for g, lr in LRS[s >= 2].items():
            opt.set_lr(g, lr)
        _set_grads(modules, grads[s])
        opt.step()
    return modules, opt


def _leaves(modules, opt):
    """Every parameter, moment, momentum buffer and count, by name."""
    out = {f"{m}.{k}": p.detach() for m, mod in modules.items()
           for k, p in mod.named_parameters()}
    for g, sd in opt.state_dict().items():
        out[f"{g}.count"] = sd["count"]
        for i, st in sd["state"].items():
            for k, t in st.items():
                out[f"{g}.{i}.{k}"] = t
    return out


def _assert_equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (what, k)


CASES = [(1, md, gd, extra) for md in ("float32", "bfloat16")
         for gd in ("float32", "bfloat16")
         for extra in ("plain", "clip", "lazy")] + [
        (2, md, gd, extra) for md in ("float32", "bfloat16")
        for gd in ("float32", "bfloat16") for extra in ("plain", "lazy")]
EXTRA = {"plain": {}, "clip": dict(apply_grad_clip=True, clip_max_norm=0.5),
         "lazy": dict(lazy_embedding_adam=True)}


def _case_cfg(md, gd, extra, **kw):
    return _cfg(adam_moments_dtype=md, grads_dtype=gd, **EXTRA[extra], **kw)


def _run_jax(stage, cfg):
    import jax
    import jax.numpy as jnp
    import optax

    from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
    from text_guided_face_recognition_tpu.engine import optim as joptim
    params, grads = _data(stage)
    jargs = JConfig().replace(**cfg)
    make = (joptim.make_stage1_bert_tx if stage == 1
            else joptim.make_stage2_tx)
    tx = make(jargs)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)

    def update(g, state, p):         # op by op: the ops' compiles are shared
        g = joptim.cast_grads(g, jargs.grads_dtype)
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state

    for s in range(STEPS):
        for g, lr in LRS[s >= 2].items():
            state = joptim.set_lr(state, g, lr)
        p, state = update(jax.tree_util.tree_map(jnp.asarray, grads[s]),
                          state, p)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("stage,md,gd,extra", CASES)
@pytest.mark.parametrize("stacked", [True, False])
def test_variants_match_jax(stage, md, gd, extra, stacked):
    """The port's one update against each of the JAX package's batchings."""
    want = _run_jax(stage, dict(_case_cfg(md, gd, extra),
                                stacked_optimizer=stacked))
    rounded = "bfloat16" in (md, gd)
    modules, _ = _run_port(stage, _case_cfg(md, gd, extra))
    for m, mod in modules.items():
        group = (poptim.GROUPS if stage == 1 else poptim.STAGE2_GROUPS)[m]
        lr = sum(LRS[s >= 2][group] for s in range(STEPS))
        for k, p in mod.items():
            lazy_leaf = extra == "lazy" and k == "emb"
            mixed = extra == "lazy" and group == "encoder"
            loose = gd == "bfloat16" and md == "float32" and not mixed
            atol = lr * (2 ** -6 if loose else 2 ** -7 if rounded
                         else 0.0) + 1e-6
            np.testing.assert_allclose(
                p.detach().numpy(), want[m][k], rtol=1e-6, atol=atol,
                err_msg=f"{m}.{k} (lazy leaf {lazy_leaf})")
    if extra == "clip":     # the clip moved something
        plain, _ = _run_port(stage, _case_cfg(md, gd, "plain"))
        assert not torch.equal(plain["text_encoder"]["w0"],
                               modules["text_encoder"]["w0"])


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("md", ["float32", "bfloat16"])
def test_lazy_rows_untouched_stay_bit_unchanged(stage, md):
    params, grads = _data(stage)
    cfg = _case_cfg(md, "float32", "lazy")
    modules, opt = _port(stage, params, cfg)
    enc = opt.opts["encoder"]
    i = next(j for j, p in enumerate(enc.params) if p.shape == EMB)
    assert enc.lazy == [i]
    for s in range(STEPS):
        for g, lr in LRS[s >= 2].items():
            opt.set_lr(g, lr)
        _set_grads(modules, grads[s])
        before = [t.clone() for t in (enc.params[i], enc.exp_avg[i],
                                      enc.exp_avg_sq[i])]
        opt.step()
        cold = grads[s]["text_encoder"]["emb"].any(1) == 0
        for old, new in zip(before, (enc.params[i], enc.exp_avg[i],
                                     enc.exp_avg_sq[i])):
            assert torch.equal(new[cold], old[cold])
            assert not torch.equal(new[~cold], old[~cold])
    # the dense update moves every row (stale momentum, weight decay)
    dense, dopt = _run_port(stage, _case_cfg(md, "float32", "plain"))
    lazy, _ = _run_port(stage, cfg)
    assert not torch.equal(dense["text_encoder"]["emb"][1000],
                           lazy["text_encoder"]["emb"][1000])
    assert torch.equal(lazy["text_encoder"]["emb"][1000],
                       torch.from_numpy(params["text_encoder"]["emb"][1000]))


def _legacy(opt):
    """The state in the torch.optim layout the trainers wrote before: Adam
    per parameter `step` (an int), `exp_avg`, `exp_avg_sq`; SGD a
    `momentum_buffer` (with momentum) and no step; no counts."""
    out = {}
    for g, sd in opt.state_dict().items():
        n = int(sd["count"])
        hp = dict(sd["param_groups"][0])
        if "betas" in hp:
            state = {i: dict(st, step=n) for i, st in sd["state"].items()}
        else:
            state = {i: dict(st) for i, st in sd["state"].items()}
            hp.update(dampening=0, nesterov=False, maximize=False,
                      foreach=None, differentiable=False, fused=None)
        out[g] = {"state": copy.deepcopy(state), "param_groups": [hp]}
    return out


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("md", ["float32", "bfloat16"])
def test_state_resumes_across_variants_and_layouts(stage, md):
    whole = _leaves(*_run_port(stage, _case_cfg(md, "float32", "lazy")))
    head, hopt = _run_port(stage, _case_cfg(md, "float32", "lazy"),
                           steps=range(2))
    at = {m: {k: p.detach().clone() for k, p in mod.items()}
          for m, mod in head.items()}
    for layout, sd in (("counts", copy.deepcopy(hopt.state_dict())),
                       ("torch.optim", _legacy(hopt))):
        got = _leaves(*_run_port(stage, _case_cfg(md, "float32", "lazy"),
                                 steps=range(2, STEPS), state=(at, sd)))
        _assert_equal(got, whole, f"{layout} layout")


# ------------------------------------------------------------- on the card --

@pytest.mark.cuda
def test_cuda_captured_step_equals_eager_steps(tmp_path, monkeypatch):
    """The captured stage-1 step (3 eager warm-up steps, then the capture
    and its replays) against eager steps, from the same weights, batch and
    drop_gen seed, at a small size in bf16 with every kernel of the
    flagship path (fused_block both, fused_ln, use_pallas, prng dropout).
    Both run the same kernels in the same order, deterministic ones, so
    after 3 and after 6 steps every parameter, moment, count and metric is
    equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.models import text_bert
    monkeypatch.setitem(text_bert.TEXT_ARCHS, "tiny", text_bert.TextArch(
        vocab_size=30522, hidden=128, layers=2, heads=2, intermediate=256,
        max_positions=64))
    monkeypatch.chdir(tmp_path)
    args = PConfig().replace(
        en_type="BERT", synthetic=True, batch_size=8, num_workers=0,
        bert_type="tiny", bert_words_num=T, num_classes=16, manual_seed=0,
        fused_block="both", fused_ln=True, use_pallas=True,
        compute_dtype="bfloat16", checkpoints_path=str(tmp_path))
    dev = torch.device("cuda")
    runs = {}
    for name, kw in (("graph", {}), ("eager", dict(eager=True))):
        tr = Stage1Trainer(args, dev, **kw)
        if runs:
            tr.model.load_state_dict(init)
        else:
            init = {k: v.clone() for k, v in tr.model.state_dict().items()}
        batch = tr.to_device(next(iter(tr.train_dl)))
        out = []
        for n in range(6):
            if n == 4:
                tr.lr["head"] *= 0.5
                tr._apply_lrs()
            out.append(tr.train_step(batch))
            if n in (2, 5):
                out.append(_leaves({"model": tr.model}, tr.opt))
        runs[name] = (out, tr.graph_replays)
    assert runs["graph"][1] == 3 and runs["eager"][1] == 0
    for a, b in zip(runs["graph"][0], runs["eager"][0]):
        _assert_equal(b, a, "eager")
