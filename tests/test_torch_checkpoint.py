"""The JAX package's Orbax checkpoints in the port, through
tools/export_jax_checkpoint.py (run in-process here, where JAX is).

One tiny JAX stage-1 run (the tiny arch of _torch_port.py at one layer,
is_CMP on, the default stacked optimizer with bf16 moments and the lazy
embedding Adam, the text tower unfused with host dropout bits; the batches
carry backbone features) takes two steps and
saves its artifacts and its train state under a temporary directory with
the JAX package's own `save_encoders` / `save_state`; the exporter writes
each as `.npz`, and:

* the port's factories load the exported text encoder (with its head),
  image head and a fusion net, and give the JAX modules' outputs on the
  same inputs within 1e-4;
* a port trainer resumes the exported train state: its parameters, batch
  statistics, Adam moments (cmp's among them), SGD traces, counts, rates
  and epoch equal those of a JAX trainer resumed from the same directory
  (bit for bit: f32 leaves, bf16 moments written as f32); then step 3 on
  one batch and the same host dropout bits: loss within 1e-5 (relative)
  of JAX's step 3, every parameter after it within 1e-4 (+ 1e-4 of its
  value) — except, as in tests/test_torch_stage1.py, the Adam elements
  whose gradient is noise (at most 1e-4 of its parameter's largest, or
  1e-6 of the model's largest gradient element: IMIM's query bias, zero
  in exact arithmetic, is noise throughout): their moments hold the noise
  of the earlier steps, and such an element moves by up to lr either way;
  they stay within 2 lr;
* an r2 train state (per-leaf multi_transform state with f32 moments and
  the encoder clip on, the pattern of tests/test_opt_state_migration.py)
  is migrated by the exporter through the JAX package's load_train_state
  and resumes in the port with the moments that the JAX package's own
  migration (convert_legacy_opt_state) gives, bit for bit;
* the port's migrate_legacy_qkv equals the JAX package's.

The exporter imports nothing of the port (checked on its source).
"""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from text_guided_face_recognition_tpu.engine import checkpoint as jckpt
from text_guided_face_recognition_tpu.engine import optim as joptim
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.engine import stage1 as jstage1
from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu_torch.engine import checkpoint as pckpt
from text_guided_face_recognition_tpu_torch.engine import prepare as pprep
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer as PTrainer)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb

from _torch_port import TINY, to_numpy
from test_torch_stage1 import _batch, _cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTER = os.path.join(ROOT, "tools", "export_jax_checkpoint.py")
CPU = torch.device("cpu")
LR = {"head": 1e-3, "encoder": 2e-5, "cls": 0.1}


def _exporter():
    spec = importlib.util.spec_from_file_location("export_jax_checkpoint",
                                                  EXPORTER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keeping(rec):
    """JAX's `_DropPlan` keeping the bits it is made with in `rec`, so a
    jitted step can return them (the port takes them as host bits)."""

    class Keep(jtb._DropPlan):
        def __init__(self, bits, rate):
            super().__init__(bits, rate)
            rec.append(bits)

    return Keep


def _jax_step_fn(trainer, rec):
    """The JAX trainer's training step (its loss, its optimizer; the grads
    in f32 need no cast), jitted once for the whole module, also returning
    the loss, the step's dropout bits and the gradients."""
    loss_fn = trainer.build_loss_fn()

    @jax.jit
    def step(state, batch, key):
        n0 = len(rec)
        (loss, (stats, _)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.batch_stats, batch,
                                   {}, key)
        updates, opt_state = trainer.tx.update(grads, state.opt_state,
                                               state.params)
        state = state.replace(params=optax.apply_updates(state.params,
                                                         updates),
                              batch_stats={"image_head": stats},
                              opt_state=opt_state, step=state.step + 1)
        return state, loss, rec[n0], grads

    return step


def _port_bits(bits) -> torch.Tensor:
    """A step's JAX dropout bits as the port takes them: the unfused JAX
    attention draws its probability bits as (B, heads, T, T), the port
    reads them as the kernels' (heads, B, T, T) (tests/test_torch_stage2.py
    `port_bits`)."""
    bits = np.asarray(bits).view(np.int32).copy()
    a = jtb.TEXT_ARCHS["tiny"]
    b, t = _batch()[1]["caps"].shape
    n_h, n_p = b * t * a.hidden, b * a.heads * t * t
    for layer in range(a.layers):
        ofs = n_h + layer * (n_p + 2 * n_h)
        bits[ofs:ofs + n_p] = bits[ofs:ofs + n_p].reshape(
            b, a.heads, t, t).transpose(1, 0, 2, 3).reshape(-1)
    return torch.from_numpy(bits)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny JAX stage-1 run: 2 steps, then its three artifacts at epoch 1
    and their exports; what the tests read. The tiny arch, the stubbed
    JAX backbone and the bit-keeping dropout plan stay in place for the
    module's tests."""
    tmp = tmp_path_factory.mktemp("jax_run")
    rec = []
    with pytest.MonkeyPatch.context() as mp:
        arch = dict(TINY, layers=1)
        mp.setitem(jtb.TEXT_ARCHS, "tiny", jtb.TextArch(**arch))
        mp.setitem(ptb.TEXT_ARCHS, "tiny", ptb.TextArch(**arch))
        mp.setattr(jprep, "prepare_backbone",
                   lambda args: jprep.Bundle(None, {}))
        mp.setattr(jtb, "_DropPlan", _keeping(rec))
        jargs, pargs = _cfg(is_CMP=True, adam_moments_dtype="bfloat16",
                            lazy_embedding_adam=True,
                            lr_head=LR["head"], min_lr_bert=LR["encoder"],
                            fused_block="none", fused_ln=False,
                            use_pallas=False)
        j = jstage1.Stage1Trainer(jargs)
        step = _jax_step_fn(j, rec)
        jb, pb = _batch()
        for n in range(2):
            j.state = step(j.state, jb, jax.random.PRNGKey(10 + n))[0]
        save_dir = str(tmp / "run")
        j.save_encoders(save_dir, 1)
        j.save_state(save_dir, 1)
        ex = _exporter()
        out = {}
        for name in ("tiny_text_encoder_1", "arcface_image_encoder_1",
                     "train_state_1"):
            out[name] = ex.export(f"{save_dir}/{name}",
                                  str(tmp / f"{name}.npz"), jargs)
        yield dict(j=j, jargs=jargs, pargs=pargs, jb=jb, pb=pb, step=step,
                   dir=save_dir, out=out, tmp=tmp, ex=ex)


def _port_moments(p) -> dict:
    """{(kind, parameter name): tensor} of a port trainer's optimizer."""
    where = {id(q): (g, i) for g, qs in p.opt.params.items()
             for i, q in enumerate(qs)}
    sd = p.opt.state_dict()
    out = {}
    for name, q in p.model.named_parameters():
        g, i = where[id(q)]
        for kind, t in sd[g]["state"][i].items():
            out[(kind, name)] = t
    return out


def _jax_moments(trainer, state, pmodel) -> dict:
    """The same map from a JAX optimizer state (the current layout:
    stacked buckets unstacked with the JAX package's helper), through the
    weight bridge's leaf transforms."""
    args = trainer.args
    parts = joptim._partition(state.params, joptim._stage1_group)
    groups = dict(state.opt_state)
    trees = {"exp_avg": {}, "exp_avg_sq": {}, "momentum_buffer": {}}
    for g, gs in groups.items():
        adam = joptim._find_one(gs, "ScaleByAdamState")
        trace = joptim._find_one(gs, "TraceState")
        for kind, tree in (("exp_avg", adam and adam.mu),
                           ("exp_avg_sq", adam and adam.nu),
                           ("momentum_buffer", trace and trace.trace)):
            if tree:
                trees[kind].update(joptim._unstack_tree(
                    tree, parts[g], int(args.stack_max_elems)))
    out = {}
    for kind, tree in trees.items():
        # bridged padded with zeros to the whole parameter tree
        full = to_numpy(jax.tree_util.tree_map(jnp.zeros_like, state.params))
        full.update(to_numpy(tree))
        sd = state_dict_from_jax(full, to_numpy(state.batch_stats),
                                 module=pmodel)
        out.update({(kind, k): v for k, v in sd.items()
                    if k.split(".")[0] in tree and "running_" not in k})
    return out


def test_exporter_imports_nothing_of_the_port():
    with open(EXPORTER) as f:
        mods = set()
        for node in ast.walk(ast.parse(f.read())):
            if isinstance(node, ast.Import):
                mods |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add(node.module or "")
    assert not any(m.startswith("text_guided_face_recognition_tpu_torch")
                   for m in mods), mods


def test_migrate_legacy_qkv_matches_jax():
    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    leg = {"layer_0": {"attn": {n: {"kernel": f32(8, 4), "bias": f32(4)}
                                for n in ("query", "key", "value")},
                       "out": {"kernel": f32(4, 8)}},
           "emb": {"embedding": f32(5, 8)}}
    want = to_numpy(jckpt.migrate_legacy_qkv(leg))
    got = pckpt.migrate_legacy_qkv(leg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    assert "qkv" in got["layer_0"]["attn"] and "query" not in \
        got["layer_0"]["attn"]


@pytest.mark.parametrize("what", ["text", "image", "fusion"])
def test_exported_weights_load_into_factories(run, what):
    j, pargs, tmp = run["j"], run["pargs"], run["tmp"]
    rng = np.random.default_rng(4)
    params, stats = j.state.params, j.state.batch_stats
    if what == "text":
        p_enc, p_head = pprep.prepare_text_encoder(pargs.replace(
            text_encoder_path=run["out"]["tiny_text_encoder_1"]), CPU)
        jb, pb = run["jb"], run["pb"]
        want = jax.jit(lambda tp, hp, caps, mask: j.text_head.module.apply(
            {"params": hp}, j.text_encoder.module.apply(
                {"params": tp}, caps, mask)[0]))(
            params["text_encoder"], params["text_head"], jb["caps"],
            jb["mask"])
        with torch.no_grad():
            got = p_head(p_enc(pb["caps"], pb["mask"])[0])
    elif what == "image":
        head = pprep.prepare_image_head(pargs.replace(
            image_encoder_path=run["out"]["arcface_image_encoder_1"]), CPU)
        jb, pb = run["jb"], run["pb"]
        want = j.image_head.module.apply(
            {"params": params["image_head"], "batch_stats":
             stats["image_head"]}, jb["img_gl"], jb["img_lc"])
        want = (want[0], jnp.transpose(want[1], (0, 3, 1, 2)))
        with torch.no_grad():
            got = head(pb["img_gl"], pb["img_lc"])
    else:
        from text_guided_face_recognition_tpu.models.fusion import FCFM
        net = FCFM(channel_dim=36)
        local = rng.normal(size=(4, 14, 14, 256)).astype(np.float32)
        word = rng.normal(size=(4, 256, 10)).astype(np.float32)
        g, s = (rng.normal(size=(4, 256)).astype(np.float32)
                for _ in range(2))
        variables = jax.jit(net.init)(jax.random.PRNGKey(6), local, word, g,
                                      s)
        path = f"{tmp}/fusion_fcfm_arcface_1"
        jckpt.save_checkpoint(path, {
            "net": variables, "image_head": {
                "params": params["image_head"],
                "batch_stats": stats["image_head"]}})
        npz = run["ex"].export(path, f"{path}.npz")
        p_net = pprep.prepare_fusion_net(pargs.replace(
            fusion_type="fcfm", fusion_net_path=npz), CPU)
        want = jax.jit(net.apply)(variables, local, word, g, s)
        with torch.no_grad():
            got = p_net(torch.from_numpy(local.transpose(0, 3, 1, 2).copy()),
                        *(torch.from_numpy(x) for x in (word, g, s)))
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_exported_train_state_resumes_and_steps_as_jax(run):
    """Step 3 after a resume, port (from the export) against JAX (from the
    Orbax directory)."""
    jargs, pargs = run["jargs"], run["pargs"]
    j2 = jstage1.Stage1Trainer(jargs)
    j2.resume_from(f"{run['dir']}/train_state_1")
    p = PTrainer(pargs, CPU)
    p.resume_from(run["out"]["train_state_1"])
    assert p.start_epoch == j2.start_epoch == 2
    assert p.lr == j2.lr and p.lr == pytest.approx(LR, rel=1e-7)
    for g in LR:
        assert p.opt.get_lr(g) == j2.lr[g]
    # the resumed state, bit for bit
    want_sd = state_dict_from_jax(to_numpy(j2.state.params),
                                  to_numpy(j2.state.batch_stats),
                                  module=p.model)
    for k, v in p.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    counts = {g: int(joptim._find_one(gs, "ScaleByAdamState").count)
              for g, gs in j2.state.opt_state.items()
              if joptim._find_one(gs, "ScaleByAdamState") is not None}
    assert counts == {"head": 2, "encoder": 2}
    for g, c in counts.items():
        assert int(p.opt.state_dict()[g]["count"]) == c
    got, want = _port_moments(p), _jax_moments(j2, j2.state, p.model)
    assert set(got) == set(want)
    assert ("exp_avg", "cmp.W") in got
    for k, v in got.items():
        assert torch.equal(v.float(), want[k].float()), k

    # step 3, the same batch and bits
    jb, pb = run["jb"], run["pb"]
    # the run's jitted step (the same configuration's loss and optimizer)
    new, loss_j, bits, grads = run["step"](j2.state, jb,
                                           jax.random.PRNGKey(3))
    metrics = p.train_step(pb, _port_bits(bits))
    np.testing.assert_allclose(float(metrics["total_loss"]), float(loss_j),
                               rtol=1e-5)
    after = state_dict_from_jax(to_numpy(new.params),
                                to_numpy(new.batch_stats),
                                module=p.model)
    gsd = state_dict_from_jax(to_numpy(grads), to_numpy(j2.state.batch_stats),
                              module=p.model)
    from text_guided_face_recognition_tpu_torch.engine.optim import GROUPS
    big = max(float(np.abs(gsd[n].numpy()).max())
              for n, _ in p.model.named_parameters())
    for name, q in p.model.named_parameters():
        w, gq = after[name].numpy(), q.detach().numpy()
        err = np.abs(gq - w)
        tight = 1e-4 + 1e-4 * np.abs(w)
        g = gsd[name].numpy()
        noise = np.abs(g) <= max(1e-4 * np.abs(g).max(), 1e-6 * big)
        group = GROUPS[name.split(".")[0]]
        assert (err[~noise] <= tight[~noise]).all(), (name, err.max())
        assert (err[noise] <= 2 * LR[group] + tight[noise]).all(), name


def test_r2_train_state_resumes_through_the_exporter(run):
    """An r2 train state (per-leaf multi_transform, f32 moments, the clip
    on; its moments and traces random, its counts 3, as after the three
    updates of tests/test_opt_state_migration.py), exported under the
    current defaults (stacked buckets, bf16 moments): the port's resumed
    optimizer equals the JAX package's own migration of it
    (convert_legacy_opt_state onto the trainer's current state, as
    load_train_state runs it), bit for bit, and its rates and counts carry
    over."""
    j, jargs, pargs = run["j"], run["jargs"], run["pargs"]
    r2 = jargs.replace(stacked_optimizer=False, fused_optimizer=False,
                       lazy_embedding_adam=False,
                       adam_moments_dtype="float32", apply_grad_clip=True)
    params = to_numpy(j.state.params)
    rng = np.random.default_rng(7)

    def moments(node):
        # the r2 state after three steps: counts 3, f32 moments
        if type(node).__name__ == "ScaleByAdamState":
            return node._replace(count=np.int32(3), mu=rand(node.mu),
                                 nu=jax.tree_util.tree_map(np.square,
                                                           rand(node.nu)))
        if type(node).__name__ == "TraceState":
            return node._replace(trace=rand(node.trace))
        return node

    def rand(tree):
        return jax.tree_util.tree_map(
            lambda x: rng.normal(0, 0.05, x.shape).astype(np.float32), tree)

    state = joptim.make_stage1_bert_tx(r2).init(params)
    state = joptim._rebuild_states(state, {
        n: moments for n in ("ScaleByAdamState", "TraceState")})
    lrs = {"head": 0.002, "encoder": 4e-5, "cls": 0.05}
    for g, lr in lrs.items():
        state = joptim.set_lr(state, g, lr)
    path = f"{run['tmp']}/r2/train_state_7"
    jckpt.save_checkpoint(path, {
        "params": params, "batch_stats": j.state.batch_stats,
        "opt_state": state,
        "meta": {"epoch": jnp.asarray(7),
                 "lr": {k: jnp.asarray(v) for k, v in lrs.items()}}})
    npz = run["ex"].export(path, f"{path}.npz", jargs)
    p = PTrainer(pargs, CPU)
    p.resume_from(npz)
    assert p.start_epoch == 8 and p.lr == {
        k: float(np.float32(v)) for k, v in lrs.items()}

    migrated = j.state.replace(params=params, opt_state=(
        joptim.convert_legacy_opt_state(
            state, j.state.opt_state, params, joptim._stage1_group,
            int(jargs.stack_max_elems))))
    got, want = _port_moments(p), _jax_moments(j, migrated, p.model)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == (torch.float32 if k[0] == "momentum_buffer"
                           else torch.bfloat16), k
        assert torch.equal(v.float(), want[k].float()), k
    for g in ("head", "encoder"):
        assert int(p.opt.state_dict()[g]["count"]) == 3
