"""The port's explicit shard_map steps (parallel/spmd.py) and its
class-sharded stage-2 step (parallel/partial_fc.py, engine/trainer.py's
modes) at world size 2, two gloo ranks on the CPU, against the JAX
package's `make_shardmap_train_step`, `make_shardmap_fusion_step` and
`make_partial_fc_fusion_step` over a 2-device mesh of the 8-device CPU
platform; and at world size 1 against the trainers' default step.

One pod of two ranks (tests/_torch_spmd_worker.py, which imports no JAX)
runs every scenario; this process builds the JAX trainers, hands the
ranks their weights and meanwhile compiles each JAX step once, jitted.
Sizes and switches are tests/test_torch_parallel.py's: the tiny post-LN
BERT of _torch_port.py with dropout off (the JAX steps fold their key by
shard, and the masks carry no parity constraint), T 12, global batch 4
(2 a rank), 16 classes, the full ImageHeading and FCFM, f32; the port runs
fused_block both (stage 1) or tower (stage 2), fused_ln and use_pallas on
the kernels' plain versions, JAX its unfused modules.

Reading JAX's gradients: each JAX step runs here with an optimizer that
returns the gradients it is handed (after the collectives) as its state,
so they are read exactly; the state after one step is then JAX's own
optimizer (the trainer's `tx`) applied to those gradients. In JAX 0.9 a
shard_map with check_vma=False transposes all_gather to a reduce-scatter
and psum to psum, so inside the per-shard grad each rank's cotangent of a
value that every rank consumes whole is counted once a rank
(`test_jax_shard_map_counts_a_whole_cotangent_once_a_rank` shows it on
two lines of JAX): the JAX steps hand the summed modules N times the
global batch's gradient (stage 1: the modules before the gather; stage 2
and partial FC: every module). The port computes the global batch's
gradient, which the JAX docstrings state; its gradients are held against
JAX's divided by N on those modules (`JAX_FACTOR`), and
`test_jax_gradients_carry_the_factor` shows the factor is there.

Tolerances, tests/test_torch_parallel.py's (its docstring): gradients
|g_port - g_jax| <= 1e-4 max |g_jax| + 1e-6 G per parameter, G the
model's largest gradient element; metrics rtol 1e-5; after one step the BN
statistics 1e-6 (+ 1e-6 relative), the SGD group lr times the gradient
tolerance, an Adam element 1e-6 (+ 1e-6 relative) where its effective
gradient is clearly signed and 2 lr elsewhere. With grads_dtype bfloat16
(cast before the collectives, summed in bfloat16 on both sides) each
gradient element within 2^-7 |g_jax| + 2^-8 max |g_jax| + 1e-6 G: the f32
gradients that both sides round differ in their last bits, so the cast of
each rank's value may land one bf16 step (2^-8 relative,
tests/test_torch_optim.py's bf16 step) apart, and the ranks' values,
which may cancel in their sum, are of the parameter's scale, not the
element's; the sum's own rounding adds a step of the element. The
partial-FC step against the port's own stage-2 shard_map step, leaf for
leaf: the same gradient rule, and after the step the same state rule. At
world size 1 each shard_map step equals the default step bit for bit; the
partial-FC step (sharded_margin_ce, its own log-sum-exp) the default step
within the gradient rule.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from functools import partial

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from text_guided_face_recognition_tpu.engine import optim as joptim
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.engine import stage1 as jstage1
from text_guided_face_recognition_tpu.engine import stage2 as jstage2
from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu.parallel import make_mesh
from text_guided_face_recognition_tpu.parallel import partial_fc as jpfc
from text_guided_face_recognition_tpu.parallel import spmd as jspmd
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch.engine import optim as poptim
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer as PStage1)
from text_guided_face_recognition_tpu_torch.engine.stage2 import (
    FusionTrainer as PStage2)
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
from text_guided_face_recognition_tpu_torch.parallel import (
    classifier_specs_for_state, gather_state_for_partial_fc,
    make_partial_fc_fusion_step, make_shardmap_fusion_step,
    make_shardmap_train_step, mesh, shard_state_for_partial_fc)

from _torch_dp_worker import _grads, _local
from _torch_port import TINY, to_numpy
from test_torch_parallel import (LR1, LR2, STAGE1, STAGE2, WD1, WD2, WORLD,
                                 _batch, _check_after, _check_grads,
                                 _free_port, _grad_errors, _jax_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_spmd_worker.py")
CLASSES = 16
PRE_GATHER = ("image_head", "text_encoder", "text_head")
JAX_FACTOR = {"stage1": {m: WORLD for m in PRE_GATHER},
              "stage1_bf16": {m: WORLD for m in PRE_GATHER},
              "stage2": WORLD, "pfc": WORLD}
CPU = torch.device("cpu")


def _capture_tx():
    """An optimizer whose state after an update is the gradients it was
    handed, and whose update is zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


def _factor(case: str, module: str) -> int:
    f = JAX_FACTOR[case]
    return f if isinstance(f, int) else f.get(module, 1)


def _jax_step(j, maker, batch, mesh_, pfc=False, **args_over):
    """JAX's step `maker(j, mesh_)` run once on the global batch with the
    capturing optimizer: (gradients after the collectives as numpy, the
    BatchNorm statistics, the metrics, the state after JAX's own
    optimizer on the gradients divided by JAX_FACTOR (`divide`))."""
    real_tx, real_state, real_args = j.tx, j.state, j.args
    j.tx = _capture_tx()
    j.args = real_args.replace(**args_over) if args_over else real_args
    j.state = real_state.replace(opt_state=j.tx.init(real_state.params))
    try:
        step = maker(j, mesh_)
        st = jax.tree_util.tree_map(jnp.copy, j.state)
        if pfc:
            st = jpfc.shard_state_for_partial_fc(
                st, mesh_, "data", (CLASSES, j.args.fusion_final_dim))
        new, metrics = step(st, _jax_batch(batch, mesh_), {},
                            jax.random.PRNGKey(0))
        grads = to_numpy(new.opt_state)
        stats = to_numpy(new.batch_stats)
    finally:
        j.tx, j.state, j.args = real_tx, real_state, real_args

    def after(divide):
        g = {k: jax.tree_util.tree_map(
            lambda x, k=k: jnp.asarray(np.asarray(x, np.float32)
                                       / divide(k)), v)
             for k, v in grads.items()}
        def apply(g, opt, params):
            upd, _ = real_tx.update(g, opt, params)
            return optax.apply_updates(params, upd)

        return to_numpy(jax.jit(apply)(g, real_state.opt_state,
                                       real_state.params))

    return dict(grads=grads, stats=stats,
                metrics={k: float(v) for k, v in metrics.items()},
                after=after)


def _export_jax_state(j, path):
    """The JAX stage-2 trainer's state as tools/export_jax_checkpoint.py
    writes a train state (its own flattening, from the live state)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint",
        os.path.join(ROOT, "tools", "export_jax_checkpoint.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    st = to_numpy({"params": j.state.params,
                   "batch_stats": j.state.batch_stats})
    lrs = {k: np.asarray(v, np.float32) for k, v in j.lr.items()}
    flat = {}
    ex._flat(st["params"], "params", flat)
    ex._flat(st["batch_stats"], "batch_stats", flat)
    ex._flat({"epoch": np.asarray(3), "lr": lrs}, "meta", flat)
    ex._flat(ex._optimizer(j.state.opt_state, j.state.params,
                           joptim._stage2_group, lrs, j.args), "opt", flat)
    return ex._write(path, flat)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Starts the pod, builds the JAX trainers, hands the ranks the
    weights, runs the JAX steps meanwhile, waits for both ranks."""
    work = tmp_path_factory.mktemp("spmd")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
        "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), port, str(work)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    outs = []
    try:
        with pytest.MonkeyPatch.context() as mp:
            arch = jtb.TextArch(**TINY)
            mp.setitem(jtb.TEXT_ARCHS, "tiny0",
                       dataclasses.replace(arch, dropout=0.0))
            mp.setattr(jprep, "prepare_backbone",
                       lambda args: jprep.Bundle(None, {}))
            batch = _batch()
            j1, j2 = (jstage1.Stage1Trainer(STAGE1[0]),
                      jstage2.FusionTrainer(STAGE2[0]))
            export = _export_jax_state(j2, str(work / "jax_state.npz"))
            spec = {"tiny": TINY, "batch": batch, "jax_export": export}
            for name, j, cfg in (("stage1", j1, STAGE1), ("stage2", j2,
                                                           STAGE2)):
                spec[name] = dict(cfg=cfg[1], params=to_numpy(j.state.params),
                                  stats=to_numpy(j.state.batch_stats))
            torch.save(spec, work / "spec.tmp")
            os.replace(work / "spec.tmp", work / "spec.pt")
            m2 = make_mesh(WORLD)
            ref = {"stage1": _jax_step(j1, jspmd.make_shardmap_train_step,
                                       batch, m2),
                   "stage1_bf16": _jax_step(
                       j1, jspmd.make_shardmap_train_step, batch, m2,
                       grads_dtype="bfloat16"),
                   "stage2": _jax_step(j2, jspmd.make_shardmap_fusion_step,
                                       batch, m2),
                   "pfc": _jax_step(j2, jpfc.make_partial_fc_fusion_step,
                                    batch, m2, pfc=True),
                   "j2_params": to_numpy(j2.state.params)}
        for p in procs:
            out, _ = p.communicate(timeout=400)
            outs.append(out)
    finally:
        for p in procs:             # a hung rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
        assert "SPMD_WORKER_OK" in out, out[-4000:]
    ref["ranks"] = [torch.load(work / f"rank{r}.pt", weights_only=False)
                    for r in range(WORLD)]
    ref["spec"], ref["work"] = spec, work
    return ref


def _model(stage: str):
    """A port model of the stage's layout for the bridge (tiny arch)."""
    with pytest.MonkeyPatch.context() as mp:
        arch = ptb.TextArch(**TINY)
        mp.setitem(ptb.TEXT_ARCHS, "tiny0",
                   dataclasses.replace(arch, dropout=0.0))
        mp.setattr(PM, "iresnet18",
                   lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
        cls, cfg = ((PStage1, STAGE1) if stage.startswith("stage1")
                    else (PStage2, STAGE2))
        return cls(cfg[2], CPU).model


_MODELS = {}


def _model_of(case: str):
    """The port model of a case's stage, built once."""
    key = "stage1" if case.startswith("stage1") else "stage2"
    if key not in _MODELS:
        _MODELS[key] = _model(key)
    return _MODELS[key]


def _bridge(case, params, stats):
    return state_dict_from_jax(params, stats, module=_model_of(case))


def _jax_grads(pod, case, divided=True):
    """JAX's gradients after the collectives in the port's layout,
    divided by JAX_FACTOR unless `divided` is False."""
    ref = pod[case]
    stats = ref["stats"]
    g = {k: jax.tree_util.tree_map(
        lambda x, k=k: np.asarray(x, np.float32)
        / (_factor(case, k) if divided else 1), v)
        for k, v in ref["grads"].items()}
    return _bridge(case, g, stats)


def _rank_grads(pod, case):
    """Each rank's gradients; partial FC: metric_fc's rows of every rank
    in rank order (each rank holds only its own)."""
    ranks = [r[case]["grads"] for r in pod["ranks"]]
    if case == "pfc":
        whole = torch.cat([g["metric_fc.weight"] for g in ranks])
        ranks = [dict(g, **{"metric_fc.weight": whole}) for g in ranks]
    return ranks


CASES = ["stage1", "stage1_bf16", "stage2", "pfc"]


def _names(case):
    return [n for n, _ in _model_of(case).named_parameters()]


@pytest.mark.parametrize("case", CASES)
def test_gradients_after_the_collectives_match_jax(pod, case):
    """Every parameter's gradient on every rank after the collectives
    (cast, summed or local, clipped) against the JAX step's, JAX's divided
    by JAX_FACTOR; in bf16 under the stated bf16 bound."""
    gsd = _jax_grads(pod, case)
    names = _names(case)
    big = max(float(gsd[n].abs().max()) for n in names)
    for got in _rank_grads(pod, case):
        if case.endswith("bf16"):
            worst = {}
            for n in names:
                want = gsd[n]
                allowed = (2.0 ** -7 * want.abs() + 2.0 ** -8 * float(
                    want.abs().max()) + 1e-6 * big)
                worst[n] = float(((got[n] - want).abs() / allowed).max())
            bad = {n: v for n, v in worst.items() if v > 1.0}
            assert not bad, bad
        else:
            _check_grads(got, gsd, names)


@pytest.mark.parametrize("case", ["stage1", "stage2", "pfc"])
def test_jax_gradients_carry_the_factor(pod, case):
    """JAX's gradients as its step hands them to the optimizer fail the
    gradient rule on exactly the modules JAX_FACTOR names: the factor is
    JAX's, and the port's gradient is the global batch's."""
    raw = _jax_grads(pod, case, divided=False)
    got = _rank_grads(pod, case)[0]
    names = _names(case)
    bad = {n.split(".")[0] for n, (e, tol) in _grad_errors(
        got, raw, names).items() if e > tol}
    factored = {n.split(".")[0] for n in names
                if _factor(case, n.split(".")[0]) != 1}
    assert bad == factored, (bad, factored)


def test_jax_shard_map_counts_a_whole_cotangent_once_a_rank():
    """JAX alone: inside a shard_map's per-shard grad, a gathered value
    that every shard's loss consumes whole (then summed over the shards,
    as the JAX stage-1 step sums the towers) gives N times the global
    gradient."""
    m2 = make_mesh(WORLD)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 3)),
                    jnp.float32)
    w = jnp.asarray(np.random.default_rng(1).normal(size=(3, 2)),
                    jnp.float32)

    def per_shard(w, x):
        def loss(w):
            e = jax.lax.all_gather(x @ w, "data", axis=0, tiled=True)
            return jnp.sum(jnp.tanh(e @ e.T))
        return jax.lax.psum(jax.grad(loss)(w), "data")

    f = jax.jit(jax.shard_map(per_shard, mesh=m2,
                              in_specs=(P(), P("data")), out_specs=P(),
                              check_vma=False))
    whole = jax.grad(lambda w: jnp.sum(jnp.tanh((x @ w) @ (x @ w).T)))(w)
    np.testing.assert_allclose(np.asarray(f(w, x)),
                               WORLD * np.asarray(whole), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["stage1", "stage1_bf16", "stage2", "pfc"])
def test_metrics_match_jax(pod, case):
    """The loss and metrics, the same on both ranks (stage 2: the focal
    factor on the global mean cross-entropy)."""
    want = pod[case]["metrics"]
    for r in pod["ranks"]:
        got = r[case]["metrics"]
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)
    assert pod["ranks"][0][case]["metrics"] == pod["ranks"][1][case][
        "metrics"]


@pytest.mark.parametrize("case", ["stage1", "stage2", "pfc"])
def test_state_after_step_matches_jax(pod, case):
    """The averaged BatchNorm running statistics and every parameter after
    one step (partial FC: metric_fc gathered) against JAX's optimizer on
    JAX's gradients divided by JAX_FACTOR."""
    ref = pod[case]
    stage = "stage1" if case == "stage1" else "stage2"
    want = _bridge(case, ref["after"](lambda k: _factor(case, k)),
                   ref["stats"])
    spec = pod["spec"][stage]
    old = _bridge(case, spec["params"], spec["stats"])
    gsd = _jax_grads(pod, case)
    groups = poptim.GROUPS if stage == "stage1" else poptim.STAGE2_GROUPS
    lr, wd = (LR1, WD1) if stage == "stage1" else (LR2, WD2)
    for r in pod["ranks"]:
        _check_after(r[case]["after"], want, old, gsd, _names(case), groups,
                     lr, wd)


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(pod, case):
    """The gradients after the collectives (the modules after the gather,
    whose JAX mean the port skips, among them), the metrics and the state
    after the step are the same on both ranks, bit for bit; partial FC:
    all but each rank's own metric_fc rows."""
    r0, r1 = (r[case] for r in pod["ranks"])
    for n, g in r0["grads"].items():
        if case == "pfc" and n == "metric_fc.weight":
            continue
        torch.testing.assert_close(g, r1["grads"][n], rtol=0, atol=0,
                                   msg=n)
    for k, v in r0["after"].items():
        torch.testing.assert_close(v, r1["after"][k], rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("fault", ["fault_summed", "fault_stats"])
def test_planted_faults_fail(pod, fault):
    """The modules after the gather summed instead of averaged fail the
    gradient rule (N times their gradient); the per-rank running
    statistics left unaveraged fail the state rule."""
    gsd = _jax_grads(pod, "stage1")
    names = _names("stage1")
    got = pod["ranks"][0][fault]
    if fault == "fault_summed":
        bad = {n.split(".")[0] for n, (e, tol) in _grad_errors(
            got["grads"], gsd, names).items() if e > tol}
        assert bad == {"image_cls", "text_cls"}, bad
        return
    want = _bridge("stage1", pod["stage1"]["after"](
        lambda k: _factor("stage1", k)), pod["stage1"]["stats"])
    errs = {k: float((got["after"][k] - want[k]).abs().max())
            for k in want if "running_" in k}
    assert max(errs.values()) > 1e-3, errs
    # the gradients themselves are the true step's
    _check_grads(got["grads"], gsd, names)


def test_partial_fc_equals_the_shard_map_step_leaf_for_leaf(pod):
    """The port's partial-FC step against its own stage-2 shard_map step:
    the loss, every gradient (metric_fc's rows of both ranks together),
    and every leaf after the step (metric_fc gathered)."""
    sm = pod["ranks"][0]["stage2"]
    pfc_grads = _rank_grads(pod, "pfc")[0]
    names = _names("stage2")
    np.testing.assert_allclose(pod["ranks"][0]["pfc"]["loss"], sm["loss"],
                               rtol=1e-5)
    _check_grads(pfc_grads, sm["grads"], names)
    old = _bridge("stage2", pod["spec"]["stage2"]["params"],
                  pod["spec"]["stage2"]["stats"])
    for r in pod["ranks"]:
        _check_after(r["pfc"]["after"], r["stage2"]["after"], old,
                     sm["grads"], names, poptim.STAGE2_GROUPS, LR2, WD2)


def test_partial_fc_rank_holds_its_rows(pod):
    """Each rank holds C/N rows of metric_fc, its rows of the W that the
    replicated layout starts from, and no optimizer state of another
    shape (stage 2's SGD has no momentum: its state is the count)."""
    w = pod["spec"]["stage2"]["params"]["metric_fc"]["weight"]
    rows = CLASSES // WORLD
    for r, got in enumerate(x["shard"] for x in pod["ranks"]):
        assert tuple(got["weight"].shape) == (rows, w.shape[1])
        np.testing.assert_array_equal(got["weight"].numpy(),
                                      w[r * rows:(r + 1) * rows])
        assert all(s[0] == rows for s in got["opt"].values()), got["opt"]
        assert got["cls_count"] == 0
        local = pod["ranks"][r]["pfc"]["local_weight"]
        assert tuple(local.shape) == (rows, w.shape[1])


def _load(path):
    return torch.load(path, weights_only=True)


def _equal_trees(a, b, exact=True):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k], exact)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y, exact)
    elif torch.is_tensor(a):
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            assert torch.equal(a, b)
    else:
        assert a == b


def test_partial_fc_checkpoint_is_the_replicated_layouts(pod):
    """The partial-FC train state, the classifier gathered to rank 0, is the
    replicated layout's file: equal before a step, the same tree (shapes,
    dtypes, keys) after one."""
    work = pod["work"]
    for epoch, exact in ((0, True), (1, False)):
        a = _load(work / "sharded" / f"train_state_{epoch}")
        b = _load(work / "replicated" / f"train_state_{epoch}")
        _equal_trees(a, b, exact)


@pytest.mark.parametrize("source", ["replicated", "jax"])
def test_partial_fc_resume_splits_the_rows(pod, source):
    """A partial-FC trainer resumed from the replicated layout's file or
    from an exported JAX stage-2 train state holds its rank's rows of the
    file's classifier and the file's other weights."""
    if source == "replicated":
        whole = _load(pod["work"] / "replicated" / "train_state_1")["model"]
    else:
        whole = _bridge("stage2", pod["j2_params"],
                        pod["spec"]["stage2"]["stats"])
    rows = CLASSES // WORLD
    for r, x in enumerate(pod["ranks"]):
        got = x["resumed"][source]
        torch.testing.assert_close(
            got["weight"], whole["metric_fc.weight"][r * rows:(r + 1) * rows],
            rtol=0, atol=0)
        for k, v in got["state"].items():
            if k != "metric_fc.weight":
                torch.testing.assert_close(v, whole[k].to(v.dtype), rtol=0,
                                           atol=0, msg=k)
        assert got["start_epoch"] == (2 if source == "replicated" else 4)


def test_partial_fc_refuses_indivisible_classes(monkeypatch):
    """num_classes not divisible by the world size: JAX's refusal, word
    for word."""
    from text_guided_face_recognition_tpu.config import TGFRConfig as JCfg
    from text_guided_face_recognition_tpu_torch.config import (
        TGFRConfig as PCfg)

    class Fake:
        def __init__(self, args):
            self.args = args

    with pytest.raises(ValueError, match="divisible") as want:
        jpfc.make_partial_fc_fusion_step(Fake(JCfg().replace(num_classes=13)),
                                         make_mesh(WORLD))
    monkeypatch.setattr(mesh, "world_size", lambda: WORLD)
    with pytest.raises(ValueError) as got:
        make_partial_fc_fusion_step(Fake(PCfg().replace(num_classes=13)))
    assert str(got.value) == str(want.value)


def test_classifier_specs_and_row_split():
    """The split names the classifier's leaves by shape and key (not a
    leaf of the same shape elsewhere); a rank's rows and their gather back
    (world 1: the identity) on a tree with an SGD momentum buffer."""
    w = torch.arange(24.0).view(6, 4)
    tree = {"model": {"metric_fc.weight": w, "fusion_net.w": w.clone()},
            "optimizer": {"cls": {"state": {0: {"momentum_buffer": w + 1}},
                                  "count": torch.tensor(3)},
                          "head": {"state": {0: {"exp_avg": w + 2}}}}}
    specs = classifier_specs_for_state(tree, (6, 4))
    assert specs["model"] == {"metric_fc.weight": 0, "fusion_net.w": None}
    assert specs["optimizer"]["cls"]["state"][0]["momentum_buffer"] == 0
    assert specs["optimizer"]["head"]["state"][0]["exp_avg"] is None
    part = shard_state_for_partial_fc(tree, (6, 4), rank=1, world=3)
    torch.testing.assert_close(part["model"]["metric_fc.weight"], w[2:4])
    torch.testing.assert_close(
        part["optimizer"]["cls"]["state"][0]["momentum_buffer"], w[2:4] + 1)
    assert part["model"]["fusion_net.w"] is tree["model"]["fusion_net.w"]
    back = gather_state_for_partial_fc(
        shard_state_for_partial_fc(tree, (6, 4)), (6, 4))
    _equal_trees(back, tree)


@pytest.fixture
def tiny_port(monkeypatch):
    arch = ptb.TextArch(**TINY)
    monkeypatch.setitem(ptb.TEXT_ARCHS, "tiny0",
                        dataclasses.replace(arch, dropout=0.0))
    monkeypatch.setattr(PM, "iresnet18",
                        lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))


def _one_step(tr, batch):
    total, _ = tr.compute_grads(batch)
    grads = _grads(tr.model)
    tr._optimizer_step()
    return float(total), grads, {k: v.clone() for k, v in
                                 tr.train_state()["model"].items()}


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_world_one_shard_map_step_is_the_default_step(tiny_port, stage):
    """One process, no group: the shard_map step equals the trainer's
    default step bit for bit (loss, gradients, state after the step), as
    the JAX package's one-device test holds its shard_map steps."""
    cls, cfg, make = ((PStage1, STAGE1[2], make_shardmap_train_step)
                      if stage == "stage1"
                      else (PStage2, STAGE2[2], make_shardmap_fusion_step))
    batch = _local(_batch(), 0, 1)
    base = cls(cfg, CPU)
    init = {k: v.clone() for k, v in base.model.state_dict().items()}
    want = _one_step(base, batch)
    tr = cls(cfg, CPU)
    tr.model.load_state_dict(init)
    make(tr)
    assert tr.mode == "shard_map"
    got = _one_step(tr, batch)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_world_one_partial_fc_step_is_the_default_step(tiny_port):
    """One process: the partial-FC step (sharded_margin_ce's own
    log-sum-exp over all classes) against the default stage-2 step."""
    batch = _local(_batch(), 0, 1)
    base = PStage2(STAGE2[2], CPU)
    init = {k: v.clone() for k, v in base.model.state_dict().items()}
    want = _one_step(base, batch)
    tr = PStage2(STAGE2[2], CPU)
    tr.model.load_state_dict(init)
    make_partial_fc_fusion_step(tr)
    got = _one_step(tr, batch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    names = [n for n, _ in tr.model.named_parameters()]
    _check_grads(got[1], want[1], names)
    _check_after(got[2], want[2], init, want[1], names, poptim.STAGE2_GROUPS,
                 LR2, WD2)


def test_mode_is_set_before_the_first_step(tiny_port):
    """A trainer that has stepped refuses a change of mode."""
    tr = PStage2(STAGE2[2], CPU)
    tr.train_step(_local(_batch(), 0, 1))
    with pytest.raises(RuntimeError, match="before the first step"):
        make_shardmap_fusion_step(tr)
