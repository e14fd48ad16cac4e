"""Data parallelism of the port (parallel/, engine/trainer.py, the stage
losses, the loader's process shard, the sharded evaluation) at world size 2,
two gloo ranks on the CPU, against the JAX package and against the port on
one process.

One pod of two ranks (tests/_torch_dp_worker.py, which imports no JAX)
runs every scenario, so process start-up is paid once; this process builds
the inputs, runs the JAX side and the one-process references while the
pod runs, and compares. Small sizes: the tiny post-LN BERT of
_torch_port.py (2 layers, H 128), T = 12, global batch 4 (2 a rank), 16
classes, the full ImageHeading and FCFM, f32. The port runs fused_block
both (stage 1) or tower (stage 2), fused_ln and use_pallas, on the kernels'
plain versions; the JAX trainers their unfused modules, jitted over a
2-device data mesh of the 8-device CPU platform (Stage1Trainer /
FusionTrainer with num_devices 2: the batch sharded, the parameters
replicated), which computes what one device computes on the global batch.

Tolerances: gradients before the optimizer |g_port - g_jax| <= 1e-4 max
|g_jax| + 1e-6 G per parameter, G the model's largest gradient element
(the second term holds gradients that are zero in exact arithmetic to
their rounding noise), the same rule against the port on one process;
metrics rtol 1e-5; after one step the BN statistics 1e-6 (+ 1e-6
relative), the SGD group lr times the gradient tolerance, and an Adam
element 1e-6 (+ 1e-6 relative) where its effective gradient is clearly
signed and 2 lr elsewhere (an Adam first step moves an element by at most
lr whatever the sign of a noise-level gradient); pair scores and
embeddings 1e-5 against one process; sharded_margin_ce value rtol 1e-5 and
gradients rtol 1e-4 + atol 1e-6 against JAX's on a 2-device mesh and the
dense head. Deviation from the JAX package: a world size that does not
divide batch_size is refused (config.check_world), where JAX shrinks its
mesh until it divides; a launched world cannot shrink.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from text_guided_face_recognition_tpu.config import TGFRConfig as JConfig
from text_guided_face_recognition_tpu.data.loader import (
    DataLoader as JLoader)
from text_guided_face_recognition_tpu.engine import prepare as jprep
from text_guided_face_recognition_tpu.engine import stage1 as jstage1
from text_guided_face_recognition_tpu.engine import stage2 as jstage2
from text_guided_face_recognition_tpu.models import text_bert as jtb
from text_guided_face_recognition_tpu.parallel import make_mesh, shard_batch
from text_guided_face_recognition_tpu.parallel.partial_fc import (
    sharded_margin_ce as j_sharded_margin_ce)
from text_guided_face_recognition_tpu_torch import models as PM
from text_guided_face_recognition_tpu_torch import ops as pops
from text_guided_face_recognition_tpu_torch.config import (
    TGFRConfig as PConfig, check_serving, check_stage1, check_stage2,
    check_world)
from text_guided_face_recognition_tpu_torch.data.loader import (
    DataLoader as PLoader)
from text_guided_face_recognition_tpu_torch.engine import optim as poptim
from text_guided_face_recognition_tpu_torch.engine.from_jax import (
    state_dict_from_jax)
from text_guided_face_recognition_tpu_torch.engine.stage1 import (
    Stage1Trainer as PStage1)
from text_guided_face_recognition_tpu_torch.engine.stage2 import (
    FusionTrainer as PStage2)
from text_guided_face_recognition_tpu_torch.engine.trainer import fold_seeds
from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
from text_guided_face_recognition_tpu_torch.parallel import mesh

from _torch_port import TINY, to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dp_worker.py")
WORLD = 2
B, T, CLASSES = 4, 12, 16
LR1 = {"head": 1e-3, "encoder": 2e-5, "cls": 0.1}
WD1 = {"head": 0.0, "encoder": 0.01, "cls": 5e-5}
LR2 = {"cls": 0.01, "encoder": 1e-5, "head": 1e-3}
WD2 = {"cls": 5e-4, "encoder": 0.01, "head": 5e-5}
PAIRS = 13          # odd: the last pair batch of 5 is short, both pad


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base(**kw):
    base = dict(en_type="BERT", synthetic=True, batch_size=B, num_workers=2,
                compute_dtype="float32", bert_type="tiny0",
                captions_per_image=2, manual_seed=0, num_classes=CLASSES,
                bert_words_num=T, checkpoints_path="",
                adam_moments_dtype="float32", fused_dropout=True)
    base.update(kw)
    return base


def _cfgs(port, jax_, **kw):
    """(JAX config on a 2-device mesh, port config of the ranks, port
    config of one process)."""
    base = _base(**kw)
    return (JConfig().replace(**base, **jax_, num_devices=WORLD),
            dict(base, **port, num_devices=WORLD),
            PConfig().replace(**base, **port))


STAGE1 = _cfgs(dict(fused_block="both", fused_ln=True, use_pallas=True),
               dict(fused_block="none"), lr_head=LR1["head"],
               min_lr_bert=LR1["encoder"])
STAGE2 = _cfgs(dict(fused_block="tower", fused_ln=True),
               dict(fused_block="none"), lr_head=LR2["head"],
               lr_image_train=LR2["cls"], weight_decay=WD2["cls"],
               fusion_type="fcfm", loss="focal_loss", text_encoder_path="",
               image_encoder_path="")
HOST = _base(bert_type="tiny", fused_block="both", fused_ln=True,
             use_pallas=True, frozen_feature_cache=True,
             feature_cache_batch=8)
PRNG = dict(HOST, fused_dropout=False, frozen_feature_cache=False)
SERVE = _base(batch_size=5, fusion_type="fcfm", fusion_final_dim=640,
              fused_block="both", fused_ln=True, is_ident=False,
              is_roc=False)


def _batch():
    """The global batch: numpy, port layout (NCHW local map); a class
    shared across the two ranks' rows."""
    rng = np.random.default_rng(0)
    caps = rng.integers(1000, 30000, (B, T)).astype(np.int32)
    caps[:, 0] = 101
    mask = np.ones((B, T), np.int32)
    mask[1, 9:] = 0
    mask[2, 6:] = 0
    cls = np.array([0, 3, 3, 7], np.int32)
    gl = rng.normal(size=(B, 512)).astype(np.float32)
    lc = rng.normal(size=(B, 256, 14, 14)).astype(np.float32)
    return dict(caps=caps, mask=mask, cls_id=cls, img_gl=gl, img_lc=lc)


def _jax_batch(b, mesh_):
    jb = dict(b, img_lc=np.ascontiguousarray(b["img_lc"].transpose(
        0, 2, 3, 1)))
    return shard_batch({k: jnp.asarray(v) for k, v in jb.items()}, mesh_)


def _jax_side(jtrainer, batch):
    """The JAX trainer's loss, metrics and gradients, jitted over its data
    mesh, and its own jitted train step there (a copy of the state)."""
    assert jtrainer.mesh is not None and jtrainer.mesh.size == WORLD
    jb = _jax_batch(batch, jtrainer.mesh)
    st = jtrainer.state
    (loss, (stats, metrics)), grads = jax.jit(jax.value_and_grad(
        jtrainer.build_loss_fn(), has_aux=True))(
            st.params, st.batch_stats, jb, {}, jax.random.PRNGKey(0))
    new, _ = jtrainer._train_step(jax.tree_util.tree_map(jnp.copy, st), jb,
                                  {}, jax.random.PRNGKey(0))
    return dict(loss=float(loss), stats=stats, grads=grads,
                metrics={k: float(v) for k, v in metrics.items()},
                new=new)


def _pfc_cases():
    rng = np.random.default_rng(3)
    cases = []
    for head, kind, pad in (("arcface", "ce", 0), ("arcface", "focal", 0),
                            ("cosface", "ce", 0), ("cosface", "focal", 0),
                            ("arcface", "ce", 3)):
        c = 12
        kw = dict(head=head, loss_kind=kind)
        if pad:
            kw["num_classes"] = c - pad
        cases.append(dict(
            emb=rng.normal(size=(8, 16)).astype(np.float32),
            w=rng.normal(size=(c, 16)).astype(np.float32),
            label=rng.integers(0, c - pad, size=8).astype(np.int64), kw=kw))
    return cases


def _jax_pfc(case):
    """JAX's sharded_margin_ce on a 2-device mesh: value, d/demb, d/dw."""
    m = make_mesh(WORLD)

    @partial(jax.shard_map, mesh=m, in_specs=(P("data"), P("data", None),
                                               P("data")),
             out_specs=P(), check_vma=False)
    def f(emb, w, label):
        return j_sharded_margin_ce(emb, w, label, "data", **case["kw"])

    label = jnp.asarray(case["label"].astype(np.int32))
    v, g = jax.jit(jax.value_and_grad(lambda e, w: f(e, w, label),
                                      argnums=(0, 1)))(
        jnp.asarray(case["emb"]), jnp.asarray(case["w"]))
    return float(v), np.asarray(g[0]), np.asarray(g[1])


def _dense_pfc(case):
    """The dense head on the whole batch and the true classes (the port's
    ArcFace logits; cosface written out): value, d/demb, d/dw (zero on
    padded class rows)."""
    kw = case["kw"]
    c = kw.get("num_classes", case["w"].shape[0])
    emb, w = (torch.from_numpy(case[k]).requires_grad_(True)
              for k in ("emb", "w"))
    label = torch.from_numpy(case["label"])
    if kw["head"] == "arcface":
        logits = pops.arc_margin_logits(emb, w[:c], label)
    else:
        cos = pops.normalized_cosine(emb, w[:c])
        hot = torch.nn.functional.one_hot(label, c).float()
        logits = (hot * (cos - 0.5) + (1.0 - hot) * cos) * 30.0
    loss = (pops.focal_loss(logits, label) if kw["loss_kind"] == "focal"
            else pops.cross_entropy_rows(logits, label))
    loss.backward()
    return float(loss), emb.grad.numpy(), w.grad.numpy()


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Starts the pod (two ranks) and the one-process references (a third
    process), builds the JAX trainers and hands the ranks their weights,
    runs the JAX side meanwhile, waits for all three and returns
    everything."""
    work = tmp_path_factory.mktemp("dp")
    inputs = {"tiny": TINY, "host_bits": dict(cfg=HOST),
              "prng": dict(cfg=PRNG), "serve": dict(cfg=SERVE, pairs=PAIRS),
              "pfc": dict(cases=_pfc_cases())}
    torch.save(inputs, work / "inputs.pt")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
        "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(w), port, str(work)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r, w in ((0, WORLD), (1, WORLD), (0, 1))]
    outs = []
    try:
        with pytest.MonkeyPatch.context() as mp:
            for archs in (jtb.TEXT_ARCHS, ptb.TEXT_ARCHS):
                arch = type(archs["bert"])(**TINY)
                mp.setitem(archs, "tiny", arch)
                mp.setitem(archs, "tiny0",
                           dataclasses.replace(arch, dropout=0.0))
            mp.setattr(jprep, "prepare_backbone",
                       lambda args: jprep.Bundle(None, {}))
            mp.setattr(PM, "iresnet18",
                       lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw))
            batch = _batch()
            j1, j2 = (jstage1.Stage1Trainer(STAGE1[0]),
                      jstage2.FusionTrainer(STAGE2[0]))
            stages = {f"stage{i}": dict(cfg=cfg[1], batch=batch,
                                        params=to_numpy(j.state.params),
                                        stats=to_numpy(j.state.batch_stats))
                      for i, j, cfg in ((1, j1, STAGE1), (2, j2, STAGE2))}
            torch.save(stages, work / "stages.tmp")
            os.replace(work / "stages.tmp", work / "stages.pt")
            ref = {"jax1": _jax_side(j1, batch), "jax2": _jax_side(j2, batch),
                   "jpfc": [_jax_pfc(c) for c in inputs["pfc"]["cases"]],
                   "dense": [_dense_pfc(c) for c in inputs["pfc"]["cases"]],
                   "p1": PStage1(STAGE1[2], torch.device("cpu")),
                   "p2": PStage2(STAGE2[2], torch.device("cpu"))}
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:             # a hung rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out[-6000:]}"
        assert "DP_WORKER_OK" in out, out[-4000:]
    ref["ranks"] = [torch.load(work / f"rank{r}.pt", weights_only=False)
                    for r in range(WORLD)]
    ref.update(torch.load(work / "one.pt", weights_only=False))
    ref["work"], ref["inputs"] = work, dict(inputs, **stages)
    return ref


# ------------------------------------------------------------ checks --

def _grad_errors(grads, gsd, names):
    """{name: (error, allowed)} under the module docstring's rule."""
    big = max(float(np.abs(gsd[n].numpy()).max()) for n in names)
    out = {}
    for n in names:
        g_j = gsd[n].numpy()
        err = float(np.abs(grads[n].numpy() - g_j).max())
        out[n] = (err, 1e-4 * float(np.abs(g_j).max()) + 1e-6 * big)
    return out


def _check_grads(grads, gsd, names):
    bad = {n: e for n, e in _grad_errors(grads, gsd, names).items()
           if e[0] > e[1]}
    assert not bad, bad


def _check_after(after, want, old, gsd, names, groups, lr, wd):
    """The state after one step (module docstring)."""
    big = max(float(np.abs(gsd[n].numpy()).max()) for n in names)
    for name, w in want.items():
        w, g = w.numpy(), after[name].numpy()
        err = np.abs(g - w)
        tight = 1e-6 + 1e-6 * np.abs(w)
        if "running_" in name:
            assert (err <= tight).all(), (name, err.max())
            continue
        group = groups[name.split(".")[0]]
        if group == "cls":
            gmax = np.abs(gsd[name].numpy()).max()
            assert (err <= tight + lr[group] * (1e-4 * gmax + 1e-6 * big)
                    ).all(), (name, err.max())
            continue
        geff = gsd[name].numpy() + wd[group] * old[name].numpy()
        signed = np.abs(geff) > max(1e-4 * np.abs(geff).max(), 1e-6 * big)
        assert (err[signed] <= tight[signed]).all(), (name, err.max())
        assert (err[~signed] <= 2.0 * lr[group] + 1e-6).all(), name


def _stage(pod, stage):
    """(the ranks' results, the JAX side, its gradients and the state after
    its step in the port's layout, the initial state, parameter names)."""
    ranks = [r[f"stage{stage}"] for r in pod["ranks"]]
    j, pt = pod[f"jax{stage}"], pod[f"p{stage}"]
    # stage 1's loss returns the image head's statistics alone
    stats = {"image_head": j["stats"]} if stage == 1 else j["stats"]
    gsd = state_dict_from_jax(to_numpy(j["grads"]), to_numpy(stats),
                              module=pt.model)
    names = [n for n, _ in pt.model.named_parameters()]
    return ranks, j, gsd, names, pt


@pytest.mark.parametrize("stage", [1, 2])
def test_rank_gradients_match_jax_data_mesh(pod, stage):
    """Every parameter's gradient on every rank, before the optimizer,
    against the JAX trainer's over its 2-device data mesh: the towers'
    summed over the ranks, the heads after the gather whole on each rank,
    global-batch BatchNorm; the ranks hold the same gradients."""
    ranks, _, gsd, names, _ = _stage(pod, stage)
    for r in ranks:
        _check_grads(r["grads"], gsd, names)
    for n in names:
        torch.testing.assert_close(ranks[0]["grads"][n], ranks[1]["grads"][n],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("stage", [1, 2])
def test_rank_metrics_match_jax_data_mesh(pod, stage):
    """The global loss and metrics (stage 2: the focal loss's batch mean
    over the global batch), the same on both ranks."""
    ranks, j, _, _, _ = _stage(pod, stage)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], j["loss"], rtol=1e-5)
        assert set(r["metrics"]) == set(j["metrics"])
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, j["metrics"][k], rtol=1e-5,
                                       err_msg=k)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


@pytest.mark.parametrize("stage", [1, 2])
def test_rank_state_after_step_matches_jax_train_step(pod, stage):
    """BatchNorm running statistics (global-batch) and every parameter after
    one optimizer step against the JAX trainer's jitted step over its
    data mesh; the ranks hold the same state."""
    ranks, j, gsd, names, pt = _stage(pod, stage)
    want = state_dict_from_jax(to_numpy(j["new"].params),
                               to_numpy(j["new"].batch_stats),
                               module=pt.model)
    spec = pod["inputs"][f"stage{stage}"]
    old = state_dict_from_jax(spec["params"], spec["stats"], module=pt.model)
    groups = poptim.GROUPS if stage == 1 else poptim.STAGE2_GROUPS
    lr, wd = (LR1, WD1) if stage == 1 else (LR2, WD2)
    for r in ranks:
        _check_after(r["after"], want, old, gsd, names, groups, lr, wd)
    for k, v in ranks[0]["after"].items():
        torch.testing.assert_close(v, ranks[1]["after"][k], rtol=0, atol=0)


def test_gather_summing_its_backward_fails_the_gradient_check(pod):
    """The trap: a gather whose backward sums the cotangents over the ranks
    (as torch.distributed.nn's all_gather does) hands the towers N times
    their gradient; the check above must catch it."""
    ranks, _, gsd, names, _ = _stage(pod, 1)
    fault = pod["ranks"][0]["stage1_fault"]
    np.testing.assert_allclose(fault["loss"], ranks[0]["loss"], rtol=1e-6)
    errors = _grad_errors(fault["grads"], gsd, names)
    bad = [n for n, (e, tol) in errors.items() if e > tol]
    assert any(n.startswith("text_encoder.") for n in bad), errors
    assert not any(n.startswith(("image_cls", "text_cls")) for n in bad)


def test_host_bits_step_equals_one_process_with_feature_cache(pod):
    """Host-bits dropout (each rank takes its rows of the global draw, the
    attention probabilities' (heads, B, T, T) layout among them) and the
    frozen-feature cache refreshed over each rank's rows, in the second
    epoch (the other ranks' rows counted as visits in the first): each
    rank's rows, features, metrics and gradients equal the one-process
    step's on the same global batch and bits."""
    one = pod["host_bits"]
    bl = B // WORLD
    for r, got in enumerate(x["host_bits"] for x in pod["ranks"]):
        rows = slice(r * bl, (r + 1) * bl)
        assert got["batches"] == one["batches"] == 64 // B
        assert got["keys"] == one["keys"][rows]
        torch.testing.assert_close(got["cls_id"], one["cls_id"][rows])
        torch.testing.assert_close(got["img_gl"], one["img_gl"][rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        for k, v in got["metrics"].items():
            np.testing.assert_allclose(v, one["metrics"][k], rtol=1e-5,
                                       err_msg=k)
        _check_grads(got["grads"], one["grads"], list(one["grads"]))


def test_prng_mode_ranks_draw_their_own_masks(pod):
    """prng mode: the host bits (the embeddings') are each rank's rows of
    the one-process draw; the kernels' seeds are folded with the rank
    (rank 0 keeps them), so the two ranks' in-kernel masks differ."""
    one = pod["prng"]
    r0, r1 = (x["prng"] for x in pod["ranks"])
    bl = B // WORLD
    for r, got in enumerate((r0, r1)):
        want = one["bits"].view(B, -1)[r * bl:(r + 1) * bl].reshape(-1)
        torch.testing.assert_close(got["bits"], want, rtol=0, atol=0)
        torch.testing.assert_close(got["seeds"], fold_seeds(one["seeds"], r),
                                   rtol=0, atol=0)
    torch.testing.assert_close(r0["seeds"], one["seeds"], rtol=0, atol=0)
    assert (r0["seeds"] != r1["seeds"]).all()
    assert (r0["seeds"] >= 0).all() and (r1["seeds"] >= 0).all()
    assert not torch.equal(r0["mask"], r1["mask"])


def test_sharded_run_test_equals_one_process(pod):
    """An odd pair count in pair batches of 5 (each padded to a multiple of
    2 and the padding dropped): scores, table-mode scores and metrics
    against one process; rank 1 returns no metrics."""
    one = pod["serve"]
    assert len(one["preds"]) == PAIRS
    for got in (x["serve"] for x in pod["ranks"]):
        np.testing.assert_allclose(got["preds"], one["preds"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["table"], one["table"], rtol=1e-5,
                                   atol=1e-5)
        assert got["labels"] == one["labels"]
    m0, m1 = (x["serve"]["metrics"] for x in pod["ranks"])
    assert m1 == {} and set(m0) == set(one["metrics"])
    for k, v in m0.items():
        np.testing.assert_allclose(v, one["metrics"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_sharded_extraction_equals_one_process(pod):
    """Every embedding on every rank against one process; rank 0 alone
    writes the .npz."""
    one = pod["serve"]
    for got in (x["serve"] for x in pod["ranks"]):
        assert got["keys"] == one["keys"]
        np.testing.assert_allclose(got["embeddings"], one["embeddings"],
                                   rtol=1e-5, atol=1e-5)
    with np.load(pod["work"] / "ranks" / "emb.npz") as f:
        np.testing.assert_array_equal(f["embeddings"],
                                      pod["ranks"][0]["serve"]["embeddings"])


@pytest.mark.parametrize("case", range(5), ids=[
    "arcface-ce", "arcface-focal", "cosface-ce", "cosface-focal",
    "arcface-ce-padded"])
def test_sharded_margin_ce_matches_jax_and_dense(pod, case):
    """Value and gradients (this rank's embedding rows, its class shard)
    against JAX's sharded_margin_ce on a 2-device mesh and against the
    dense head; padded class rows take a zero gradient."""
    spec = pod["inputs"]["pfc"]["cases"][case]
    bl, cl = 8 // WORLD, spec["w"].shape[0] // WORLD
    for ref in (pod["jpfc"][case], pod["dense"][case]):
        v, g_emb, g_w = ref
        for r, got in enumerate(x["pfc"][case] for x in pod["ranks"]):
            np.testing.assert_allclose(got["loss"], v, rtol=1e-5)
            np.testing.assert_allclose(got["g_emb"].numpy(),
                                       g_emb[r * bl:(r + 1) * bl],
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got["g_w"].numpy(),
                                       g_w[r * cl:(r + 1) * cl],
                                       rtol=1e-4, atol=1e-6)
    pad = spec["w"].shape[0] - spec["kw"].get("num_classes",
                                              spec["w"].shape[0])
    if pad:
        assert (pod["ranks"][-1]["pfc"][case]["g_w"][-pad:] == 0).all()


def test_sharded_margin_ce_is_the_dense_head_on_one_process():
    """Without a process group it is the port's dense ArcFace head."""
    rng = np.random.default_rng(1)
    emb = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    label = torch.tensor([0, 1, 4, 4, 2, 3])
    from text_guided_face_recognition_tpu_torch.parallel import (
        sharded_margin_ce)
    for kind, loss in (("ce", pops.cross_entropy_rows),
                       ("focal", pops.focal_loss)):
        got = sharded_margin_ce(emb, w, label, loss_kind=kind)
        want = loss(pops.arc_margin_logits(emb, w, label), label)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _collective_want(name: str, rank: int):
    """(value, gradient) of tests/_torch_dp_worker._collectives' op on rank
    `rank`: x_r = (r + 1) ones(2, 3), the loss sum(out * coef_r), coef_r =
    (r + 1) arange(out's size)."""
    ones = torch.ones(2, 3)
    xs = [(r + 1) * ones for r in range(WORLD)]

    def coef(r, shape):
        return (r + 1) * torch.arange(float(np.prod(shape))).view(shape)

    if name in ("psum", "psum_mean", "sync_sum"):
        total = sum(xs)
        value = total / WORLD if name == "psum_mean" else total
        c = coef(rank, (2, 3))
        grad = {"psum": c, "psum_mean": c / WORLD,
                "sync_sum": sum(coef(r, (2, 3)) for r in range(WORLD))}[name]
        return value, grad
    value = torch.cat(xs)
    rows = slice(2 * rank, 2 * rank + 2)
    if name == "gather_global_negatives":
        return value, coef(rank, (2 * WORLD, 3))[rows]
    return value, sum(coef(r, (2 * WORLD, 3)) for r in range(WORLD))[rows]


@pytest.mark.parametrize("name", [
    "psum", "psum_mean", "sync_sum", "gather_global_negatives",
    "gather_rows_summed"])
def test_differentiable_collectives(pod, name):
    """Each collective's value and the backward its consumer calls for
    (parallel/contrastive.py): the gather for a loss every rank evaluates
    whole takes its rows of the cotangent, the one for split consumers
    sums them over the ranks first; psum hands the cotangent through,
    psum_mean 1/N of it, sync_sum sums it over the ranks. Exact."""
    for r, got in enumerate(x["collectives"] for x in pod["ranks"]):
        value, grad = got[name]
        want_v, want_g = _collective_want(name, r)
        torch.testing.assert_close(value, want_v, rtol=0, atol=0)
        torch.testing.assert_close(grad, want_g, rtol=0, atol=0)


def test_local_diag_labels(pod):
    """Each rank's matching-pair columns in the gathered batch."""
    for r, got in enumerate(x["collectives"] for x in pod["ranks"]):
        assert got["labels"].tolist() == [3 * r, 3 * r + 1, 3 * r + 2]


# ------------------------------------------------ no processes needed --

SHARDS = [(0, 1), (0, 2), (1, 2), (0, 4), (3, 4)]


@pytest.mark.parametrize("index,count", SHARDS)
def test_process_shard_rows_match_jax(index, count):
    """Each process's rows of every global batch, two epochs of a seeded
    shuffle, against the JAX loader's `_batch_indices`."""
    data = list(range(37))
    jl = JLoader(data, 8, shuffle=True, drop_last=True, seed=5,
                 process_shard=(index, count))
    pl = PLoader(data, 8, shuffle=True, drop_last=True, seed=5,
                 process_shard=(index, count))
    for _ in range(2):
        want = [b.tolist() for b in jl._batch_indices()]
        assert [b.tolist() for b in pl._batch_indices()] == want
        assert len(want) == 4 and all(len(b) == 8 // count for b in want)


def test_epoch_rows_draw_the_coming_epoch():
    """epoch_rows names the rows the next iteration yields (and draws that
    epoch's order once)."""
    data = list(range(20))
    pl = PLoader(data, 4, shuffle=True, drop_last=True, seed=2,
                 process_shard=(1, 2))
    ref = PLoader(data, 4, shuffle=True, drop_last=True, seed=2,
                  process_shard=(1, 2))
    for _ in range(2):
        rows = pl.epoch_rows()
        np.testing.assert_array_equal(pl.epoch_rows(), rows)
        got = np.concatenate(list(pl._batch_indices()))
        np.testing.assert_array_equal(got, rows)
        np.testing.assert_array_equal(
            got, np.concatenate(list(ref._batch_indices())))


@pytest.mark.parametrize("shard,batch,drop_last", [
    ((2, 2), 8, True), ((-1, 2), 8, True), ((0, 3), 8, True),
    ((0, 2), 8, False)])
def test_process_shard_refusals_match_jax(shard, batch, drop_last):
    data = list(range(16))
    with pytest.raises(ValueError) as want:
        JLoader(data, batch, drop_last=drop_last, process_shard=shard)
    with pytest.raises(ValueError) as got:
        PLoader(data, batch, drop_last=drop_last, process_shard=shard)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("check", [check_stage1, check_stage2,
                                   check_serving])
def test_num_devices_other_than_the_world_is_refused(check):
    """num_devices 0 is the world size; another value must equal it."""
    cfg = PConfig().replace(num_devices=2, fusion_type="fcfm")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        check(cfg)
    assert check_world(cfg, world=2) == 2
    assert check_world(cfg.replace(num_devices=0), world=3,
                       batch=False) == 3


def test_indivisible_batch_is_refused():
    """A world that does not split batch_size is refused in training (the
    JAX package shrinks its mesh instead); serving pads."""
    cfg = PConfig().replace(batch_size=5)
    with pytest.raises(ValueError, match="does not split evenly over 2"):
        check_world(cfg, world=2)
    assert check_world(cfg, world=2, batch=False) == 2
    assert check_world(cfg.replace(batch_size=6), world=2) == 2


def test_ranks_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    """Under a launcher, a rank without CUDA raises (no CPU fallback);
    without a process group every helper answers for one rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_from_env(cpu=False)
    assert not mesh.active()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main(),
            mesh.backend()) == (0, 1, True, None)
    x = torch.arange(3)
    assert mesh.all_gather_rows(x) is x


@pytest.mark.parametrize("n,world", [(5, 2), (8, 2), (7, 3), (1, 2)])
def test_eval_loader_row_shard_splits_the_loading(n, world):
    """An eval loader with row_shard loads only its rank's rows of each
    batch (padded by repeating row 0, as the JAX package's `_shard_eval`),
    every batch names the whole batch's rows, and the ranks' rows in rank
    order, cut to the batch, are the whole batch."""
    data = [{"x": np.int64(i)} for i in range(n + 4)]
    whole = [b["x"].tolist() for b in PLoader(data, n, num_workers=1)]
    per_rank = [list(PLoader(data, n, num_workers=1,
                             row_shard=(r, world))) for r in range(world)]
    for k, want in enumerate(whole):
        parts = [per_rank[r][k] for r in range(world)]
        per = -(-len(want) // world)
        assert all(len(p["x"]) == per for p in parts)
        assert [p["global_rows"].tolist() for p in parts] == [want] * world
        got = np.concatenate([p["x"] for p in parts]).tolist()
        assert got[:len(want)] == want
        assert got[len(want):] == [want[0]] * (per * world - len(want))
    with pytest.raises(ValueError, match="row_shard"):
        PLoader(data, n, shuffle=True, row_shard=(0, world))


def test_feature_cache_holds_its_rows_alone(monkeypatch):
    """With a rank's rows the cache holds those rows and no others (host
    bytes of len(rows) images), each equal to the whole refresh's row,
    and the dataset hands them out by index; another rank's index raises
    instead of reading a wrong row."""
    from text_guided_face_recognition_tpu_torch.engine import feature_cache
    from text_guided_face_recognition_tpu_torch.engine import prepare as pp

    monkeypatch.setattr(feature_cache, "backbone_features", lambda b, t, x: (
        x.float().mean((1, 2, 3))[:, None].repeat(1, 3),
        x[:, :2, :2, :].float()))
    cfg = PConfig().replace(**HOST)
    _, ds = pp.prepare_dataloader(cfg, "train")
    whole = feature_cache.FrozenFeatureCache(None, cfg, torch.device("cpu"))
    whole.refresh(ds)
    mine = feature_cache.FrozenFeatureCache(None, cfg, torch.device("cpu"))
    rows = np.asarray([9, 2, 5, 2, 14])
    mine.refresh(ds, rows)
    held = np.unique(rows)
    assert mine.gl.shape[0] == len(held)
    assert mine.host_bytes() * len(ds) == whole.host_bytes() * len(held)
    assert torch.equal(mine.gl, whole.gl[held])
    assert torch.equal(mine.lc, whole.lc[held])
    assert torch.equal(torch.as_tensor(ds[5]["img_gl"]), whole.gl[5])
    with pytest.raises(KeyError, match="another rank"):
        ds[3]


def test_launched_process_joins_its_group_at_world_one(monkeypatch):
    """Under a launcher's variables one rank joins a group too (the
    data-parallel step over one rank), and prepare.resolve_device answers
    through the same rule; without them nothing joins."""
    from text_guided_face_recognition_tpu_torch.engine import prepare as pp

    for name in ("RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pp.resolve_device(True).type == "cpu" and not mesh.active()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert mesh.init_from_env(cpu=True).type == "cpu"
        assert mesh.active() and (mesh.backend(), mesh.world_size(),
                                  mesh.rank()) == ("gloo", 1, 0)
        assert pp.resolve_device(True).type == "cpu"
    finally:
        mesh.shutdown()
    assert not mesh.active()


def test_entry_point_closes_its_trainer_before_leaving_the_group(
        monkeypatch):
    """cli.run closes what main returns (a trainer's captured step) before
    it leaves the process group, also when main fails."""
    from text_guided_face_recognition_tpu_torch import cli

    calls = []
    monkeypatch.setattr(mesh, "shutdown", lambda: calls.append("leave"))

    class Trainer:
        def close(self):
            calls.append("close")

    cli.run(lambda: Trainer())
    assert calls == ["close", "leave"]
    calls.clear()
    with pytest.raises(ZeroDivisionError):
        cli.run(lambda: 1 / 0)
    assert calls == ["leave"]
