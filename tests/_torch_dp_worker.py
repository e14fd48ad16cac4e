"""One rank of the port's data-parallel pod (tests/test_torch_parallel.py).

  python tests/_torch_dp_worker.py RANK WORLD PORT WORKDIR

Joins the gloo process group as torchrun would set it up (the RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT
variables, then parallel/mesh.init_from_env(cpu=True)), reads
WORKDIR/inputs.pt, runs every scenario on the CPU and writes its results to
WORKDIR/rank{RANK}.pt; prints DP_WORKER_OK on success. With WORLD 1 it
sets no launcher variable and joins no group (one process, the
references) and runs the scenarios that
need no weights from the test process, into WORKDIR/one.pt. Imports no
JAX: the JAX package's side of each comparison runs in the test process,
which meanwhile writes the JAX weights of the stage steps into
WORKDIR/stages.pt, for which the ranks wait.

Scenarios: a host-bits stage-1 step from the train loader with the
frozen-feature cache, in the second epoch; the prng mode's draws; sharded
pair scores, run_test and embedding extraction; sharded_margin_ce; the
differentiable collectives on small tensors; then one
stage-1 and one stage-2 step from the given weights on this rank's rows of
the given global batch (the gradients before the optimizer, the metrics,
the state after the optimizer), and the stage-1 step once more with a
planted fault (a gather whose backward sums the cotangents over the ranks).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _local(batch, rank, world):
    """This rank's rows of a global numpy batch, as tensors."""
    import torch
    out = {}
    for k, v in batch.items():
        bl = len(v) // world
        out[k] = torch.from_numpy(v[rank * bl:(rank + 1) * bl].copy())
    return out


def _grads(model):
    import torch
    return {n: (p.grad.clone() if p.grad is not None
                else torch.zeros_like(p)).detach()
            for n, p in model.named_parameters()}


def _step(cls, spec, rank, world, fault=False):
    """compute_grads on this rank's rows, then the optimizer step."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import TGFRConfig
    from text_guided_face_recognition_tpu_torch.engine import stage1
    from text_guided_face_recognition_tpu_torch.engine.from_jax import (
        state_dict_from_jax)
    from text_guided_face_recognition_tpu_torch.parallel import contrastive

    tr = cls(TGFRConfig().replace(**spec["cfg"]), torch.device("cpu"))
    tr.model.load_state_dict(state_dict_from_jax(
        spec["params"], spec["stats"], module=tr.model))
    batch = _local(spec["batch"], rank, world)
    if fault:   # the trap: a gather whose backward sums over the ranks
        saved = stage1.gather_global_negatives
        stage1.gather_global_negatives = (
            lambda x: contrastive._gather_rows(x, summed=True))
        tr.loss_fn = tr.build_loss_fn()
    try:
        total, metrics = tr.compute_grads(batch)
    finally:
        if fault:
            stage1.gather_global_negatives = saved
    out = {"loss": float(total),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _grads(tr.model)}
    if not fault:
        tr.opt.step()
        out["after"] = {k: v.clone() for k, v in
                        tr.model.state_dict().items()}
    return out


def _host_bits(spec):
    """The second epoch's first step of a host-bits stage-1 trainer with the
    frozen-feature cache: one epoch of batches consumed (visits counted),
    the cache refreshed over this rank's rows, then one step."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import TGFRConfig
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)

    tr = Stage1Trainer(TGFRConfig().replace(**spec["cfg"]),
                       torch.device("cpu"))
    n_epoch = sum(1 for _ in tr.train_dl)
    tr.refresh_features()
    it = iter(tr.train_dl)
    batch = next(it)
    it.close()
    total, metrics = tr.compute_grads(tr.to_device(batch))
    return {"batches": n_epoch, "keys": [str(k) for k in batch["key"]],
            "cls_id": torch.as_tensor(batch["cls_id"]),
            "img_gl": batch["img_gl"].clone(), "loss": float(total),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(tr.model)}


def _prng(spec, rank, world):
    """One step's dropout draw in prng mode, and the bits of the first
    layer's attention probabilities its first seed draws."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import TGFRConfig
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.ops.philox import (
        attn_stream_bits)

    args = TGFRConfig().replace(**spec["cfg"])
    tr = Stage1Trainer(args, torch.device("cpu"))
    a = tr.model.text_encoder.model.arch
    b, t = args.batch_size // world, args.bert_words_num
    bits, seeds = tr.draw_drop(b, t)
    return {"bits": bits, "seeds": seeds,
            "mask": attn_stream_bits(seeds[:1], b, t, a.hidden, a.heads)[0]}


def _serve(spec, workdir):
    """Sharded pair scores, run_test and embedding extraction."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import TGFRConfig
    from text_guided_face_recognition_tpu_torch.engine import evaluate
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.extract import (
        extract_embeddings)

    cpu = torch.device("cpu")
    args = TGFRConfig().replace(**spec["cfg"])
    dl, ds = prep.prepare_dataloader(args, "test")
    ds.imgs_pair = ds.imgs_pair[:spec["pairs"]]
    ds.pair_label = ds.pair_label[:spec["pairs"]]
    te, th = prep.prepare_text_encoder(args, cpu)
    mods = (prep.prepare_backbone(args, cpu), prep.prepare_image_head(
        args, cpu), prep.prepare_fusion_net(args, cpu), te, th)
    preds, labels = evaluate.predict_pairs(args, dl, *mods)
    metrics = evaluate.run_test(args, dl, *mods)
    table, _ = evaluate.predict_pairs(args.replace(eval_table_mode=True), dl,
                                      *mods)
    emb = extract_embeddings(args, "test", os.path.join(workdir, "emb.npz"),
                             cpu)
    return {"preds": preds, "labels": labels, "metrics": metrics,
            "table": table, "embeddings": emb["embeddings"],
            "keys": emb["keys"].tolist()}


def _pfc(spec, rank, world):
    """sharded_margin_ce's value and gradients on this rank's rows and class
    shard, per case."""
    import torch

    from text_guided_face_recognition_tpu_torch.parallel import (
        sharded_margin_ce)

    out = []
    for case in spec["cases"]:
        emb, w, label = (torch.from_numpy(case[k]) for k in ("emb", "w",
                                                               "label"))
        bl, cl = emb.shape[0] // world, w.shape[0] // world
        e = emb[rank * bl:(rank + 1) * bl].clone().requires_grad_(True)
        wl = w[rank * cl:(rank + 1) * cl].clone().requires_grad_(True)
        loss = sharded_margin_ce(e, wl, label[rank * bl:(rank + 1) * bl],
                                 **case["kw"])
        loss.backward()
        out.append({"loss": float(loss), "g_emb": e.grad, "g_w": wl.grad})
    return out


def _collectives(rank, world):
    """Each differentiable collective's value and gradient on small tensors:
    rows (rank + 1) * ones(2, 3); the gradient of sum(out * coef)."""
    import torch

    from text_guided_face_recognition_tpu_torch.parallel import contrastive

    out = {"labels": contrastive.local_diag_labels(3)}
    for name in ("psum", "psum_mean", "sync_sum", "gather_global_negatives",
                 "gather_rows_summed"):
        x = torch.full((2, 3), float(rank + 1), requires_grad=True)
        y = getattr(contrastive, name)(x)
        coef = (rank + 1) * torch.arange(y.numel(), dtype=torch.float32
                                         ).view_as(y)
        (y * coef).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def main(argv) -> int:
    rank, world, port, workdir = (int(argv[1]), int(argv[2]), argv[3],
                                  argv[4])
    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(2)
    from text_guided_face_recognition_tpu_torch import models as PM
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)
    from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    device = mesh.init_from_env(cpu=True)
    assert device.type == "cpu"
    assert mesh.backend() == ("gloo" if world > 1 else None)
    assert (mesh.rank(), mesh.world_size()) == (rank, world)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    arch = ptb.TextArch(**inputs["tiny"])
    ptb.TEXT_ARCHS["tiny"] = arch
    ptb.TEXT_ARCHS["tiny0"] = dataclasses.replace(arch, dropout=0.0)
    PM.iresnet18 = lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw)

    serve_dir = os.path.join(workdir, "one" if world == 1 else "ranks")
    os.makedirs(serve_dir, exist_ok=True)
    out = {"host_bits": _host_bits(inputs["host_bits"]),
           "prng": _prng(inputs["prng"], rank, world),
           "serve": _serve(inputs["serve"], serve_dir)}
    if world == 1:
        torch.save(out, os.path.join(workdir, "one.pt"))
        print("DP_WORKER_OK one process", flush=True)
        return 0
    out["pfc"] = _pfc(inputs["pfc"], rank, world)
    out["collectives"] = _collectives(rank, world)
    path = os.path.join(workdir, "stages.pt")
    deadline = time.time() + 600
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.2)
    stages = torch.load(path, weights_only=False)
    out.update(
        stage1=_step(Stage1Trainer, stages["stage1"], rank, world),
        stage1_fault=_step(Stage1Trainer, stages["stage1"], rank, world,
                           fault=True),
        stage2=_step(FusionTrainer, stages["stage2"], rank, world))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.barrier()
    mesh.shutdown()
    print(f"DP_WORKER_OK rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
