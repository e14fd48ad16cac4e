"""One rank of the pod of tests/test_torch_spmd.py: the port's explicit
shard_map steps and its class-sharded (partial-FC) stage-2 step.

  python tests/_torch_spmd_worker.py RANK WORLD PORT WORKDIR

Joins the gloo process group as torchrun would set it up (parallel/mesh.
init_from_env(cpu=True)), waits for WORKDIR/spec.pt (the JAX weights of
both stages, the global batch, the configurations, an exported JAX
stage-2 train state), runs every scenario on the CPU and writes its
results to WORKDIR/rank{RANK}.pt; prints SPMD_WORKER_OK on success.
Imports no JAX.

Scenarios, each from the JAX weights on this rank's rows of the global
batch: a step of the stage-1 shard_map mode in f32 and with grads_dtype
bfloat16, of the stage-2 shard_map mode and of the partial-FC mode (the
gradients after the collectives, the loss and metrics, the state after
the optimizer and the BatchNorm averaging); the stage-1 step with two
planted faults (the modules after the gather among the summed ones, the
running statistics left unaveraged); the class-sharded state's shapes;
the partial-FC train state against the replicated layout's, written before
and after a step; a partial-FC trainer resumed from the replicated
layout's file and from the exported JAX state.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from _torch_dp_worker import _grads, _local  # noqa: E402


def _trainer(cls, stage_spec, load: bool = True, **over):
    """A trainer of the stage's configuration (with `over`) on the CPU,
    holding the JAX weights when `load`."""
    import torch

    from text_guided_face_recognition_tpu_torch.config import TGFRConfig
    from text_guided_face_recognition_tpu_torch.engine.from_jax import (
        state_dict_from_jax)

    tr = cls(TGFRConfig().replace(**dict(stage_spec["cfg"], **over)),
             torch.device("cpu"))
    if load:
        tr.model.load_state_dict(state_dict_from_jax(
            stage_spec["params"], stage_spec["stats"], module=tr.model))
    return tr


def _step(tr, spec, rank, world):
    """compute_grads on this rank's rows (the gradients after the
    collectives), then the optimizer and the statistics' averaging."""
    batch = _local(spec["batch"], rank, world)
    total, metrics = tr.compute_grads(batch)
    out = {"loss": float(total),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _grads(tr.model)}
    tr._optimizer_step()
    out["after"] = {k: v.clone() for k, v in tr.train_state()[
        "model"].items()}
    return out


def main(argv) -> int:
    rank, world, port, workdir = (int(argv[1]), int(argv[2]), argv[3],
                                  argv[4])
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
    from text_guided_face_recognition_tpu_torch.parallel import (
        make_partial_fc_fusion_step, make_shardmap_fusion_step,
        make_shardmap_train_step, mesh)

    device = mesh.init_from_env(cpu=True)
    assert device.type == "cpu" and mesh.backend() == "gloo"
    path = os.path.join(workdir, "spec.pt")
    deadline = time.time() + 600
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.2)
    spec = torch.load(path, weights_only=False)
    arch = ptb.TextArch(**spec["tiny"])
    ptb.TEXT_ARCHS["tiny0"] = dataclasses.replace(arch, dropout=0.0)
    PM.iresnet18 = lambda **kw: PM.IResNet(layers=(1, 1, 1, 1), **kw)
    s1, s2 = spec["stage1"], spec["stage2"]
    out = {}

    tr = _trainer(Stage1Trainer, s1)
    make_shardmap_train_step(tr)
    out["stage1"] = _step(tr, spec, rank, world)
    tr = _trainer(Stage1Trainer, s1, grads_dtype="bfloat16")
    make_shardmap_train_step(tr)
    out["stage1_bf16"] = _step(tr, spec, rank, world)
    tr = _trainer(Stage1Trainer, s1)     # fault: post-gather summed
    tr.set_mode("shard_map", post_gather=())
    out["fault_summed"] = _step(tr, spec, rank, world)
    tr = _trainer(Stage1Trainer, s1)     # fault: stats unaveraged
    make_shardmap_train_step(tr)
    tr._stats = []
    out["fault_stats"] = _step(tr, spec, rank, world)

    tr = _trainer(FusionTrainer, s2)
    make_shardmap_fusion_step(tr)
    saved = os.path.join(workdir, "replicated")
    tr.save_state(saved, 0)
    out["stage2"] = _step(tr, spec, rank, world)
    tr.save_state(saved, 1)

    tr = _trainer(FusionTrainer, s2)
    make_partial_fc_fusion_step(tr)
    out["shard"] = {
        "weight": tr.model.metric_fc.weight.detach().clone(),
        "opt": {k: tuple(t.shape) for st in tr.opt.state_dict()["cls"][
            "state"].values() for k, t in st.items()},
        "cls_count": int(tr.opt.opts["cls"].count)}
    tr.save_state(os.path.join(workdir, "sharded"), 0)
    out["pfc"] = _step(tr, spec, rank, world)
    out["pfc"]["local_weight"] = tr.model.metric_fc.weight.detach().clone()
    tr.save_state(os.path.join(workdir, "sharded"), 1)
    mesh.barrier()      # rank 0 has written the files

    resumed = {}
    for name, src in (("replicated", os.path.join(saved, "train_state_1")),
                      ("jax", spec["jax_export"])):
        tr = _trainer(FusionTrainer, s2, load=False)
        make_partial_fc_fusion_step(tr)
        tr.resume_from(src)
        resumed[name] = {"weight": tr.model.metric_fc.weight.detach().clone(),
                         "state": {k: v.clone() for k, v in
                                   tr.model.state_dict().items()},
                         "counts": {g: int(o.count)
                                    for g, o in tr.opt.opts.items()},
                         "start_epoch": tr.start_epoch}
    out["resumed"] = resumed
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.barrier()
    mesh.shutdown()
    print(f"SPMD_WORKER_OK rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
