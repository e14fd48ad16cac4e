"""One rank of a two-rank stage-1 step of a pre-LN text arch
(tests/test_torch_text_archs.py).

  python tests/_torch_dp_archs.py RANK WORLD PORT WORKDIR

Joins the gloo process group as torchrun would set it up, registers the
small arch of WORKDIR/inputs.pt under its bert_type, and runs the stage-1
step of tests/_torch_dp_worker.py (`_step`: this rank's rows of the global
batch, the gradients before the optimizer) on the given weights, into
WORKDIR/rank{RANK}.pt; prints DP_ARCHS_OK on success. Imports no JAX.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    rank, world, port, workdir = (int(argv[1]), int(argv[2]), argv[3],
                                  argv[4])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    torch.set_num_threads(2)
    from _torch_dp_worker import _step
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.models import text_bert as ptb
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    ptb.TEXT_ARCHS[inputs["bert_type"]] = ptb.TextArch(**inputs["arch"])
    device = mesh.init_from_env(cpu=True)
    assert mesh.backend() == "gloo" and mesh.world_size() == world
    out = _step(Stage1Trainer, inputs["stage1"], rank, world)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.barrier()
    mesh.shutdown()
    print(f"DP_ARCHS_OK rank={rank} device={device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
