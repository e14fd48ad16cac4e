"""The data-parallel process group: one process per rank, launched by
`torchrun`.

Counterpart of text_guided_face_recognition_tpu/parallel/mesh.py. The JAX
package jits its step over a 1-D device mesh inside one process
(`make_data_mesh`, `shard_batch`, `prefetch_to_device`); the port runs one
process a rank, joined by `torch.distributed`, each feeding its own rows of
every global batch (data/loader.py `process_shard`). Nothing here changes
the one-device path: without a process group every helper answers for one
rank, and the trainers, the evaluation and the extraction take the code they
took before.

The backend rule (`init_from_env`):

  * on the CPU (`--cpu`, the tests): gloo;
  * one rank a card: NCCL, rank r on `cuda:LOCAL_RANK`; its collectives
    are captured in the train step's CUDA graph (engine/trainer.py);
  * more ranks on a host than cards: gloo, the ranks sharing the cards
    (`cuda:LOCAL_RANK % cards`), since NCCL refuses two ranks on one
    device. Gloo's collectives take CUDA tensors and stage them through
    the host; they cannot be captured, so a trainer asked for the
    captured step under gloo raises (the caller asks for eager steps).

A launched process (MASTER_ADDR and WORLD_SIZE set, as torchrun sets
them) joins its group at any world size, one rank too: `torchrun
--nproc_per_node 1` runs the data-parallel step, its collectives over one
rank. `init_from_env` is also the port's one rule for the device a process
runs on (engine/prepare.py `resolve_device` is it).

`num_devices` in the config: 0 is the launcher's world size (1 without
torchrun); any other value must equal it (config.py `check_world`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["active", "world_size", "rank", "is_main", "backend",
           "init_from_env", "init_group", "shutdown", "barrier",
           "all_gather_rows", "all_reduce_sum_", "shard_positions",
           "sync_batchnorm"]


def active() -> bool:
    """A process group is up: the trainers take their data-parallel path
    (also at world size 1, as the one-rank NCCL check does)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    """Rank 0, which alone writes checkpoints, embeddings and metrics."""
    return rank() == 0


def backend() -> Optional[str]:
    return str(dist.get_backend()) if active() else None


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def init_group(device: torch.device, backend_name: str, rank_: int,
               world: int, init_method: str = "env://") -> torch.device:
    """Join the process group (`backend_name` nccl or gloo) as `rank_` of
    `world` on `device`; returns the device. A process that already
    joined one keeps it, and must ask for the same."""
    if active():
        if (dist.get_rank(), dist.get_world_size(), backend()) != (
                rank_, world, backend_name):
            raise RuntimeError(
                f"a process group is up as rank {dist.get_rank()} of "
                f"{dist.get_world_size()} ({backend()}); asked for rank "
                f"{rank_} of {world} ({backend_name})")
        return device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_name, init_method=init_method,
                            rank=rank_, world_size=world)
    return device


def launched() -> bool:
    """A launcher's variables are set (torchrun sets both)."""
    return bool(os.environ.get("MASTER_ADDR")) and bool(
        os.environ.get("WORLD_SIZE"))


def init_from_env(cpu: bool = False) -> torch.device:
    """This process's device, joining the process group of a launch
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; module docstring) with the backend rule of the module
    docstring. Without a launcher: the CUDA card, or the CPU when asked
    for; never a silent CPU fallback."""
    world = _env_int("WORLD_SIZE", 1)
    join = world > 1 or launched()
    if cpu:
        device = torch.device("cpu")
        name = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the port runs on an "
                               "NVIDIA GPU; pass --cpu (device='cpu') to run "
                               "on the CPU")
        if not join:
            return torch.device("cuda", torch.cuda.current_device())
        local = _env_int("LOCAL_RANK", _env_int("RANK", 0))
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards)
        name = ("nccl" if _env_int("LOCAL_WORLD_SIZE", world) <= cards
                else "gloo")
    if not join:
        return device
    return init_group(device, name, _env_int("RANK", 0), world)


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (the same shape on each), concatenated on the
    leading axis in rank order; no gradient. `x` itself without a process
    group. Bool tensors travel as uint8."""
    if not active():
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ranks in place; no gradient."""
    if active():
        dist.all_reduce(x)
    return x


def shard_positions(n: int, rank_: int, world: int) -> np.ndarray:
    """The positions, in a batch of n rows, that rank `rank_` of `world`
    handles (the JAX package's `_shard_eval`): the batch padded to a
    multiple of `world` by repeating row 0, the rank's contiguous share of
    it; np.arange(n) for one rank. Every rank's outputs gathered in rank
    order and cut to n are the whole batch's."""
    per = -(-n // world)
    pos = np.arange(per * world)
    pos[n:] = 0
    return pos[rank_ * per:(rank_ + 1) * per]


def sync_batchnorm(module: torch.nn.Module) -> torch.nn.Module:
    """Make every BatchNorm of `module` take global-batch statistics in
    train mode (models/layers.py) while a process group is up."""
    from text_guided_face_recognition_tpu_torch.models.layers import (
        BatchNorm)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync = active()
    return module
