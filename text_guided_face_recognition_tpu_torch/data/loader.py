"""Host-side batching loader with background prefetch.

Counterpart of text_guided_face_recognition_tpu/data/loader.py for one
process: a thread pool builds each batch's samples and a producer thread
keeps `prefetch` collated batches (dicts of stacked numpy arrays, or of
stacked CPU tensors where the samples hold tensors: the frozen-feature
cache's bf16 maps) ahead of the consumer. A batch of an epoch is made only
once that epoch's iteration has begun: nothing is fetched across the epoch
boundary, so the cache refreshed before an epoch feeds all of it.

Data parallelism: `process_shard=(rank, world)` makes the loader yield only
its rank's contiguous rows of every GLOBAL batch (`batch_size` stays the
global size): every rank draws the same seeded order, so the global batch
is the one process's at the same seed, with the JAX loader's refusals (an
index out of range, a batch the ranks do not split evenly, a kept short
last batch). The other ranks' rows count a visit on the dataset
(`count_visits`, where it has one) without being loaded, so the next
epoch's augmentation and caption draws of every row are the ones one
process would take. `epoch_rows` draws the coming epoch's order ahead and
names this rank's rows of it (the frozen-feature cache's refresh).

Sharded evaluation: `row_shard=(rank, world)` makes an eval loader (no
shuffle, the last batch kept short) load only its rank's share of every
batch, the batch padded to a multiple of `world` by repeating its first
row (parallel/mesh.py `shard_positions`), so the ranks split the decoding
instead of each making the whole batch; each batch then carries
`global_rows`, the dataset indices of the whole batch, for the gather of
the ranks' outputs (engine/evaluate.py).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from text_guided_face_recognition_tpu_torch.parallel.mesh import (
    shard_positions)

__all__ = ["DataLoader"]


def _collate(samples) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        if isinstance(samples[0][k], str):
            out[k] = np.asarray([s[k] for s in samples])
        elif isinstance(samples[0][k], torch.Tensor):
            out[k] = torch.stack([s[k] for s in samples])
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: int = 0, prefetch: int = 2,
                 process_shard: Optional[Tuple[int, int]] = None,
                 row_shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        if process_shard is not None:
            idx, count = process_shard
            if not (0 <= idx < count):
                raise ValueError(f"process_shard index {idx} out of range "
                                 f"for count {count}")
            if batch_size % count != 0:
                raise ValueError(
                    f"batch_size {batch_size} must divide evenly across "
                    f"{count} processes")
            if not drop_last and count > 1:
                raise ValueError("process_shard requires drop_last=True "
                                 "(a ragged final batch cannot be split "
                                 "evenly across hosts)")
        if row_shard is not None and (process_shard is not None
                                      or shuffle):
            raise ValueError("row_shard shards an eval loader (no shuffle, "
                             "no process_shard)")
        self.process_shard = process_shard
        self.row_shard = row_shard
        self._order: Optional[np.ndarray] = None   # drawn by epoch_rows

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        """The coming epoch's order of the dataset's indices, drawn once."""
        if self._order is None:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                self._rng.shuffle(idx)
            self._order = idx
        return self._order

    def _local(self, full: np.ndarray) -> np.ndarray:
        """This process's rows of one global batch."""
        if self.row_shard is not None:
            return full[shard_positions(len(full), *self.row_shard)]
        if self.process_shard is None:
            return full
        pi, pc = self.process_shard
        local = self.batch_size // pc
        return full[pi * local:(pi + 1) * local]

    def _global_batches(self):
        idx = self._epoch_order()
        self._order = None
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def _batch_indices(self):
        for full in self._global_batches():
            yield self._local(full)

    def epoch_rows(self) -> np.ndarray:
        """The indices this process loads in the coming epoch, drawing that
        epoch's order now (the next iteration takes the same order)."""
        idx, bs = self._epoch_order(), self.batch_size
        rows = [self._local(idx[b * bs:(b + 1) * bs])
                for b in range(len(self))]
        return np.concatenate(rows) if rows else idx[:0]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()
        count_visits = getattr(self.dataset, "count_visits", None)

        def produce():
            try:
                for full in self._global_batches():
                    if stop.is_set():
                        return
                    batch_idx = self._local(full)
                    if count_visits is not None and \
                            self.process_shard is not None and \
                            len(batch_idx) < len(full):
                        count_visits(np.setdiff1d(full, batch_idx))
                    samples = list(pool.map(self.dataset.__getitem__,
                                            batch_idx.tolist()))
                    batch = _collate(samples)
                    if self.row_shard is not None:
                        batch["global_rows"] = full
                    q.put(batch)
            except BaseException as e:  # surfaced to the consumer below
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then wait for it
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
            pool.shutdown(wait=True)
