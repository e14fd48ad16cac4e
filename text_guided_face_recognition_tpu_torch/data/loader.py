"""Host-side batching loader with background prefetch.

Counterpart of text_guided_face_recognition_tpu/data/loader.py for one
process: a thread pool builds each batch's samples and a producer thread
keeps `prefetch` collated batches (dicts of stacked numpy arrays) ahead of
the consumer. The multi-host `process_shard` option waits for the parallel
slice (ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataLoader"]


def _collate(samples) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        if isinstance(samples[0][k], str):
            out[k] = np.asarray([s[k] for s in samples])
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()

        def produce():
            try:
                for batch_idx in self._batch_indices():
                    if stop.is_set():
                        return
                    samples = list(pool.map(self.dataset.__getitem__,
                                            batch_idx.tolist()))
                    q.put(_collate(samples))
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
