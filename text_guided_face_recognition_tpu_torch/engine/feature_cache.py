"""The frozen backbone's features, once an epoch (`frozen_feature_cache`).

Counterpart of text_guided_face_recognition_tpu/engine/feature_cache.py.
Both stages keep the face backbone frozen (eval-mode BN, no gradient), so
its output for a training sample depends only on the image and that
epoch's augmentation draw. `refresh` runs it once over the whole train
split (with more than one rank: over this rank's rows of the coming
epoch, data/loader.py `epoch_rows`) at `feature_cache_batch` before the
epoch, on each sample's next augmentation (data/datasets.py
`peek_augmented_image`), and installs the
(global, local) features on the dataset, which then hands them out in
place of the image (`set_feature_cache`); the train step skips the
backbone. The values are those the step would have computed, up to the
rounding of another batch size; the caption draws do not change.

The cache lives on the host: gl (N, 512) f32 and lc (N, 256, S, S) in the
backbone's dtype (102400 bytes an image for iresnet18 at 112 x 112 in
bf16), N the dataset's size, aligned with its indices; with more than one
rank N is the rank's rows of the epoch, in sorted index order, and `slot`
maps a dataset index to its row (-1 for another rank's), so N ranks on a
host hold one split's features between them, not N times over. On a CUDA
device one chunk's images and outputs go through pinned buffers with
non-blocking copies: the host decodes chunk i + 1 while the device runs
chunk i, and waits on chunk i's event only then, so there is one wait a chunk and no device
synchronisation.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from text_guided_face_recognition_tpu_torch.engine.evaluate import (
    backbone_features)

__all__ = ["FrozenFeatureCache"]


class FrozenFeatureCache:
    """The per-epoch features of one trainer's frozen backbone."""

    def __init__(self, backbone: torch.nn.Module, args,
                 device: torch.device):
        self.backbone = backbone
        self.model_type = args.model_type
        self.batch = max(1, int(args.feature_cache_batch))
        self.workers = max(1, int(args.num_workers))
        self.device = device
        self.gl: Optional[torch.Tensor] = None
        self.lc: Optional[torch.Tensor] = None
        self.slot: Optional[np.ndarray] = None
        self.last_refresh_s = 0.0
        self._pinned = None          # (images, gl, lc) chunk buffers

    def host_bytes(self) -> int:
        """The bytes the cache holds on the host."""
        return sum(t.numel() * t.element_size() for t in (self.gl, self.lc)
                   if t is not None)

    def _buffers(self, img: np.ndarray, gl: torch.Tensor, lc: torch.Tensor):
        """Pinned buffers for a chunk of `self.batch`, made at the first
        refresh (the shapes do not change between epochs)."""
        if self._pinned is None:
            pb = self.batch

            def pinned(shape, dtype):
                return torch.empty((pb,) + tuple(shape), dtype=dtype,
                                   pin_memory=True)

            self._pinned = (pinned(img.shape[1:], torch.from_numpy(
                img[:1]).dtype), pinned(gl.shape[1:], gl.dtype),
                pinned(lc.shape[1:], lc.dtype))
        return self._pinned

    def _store(self, n: int, at: int, k: int, gl, lc, done) -> None:
        """A chunk's k features into cache rows [at, at + k) of n, after
        its event."""
        if done is not None:
            done.synchronize()
        if self.gl is None or self.gl.shape[0] != n:
            self.gl = torch.empty((n,) + tuple(gl.shape[1:]), dtype=gl.dtype)
            self.lc = torch.empty((n,) + tuple(lc.shape[1:]), dtype=lc.dtype)
        self.gl[at:at + k] = gl[:k]
        self.lc[at:at + k] = lc[:k]

    @torch.no_grad()
    def _forward(self, img: np.ndarray):
        """Enqueue one chunk's forward: (gl, lc, event) with the outputs on
        the host (pinned staging on CUDA, read after the event)."""
        k = img.shape[0]
        if self.device.type != "cuda":
            gl, lc = backbone_features(self.backbone, self.model_type,
                                       torch.from_numpy(img))
            return gl, lc, None
        if self._pinned is None:      # the first chunk: learn the shapes
            gl, lc = backbone_features(
                self.backbone, self.model_type,
                torch.from_numpy(img[:1]).to(self.device))
            self._buffers(img, gl, lc)
        x_h, gl_h, lc_h = self._pinned
        x_h[:k].copy_(torch.from_numpy(img))
        gl, lc = backbone_features(self.backbone, self.model_type,
                                   x_h[:k].to(self.device, non_blocking=True))
        gl_h[:k].copy_(gl, non_blocking=True)
        lc_h[:k].copy_(lc, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return gl_h, lc_h, done

    def refresh(self, dataset, rows: Optional[np.ndarray] = None) -> float:
        """Recompute the features of every index (or of the dataset
        indices `rows` alone: a rank's rows of the coming epoch, sorted
        here, which the cache then holds and no other) at its next visit's
        augmentation and install them on `dataset`; the wall seconds (also
        `last_refresh_s`)."""
        t0 = time.perf_counter()
        n_all = len(dataset)
        if rows is None:
            rows, self.slot = np.arange(n_all), None
        else:
            rows = np.unique(np.asarray(rows, dtype=np.int64))
            self.slot = np.full(n_all, -1, dtype=np.int64)
            self.slot[rows] = np.arange(len(rows))
        n = len(rows)
        pb = max(1, min(self.batch, n))
        pending = None               # (at, k, gl, lc, event)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for start in range(0, n, pb):
                chunk = rows[start:start + pb]
                img = np.stack(list(pool.map(dataset.peek_augmented_image,
                                             chunk.tolist())))
                if pending is not None:    # chunk i - 1 ran meanwhile
                    self._store(n, *pending)
                pending = (start, len(chunk)) + self._forward(img)
        if pending is not None:
            self._store(n, *pending)
        dataset.set_feature_cache({"gl": self.gl, "lc": self.lc,
                                   "slot": self.slot})
        self.last_refresh_s = time.perf_counter() - t0
        return self.last_refresh_s
