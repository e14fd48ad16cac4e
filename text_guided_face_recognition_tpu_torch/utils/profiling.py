"""Tracing and profiling hooks.

Counterpart of text_guided_face_recognition_tpu/utils/profiling.py, with
torch.profiler in place of jax.profiler. Usage in the train loops:

    with maybe_profile(args, step):     # traces the steps [start,
        metrics = train_step(...)       # start + num) when profile_dir is set

plus `nan_guard(metrics)` for a fail-fast NaN / Inf check of the loss
aggregates, and `StepTimer`, host wall time per step without its warm-up.

`profile_dir`, `profile_start` (default 5) and `profile_steps` (default 3)
are read with getattr: the yml keys land in the config's `extras`, which
getattr reads. The trace (CPU and, where there is a card, CUDA activity)
is written as a Chrome trace, `trace_<pid>_<time>.json`, into profile_dir.
The captured train step (engine/trainer.py) is captured while the trace is
open when the window covers its fourth step; the trace then holds the
capture's launches and each later replay's kernels.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["maybe_profile", "StepTimer", "nan_guard"]

_session: Dict[str, object] = {}


def _start(profile_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _session.update(prof=prof, dir=profile_dir)


def _stop() -> str:
    prof = _session.pop("prof")
    out_dir = _session.pop("dir")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_profile(args, step: int):
    """Wrap a step in a torch.profiler trace when `profile_dir` is set and
    step is in [profile_start, profile_start + profile_steps)."""
    profile_dir = getattr(args, "profile_dir", None)
    start = int(getattr(args, "profile_start", 5))
    num = int(getattr(args, "profile_steps", 3))
    if profile_dir and start <= step < start + num:
        if step == start:
            _start(os.path.expanduser(profile_dir))
        try:
            yield
        finally:
            if step == start + num - 1 and "prof" in _session:
                _stop()
                print(f"profiler trace written to {profile_dir}")
    else:
        yield


class StepTimer:
    """Wall-clock per-step timing with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self._time = time.perf_counter
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = self._time()
        return self

    def __exit__(self, *exc):
        dt = self._time() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def mean(self) -> float:
        n = max(self.count - self.warmup, 1)
        return self.total / n


def nan_guard(metrics: Dict[str, object], step: int = -1) -> None:
    """Fail fast on non-finite loss aggregates (the reference would silently
    continue training on NaN); floats, numpy values or tensors."""
    for k, v in metrics.items():
        if torch.is_tensor(v):
            v = float(v.detach().float().cpu())
        val = v if isinstance(v, (int, float)) else float(np.asarray(v))
        if isinstance(val, float) and not math.isfinite(val):
            raise FloatingPointError(
                f"non-finite metric {k!r}={val} at step {step}")
