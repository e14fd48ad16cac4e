"""ctypes binding to the native batch image loader (native/tgfr_dataio.cpp).

Counterpart of text_guided_face_recognition_tpu/data/native.py: the port's
own binding to the same shared library, `native/libtgfr_dataio.so`, with
the same argument types and version checks, so the port decodes, resizes,
augments and normalises an on-disk image exactly as the JAX package does.
`decode_batch(paths, ...)` runs a whole batch in one C++ call (its own
thread pool). When the library is absent it is built with
`make -C native` on first use, as the JAX package does; if that fails or
the library does not load, `available()` is False and the datasets take
the PIL path, with the JAX package's warnings.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional, Sequence

import numpy as np

__all__ = ["available", "supports_u8", "decode_batch", "FLAG_TRAIN_AUG",
           "FLAG_BGR", "FLAG_U8_OUT"]

FLAG_TRAIN_AUG = 1
FLAG_BGR = 2
FLAG_U8_OUT = 4  # library v2+: augmented uint8 RGB out (the device normalises)

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                          ".."))
_SO_PATH = os.path.join(_REPO_ROOT, "native", "libtgfr_dataio.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.isfile(_SO_PATH):
            try:
                subprocess.run(["make", "-C", os.path.dirname(_SO_PATH)],
                               check=True, capture_output=True, timeout=120)
            except Exception as e:
                warnings.warn(f"native dataio build failed ({e}); "
                              "falling back to PIL decode")
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.tgfr_decode_batch.restype = ctypes.c_int
            lib.tgfr_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ]
            if lib.tgfr_dataio_version() < 1:
                raise RuntimeError("tgfr_dataio_version() < 1")
            _lib = lib
        except Exception as e:
            warnings.warn(f"native dataio unavailable ({e})")
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def supports_u8() -> bool:
    """uint8 output needs library v2 (an older library would misread the
    output buffer)."""
    lib = _load()
    return lib is not None and lib.tgfr_dataio_version() >= 2


def decode_batch(paths: Sequence[str], out_h: int, out_w: int,
                 seeds: Optional[np.ndarray] = None, train_aug: bool = False,
                 bgr: bool = False, n_threads: int = 0,
                 u8_out: bool = False) -> np.ndarray:
    """Decode a batch of JPEGs -> (N, H, W, 3) float32 in [-1, 1], or with
    u8_out augmented uint8 RGB.

    seeds: one uint64 RNG seed per image for the train augmentations,
    required with train_aug (the result depends on the seed alone, not on
    the thread schedule). A failed decode comes back as a zero image (the
    count is reported as a warning).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native dataio not available")
    if u8_out and not supports_u8():
        raise RuntimeError("native dataio library predates u8_out (rebuild: "
                           "make -C native)")
    n = len(paths)
    dtype = np.uint8 if u8_out else np.float32
    out = np.empty((n, out_h, out_w, 3), dtype)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    flags = ((FLAG_TRAIN_AUG if train_aug else 0)
             | (FLAG_BGR if bgr and not u8_out else 0)
             | (FLAG_U8_OUT if u8_out else 0))
    if train_aug:
        if seeds is None:
            raise ValueError("train_aug requires per-image seeds")
        seeds = np.ascontiguousarray(seeds, np.uint64)
        seeds_p = seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    else:
        seeds_p = None
    failures = lib.tgfr_decode_batch(
        c_paths, n, out_h, out_w, out.ctypes.data_as(ctypes.c_void_p),
        seeds_p, flags, n_threads)
    if failures:
        warnings.warn(f"native dataio: {failures}/{n} images failed to "
                      "decode (zero-filled)")
    return out
