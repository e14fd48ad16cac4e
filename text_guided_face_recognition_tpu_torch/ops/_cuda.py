"""Build and load the port's hand-written CUDA kernels.

Each source in `csrc/` (`layernorm.cu`, `ffn_block.cu`, `attn_block.cu`)
compiles on its own with `nvcc` into a shared library with a plain C
interface, loaded with `ctypes`. Libraries are built at first use into
`_build/` beside this package (listed in `.gitignore`), named by a digest of
their sources and flags, so an edited source never loads a stale library.
`build()` compiles several sources in parallel, one `nvcc` process each.

Nothing here runs at import time: this module imports on hosts with no CUDA
toolchain, where the kernels' plain versions serve CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

__all__ = ["SOURCES", "build", "function", "dtype_code", "launch"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("layernorm", "ffn_block", "attn_block")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ on a host with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for part in (_CSRC / f"{name}.cu", _CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, all at once.

    Returns {name: seconds} for the sources compiled by this call. The
    compiler's report (registers, spills) is kept beside each library as
    `<library>.log`. Raises RuntimeError with the compiler output on failure.
    """
    _BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def function(lib: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function `fn` of library `lib`, built and loaded on first use,
    with its argument types set (pointers as c_void_p, so ctypes passes all
    64 bits) and an int return: the launch's cudaError_t."""
    key = f"{lib}:{fn}"
    with _lock:
        if key not in _fns:
            if lib not in _libs:
                build([lib])
                _libs[lib] = ctypes.CDLL(str(_target(lib)))
            f = getattr(_libs[lib], fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _fns[key] = f
        return _fns[key]


def dtype_code(dtype: torch.dtype) -> int:
    """The kernels' element-type code (csrc/common.cuh `DType`)."""
    return {torch.float32: 0, torch.bfloat16: 1}[dtype]


def launch(f: ctypes._CFuncPtr, *args) -> None:
    """Call a C launcher on the current stream and raise if CUDA refused
    any of its launches."""
    err = f(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{f.__name__}: launch failed with cudaError_t "
                           f"{err}")
