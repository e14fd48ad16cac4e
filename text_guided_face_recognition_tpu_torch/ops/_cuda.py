"""Build and load the port's hand-written CUDA kernels.

Each source in `csrc/` (`layernorm.cu`, `ffn_block.cu`, `attn_block.cu`,
`tower_block.cu`, `damsm.cu`, `philox.cu`) compiles on its own with `nvcc`
into a shared library with a plain C interface, loaded with `ctypes`.
Libraries are built at first use into `_build/` beside this package (listed
in `.gitignore`), named by a digest of their sources and flags, so an
edited source never loads a stale library.
`build()` compiles several sources in parallel, one `nvcc` process each,
under a file lock in `_build/`, so that the ranks of a data-parallel run
(parallel/mesh.py) starting together compile each library once: the
first builds, the others wait and load.
A variant (`VARIANTS`) is a source built with extra flags into a library
of its own name: the measurement build of the tower kernels, which only
chip_smoke.py loads. A library of `PARTS` is a shared library a part,
each compiled from the source with its own flags, all at once beside the
other sources (the whole-tower kernels' forward and backward, minutes
each); `function` finds a C function in whichever part has it.

Nothing here runs at import time: this module imports on hosts with no CUDA
toolchain, where the kernels' plain versions serve CPU tensors.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

__all__ = ["SOURCES", "VARIANTS", "PARTS", "build", "built", "load",
           "function", "dtype_code", "launch"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("layernorm", "ffn_block", "attn_block", "tower_block", "damsm",
           "philox")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xcompiler", "-fvisibility=hidden",
          "-Xptxas", "-v")
# name: (source, extra flags). The tower kernels with %globaltimer stamps
# at every grid barrier (csrc/tower_block.cu, TGFR_PHASE_TIMES).
VARIANTS = {"tower_block_phases": ("tower_block", ("-DTGFR_PHASE_TIMES",))}
# name: the extra flags of each part (csrc/tower_block.cu TGFR_TOWER_PART:
# the forward, the backward)
PARTS = {"tower_block": (("-DTGFR_TOWER_PART=1",), ("-DTGFR_TOWER_PART=2",))}

_lock = threading.Lock()
_libs: Dict[str, List[ctypes.CDLL]] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ on a host with the CUDA toolkit")
    return path


def _source(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """(the source of library `name`, its flags)."""
    src, extra = VARIANTS.get(name, (name, ()))
    return _CSRC / f"{src}.cu", _FLAGS + tuple(extra)


def _targets(name: str) -> List[Tuple[Path, Tuple[str, ...]]]:
    """[(a shared library of `name`, its compile flags)]: one, or one a
    part, each named by a digest of its sources and flags."""
    src, flags = _source(name)
    out = []
    for i, extra in enumerate(PARTS.get(name, ((),))):
        h = hashlib.sha1()
        for part in (src, _CSRC / "common.cuh"):
            h.update(part.read_bytes())
        h.update(" ".join(flags + extra).encode())
        stem = name if name not in PARTS else f"{name}.{i}"
        out.append((_BUILD / f"{stem}-{h.hexdigest()[:16]}.so",
                    flags + extra))
    return out


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, all at once.

    Returns {name: seconds} for the sources compiled by this call. The
    compiler's report (registers, spills) is kept beside each library as
    `<library>.log`. Raises RuntimeError with the compiler output on failure.
    Another process building meanwhile holds the lock; this one waits.
    """
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(names)


def _build_locked(names: Iterable[str]) -> Dict[str, float]:
    jobs = {}
    for name in names:
        src = _source(name)[0]
        for out, flags in _targets(name):
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.setdefault(name, []).append(
                (proc, tmp, out, time.perf_counter()))
    seconds, failed = {}, []
    for name, parts in jobs.items():
        for proc, tmp, out, t0 in parts:
            log, _ = proc.communicate()
            seconds[name] = max(seconds.get(name, 0.0),
                                time.perf_counter() - t0)
            out.with_suffix(".so.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {out.name} "
                              f"({_source(name)[0].name}):\n{log}")
                continue
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def built(name: str) -> bool:
    """The library of `name` is built from the current sources (`build`
    moves each library into place as its compile ends, in the order of
    its names)."""
    return all(out.exists() for out, _ in _targets(name))


def load(names: Iterable[str]) -> None:
    """Load the named libraries, built before, so that their functions
    (`function`) take no build lock: another thread may meanwhile hold it
    to build other sources (chip_smoke.py runs the phases that need no
    tower kernel while `tower_block.cu` compiles)."""
    with _lock:
        for name in names:
            if name not in _libs:
                for path, _ in _targets(name):
                    if not path.exists():
                        raise RuntimeError(f"{name}: not built ({path})")
                _libs[name] = [ctypes.CDLL(str(p)) for p, _ in
                               _targets(name)]


def function(lib: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function `fn` of library `lib` (of the part that has it),
    built and loaded on first use, with its argument types set (pointers as
    c_void_p, so ctypes passes all 64 bits) and an int return: the launch's
    cudaError_t."""
    key = f"{lib}:{fn}"
    with _lock:
        if key not in _fns:
            if lib not in _libs:
                build([lib])
                _libs[lib] = [ctypes.CDLL(str(p)) for p, _ in _targets(lib)]
            having = [d for d in _libs[lib] if hasattr(d, fn)]
            if not having:
                raise AttributeError(f"{lib}: no C function {fn}")
            f = getattr(having[0], fn)
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
