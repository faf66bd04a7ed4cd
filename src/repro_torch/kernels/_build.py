"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` for ``sm_90a`` (Hopper), at first
use; the hash is of the source and the shared headers, so an edit builds
anew.  `build_all` starts one nvcc per source, all at once.  Nothing here
runs at import: this module loads on machines without nvcc or a card.

Every C entry point launches on the stream it is given and returns the
``cudaError_t`` of ``cudaGetLastError()`` after its launches; `check`
raises on a non-zero one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
NVCC_SECONDS: Dict[str, float] = {}  # each source's nvcc wall time, this process


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """The library's path, keyed by its source and the shared headers."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(nvcc)


def _compile(names: Sequence[str]) -> None:
    """One nvcc per source, all started together; ptxas's report goes to
    ``_build/<name>.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outs: Dict[str, str] = {}

    def finish(name, t0, proc):  # in a thread each: a source's own wall time
        outs[name] = proc.communicate()[0]
        NVCC_SECONDS[name] = time.perf_counter() - t0

    waits = [threading.Thread(target=finish, args=(name, t0, proc))
             for name, _, t0, proc in procs]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    failed = []
    for name, tmp, _, proc in procs:
        out = outs[name]
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, library_path(name))  # atomic: readers see whole files
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_all() -> float:
    """Compile every kernel source (in parallel) and load each library;
    returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        _compile(sources())
    for name in sources():
        library(name)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(lib: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    f = getattr(library(lib), fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1,
               torch.int8: 2}  # csrc/common.cuh DType


def dtype_code(t: torch.Tensor) -> int:
    return DTYPE_CODES[t.dtype]
