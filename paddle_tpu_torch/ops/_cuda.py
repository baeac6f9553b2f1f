"""Build and load the hand-written CUDA kernels.

Each source in ``paddle_tpu_torch/csrc`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, which
``ctypes`` loads. A library is built once, at first use, into
``build/paddle_tpu_torch/`` beside the package (named by a hash of its
source and flags, so an edited source rebuilds); ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them together.

Every exported C function takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
``CudaKernel.launch`` raises when that is not 0 and counts the launch
when it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["CudaKernel", "build_all", "KERNEL_SOURCES", "DTYPE_CODES",
           "HEAD_DIMS", "padded_head_dim"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: every kernel source of the package, in build order
KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "paged_attention.cu")
#: element types the kernels take, by the codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)


def padded_head_dim(d: int) -> int:
    """The smallest instantiated head dim that holds ``d`` (``d`` itself
    when it is one, or larger than all of them). Callers zero-pad to it:
    zero columns add nothing to q.k or to p.v."""
    return next((h for h in HEAD_DIMS if h >= d), d)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(source: str) -> Path:
    """Where ``source``'s library lives: keyed by the content of every
    file in csrc (sources include shared headers) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Build every library in ``sources`` that is not built yet, one nvcc
    per source, all started together. Returns, per source, the library
    path, the seconds its build took (0 when it was already built) and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills).
    Raises RuntimeError with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            out[src] = {"library": str(lib), "seconds": 0.0, "report": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, p in procs:
        report, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src}:\n{report}")
            continue
        os.replace(tmp, lib)  # atomic: no process loads a half-written file
        out[src] = {"library": str(lib),
                    "seconds": time.perf_counter() - t0, "report": report}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


class CudaKernel:
    """One exported C function of one kernel library, loaded at first
    launch. ``launches`` counts the launches that returned no error.
    ``library``: a library built elsewhere (another checkout's source, with
    the same C interface) to load in place of building ``source``."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 library: Optional[str] = None):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.library = library
        self.launches = 0
        self._fn = None
        self._lib = None

    def _load(self):
        lib = ctypes.CDLL(self.library or build_all([self.source])
                          [self.source]["library"])
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn
        return fn

    def launch(self, *args) -> None:
        fn = self._fn or self._load()
        err = fn(*args)
        if err != 0:
            msg = self._lib.ptt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
