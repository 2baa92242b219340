"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source ``csrc/<name>.cu`` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
for ``sm_90a``. Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built at
import time: the first launch of a kernel builds it, and
:func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together.
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
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build",
           "library", "ptxas_report"]

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("spmm_csr", "fused_attention_csr", "sddmm_csr",
           "binary_reduce_csr", "edge_softmax_csr")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile ``names`` (default: every source) that are not built yet,
    one ``nvcc`` each, all in parallel. Returns seconds per compiled
    source; raises with the compiler's output when one fails."""
    names = tuple(SOURCES if names is None else names)
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}")
    todo = [n for n in names if not _target(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds: Dict[str, float] = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def ptxas_report(name: str) -> str:
    """The compiler's register / shared-memory report for ``name`` (the
    ``-Xptxas -v`` output kept beside the built library)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, building it first if
    needed. Loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
