"""Build the package's CUDA sources into a shared library and load it.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library is built at first use from ``pixie_tpu_torch/csrc/<name>.cu`` into
``build/pixie_tpu_torch/`` at the root of the checkout, cached under a hash
of the sources and the compiler flags.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pixie_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas register / spill report of each library built in this process
BUILD_LOG: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _sources(name: str) -> list[Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return [src] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_libraries(*names: str) -> list[ctypes.CDLL]:
    """Build (if not cached) and load ``csrc/<name>.cu`` for each name; the
    missing libraries build at once, one nvcc each.  Raises on failure."""
    with _LOCK:
        procs = {}
        for name in names:
            if name in _LIBS or library_path(name).exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n{log}")
            else:
                os.replace(tmp, library_path(name))
                BUILD_LOG[name] = log.strip()
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return [_LIBS[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if not cached) and load ``csrc/<name>.cu``; raises on failure."""
    return load_libraries(name)[0]


def check_tensor(name: str, t, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape, dtype and device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.pixie_error_string(code).decode()} ({code})")
