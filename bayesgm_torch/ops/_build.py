"""Build the CUDA sources of ``bayesgm_torch/csrc`` and load them.

Each source is compiled on first use with ``nvcc`` into a shared library with
a plain C interface in the kernel build directory, named by a hash of the
source, and loaded with ``ctypes``.  The directory is
``build/bayesgm_torch_kernels/`` at the root of the checkout unless
:func:`bayesgm_torch.utils.cache.enable_compilation_cache` names another
(or ``$BAYESGM_TORCH_KERNEL_CACHE`` does) before the first build.  A build
that fails raises with the compiler's output; nothing falls back.  The
kernel wrappers' launch helpers live here too: the argument check, the
current stream and the check of a launch's return code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "bayesgm_torch_kernels"  # the default build directory
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary:
    """A loaded ``.so`` plus what its build printed and how long it took."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_log: str, build_s: float):
        self.lib = lib
        self.path = path
        self.build_log = build_log
        self.build_s = build_s


_GUARD = threading.Lock()
_LOCKS: dict = {}  # one lock per source, so two sources build in parallel
_LOADED: dict = {}
_BUILD_DIR: list = []  # the directory the first build fixed, once set


def build_dir() -> Path:
    """The kernel build directory: the one set by :func:`set_build_dir`, else
    (fixing it) ``$BAYESGM_TORCH_KERNEL_CACHE`` or :data:`BUILD_DIR`."""
    with _GUARD:
        if not _BUILD_DIR:
            _BUILD_DIR.append(Path(os.environ.get("BAYESGM_TORCH_KERNEL_CACHE") or BUILD_DIR))
        return _BUILD_DIR[0]


def set_build_dir(path) -> Path:
    """Point the kernel builds at ``path``.  Once a kernel library has
    loaded, asking for another directory raises: the process keeps the
    libraries it has and never switches quietly."""
    path = Path(path).resolve()
    with _GUARD:
        if _LOADED and _BUILD_DIR and _BUILD_DIR[0].resolve() != path:
            raise RuntimeError(
                f"kernel build directory is {_BUILD_DIR[0]} and {sorted(_LOADED)} already "
                f"loaded from it: cannot switch to {path}")
        _BUILD_DIR[:] = [path]
        return path


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def load_library(source: str) -> KernelLibrary:
    """Build (if not cached) and load ``csrc/<source>``; safe to call from
    several threads at once."""
    with _GUARD:
        lock = _LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source in _LOADED:
            return _LOADED[source]
        src = CSRC / source
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = build_dir()
        so = out_dir / f"{src.stem}_{digest}.so"
        log, build_s = "(cached)", 0.0
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            build_s = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed to build {src} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, so)
        lib = KernelLibrary(ctypes.CDLL(str(so)), so, log, build_s)
        _LOADED[source] = lib
        return lib


def cuda_stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a kernel's launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda_f32(name, t, device, shape=None):
    """Raise unless ``t`` is a contiguous float32 tensor on ``device`` (of
    ``shape``, when given): what the kernels take."""
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def check_launch(code: int, what: str, error_string) -> None:
    """Raise unless a kernel library's host function returned 0; the message
    is the library's ``error_string(code)``."""
    if code != 0:
        raise RuntimeError(f"{what} failed: {error_string(code).decode()} (code {code})")
