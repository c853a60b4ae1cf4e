"""Build the package's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) at first
use, into ``contrast_renderer_tpu_torch/build/`` under a name keyed by a
hash of its sources and flags, and loaded with ``ctypes``.  The sources
expose plain C entry points, so the build includes no PyTorch header and
takes seconds.  A failed build raises; nothing falls back.
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

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

#: ``--fmad=false`` keeps every float multiply and add separately
#: rounded, as PyTorch's elementwise ops (and the reference's XLA ops)
#: round them; the fill test's edge ties depend on it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libraries = {}
#: nvcc's output (ptxas register and spill report) and wall seconds of
#: the builds this process ran, by library name.
build_logs = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    # The CUDA toolkit's conventional install prefix.
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels build only "
        "where the CUDA toolkit is installed"
    )


def library_path(name: str, sources) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str, sources) -> ctypes.CDLL:
    """The library built from ``csrc/<sources>``, compiled on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        path = library_path(name, sources)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build beside the target and rename: a concurrent process
            # never loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *(str(CSRC_DIR / s) for s in sources)]
            start = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed building {name}:\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            build_logs[name] = (
                time.perf_counter() - start, proc.stdout + proc.stderr
            )
        lib = ctypes.CDLL(str(path))
        _libraries[name] = lib
        return lib
