"""Build the package's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) at first
use, into ``contrast_renderer_tpu_torch/build/`` under a name keyed by a
hash of its compile units and flags, and loaded with ``ctypes``.  A
library is a list of compile units, each a source with its preprocessor
defines; every unit gets its own ``nvcc``, all started together, and the
objects are linked into one shared library.  The sources expose plain C
entry points, so the build includes no PyTorch header.  A failed build
raises; nothing falls back.
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
    "-Xcompiler", "-fPIC",
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


def library_path(name: str, units) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src, defines in units:
        digest.update(" ".join((src, *defines)).encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str, units, path: Path) -> str:
    """Compile ``units`` (one nvcc each, all at once) and link them into
    ``path``; returns the compilers' output."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a private directory beside the target and rename: a
    # concurrent process never loads a half-written library.
    tmp = Path(tempfile.mkdtemp(prefix=f"{name}-", dir=BUILD_DIR))
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c",
                 "-o", str(tmp / f"unit{i}.o"), str(CSRC_DIR / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i, (src, defines) in enumerate(units)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        if any(proc.returncode != 0 for proc in procs):
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / "lib.so"),
             *(str(tmp / f"unit{i}.o") for i in range(len(units)))],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed linking {name}:\n{link.stdout}{link.stderr}"
            )
        os.replace(tmp / "lib.so", path)
        return log + link.stdout + link.stderr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library(name: str, units) -> ctypes.CDLL:
    """The library built from ``units``, ``(source in csrc/, defines)``
    pairs, compiled on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        path = library_path(name, units)
        if not path.exists():
            start = time.perf_counter()
            log = _build(name, units, path)
            build_logs[name] = (time.perf_counter() - start, log)
        lib = ctypes.CDLL(str(path))
        _libraries[name] = lib
        return lib
