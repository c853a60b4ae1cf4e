"""Build the package's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) at first
use, into ``contrast_renderer_tpu_torch/build/`` under a name keyed by a
hash of its compile units, the sources under ``csrc/`` and the flags,
and loaded with ``ctypes``.  A library is a list of compile units, each
a source with its preprocessor defines: a file under ``csrc/``, or one
generated into ``build/`` (``generated_source``) that may include them.
Every unit gets its own ``nvcc``, all started together, and the objects
are linked into one shared library; libraries of different names build
concurrently from several threads.  The sources expose plain C entry
points, so the build includes no PyTorch header.  A failed build raises;
nothing falls back.
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
    "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR),
)

_lock = threading.Lock()
#: One lock per library name: a library builds once, others meanwhile.
_name_locks = {}
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


def generated_source(stem: str, text: str) -> Path:
    """Write a generated compile unit into ``build/``, named by a hash of
    its text, and return its path."""
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    path = BUILD_DIR / f"{stem}-{digest}.cu"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".cu", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    return path


def _unit_path(src) -> Path:
    return Path(src) if Path(src).is_absolute() else CSRC_DIR / src


def library_path(name: str, units) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src, defines in units:
        digest.update(" ".join((Path(src).name, *defines)).encode())
        digest.update(_unit_path(src).read_bytes())
    # A unit may include any source under csrc/.
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.read_bytes())
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
                 "-o", str(tmp / f"unit{i}.o"), str(_unit_path(src))],
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
    """The library built from ``units``, ``(source, defines)`` pairs (a
    source is a file name under csrc/ or a generated unit's path),
    compiled on first use."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        path = library_path(name, units)
        lib = _libraries.get(path)
        if lib is not None:
            return lib
        if not path.exists():
            start = time.perf_counter()
            log = _build(name, units, path)
            build_logs[name] = (time.perf_counter() - start, log)
        lib = ctypes.CDLL(str(path))
        _libraries[path] = lib
        return lib
