"""Build the port's CUDA sources (``ops/csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface under ``build/torch_kernels/`` at the root of the checkout, and
loads with ``ctypes``; loading one builds that one alone. A library newer
than its source and every shared header (``csrc/*.cuh``) is reused; a stale
one is compiled again. Builds and loads hold one lock, so
two threads that reach a kernel first at once (the serving daemon's
handlers) build it once.
Nothing but the repo's own sources goes into a build.
"""

import ctypes
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_log_path(name: str) -> Path:
    """Where the last build of ``name`` left nvcc's output (ptxas register
    and shared-memory report included)."""
    return BUILD_DIR / f"lib{name}.log"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def _compile(name: str) -> None:
    """``nvcc`` ``csrc/<name>.cu`` into its library; raises with nvcc's
    output when the compile fails."""
    tmp = library_path(name).with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log_path(name).write_text(res.stdout)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build of {name} failed (nvcc exit {res.returncode}):\n{res.stdout}")
    os.replace(tmp, library_path(name))  # atomic: no half-written lib


def build(name: str) -> bool:
    """Compile ``csrc/<name>.cu`` if its library is stale; returns whether
    it did."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stale = _stale(name)
        if stale:
            _compile(name)
        return stale


def build_all() -> Dict[str, bool]:
    """Compile every stale ``csrc/*.cu``; returns {name: rebuilt}."""
    return {name: build(name) for name in sorted(p.stem for p in CSRC.glob("*.cu"))}


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if stale)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
