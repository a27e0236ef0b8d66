"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface: ``nvcc`` compiles it for
``sm_90a`` into a shared library, which ``ctypes`` loads. Nothing is built
when a module is imported; the first kernel launch builds (``build_all``
starts one ``nvcc`` per source at once for a caller that wants them all).
The library name carries a hash of the source, of the headers beside it
(``csrc/*.cuh``) and of the flags, so an edited source is never served by a
stale build. The build directory is
``deepcoro_clip_tpu_torch/_build`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}   # name -> ctypes.CDLL, one load per process
build_info: dict = {}  # name -> {"path", "seconds", "log"} of this process's builds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into the build directory if it is not
    there yet; returns the library's path."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info[name] = {"path": str(out),
                        "seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


def build_all(names=("flash_fwd", "flash_fwd_proj", "flash_bwd", "flash_short",
                     "ring_attention")) -> None:
    """Build several sources side by side, one ``nvcc`` process each."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        for fut in [ex.submit(build, n) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
