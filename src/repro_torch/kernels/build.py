"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` builds
them in seconds into a shared library that ``ctypes`` loads; nothing
includes PyTorch's headers.  The library is built on first use into
``_build/`` beside this file (ignored by git), named by a hash of the
source and flags, so an edited source rebuilds and concurrent processes
never load a half-written file (each builds to a temporary name and
renames it into place).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
SOURCES = ("lane_scan.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# What the last build reported: seconds spent in nvcc (0 when the
# library was already built) and the compiler's resource usage lines.
BUILD_INFO: dict = {"seconds": 0.0, "log": "", "path": ""}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels if this source/flag set is not built yet."""
    lib = BUILD_DIR / f"libpim_kernels-{_digest()}.so"
    BUILD_INFO["path"] = str(lib)
    if lib.exists():
        BUILD_INFO["seconds"] = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{BUILD_INFO['log']}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry
    points: every pointer and the stream as ``c_void_p``."""
    lib = ctypes.CDLL(str(build()))
    lib.lane_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.lane_scan_launch.restype = ctypes.c_int
    lib.lane_scan_error_string.argtypes = [ctypes.c_int]
    lib.lane_scan_error_string.restype = ctypes.c_char_p
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.lane_scan_error_string(int(err)).decode()
