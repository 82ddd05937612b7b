"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` builds
them in seconds into one shared library that ``ctypes`` loads; nothing
includes PyTorch's headers.  Each source compiles in its own ``nvcc``
process, all started together, and one more links the objects.  The
library is built on first use into ``_build/`` beside this file (ignored
by git), named by a hash of every file under ``csrc/`` and the flags, so
an edited source or header rebuilds and concurrent processes never load
a half-written file (each builds in a temporary directory and renames
the library into place).

Every launch function takes pointers and the stream as ``void*`` and
returns the ``cudaError_t`` of its launch; :func:`launch` calls one with
its typed signature and raises with the CUDA message when it fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
SOURCES = ("lane_scan.cu", "pim_gemv.cu", "pim_gemm.cu", "errors.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Launch functions: argument types (pointers and the stream as c_void_p,
# or ctypes would pass them as 32-bit ints); each returns cudaError_t.
ENTRY_POINTS = {
    # cycs, streams, lengths, issue, totals, F, N, num_banks, stream
    "lane_scan_launch": (_P, _P, _P, _P, _P, _I, _L, _I, _P),
    # w, x, ws, xs, out, H, W, w_bits, x_bytes, rows, stream
    "pim_gemv_int_launch": (_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P),
    # w, x, out, H, W, x_bytes, vec, stream
    "pim_gemv_fp_launch": (_P, _P, _P, _I, _L, _I, _I, _P),
    # w, x, ws, out, B, H, W, w_bits, x_bytes, vec, stream
    "pim_gemm_int_launch": (_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P),
    # w, x, out, B, H, W, x_bytes, vec, stream
    "pim_gemm_fp_launch": (_P, _P, _P, _I, _I, _L, _I, _I, _P),
}

# What the last build reported: seconds spent in nvcc (0 when the
# library was already built) and each source's compiler output (ptxas
# resource usage lines).
BUILD_INFO: dict = {"seconds": 0.0, "logs": {}, "path": ""}


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
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join((*COMPILE_FLAGS, *SOURCES)).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: dict[str, list[str]]) -> dict[str, str]:
    """Run the commands at once; raise naming every one that failed."""
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    logs = {name: p.communicate()[0] for name, p in procs.items()}
    failed = [name for name, p in procs.items() if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[name] for name in failed))
    return logs


def build() -> pathlib.Path:
    """Compile the kernels if this source/flag set is not built yet."""
    lib = BUILD_DIR / f"libpim_kernels-{_digest()}.so"
    BUILD_INFO["path"] = str(lib)
    if lib.exists():
        BUILD_INFO["seconds"] = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = {name: pathlib.Path(tmp) / f"{name}.o" for name in SOURCES}
        BUILD_INFO["logs"] = _run_all({
            name: [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(CSRC / name)]
            for name, obj in objs.items()})
        out = pathlib.Path(tmp) / lib.name
        _run_all({"link": [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
                           *map(str, objs.values())]})
        os.replace(out, lib)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point of :data:`ENTRY_POINTS` typed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call the launch function ``name`` (building the library on first
    use); raise with CUDA's message if the launch failed."""
    lib = load_library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.kernels_error_string(err).decode()} "
                           f"(code {err})")
