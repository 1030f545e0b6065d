"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``lotus_tpu_torch/csrc/*.cu`` (one
process per source, all started together) and links them into one shared
library with a plain C interface under ``build/lotus_tpu_torch/`` (beside
the package), named by a hash of the sources and of the shared headers
(``csrc/*.cuh``) so an edit never loads a stale build.  The flags have no
fast-math: the kernels round as the reference does.  ``ctypes`` loads the
library; every device pointer and the stream are passed as ``c_void_p``.
Nothing here runs at import time: a machine without nvcc or a GPU imports
the package and uses the plain PyTorch versions.
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

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "lotus_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# What the last build printed (ptxas register / spill report) and its seconds.
build_log = ""
build_seconds = 0.0


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit to build")


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library path."""
    global build_log, build_seconds
    sources = sorted(SRC_DIR.glob("*.cu"))
    # The shared headers are hashed too, so an edit to one rebuilds.
    hashed = sorted([*sources, *SRC_DIR.glob("*.cuh")])
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in hashed) + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"liblotus_tpu_torch_{digest.hexdigest()[:12]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        procs = [
            subprocess.Popen([cuda_tool("nvcc"), *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)
        ]
        build_log = "".join(p.communicate()[0] for p in procs)
        codes = [p.returncode for p in procs]
        if not any(codes):
            link = subprocess.run([cuda_tool("nvcc"), *ARCH, "-shared", "-o", str(Path(tmp) / "lib.so"), *objs],
                                  capture_output=True, text=True)
            build_log += link.stdout + link.stderr
            codes.append(link.returncode)
        build_seconds = time.perf_counter() - t0
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{build_log}")
        os.replace(Path(tmp) / "lib.so", lib_path)  # atomic: concurrent builders never load a partial file
    return lib_path


def bind(path: Path | str) -> ctypes.CDLL:
    """Load a kernel library and declare its C interface."""
    handle = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    handle.lotus_ivf_probe.argtypes = [vp] * 9 + [ci] * 11 + [vp] + [ctypes.POINTER(ci)] * 2
    handle.lotus_ivf_probe.restype = ci
    handle.lotus_flat_scan.argtypes = [vp] * 9 + [ci] * 8 + [vp] + [ctypes.POINTER(ci)] * 2
    handle.lotus_flat_scan.restype = ci
    handle.lotus_flat_scan_plan.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 2
    handle.lotus_flat_scan_plan.restype = None
    handle.lotus_pool_select.argtypes = [vp] * 11 + [ctypes.c_longlong] + [ci] * 6 + [vp]
    handle.lotus_pool_select.restype = ci
    handle.lotus_pool_select_workspace.argtypes = [ci] * 3
    handle.lotus_pool_select_workspace.restype = ctypes.c_longlong
    handle.lotus_moe_combine.argtypes = [vp] * 6 + [ctypes.c_longlong] + [ci] * 3 + [vp]
    handle.lotus_moe_combine.restype = ci
    handle.lotus_cuda_error_string.argtypes = [ci]
    handle.lotus_cuda_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a non-zero ``cudaGetLastError()``."""
    if code != 0:
        msg = lib().lotus_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
