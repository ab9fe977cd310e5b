"""Builds the port's CUDA kernels (`csrc/*.cu`) and loads them with ctypes.

Each source has a plain C interface and is compiled by `nvcc` for Hopper
(`sm_90a`); all sources compile at once, one `nvcc` process each, and link
into one shared library under `_build/` (named by a hash of the sources, the
headers they share (`csrc/*.cuh`) and the flags, so an edited source or
header rebuilds). The build happens at the first kernel
launch, never at import: the CPU tests import every module on machines
without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source on top of NVCC_FLAGS: the rasterizer's products and
# sums round one at a time, as its plain version's do (no FMA contraction),
# since its 1/255 and 1e-4 thresholds turn ulps into whole splats
SOURCE_FLAGS = {"gaussian_raster.cu": ["-fmad=false"]}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}
_counted: Dict[str, object] = {}  # "module:qualname" -> every wrapper `count` has seen
build_log = ""  # ptxas register/spill report of the last build
build_seconds = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _build(sources: List[Path], so_path: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s.name, []), "-c", str(s),
                               "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs, failed = [], []
    for s, p in zip(sources, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so_path)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is None:
            sources = sorted(CSRC.glob("*.cu"))
            h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(SOURCE_FLAGS).encode())
            for s in sources + sorted(CSRC.glob("*.cuh")):  # headers the sources include
                h.update(s.name.encode())
                h.update(s.read_bytes())
            so_path = BUILD_DIR / f"liborv_kernels_{h.hexdigest()[:16]}.so"
            t0 = time.perf_counter()
            if not so_path.exists():
                build_log = _build(sources, so_path)
            _lib = ctypes.CDLL(str(so_path))
            build_seconds = time.perf_counter() - t0
        return _lib


def kernel(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point `name` of the library, with its argument types set.
    Every entry point returns the CUDA error of its launch as an int."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def count(wrapper) -> None:
    """Add one to `wrapper.launches` under a lock: the in-process ring
    (`parallel/sp.py:LocalRing`) launches kernels from one thread per rank."""
    with _count_lock:
        wrapper.launches += 1
        _counted[f"{wrapper.__module__}:{wrapper.__qualname__}"] = wrapper


def launch_counts() -> Dict[str, int]:
    """The launch counts of every wrapper that launched in this process, by
    "module:qualname": a worker process sends them to its parent."""
    with _count_lock:
        return {name: w.launches for name, w in _counted.items()}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add another process's `launch_counts` to this process's wrappers."""
    import importlib

    for name, n in counts.items():
        module, qualname = name.split(":")
        wrapper = importlib.import_module(module)
        for part in qualname.split("."):
            wrapper = getattr(wrapper, part)
        with _count_lock:
            wrapper.launches += n


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        fn = library().orv_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({fn(err).decode()})")
