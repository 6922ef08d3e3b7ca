"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point.  At its
first launch in a process, ``load(name)`` compiles it for Hopper
(``sm_90a``) into ``<repo>/build/kernels/lib<name>-<hash>.so``, where the
hash covers the source and the flags, and loads it.  A file with a plain C
interface builds in seconds; nothing includes PyTorch's headers.
``build_all`` compiles every kernel at once, one ``nvcc`` per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
# name -> C entry point -> (argtypes, restype)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "flash_attention": {
        "repro_flash_attention_fwd": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr,                 # q k v o
             _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
             ctypes.POINTER(ctypes.c_longlong),              # 12 strides
             ctypes.c_float, _c_int, _c_ptr],                # scale causal stream
            _c_int),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for one kernel; returns (popen, tmp, final, log) or None
    when the library is already built."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log = so.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, log


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, so, log = started
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{out}")
    os.replace(tmp, so)          # atomic: a concurrent loader sees all or none
    return out


def build_all() -> Dict[str, str]:
    """Compile every kernel concurrently, one nvcc per source; returns the
    compiler's output (register and shared-memory use) per kernel."""
    started = {n: _start(n) for n in SIGNATURES}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use in this process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
