"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point (the
tensor-core kernels share ``csrc/*.cuh`` headers).  At its first launch in
a process, ``load(name)`` compiles it for Hopper (``sm_90a``) into
``<repo>/build/kernels/lib<name>-<hash>.so``, where the hash covers the
source, the headers and the flags, and loads it.  A file with a plain C
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
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_longlong = ctypes.c_longlong
_c_float = ctypes.c_float
# name -> C entry point -> (argtypes, restype)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "flash_attention": {
        "repro_flash_attention_fwd": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr,                 # q k v o
             _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
             ctypes.POINTER(ctypes.c_longlong),              # 12 strides
             ctypes.c_float, _c_int, _c_int,                 # scale causal window
             ctypes.c_float, _c_ptr],                        # softcap stream
            _c_int),
    },
    "xent": {
        "repro_torch_xent_fwd": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr,                 # logits labels nll lse
             _c_int, _c_int, _c_int, _c_longlong,            # dtype R V row_stride
             _c_float, _c_ptr],                              # softcap stream
            _c_int),
        "repro_torch_xent_bwd": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,         # logits labels lse dy dlogits
             _c_int, _c_int, _c_int, _c_longlong,            # dtype R V row_stride
             _c_float, _c_ptr],                              # softcap stream
            _c_int),
    },
    "adamw_update": {
        "repro_torch_adamw_update": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,         # p g m v scalars
             _c_int, _c_int, _c_longlong,                    # p/g dtype n
             _c_float, _c_float, _c_float, _c_float,         # b1 1-b1 b2 1-b2
             _c_float, _c_float, _c_ptr],                    # eps wd stream
            _c_int),
    },
    "ssm_scan": {
        "repro_torch_ssd_scan": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # x dt a B C h0
             _c_ptr, _c_ptr,                                  # y h_last
             _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # dtype B S H hd N
             ctypes.POINTER(ctypes.c_longlong),               # 10 strides
             _c_ptr],                                         # stream
            _c_int),
        "repro_torch_ssd_walk": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # x dt a B C h0
             _c_ptr, _c_ptr,                                  # y h_last
             _c_int, _c_int, _c_int, _c_int, _c_int,          # B S H hd N
             ctypes.POINTER(ctypes.c_longlong),               # 10 strides
             _c_int, _c_int, _c_int,                          # dsl stages smem
             _c_int, _c_int, _c_int,                          # grid
             _c_ptr],                                         # stream
            _c_int),
    },
    "wkv6": {
        "repro_torch_wkv6": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # r k v logw u s0
             _c_ptr, _c_ptr,                                  # y s_last
             _c_int, _c_int, _c_int, _c_int, _c_int,          # dtype B S H hd
             ctypes.POINTER(ctypes.c_longlong),               # 12 strides
             _c_ptr],                                         # stream
            _c_int),
        "repro_torch_wkv6_walk": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # r k v logw u s0
             _c_ptr, _c_ptr,                                  # y s_last
             _c_int, _c_int, _c_int, _c_int,                  # B S H hd
             ctypes.POINTER(ctypes.c_longlong),               # 12 strides
             _c_int, _c_int, _c_int, _c_int, _c_int,          # slices cluster
                                                              # stages smem
             _c_int, _c_int, _c_int, _c_int,                  # grid threads
             _c_ptr],                                         # stream
            _c_int),
        "repro_torch_wkv6_max_clusters": (
            [_c_int, ctypes.POINTER(ctypes.c_int)],          # cluster out
            _c_int),
    },
    "moe_gmm": {
        "repro_torch_gmm": (
            [_c_ptr, _c_ptr, _c_ptr, _c_ptr,                  # a b out rows
             _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # dtype mode E M N K
             ctypes.POINTER(ctypes.c_longlong),               # 4 strides
             _c_ptr],                                         # stream
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


def takes_plain(name: str, t) -> bool:
    """Whether a wrapper runs its kernel's plain version on ``t``'s device.

    A CPU tensor computes it; a ``meta`` tensor (the dry run,
    ``launch.dryrun``) infers its output shapes through it and computes
    nothing.  On CUDA the wrapper launches its kernel (False); any other
    device raises ``ValueError``."""
    kind = t.device.type
    if kind in ("cpu", "meta"):
        return True
    if kind != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu (meta for shapes), "
                         f"not {t.device}")
    return False


def require_aligned16(name: str, t) -> None:
    """Raise ``ValueError`` unless every row of ``t`` starts on 16 bytes:
    its data pointer and the stride of each axis but the last (of size
    above 1) are multiples of 16 bytes.  The f16/bf16 kernels copy 16-byte
    chunks with ``cp.async`` or vector loads, which need that."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}'s data pointer is {t.data_ptr() % 16} bytes "
                         f"past a 16-byte boundary: the kernel copies "
                         f"16-byte chunks")
    item = t.element_size()
    for dim in range(t.dim() - 1):
        if t.shape[dim] > 1 and t.stride(dim) * item % 16:
            raise ValueError(f"{name}.stride({dim}) is {t.stride(dim)} "
                             f"elements ({t.stride(dim) * item} bytes), not a "
                             f"multiple of 16 bytes: the kernel copies "
                             f"16-byte chunks")


def tma_map(name: str, t, axes, box) -> tuple:
    """A scan kernel's TMA tensor map of view ``t`` as its C side encodes
    it: (dims of ``axes``, innermost first; byte strides of the outer dims;
    ``box``).  A dim of size 1 is never stepped and takes the packed
    stride (the rows inside it, rounded up to 16 bytes).  Raises
    ``ValueError`` naming a stride TMA cannot take: not a positive
    multiple of 16 bytes below 2^40."""
    item = t.element_size()
    dims = tuple(int(t.shape[ax]) for ax in axes)
    packed = -(-dims[0] * item // 16) * 16
    strides = []
    for ax, size in zip(axes[1:], dims[1:]):
        step = int(t.stride(ax)) * item
        if size == 1:
            step = packed
        elif step <= 0 or step % 16 or step >= 1 << 40:
            raise ValueError(f"{name}.stride({ax}) is {t.stride(ax)} "
                             f"elements ({step} bytes): a TMA tensor map "
                             f"takes positive multiples of 16 bytes below "
                             f"2^40")
        strides.append(step)
        packed = step * size
    return dims, tuple(strides), tuple(box)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for one kernel, its output going to the log; returns
    (popen, tmp, final, log, start time) or None when the library is
    already built."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log = so.with_suffix(f".{os.getpid()}.log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return proc, tmp, so, log, time.perf_counter()


def _finish(name: str, started) -> Tuple[str, float]:
    """Wait for nvcc; returns (its output, seconds from its start to its
    end), ("", 0.0) when nothing was built."""
    if started is None:
        return "", 0.0
    proc, tmp, so, log, t0 = started
    proc.wait()
    seconds = time.perf_counter() - t0
    out = log.read_text()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{out}")
    os.replace(tmp, so)          # atomic: a concurrent loader sees all or none
    return out, seconds


def build_all() -> Dict[str, Tuple[str, float]]:
    """Compile every kernel concurrently, one nvcc per source; returns per
    kernel the compiler's output (register and shared-memory use) and the
    seconds its nvcc took."""
    started = {n: _start(n) for n in SIGNATURES}
    pending, done = dict(started), {}
    while pending:               # finish each as it ends, for its own time
        for n, s in list(pending.items()):
            if s is None or s[0].poll() is not None:
                done[n] = _finish(n, s)
                del pending[n]
        time.sleep(0.05)
    return {n: done[n] for n in SIGNATURES}


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
