"""Flash attention for the port's prefill: a hand-written Hopper kernel.

Replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py:_flash_kernel`` (its ``pl.pallas_call`` in
``flash_attention``): ``softmax(q k^T * scale [causal]) v`` with an online
max and sum over k tiles and f32 accumulators, written in q's dtype.  The
CUDA source is ``repro_torch/csrc/flash_attention.cu``; its header says how
the Pallas grid maps onto CUDA blocks.

What bounds it on an H100: at phi4-mini prefill shapes (B=1, H=24, KV=8,
S=512, dh=128, bf16) the inputs and output are 8.4 MB against 1.6 GFLOP of
causal work, so the floor is memory traffic (2.5 us at 3.35 TB/s), not the
tensor cores (1.6 us at 989 TFLOP/s).  The design reads q, k and v in place
through their strides (no repeat of KV heads, no transpose copy), keeps
scores and probabilities on chip (registers; shared memory in f32) and
never writes them out, and skips k tiles above the causal diagonal.  In
f16/bf16 it is FlashAttention-2 on the tensor cores: ``mma.sync`` for
Q K^T and P V, K/V tiles double-buffered by ``cp.async``, P rounded to q's
dtype before P V (as the JAX model rounds its probabilities,
``models/attention.py``), row statistics and the final rescale in f32.
f32 keeps the first port's CUDA-core kernel: TF32 products would not hold
its tolerance.

Differences from the Pallas kernel, on purpose:
  * GQA is native: k/v are (B, KV, Sk, dh) with KV dividing H, and query
    head h reads KV head h // (H // KV) (the JAX model's grouping).
  * The causal mask is bottom-right aligned like ``ref.attention_ref``
    (``tril(k=Sk-Sq)``); the Pallas kernel's ``kpos <= qpos`` is top-left
    aligned and disagrees with its own oracle when Sq < Sk.
  * Sq and Sk need not be multiples of the tile: the ragged edge is masked
    inside the kernel.

On a CPU tensor the wrapper runs the plain version (``attention_plain``);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 80, 128)   # 80: zamba2's shared attention
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

launches = 0          # kernel launches in this process (chip_smoke reads it)
# replicas and RL actors prefill from their own threads
_launches_lock = threading.Lock()


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B,H,Sq,dh), (B,KV,Sk,dh)")
    B, H, Sq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    KV = k.shape[1]
    if KV < 1 or H % KV:
        raise ValueError(f"KV heads ({KV}) must divide query heads ({H})")
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")


def attention_plain(q, k, v, *, causal: bool = True, scale=None):
    """The kernel's plain version: the oracle with KV heads expanded
    (head h reads KV head h // (H // KV))."""
    _check(q, k, v)
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    return ref.attention_ref(q, k, v, causal=causal, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """q (B,H,Sq,dh); k/v (B,KV,Sk,dh) -> (B,H,Sq,dh) in q.dtype.

    The inputs may be strided views (e.g. ``x.transpose(1, 2)`` of a
    (B,S,H,dh) projection) as long as dh is contiguous, and in f16/bf16
    their rows start on 16 bytes (``ValueError`` otherwise, naming the
    stride).  On CUDA the result is a (B,H,Sq,dh) view of a (B,Sq,H,dh)
    buffer, so transposing it back to the model layout costs no copy.
    """
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes one of {list(_DTYPE_CODE)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if q.dtype != torch.float32:
        for name, t in (("q", q), ("k", k), ("v", v)):
            build.require_aligned16(name, t)
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    scale = dh ** -0.5 if scale is None else float(scale)
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, KV, Sq, Sk, dh, strides,
            scale, int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {rc}")
    with _launches_lock:
        launches += 1
    return out
