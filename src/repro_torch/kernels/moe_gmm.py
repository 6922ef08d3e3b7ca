"""Grouped matmul for the MoE experts: a hand-written Hopper kernel.

Replaces the JAX package's Pallas TPU kernel ``kernels/moe_gmm.py:_gmm_kernel``
(its ``pl.pallas_call`` in ``gmm``): for every expert e,
``out[e] = x[e] @ w[e]`` with x (E,C,D), w (E,D,F) and out (E,C,F) in x's
dtype, summed in f32.  The model's gate, up and out products of its
expert buckets all run through it, in prefill and in decode.  The CUDA
source is ``repro_torch/csrc/moe_gmm.cu``; its header says how the Pallas
grid maps onto CUDA blocks and what bounds the kernel on an H100.

Both of granite-moe's buckets are bytes-bound on an H100 (the prefill
bucket moves 53.2 MB for 6.7 GFLOP, 15.9 us at 3.35 TB/s; the decode one
streams 33.6 MB of weights, 10.1 us), so the kernel picks its path by the
dtype and C to stream the weights once at the card's rate: f16/bf16 with
C above 8 multiply on the tensor cores (``mma.sync``) from a ring of
``cp.async`` stages; f16/bf16 with C of 8 or less, a decode step's
buckets, run a batched GEMV with 16-byte weight loads; f32 keeps the
first port's CUDA-core kernel, since TF32 would not hold f32's tolerance.

Beyond the Pallas kernel, which asserts that C, D and F divide its
128-wide blocks, this one masks ragged C, D and F: the model's bucket
capacities (200 rows in a 512-token prefill, 2 in a 4-slot decode step)
divide nothing.  x and w are read through their strides (unit stride on
the last axis), so one group's slice of the stacked weights goes in
without a copy.

On a CPU tensor the wrapper runs the plain version (``gmm_plain``, the
oracle ``ref.gmm_ref``; a ``meta`` tensor too, for shapes:
``build.takes_plain``); on a CUDA tensor it launches the kernel or raises.

Training goes through ``gmm_train``, a ``torch.autograd.Function`` whose
backward is two more launches of the same kernel: ``dx = dy @ w^T`` and
``dw = x^T @ dy``, each grouped by expert and summed in f32, where the
reference differentiates its batched einsum through XLA.  The kernel reads
a contiguous last axis, so the transposed operand (w^T, x^T) is copied
first, each row padded to start on 16 bytes, since x^T's rows are a
bucket's ragged capacity long (ROADMAP A6: a kernel that reads it
transposed).  On a
CPU tensor both directions run ``gmm_plain``.  Serving calls ``gmm``
directly, under ``no_grad``, and pays nothing for the Function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gmm_ref

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

launches = 0          # kernel launches in this process (chip_smoke reads it)


def _check(x, w) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x (E,C,D) and w (E,D,F), not {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")


def gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: an f32 einsum cast to x's dtype."""
    _check(x, w)
    return gmm_ref(x, w)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E,C,D) @ w (E,D,F) -> (E,C,F) in x.dtype, summed in f32.

    x and w share one dtype (f32, f16 or bf16) on the card; each may be a
    strided view whose last axis is contiguous, and in f16/bf16 its rows
    start on 16 bytes (``ValueError`` otherwise, naming the stride).
    Nothing is launched when the output is empty.
    """
    global launches
    _check(x, w)
    if build.takes_plain("gmm", x):
        return gmm_plain(x, w)
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x/w dtypes {x.dtype}/{w.dtype}: the kernel takes "
                        f"one of {list(_DTYPE_CODE)} for both")
    if x.stride(2) != 1 or w.stride(2) != 1:
        raise ValueError("the last axis of x and w must be contiguous")
    if x.dtype != torch.float32:
        build.require_aligned16("x", x)
        build.require_aligned16("w", w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 4)(x.stride(0), x.stride(1), w.stride(0),
                                      w.stride(1))
    lib = build.load("moe_gmm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_torch_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 _DTYPE_CODE[x.dtype], E, C, D, F, strides,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"gmm launch failed: CUDA error {rc}")
    launches += 1
    return out


def _transposed(t: torch.Tensor) -> torch.Tensor:
    """t (E, A, B) -> t^T (E, B, A): a copy with a contiguous last axis whose
    rows start on 16 bytes, as the kernel's half-precision loads need."""
    E, A, B = t.shape
    pad = -A % (16 // t.element_size())
    out = t.new_empty((E, B, A + pad))[:, :, :A]
    out.copy_(t.transpose(1, 2))
    return out


class _GMM(torch.autograd.Function):
    """``gmm`` with its gradient through the same kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, _transposed(w))
        if ctx.needs_input_grad[1]:
            dw = gmm(_transposed(x), dy)
        return dx, dw


def gmm_train(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``gmm`` under autograd: the forward launches the kernel once, the
    backward twice (dx (E,C,D) and dw (E,D,F), in x's dtype)."""
    return _GMM.apply(x, w)
