"""Grouped matmul for the MoE experts: a hand-written Hopper kernel.

Replaces the JAX package's Pallas TPU kernel ``kernels/moe_gmm.py:_gmm_kernel``
(its ``pl.pallas_call`` in ``gmm``): for every expert e,
``out[e] = x[e] @ w[e]`` with x (E,C,D), w (E,D,F) and out (E,C,F) in x's
dtype, summed in f32.  The model's gate, up and out products of its
expert buckets all run through it, in prefill, decode and training.  The
CUDA source is ``repro_torch/csrc/moe_gmm.cu``; its header says how the
kernel walks the buckets and what bounds each path on an H100.

Occupied rows.  ``rows`` (int32 (E,), on x's device, or None for C rows
everywhere) counts the rows of each bucket that hold routed entries, its
first rows: the dispatch's ``min(count_e, cap_e)``.  The kernel clamps
each value to [0, C].  Output rows c >= rows[e] are exact zeros; rows of x
at or past rows[e] may hold anything, NaN included, and never reach the
result; an expert with rows[e] == 0 reads nothing of w[e].  So the weights
of the experts no entry chose are not read at all: kimi's decode step
fills at most 32 of its 384 buckets.  The values stay on the device (no
host sync), and a call whose rows are all zero launches all the same.

Paths, from the dtype and C: f16/bf16 with C above 8 multiply with
``wgmma`` on tiles that TMA loads into a ring of shared-memory stages, in
a persistent grid (Hopper's route to the tensor cores' rate; granite's
prefill bucket, 53.2 MB for 6.7 GFLOP, is bytes-bound at 15.9 us, and
the tiles' repeated reads of the operands through L2 are what the
measured times follow);
f16/bf16 with C of 8 or less, a decode step's buckets, run a batched GEMV
with 16-byte weight loads (granite's decode bucket streams 33.6 MB of
weights, 10.1 us); f32 keeps the first port's CUDA-core kernel, since TF32
would not hold f32's tolerance.  Beyond the Pallas kernel, which asserts
that C, D and F divide its 128-wide blocks, this one takes ragged C, D
and F (200 rows in a 512-token prefill, 2 in a 4-slot decode step).  x
and w are read through their strides (unit stride on the last axis), so
one group's slice of the stacked weights goes in without a copy.

On a CPU tensor the wrapper runs the plain version (``gmm_plain``: the
oracle ``ref.gmm_ref`` with x and the output masked past ``rows`` by
``torch.where``; a ``meta`` tensor too, for shapes and FLOPs:
``build.takes_plain``); on a CUDA tensor it launches the kernel or raises.

Training goes through ``gmm_train``, a ``torch.autograd.Function`` whose
backward is two more launches of the same entry point, each reading its
operands in place: ``dx = dy @ w^T`` (w read as the product's K-major B)
and ``dw = x^T @ dy`` (x read as an M-major A), grouped by expert and
summed in f32 over the occupied rows only, where the reference
differentiates its batched einsum through XLA.  No operand is copied, in
f32 either (its kernel reads both strides).  On a CPU tensor both
directions run their plain versions.  Serving calls ``gmm`` directly,
under ``no_grad``, and pays nothing for the Function.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gmm_ref

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# out[e] = A[e] B[e] in the entry point's three layouts (csrc Mode)
_FWD, _DX, _DW = 0, 1, 2

launches = 0          # kernel launches in this process (chip_smoke reads it)


def _check(x, w) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x (E,C,D) and w (E,D,F), not {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")


def _check_rows(rows: Optional[torch.Tensor], E: int, device) -> None:
    if rows is None:
        return
    if (rows.dtype != torch.int32 or tuple(rows.shape) != (E,)
            or rows.device != device or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous int32 ({E},) tensor on "
                         f"{device}, not {rows.dtype} {tuple(rows.shape)} on "
                         f"{rows.device}")


def _keep(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """t (E, C, ...) with rows c >= rows[e] replaced by zeros (a select, so
    NaN there goes too)."""
    live = torch.arange(t.shape[1], device=t.device) < rows[:, None]
    return torch.where(live[:, :, None], t, 0)


def gmm_plain(x: torch.Tensor, w: torch.Tensor,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain version: an f32 einsum cast to x's dtype, with x
    and the output masked past ``rows``."""
    _check(x, w)
    _check_rows(rows, x.shape[0], x.device)
    if rows is None:
        return gmm_ref(x, w)
    return _keep(gmm_ref(_keep(x, rows), w), rows)


def _dx_plain(dy, w, rows):
    """dx (E,C,D) = dy @ w^T over the occupied rows, in dy's dtype."""
    if rows is not None:
        dy = _keep(dy, rows)
    dx = torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(dy.dtype)
    return dx if rows is None else _keep(dx, rows)


def _dw_plain(x, dy, rows):
    """dw (E,D,F) = x^T @ dy summed over the occupied rows, in x's dtype."""
    if rows is not None:
        x, dy = _keep(x, rows), _keep(dy, rows)
    return torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(x.dtype)


def _launch(mode: int, a: torch.Tensor, b: torch.Tensor,
            rows: Optional[torch.Tensor], M: int, N: int,
            K: int) -> torch.Tensor:
    """out (E,M,N) = A B through the entry point; a and b as stored (see
    ``csrc/moe_gmm.cu``'s ``repro_torch_gmm``)."""
    global launches
    names = {_FWD: ("x", "w"), _DX: ("dy", "w"), _DW: ("x", "dy")}[mode]
    if b.device != a.device:
        raise ValueError(f"{names[0]} and {names[1]} must be on one device")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"{names[0]}/{names[1]} dtypes {a.dtype}/{b.dtype}: "
                        f"the kernel takes one of {list(_DTYPE_CODE)} for "
                        f"both")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError(f"the last axis of {names[0]} and {names[1]} must be "
                         f"contiguous")
    if a.dtype != torch.float32:
        build.require_aligned16(names[0], a)
        build.require_aligned16(names[1], b)
    E = a.shape[0]
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 4)(a.stride(0), a.stride(1), b.stride(0),
                                      b.stride(1))
    lib = build.load("moe_gmm")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.repro_torch_gmm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 None if rows is None else rows.data_ptr(),
                                 _DTYPE_CODE[a.dtype], mode, E, M, N, K,
                                 strides, stream)
    if rc != 0:
        raise RuntimeError(
            f"gmm launch failed: CUDA error {rc} ({names[0]} strides "
            f"{a.stride()}, {names[1]} strides {b.stride()}; TMA takes "
            f"strides that are positive multiples of 16 bytes below 2^40)")
    launches += 1
    return out


def gmm(x: torch.Tensor, w: torch.Tensor,
        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E,C,D) @ w (E,D,F) -> (E,C,F) in x.dtype, summed in f32; with
    ``rows``, output rows c >= rows[e] are zeros and x's rows there are
    never used (see the module docstring).

    x and w share one dtype (f32, f16 or bf16) on the card; each may be a
    strided view whose last axis is contiguous, and in f16/bf16 its rows
    start on 16 bytes (``ValueError`` otherwise, naming the stride).
    Nothing is launched when the output is empty.
    """
    _check(x, w)
    _check_rows(rows, x.shape[0], x.device)
    if build.takes_plain("gmm", x):
        return gmm_plain(x, w, rows)
    E, C, D = x.shape
    return _launch(_FWD, x, w, rows, C, w.shape[2], D)


class _GMM(torch.autograd.Function):
    """``gmm`` with its gradient through the same kernel."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w, rows)
        return gmm(x, w, rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows = ctx.saved_tensors
        dy = dy.contiguous()
        plain = build.takes_plain("gmm", dy)
        E, C, D = x.shape
        F = w.shape[2]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (_dx_plain(dy, w, rows) if plain
                  else _launch(_DX, dy, w, rows, C, D, F))
        if ctx.needs_input_grad[1]:
            dw = (_dw_plain(x, dy, rows) if plain
                  else _launch(_DW, x, dy, rows, D, F, C))
        return dx, dw, None


def gmm_train(x: torch.Tensor, w: torch.Tensor,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gmm`` under autograd: the forward launches the kernel once, the
    backward twice (dx (E,C,D), zero past ``rows``, and dw (E,D,F), summed
    over the occupied rows, in x's dtype)."""
    _check(x, w)
    _check_rows(rows, x.shape[0], x.device)
    return _GMM.apply(x, w, rows)
