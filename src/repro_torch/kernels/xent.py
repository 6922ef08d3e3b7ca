"""Fused softmax cross-entropy for the port's loss: hand-written Hopper kernels.

Replaces the JAX package's Pallas TPU kernels ``kernels/xent.py``
``_xent_fwd_kernel`` (per-row NLL = lse - gold with an online max and sum
over vocab tiles, optional softcap, saves lse) and ``_xent_bwd_kernel``
(``dy * (softmax - onehot) * (1 - tanh^2)`` recomputed from the saved
lse), and their ``jax.custom_vjp`` ``_xent_core``.  The CUDA source is
``repro_torch/csrc/xent.cu``; its header says how the Pallas grid maps
onto CUDA blocks and what bounds each kernel on an H100 (memory traffic:
the logits are read once forward and read and written once backward).

``softmax_xent`` is a ``torch.autograd.Function`` that saves ``(logits,
labels, lse)`` like ``_xent_core_fwd``.  On a CPU tensor its forward and
backward run ``xent_fwd_plain`` / ``xent_bwd_plain``, plain PyTorch
transcriptions of the two kernel bodies (a ``meta`` tensor takes them too,
for shapes: ``build.takes_plain``); on a CUDA tensor they launch the
kernels or raise.  A label outside [0, V) has gold 0, as in the Pallas
kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}

fwd_launches = 0      # forward-kernel launches in this process
bwd_launches = 0      # backward-kernel launches in this process


def _capped(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def xent_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                   softcap: Optional[float] = None):
    """The forward kernel's plain version -> (nll, lse), both (R,) f32."""
    V = logits.shape[1]
    sc = _capped(logits.float(), softcap)
    m = sc.amax(dim=1).clamp_min(NEG_INF)
    lse = m + torch.log(torch.exp(sc - m[:, None]).sum(dim=1).clamp_min(1e-30))
    valid = (labels >= 0) & (labels < V)
    idx = labels.long().clamp(0, V - 1)[:, None]
    gold = torch.where(valid, torch.take_along_dim(sc, idx, dim=1)[:, 0],
                       torch.zeros((), device=sc.device))
    return lse - gold, lse


def xent_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                   lse: torch.Tensor, dy: torch.Tensor,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """The backward kernel's plain version -> dlogits in logits' dtype."""
    s = logits.float()
    if softcap is None:
        sc, dsc = s, 1.0
    else:
        t = torch.tanh(s / softcap)
        sc, dsc = softcap * t, 1.0 - t * t
    cols = torch.arange(logits.shape[1], device=logits.device)
    p = torch.exp(sc - lse[:, None])
    onehot = (cols[None, :] == labels[:, None]).float()
    return (dy[:, None] * (p - onehot) * dsc).to(logits.dtype)


def _check(logits: torch.Tensor, labels: torch.Tensor,
           softcap: Optional[float]) -> None:
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"logits must be (R, V) and labels (R,); got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.shape[0] < 1 or logits.shape[1] < 1:
        raise ValueError("empty logits")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if logits.device != labels.device:
        raise ValueError("logits and labels must be on one device")
    build.takes_plain("softmax_xent", logits)


def _cuda_args(logits: torch.Tensor, labels: torch.Tensor):
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"logits dtype {logits.dtype}: the kernel takes one "
                        f"of {list(_DTYPE_CODE)}")
    if logits.stride(1) != 1:
        raise ValueError("the vocab axis of logits must be contiguous")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise TypeError("the kernel takes contiguous int32 labels")
    return _DTYPE_CODE[logits.dtype], logits.stride(0)


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor,
             softcap: Optional[float] = None):
    """logits (R, V), labels (R,) int32 -> (nll, lse), both (R,) f32."""
    global fwd_launches
    _check(logits, labels, softcap)
    if build.takes_plain("softmax_xent", logits):
        return xent_fwd_plain(logits, labels, softcap)
    code, row_stride = _cuda_args(logits, labels)
    R, V = logits.shape
    nll = torch.empty(R, dtype=torch.float32, device=logits.device)
    lse = torch.empty(R, dtype=torch.float32, device=logits.device)
    lib = build.load("xent")
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.repro_torch_xent_fwd(
            logits.data_ptr(), labels.data_ptr(), nll.data_ptr(),
            lse.data_ptr(), code, R, V, row_stride, float(softcap or 0.0),
            stream)
    if rc != 0:
        raise RuntimeError(f"xent forward launch failed: CUDA error {rc}")
    fwd_launches += 1
    return nll, lse


def xent_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
             dy: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    """d(sum dy * nll)/d logits, (R, V) in logits' dtype; lse and dy (R,)."""
    global bwd_launches
    _check(logits, labels, softcap)
    if lse.shape != labels.shape or dy.shape != labels.shape:
        raise ValueError("lse and dy must be (R,)")
    if build.takes_plain("softmax_xent", logits):
        return xent_bwd_plain(logits, labels, lse, dy, softcap)
    code, row_stride = _cuda_args(logits, labels)
    for name, t in (("lse", lse), ("dy", dy)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != logits.device:
            raise TypeError(f"{name} must be contiguous f32 on "
                            f"{logits.device}")
    R, V = logits.shape
    dlogits = torch.empty((R, V), dtype=logits.dtype, device=logits.device)
    lib = build.load("xent")
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = lib.repro_torch_xent_bwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            dy.data_ptr(), dlogits.data_ptr(), code, R, V, row_stride,
            float(softcap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"xent backward launch failed: CUDA error {rc}")
    bwd_launches += 1
    return dlogits


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, softcap):
        nll, lse = xent_fwd(logits, labels, softcap)
        ctx.save_for_backward(logits, labels, lse)
        ctx.softcap = softcap
        return nll

    @staticmethod
    def backward(ctx, dy):
        logits, labels, lse = ctx.saved_tensors
        dlogits = xent_bwd(logits, labels, lse, dy.float().contiguous(),
                           ctx.softcap)
        return dlogits, None, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """Per-row softmax cross-entropy: logits (R, V), labels (R,) int ->
    NLL (R,) f32.  Differentiable w.r.t. ``logits`` (the fused forward and
    backward kernels on CUDA); the caller reduces (sum/mean) as needed."""
    if labels.device.type == "cuda":
        labels = labels.to(torch.int32).contiguous()
    return _SoftmaxXent.apply(logits, labels, softcap)
