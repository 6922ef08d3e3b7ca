"""Fused AdamW leaf update for the port's optimizer: a hand-written Hopper kernel.

Replaces the JAX package's Pallas TPU kernel
``kernels/adamw_update.py:_adamw_kernel`` (``adamw_update``): the whole
elementwise AdamW chain (moment updates, bias correction, decoupled weight
decay, parameter write) in one pass, f32 math, the parameter written back
in its own dtype.  The CUDA source is ``repro_torch/csrc/adamw_update.cu``;
its header says what bounds it on an H100 (memory traffic, 22 bytes per
element for a bf16 parameter and gradient).

Unlike the Pallas kernel, which returns new arrays, this one updates
``p``, ``m`` and ``v`` in place: the full-width phi4 step has no room on an
80 GB card for a second copy of its 30.7 GB of f32 moments.  ``lr``,
``bc1`` and ``bc2`` travel in a 3-float tensor on the parameter's device
(``scalars``), so the host never waits on the device for them.

On a CPU tensor the wrapper runs ``adamw_update_plain`` (the oracle) and
copies its result into ``p``, ``m`` and ``v`` (a ``meta`` tensor takes it
too, for shapes: ``build.takes_plain``); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}

launches = 0          # kernel launches in this process (chip_smoke reads it)


def adamw_update_plain(p, g, m, v, scalars, *, b1: float, b2: float,
                       eps: float, weight_decay: float = 0.0):
    """The kernel's plain version -> new (p, m, v); ``scalars`` is
    [lr, bc1, bc2]."""
    lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    return ref.adamw_update_ref(p, g, m, v, lr, bc1, bc2, b1=b1, b2=b2,
                                eps=eps, weight_decay=weight_decay)


def _check(p, g, m, v, scalars) -> None:
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"p {tuple(p.shape)}, g {tuple(g.shape)}, m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)} differ")
    if scalars.shape != (3,) or scalars.dtype != torch.float32:
        raise ValueError("scalars must be a (3,) f32 tensor [lr, bc1, bc2]")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("the moments m and v must be f32")
    if p.dtype not in _DTYPE_CODE or g.dtype not in _DTYPE_CODE:
        raise TypeError(f"p {p.dtype} / g {g.dtype}: the kernel takes "
                        f"{list(_DTYPE_CODE)}")
    devs = {t.device for t in (p, g, m, v, scalars)}
    if len(devs) != 1:
        raise ValueError(f"p, g, m, v and scalars must be on one device, "
                         f"not {sorted(map(str, devs))}")
    build.takes_plain("adamw_update", p)
    if not all(t.is_contiguous() for t in (p, g, m, v, scalars)):
        raise ValueError("p, g, m, v and scalars must be contiguous")


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, scalars: torch.Tensor, *, b1: float,
                 b2: float, eps: float, weight_decay: float = 0.0):
    """One AdamW step for a leaf of any shape, in place; returns (p, m, v).

    p f32/bf16, g f32/bf16, m/v f32, all of p's shape and contiguous;
    ``scalars`` = [lr, 1 - b1^t, 1 - b2^t] as f32 on p's device.
    """
    global launches
    _check(p, g, m, v, scalars)
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if build.takes_plain("adamw_update", p):
        new_p, new_m, new_v = adamw_update_plain(p, g, m, v, scalars, **hyper)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
        return p, m, v
    n = p.numel()
    if n == 0:
        return p, m, v
    lib = build.load("adamw_update")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.repro_torch_adamw_update(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            scalars.data_ptr(), _DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype],
            n, b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, stream)
    if rc != 0:
        raise RuntimeError(f"adamw_update launch failed: CUDA error {rc}")
    launches += 1
    return p, m, v
