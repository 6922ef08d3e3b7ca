"""Plain PyTorch oracles for the port's kernels (the correctness contract).

Each is a line-for-line port of the JAX package's ``kernels/ref.py``
function of the same name: the naive, obviously-correct formulation that a
kernel is held against, on the CPU in the tests and on the card in
``chip_smoke.py``.  The other oracles arrive with their kernels.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q (B,H,Sq,dh); k/v (B,H,Sk,dh).  Causal mask is bottom-right
    aligned, ``tril(k=Sk-Sq)``; math in f32, result in q.dtype."""
    B, H, Sq, dh = q.shape
    Sk = k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
