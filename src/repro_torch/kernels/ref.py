"""Plain PyTorch oracles for the port's kernels (the correctness contract).

Each is a line-for-line port of the JAX package's ``kernels/ref.py``
function of the same name: the naive, obviously-correct formulation that a
kernel is held against, on the CPU in the tests and on the card in
``chip_smoke.py``.  The grouped-matmul, SSD and WKV6 oracles arrive with
their kernels.
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


def softmax_xent_ref(logits, labels, *, softcap=None):
    """Per-row NLL, f32: logits (R,V); labels (R,) int -> (R,) f32."""
    lf = logits.float()
    if softcap is not None:
        lf = softcap * torch.tanh(lf / softcap)
    m = lf.amax(dim=-1)
    lse = m + torch.log(torch.exp(lf - m[:, None]).sum(dim=-1))
    gold = torch.take_along_dim(lf, labels[:, None].long(), dim=-1)[:, 0]
    return lse - gold


def adamw_update_ref(p, g, m, v, lr, bc1, bc2, *, b1, b2, eps,
                     weight_decay=0.0):
    """Unfused AdamW leaf update (the float32/full state recipe): f32 math,
    params back in p.dtype.  Returns new (p, m, v)."""
    g32 = g.float()
    m_new = b1 * m.float() + (1.0 - b1) * g32
    v_new = b2 * v.float() + (1.0 - b2) * torch.square(g32)
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if weight_decay:
        update = update + weight_decay * p.float()
    new_p = (p.float() - lr * update).to(p.dtype)
    return new_p, m_new, v_new
