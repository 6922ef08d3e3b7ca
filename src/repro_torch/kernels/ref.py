"""Plain PyTorch oracles for the port's kernels (the correctness contract).

Each is a line-for-line port of the JAX package's ``kernels/ref.py``
function of the same name: the naive, obviously-correct formulation that a
kernel is held against, on the CPU in the tests and on the card in
``chip_smoke.py``.
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


def ssd_ref(x, dt, a, B_, C, h0):
    """Naive Mamba2/SSD recurrence, step by step.

    x (B,S,H,hd); dt (B,S,H) > 0; a (H,) < 0; B_/C (B,S,N); h0 (B,H,hd,N).
    Returns (y (B,S,H,hd) f32, h_last (B,H,hd,N) f32).
    """
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t] * a)                           # (B,H)
        upd = torch.einsum("bh,bn,bhd->bhdn", dt[:, t].float(),
                           B_[:, t].float(), x[:, t].float())
        h = da[..., None, None] * h + upd
        ys.append(torch.einsum("bn,bhdn->bhd", C[:, t].float(), h))
    return torch.stack(ys, dim=1), h


def wkv6_ref(r, k, v, logw, u, s0):
    """Naive RWKV6 recurrence: S_t = diag(w_t) S_{t-1} + k_t^T v_t,
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t).

    r/k/v/logw (B,S,H,hd); u (H,hd); s0 (B,H,hd,hd).  Returns
    (y (B,S,H,hd) f32, s_last (B,H,hd,hd) f32).
    """
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        rf, kf, vf = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = torch.einsum("bhi,bhj->bhij", kf, vf)
        ys.append(torch.einsum("bhi,bhij->bhj", rf,
                               s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, t].float())[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def gmm_ref(x, w):
    """Grouped matmul: x (E,C,D) @ w (E,D,F) -> (E,C,F) in x.dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


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
