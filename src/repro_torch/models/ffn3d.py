"""Flood-Filling Network (FFN) — 3-D CNN for object segmentation (paper §III).

The paper adapts Google's FFN (Januszewski et al., Nature Methods 2018) from
connectomics to NASA MERRA-2 IVT volumes: a deep residual stack of 3x3x3
convolutions that, given the raw volume AND the current object-mask belief,
predicts an updated mask; inference iterates this until the mask converges
("flood filling").  Input channels = [ivt, mask], K residual conv blocks,
logit output; ``flood_fill`` iterates the belief update.

A port of the JAX package's ``models/ffn3d.py``.  The parameters keep the
JAX layout (DHWIO, a dict of tensors with the JAX leaf names), so the
bridge and the model files carry them between the stacks unchanged;
``ffn_apply`` permutes each weight to ``F.conv3d``'s (O, I, D, H, W) and
the activations to NCDHW.  SAME padding is ``k // 2`` for the odd kernels
used here (3 and the 1x1x1 head).  The JAX model has no Pallas kernel (its
convolutions are ``lax.conv_general_dilated``), so this one has none.

Precision: the convolutions run in f32, the reference's semantics, with
deterministic algorithms.  On the card cuDNN would run f32 convolutions in
TF32 (``torch.backends.cudnn.allow_tf32`` defaults to True) and may pick
backward algorithms that add with atomics, so two runs of one training
could differ.  ``reference_convs()`` turns TF32 off and deterministic
algorithms on while FFN work runs, and puts the caller's settings back
when the last user leaves.  The card then differs from the CPU only by
the order of f32 sums, and a run's results do not depend on where (or how
often) it ran.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import PSpec


@dataclass(frozen=True)
class FFNConfig:
    depth: int = 8              # residual blocks (paper's "deep stack")
    width: int = 32             # feature maps
    kernel: int = 3
    fov: tuple = (16, 32, 32)   # (t, lat, lon) field of view
    flood_iters: int = 4
    mask_init: float = 0.05     # initial belief inside the seed


def ffn_schema(cfg: FFNConfig) -> Dict[str, PSpec]:
    k, w = cfg.kernel, cfg.width
    fan_stem = (k ** 3 * 2) ** -0.5
    fan_blk = (k ** 3 * w) ** -0.5
    schema: Dict[str, PSpec] = {
        "stem": PSpec((k, k, k, 2, w), (None,) * 5, scale=fan_stem),
        "head": PSpec((1, 1, 1, w, 1), (None,) * 5, scale=0.05),
        "head_b": PSpec((1,), (None,), "zeros"),
    }
    for i in range(cfg.depth):
        schema[f"block{i}_a"] = PSpec((k, k, k, w, w), (None,) * 5,
                                      scale=fan_blk)
        # zero-init the second conv: each residual block starts as identity
        schema[f"block{i}_b"] = PSpec((k, k, k, w, w), (None,) * 5, "zeros")
    return schema


class _ReferenceConvs:
    """Reference count of the threads inside ``reference_convs``: the
    cuDNN flags are process-wide, so they are set by the first to enter
    and restored by the last to leave (workers run chunks concurrently)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.users = 0
        self.saved = (True, False)


_REF = _ReferenceConvs()


@contextlib.contextmanager
def reference_convs():
    """Run the FFN's convolutions on the card in f32 (no TF32) with
    deterministic algorithms."""
    cudnn = torch.backends.cudnn
    with _REF.lock:
        if _REF.users == 0:
            _REF.saved = (cudnn.allow_tf32, cudnn.deterministic)
            cudnn.allow_tf32, cudnn.deterministic = False, True
        _REF.users += 1
    try:
        yield
    finally:
        with _REF.lock:
            _REF.users -= 1
            if _REF.users == 0:
                cudnn.allow_tf32, cudnn.deterministic = _REF.saved


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME, stride 1: x (B, I, T, H, W), w DHWIO -> (B, O, T, H, W)."""
    return F.conv3d(x, w.permute(4, 3, 0, 1, 2), padding=w.shape[0] // 2)


def ffn_apply(cfg: FFNConfig, params, ivt: torch.Tensor,
              mask_logit: torch.Tensor) -> torch.Tensor:
    """One FFN belief update.  ivt (B,T,H,W); mask_logit (B,T,H,W) ->
    updated mask logits (residual, as in the original FFN)."""
    x = torch.stack([ivt, torch.sigmoid(mask_logit)], dim=1)  # (B,2,T,H,W)
    h = torch.relu(_conv(x, params["stem"]))
    for i in range(cfg.depth):
        r = torch.relu(_conv(h, params[f"block{i}_a"]))
        r = _conv(r, params[f"block{i}_b"])
        h = torch.relu(h + r)
    delta = _conv(h, params["head"])[:, 0] + params["head_b"]
    return mask_logit + delta          # FFN updates its belief residually


def seed_mask(cfg: FFNConfig, shape, device="cuda") -> torch.Tensor:
    """Center-seeded initial belief (logit space), as in FFN inference."""
    B, T, H, W = shape
    # the log in f32, as the reference takes it
    logit0 = torch.log(torch.tensor(cfg.mask_init / (1 - cfg.mask_init),
                                    dtype=torch.float32)).item()
    m = torch.full((B, T, H, W), logit0, dtype=torch.float32, device=device)
    m[:, :, H // 2, W // 2] = -logit0
    return m


def flood_fill(cfg: FFNConfig, params, ivt: torch.Tensor,
               iters: int | None = None) -> torch.Tensor:
    """Iterated belief updates (the 'flood fill')."""
    it = cfg.flood_iters if iters is None else iters
    m = seed_mask(cfg, ivt.shape, ivt.device)
    for _ in range(it):
        m = ffn_apply(cfg, params, ivt, m)
    return m


def bce_loss(cfg: FFNConfig, params, ivt: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Train objective: BCE of the one-step update from the seed belief."""
    logits = ffn_apply(cfg, params, ivt,
                       seed_mask(cfg, ivt.shape, ivt.device))
    z = labels.to(torch.float32)
    bce = torch.clamp_min(logits, 0) - logits * z + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.mean(bce)


def iou(pred_mask: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    p = pred_mask.to(torch.bool)
    l = labels.to(torch.bool)
    inter = torch.sum(p & l)
    union = torch.clamp_min(torch.sum(p | l), 1)
    return inter / union
