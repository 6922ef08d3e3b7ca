"""CONNECT — connected-object labeling in time+space (paper §III, refs
[21][22][23]).

CONNECT's insight: earth-science phenomena must be tracked through their
whole life-cycle by connecting pixels in BOTH space and time.  That is 3-D
connected-component labeling over (T, lat, lon) masks with 6-connectivity
(the T links give the life-cycle).

A port of the JAX package's ``apps/connect/segment.py``: iterative min-label
propagation — each voxel takes the min label of its masked neighbors until
fixpoint — as a loop of elementwise shifts on the mask's device (the JAX
module's ``lax.while_loop``; it holds no Pallas kernel, so neither does
this).  Integer arithmetic throughout: the labels equal the reference's
exactly.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

_BIG = 2 ** 30


def _neighbor_min(lbl: torch.Tensor) -> torch.Tensor:
    """Min over the 6-neighborhood (T, Y, X), edge-padded with _BIG."""
    out = lbl
    for axis in range(3):
        n = lbl.shape[axis]
        big = torch.full_like(lbl.narrow(axis, 0, 1), _BIG)
        fwd = torch.cat([lbl.narrow(axis, 1, n - 1), big], dim=axis)
        bwd = torch.cat([big, lbl.narrow(axis, 0, n - 1)], dim=axis)
        out = torch.minimum(out, torch.minimum(fwd, bwd))
    return out


def connect_label(mask: torch.Tensor) -> torch.Tensor:
    """Label connected objects of a binary (T, Y, X) mask, on its device.

    Returns int32 labels: 0 = background, else the (flat-index+1) of the
    object's minimal voxel — stable, order-independent ids.
    """
    mask = mask.to(torch.bool)
    ids = torch.arange(1, mask.numel() + 1, dtype=torch.int32,
                       device=mask.device).reshape(mask.shape)
    big = torch.full_like(ids, _BIG)
    lbl = torch.where(mask, ids, big)
    while True:
        new = torch.where(mask, torch.minimum(lbl, _neighbor_min(lbl)), big)
        if not bool(torch.any(new != lbl)):
            break
        lbl = new
    return torch.where(mask, lbl, torch.zeros_like(lbl))


def object_stats(labels: np.ndarray) -> List[Dict]:
    """Life-cycle statistics per object (host-side post-processing, paper
    Step 4): voxels, genesis/termination frame, duration, centroid drift."""
    labels = np.asarray(labels)
    out = []
    for obj in np.unique(labels):
        if obj == 0:
            continue
        t, y, x = np.nonzero(labels == obj)
        out.append({
            "id": int(obj),
            "voxels": int(t.size),
            "genesis_frame": int(t.min()),
            "termination_frame": int(t.max()),
            "duration": int(t.max() - t.min() + 1),
            "centroid": (float(y.mean()), float(x.mean())),
            "drift": float(np.hypot(y[t == t.max()].mean() -
                                    y[t == t.min()].mean(),
                                    x[t == t.max()].mean() -
                                    x[t == t.min()].mean())),
        })
    return sorted(out, key=lambda d: -d["voxels"])
