"""Synthetic MERRA-2-like IVT volumes — the case study's data substrate.

The paper's Step 1 downloads 3-hourly NASA MERRA-2 reanalysis (576 x 361
global grid) and derives Integrated Water Vapor Transport (IVT); intense
filament-shaped IVT structures ("atmospheric rivers") are what CONNECT/FFN
segment.  Offline we synthesize statistically similar volumes: smooth
correlated background + advecting filament events, seeded per time-chunk so
any worker can (re)generate any chunk — which is exactly what makes the
queue-driven download step idempotent.

A copy of the JAX package's ``data/volumes.py`` (numpy only): the same
generator, byte for byte, so either stack can regenerate or read the
other's chunks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

GRID_LAT, GRID_LON = 361, 576     # MERRA-2 full horizontal resolution


def _smooth(a: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Box-smooth along axis (cheap separable correlation)."""
    n = a.shape[axis]
    out = np.cumsum(a, axis=axis, dtype=np.float32)
    lo = np.take(out, np.maximum(np.arange(n) - k, 0), axis=axis)
    out = (np.take(out, np.minimum(np.arange(n) + k, n - 1), axis=axis) - lo)
    return out / (2 * k + 1)


@dataclass(frozen=True)
class VolumeSpec:
    lat: int = 96                 # reduced grid for CPU tests; 361 at scale
    lon: int = 144                # 576 at scale
    frames: int = 24              # 3-hourly steps per chunk
    events: int = 3               # filament events per chunk
    threshold: float = 0.55      # IVT intensity -> binary CONNECT label


def generate_chunk(spec: VolumeSpec, chunk_id: int) -> Tuple[np.ndarray,
                                                             np.ndarray]:
    """Returns (ivt (T,lat,lon) f32 in [0,1], labels (T,lat,lon) uint8)."""
    rng = np.random.RandomState(chunk_id % 2**31)
    T, LA, LO = spec.frames, spec.lat, spec.lon
    base = rng.randn(T, LA, LO).astype(np.float32)
    for ax, k in ((0, 2), (1, 6), (2, 6)):
        base = _smooth(base, k, ax)
    base = (base - base.min()) / (np.ptp(base) + 1e-6) * 0.45

    yy, xx = np.mgrid[0:LA, 0:LO].astype(np.float32)
    for _ in range(spec.events):
        # an advecting, rotating filament (atmospheric-river analogue)
        cy, cx = rng.uniform(0.2, 0.8) * LA, rng.uniform(0.1, 0.5) * LO
        vy, vx = rng.uniform(-1, 1), rng.uniform(1.0, 3.0)
        ang = rng.uniform(0, np.pi)
        length, width = rng.uniform(0.2, 0.4) * LO, rng.uniform(2, 5)
        amp = rng.uniform(0.5, 0.9)
        for t in range(T):
            oy, ox = cy + vy * t, cx + vx * t
            dy, dx = yy - oy, xx - ox
            u = dx * np.cos(ang) + dy * np.sin(ang)
            w = -dx * np.sin(ang) + dy * np.cos(ang)
            blob = np.exp(-(u / length) ** 2 - (w / width) ** 2)
            base[t] += amp * blob.astype(np.float32)
    ivt = np.clip(base, 0, 1.5) / 1.5
    labels = (ivt > spec.threshold).astype(np.uint8)
    return ivt.astype(np.float32), labels


def chunk_keys(n_chunks: int, prefix: str = "merra/ivt") -> List[str]:
    return [f"{prefix}/chunk_{i:05d}" for i in range(n_chunks)]


def subvolumes(ivt: np.ndarray, labels: np.ndarray, fov: Tuple[int, int, int],
               stride: Tuple[int, int, int]):
    """Sliding (t, lat, lon) training windows for the FFN (paper Step 2)."""
    T, LA, LO = ivt.shape
    ft, fy, fx = fov
    st, sy, sx = stride
    out = []
    for t0 in range(0, max(T - ft + 1, 1), st):
        for y0 in range(0, max(LA - fy + 1, 1), sy):
            for x0 in range(0, max(LO - fx + 1, 1), sx):
                out.append((ivt[t0:t0 + ft, y0:y0 + fy, x0:x0 + fx],
                            labels[t0:t0 + ft, y0:y0 + fy, x0:x0 + fx]))
    return out
