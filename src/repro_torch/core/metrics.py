"""Measurement layer — the Prometheus/Grafana analogue.

The paper's methodology is "constantly measuring, learning, and informing
every aspect of a machine learning workflow" (CHASE-CI §VI, Figs 3-6,
Table I).  This registry provides counters / gauges / histograms plus
timestamped series, and renders the paper's Table I (per-step resource
summary) from StepReports.  This copy holds only what serving, the
router, the orchestrator, the elastic trainer and the RL workload call.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Series:
    """One metric stream.  Pod/worker threads append concurrently while
    dashboards summarize, so every read derives from ONE locked snapshot —
    the registry's dict lock alone cannot make count/mean/total agree."""
    points: List[Tuple[float, float]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def record(self, value: float, ts: Optional[float] = None):
        with self._lock:
            self.points.append((time.time() if ts is None else ts,
                                float(value)))

    def snapshot(self) -> List[Tuple[float, float]]:
        """A consistent copy of the points at one instant."""
        with self._lock:
            return list(self.points)

    @property
    def last(self) -> float:
        with self._lock:
            return self.points[-1][1] if self.points else 0.0

    @property
    def total(self) -> float:
        return sum(v for _, v in self.snapshot())

    @property
    def max(self) -> float:
        return max((v for _, v in self.snapshot()), default=0.0)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile of recorded values, q in [0, 100]."""
        vals = sorted(v for _, v in self.snapshot())
        if not vals:
            return 0.0
        rank = min(len(vals) - 1, max(0, int(round(q / 100 * (len(vals) - 1)))))
        return vals[rank]

    def stats(self) -> Dict[str, float]:
        """count/last/mean/max/total/p50/p99 from a SINGLE snapshot, so
        the numbers are mutually consistent even under concurrent
        ``record`` calls (count * mean == total, always)."""
        pts = self.snapshot()
        vals = sorted(v for _, v in pts)
        n = len(vals)

        def pct(q):
            if not n:
                return 0.0
            return vals[min(n - 1, max(0, int(round(q / 100 * (n - 1)))))]

        total = sum(vals)
        return {"count": n, "last": pts[-1][1] if pts else 0.0,
                "mean": total / n if n else 0.0,
                "max": vals[-1] if n else 0.0, "total": total,
                "p50": pct(50), "p99": pct(99)}


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[str, Series] = {}

    def series(self, name: str) -> Series:
        with self._lock:
            return self._series.setdefault(name, Series())

    def inc(self, name: str, value: float = 1.0):
        self.series(name).record(value)

    def gauge(self, name: str, value: float):
        self.series(name).record(value)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-series stats (count/last/mean/max/total/p50/p99) — the
        scrape endpoint a serving dashboard (paper §VI) would poll.
        Each series is summarized from one atomic snapshot, so its stats
        are mutually consistent under concurrent recording."""
        with self._lock:
            series = dict(self._series)
        return {k: s.stats() for k, s in series.items()}

    def to_csv(self) -> str:
        lines = ["metric,count,last,mean,max,total"]
        for k, st in sorted(self.summary().items()):
            lines.append(f"{k},{st['count']},{st['last']:.6g},"
                         f"{st['mean']:.6g},{st['max']:.6g},"
                         f"{st['total']:.6g}")
        return "\n".join(lines)


@dataclass
class StepReport:
    """One column of the paper's Table I."""
    step: str
    pods: int = 0
    cpus: int = 0
    devices: int = 0          # "# of GPUs" in the paper
    data_processed_bytes: int = 0
    memory_bytes: int = 0
    total_time_s: float = 0.0
    site: str = ""            # federation site the step ran at (repro.fabric)
    extra: Dict[str, float] = field(default_factory=dict)


def table_one(reports: List[StepReport]) -> str:
    """Render the paper's Table I (Nautilus resource summary) as markdown."""
    def fmt_bytes(b):
        for unit in ("B", "KB", "MB", "GB", "TB"):
            if abs(b) < 1024:
                return f"{b:.1f}{unit}"
            b /= 1024
        return f"{b:.1f}PB"

    head = "| | " + " | ".join(r.step for r in reports) + " |"
    sep = "|---" * (len(reports) + 1) + "|"
    rows = [
        ("# of Pods", [str(r.pods) for r in reports]),
        ("# of CPUs", [str(r.cpus) for r in reports]),
        ("# of Devices", [str(r.devices) for r in reports]),
        ("Data Processed", [fmt_bytes(r.data_processed_bytes) for r in reports]),
        ("Memory", [fmt_bytes(r.memory_bytes) for r in reports]),
        ("Total Time", [f"{r.total_time_s:.1f}s" for r in reports]),
    ]
    out = [head, sep]
    # multi-site runs (repro.fabric) say where each step landed
    if any(r.site for r in reports):
        out.append("| Site | " + " | ".join(r.site or "-" for r in reports)
                   + " |")
    for name, vals in rows:
        out.append("| " + name + " | " + " | ".join(vals) + " |")
    # free-form per-step metrics (e.g. serving tokens/s, slot occupancy)
    # render as additional rows; steps missing a key show "-"
    extra_keys = sorted({k for r in reports for k in r.extra})
    for key in extra_keys:
        vals = [f"{r.extra[key]:.4g}" if key in r.extra else "-"
                for r in reports]
        out.append("| " + key + " | " + " | ".join(vals) + " |")
    return "\n".join(out)
