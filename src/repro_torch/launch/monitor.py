"""Live text dashboard — the paper's "visualization facility across the
network ... in near real-time" (§I contribution 4) as a terminal view.

    PYTHONPATH=src python -m repro_torch.launch.monitor [--seconds 5] \
        [--device cpu]

Renders, at a fixed cadence, the state the monitor stream carries:
per-tenant fair-share accounting (usage, dominant share, priority),
per-site capacity/queue depth, and the tail of the event stream
(scheduling decisions, preemptions, pod churn, transfers, throughput
gauges).  ``render_frame`` is a pure function of (scheduler, events) so
tests can assert on frames without a terminal; ``run_dashboard`` drives
it from a live ``EventBus`` subscription.

Run as a module it stages a small self-contained demo: two tenants
contending for a 2-site fabric while the dashboard streams.  The demo's
sites hold logical slots, as the JAX demo's do; its jobs compute nothing,
and ``--device`` only names where the fabric's sites would compute
(``"cuda"`` by default, which raises without a card).

A copy of the JAX package's ``launch/monitor.py`` plus ``--device``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Sequence

from repro_torch.vcluster.monitor import Event
from repro_torch.vcluster.scheduler import FairShareScheduler


def render_frame(sched: FairShareScheduler, events: Sequence[Event], *,
                 tail: int = 12, clock=time.time, workloads: Sequence = ()
                 ) -> str:
    """One dashboard frame as text (pure: no I/O, injectable clock).

    ``workloads`` — ``repro_torch.api`` Handles (or their WorkloadStatus
    snapshots): every kind the unified API drives (train / serve /
    batch / workflow) renders as one uniform row, alongside the
    ``workload`` lifecycle events already in the tail."""
    lines: List[str] = []
    lines.append("=" * 72)
    lines.append(f"  virtual clusters @ {time.strftime('%H:%M:%S', time.localtime(clock()))}"
                 f"   policy={sched.policy}  events={sched.bus.published}")
    lines.append("-" * 72)
    lines.append(f"  {'site':<10} {'devices':>8} {'free':>6} {'queue':>6}")
    for site in sched.fabric.sites.values():
        cap = len(site.cluster.online_devices) if site.up else 0
        free = site.cluster.free_devices() if site.up else 0
        state = "" if site.up else "  DOWN"
        lines.append(f"  {site.name:<10} {cap:>8} {free:>6} "
                     f"{site.queue_depth():>6}{state}")
    lines.append("-" * 72)
    lines.append(f"  {'tenant':<10} {'prio':>5} {'weight':>7} {'devices':>8} "
                 f"{'share':>7} {'queued':>7} {'running':>8}")
    with sched._lock:
        pending = list(sched._pending)
        running = list(sched._running)
    for name, vc in sorted(sched.tenants.items()):
        used = sum(vc.usage().values())
        nq = sum(1 for j in pending if j.tenant == name)
        nr = sum(1 for j in running if j.tenant == name)
        lines.append(f"  {name:<10} {vc.spec.priority:>5} "
                     f"{vc.spec.weight:>7.2f} {used:>8} "
                     f"{vc.dominant_share():>7.3f} {nq:>7} {nr:>8}")
    if workloads:
        lines.append("-" * 72)
        lines.append(f"  {'workload':<20} {'kind':<12} {'backend':<8} "
                     f"{'state':<10}")
        for w in workloads:
            st = w.status() if hasattr(w, "status") else w
            lines.append(f"  {st.name:<20} {st.kind:<12} {st.backend:<8} "
                         f"{st.state.value:<10}")
    if events:
        lines.append("-" * 72)
        for ev in list(events)[-tail:]:
            lines.append(f"  [{ev.seq:>5}] {ev.brief()[:66]}")
    lines.append("=" * 72)
    return "\n".join(lines)


def run_dashboard(sched: FairShareScheduler, *, interval_s: float = 0.5,
                  stop: Optional[threading.Event] = None, out=print,
                  tail: int = 12, max_frames: Optional[int] = None) -> int:
    """Stream dashboard frames until ``stop`` is set.  Subscribes to the
    scheduler's bus; returns the number of events seen.  Lag stays below
    one dashboard interval because delivery is synchronous fan-out and
    each frame drains the whole subscription queue."""
    stop = stop or threading.Event()
    sub = sched.bus.subscribe(maxlen=4096)
    window: Deque[Event] = deque(maxlen=max(tail, 64))
    seen = 0
    frames = 0
    try:
        while not stop.is_set():
            got = sub.poll(timeout=interval_s)
            seen += len(got)
            window.extend(got)
            out(render_frame(sched, window, tail=tail))
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break
            stop.wait(interval_s)
    finally:
        sub.close()
    return seen


def _demo(seconds: float, device="cuda") -> None:
    from repro_torch.core.orchestrator import JobSpec
    from repro_torch.fabric import Fabric
    from repro_torch.vcluster import FairShareScheduler, TenantSpec

    fabric = Fabric(device=device)
    fabric.add_site("sdsc", devices=list(range(2)))
    fabric.add_site("calit2", devices=list(range(2)))
    fabric.connect("sdsc", "calit2", gbps=10.0, latency_ms=3.0)
    sched = FairShareScheduler(fabric, reconcile_s=0.02)
    sched.bus.attach_fabric(fabric)
    alice = sched.create_tenant(TenantSpec("alice"))
    bob = sched.create_tenant(TenantSpec("bob", weight=2.0))

    def work(ctx):
        end = time.monotonic() + 0.2
        while time.monotonic() < end and not ctx.should_stop():
            time.sleep(0.01)
        return "ok"

    stop = threading.Event()
    with sched:
        for i in range(8):
            alice.submit(JobSpec(f"a{i}", work, devices_per_pod=1))
            bob.submit(JobSpec(f"b{i}", work, devices_per_pod=1))
        t = threading.Timer(seconds, stop.set)
        t.start()
        run_dashboard(sched, interval_s=0.25, stop=stop)
        t.cancel()


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="demo duration")
    ap.add_argument("--device", default="cuda",
                    help="where the demo fabric's sites compute")
    args = ap.parse_args(argv)
    _demo(args.seconds, args.device)


if __name__ == "__main__":
    main()
