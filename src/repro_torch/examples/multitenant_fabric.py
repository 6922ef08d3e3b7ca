"""Multi-tenant virtual clusters on one shared fabric (paper §I, §IV), on
the port.

The twin of ``examples/multitenant_fabric.py``.  Every site holds
logical slots and computes on one device (the card unless ``--device
cpu``), where the JAX example builds two of its sites from its host's
devices.

CHASE-CI is a *shared appliance*: ~30 institutions on one federation.
This example runs the multi-tenant stack end to end — every workload
declared through the unified API (`Session(tenant=...)`) — and asserts
the paper-shaped contracts:

  1. **fair share under contention** — two equal-share tenants submit
     identical job streams to a saturated 2-site fabric.  Under the
     dominant-share scheduler they finish within 20% of each other's
     makespan; under the FIFO baseline the first tenant's backlog
     head-of-line blocks the second (>2x skew in mean completion time);
  2. **preemption + resume** — a low-priority training tenant is
     checkpoint-then-evicted by a high-priority burst, and resumes from
     its checkpoint when the grant returns, while an inference tenant
     keeps serving on its own slice of the SAME fabric (train and serve
     tenants co-exist);
  3. **near-real-time monitor** — every scheduling / churn / transfer /
     workload-lifecycle event reaches a live subscriber with bounded
     lag, rendered by the repro_torch.launch.monitor dashboard.

    PYTHONPATH=src python -m repro_torch.examples.multitenant_fabric \
        [--fast] [--device cpu]

Prints a ``VCLUSTER_REPORT {json}`` line.
"""
import argparse
import json
import tempfile
import threading
import time

from repro_torch.api import BatchJob, ServeJob, Session, TrainJob
from repro_torch.core.orchestrator import JobSpec
from repro_torch.fabric import Fabric, FederatedStore
from repro_torch.launch.monitor import render_frame
from repro_torch.vcluster import FairShareScheduler, TenantSpec

MONITOR_INTERVAL_S = 0.5        # the lag SLO: one monitor reconcile tick


# ---------------------------------------------------------------- fairness

def run_contention(policy: str, *, n_jobs: int, job_s: float,
                   device="cuda") -> dict:
    """Two equal-share tenants hammer a saturated 2-site fabric."""
    fabric = Fabric(device=device)
    fabric.add_site("s0", devices=list(range(2)))
    fabric.add_site("s1", devices=list(range(2)))
    fabric.connect("s0", "s1", gbps=10.0, latency_ms=1.0)
    sched = FairShareScheduler(fabric, policy=policy, reconcile_s=0.01)
    tenants = {n: sched.create_tenant(TenantSpec(n)) for n in ("alice", "bob")}

    def work(ctx):
        end = time.monotonic() + job_s
        while time.monotonic() < end and not ctx.should_stop():
            time.sleep(0.005)
        return "ok"

    t0 = time.monotonic()
    jobs = {n: [vc.submit(JobSpec(f"{n}{i}", work, devices_per_pod=1))
                for i in range(n_jobs)]
            for n, vc in tenants.items()}          # alice's backlog first
    with sched:
        for js in jobs.values():
            for j in js:
                j.wait(120)
    out = {}
    for name, js in jobs.items():
        out[name] = {
            "makespan_s": round(max(j.done_ts for j in js) - t0, 3),
            "mean_completion_s": round(
                sum(j.done_ts - t0 for j in js) / len(js), 3)}
    mk = [v["makespan_s"] for v in out.values()]
    mc = [v["mean_completion_s"] for v in out.values()]
    out["makespan_ratio"] = round(max(mk) / min(mk), 3)
    out["completion_skew"] = round(max(mc) / min(mc), 3)
    return out


# ------------------------------------------------- train+serve+preemption

def run_preemption_scenario(fast: bool, device="cuda",
                            root: str = "") -> dict:
    """Train / serve / burst tenants share one fabric; the burst
    checkpoint-evicts the trainer, which resumes and finishes.  Each
    tenant's workloads go through its own Session on the same API.
    Each site's store lives under ``root`` when given."""
    fabric = Fabric(device=device)
    # one training appliance, one inference appliance, one data hub
    for name in ("gpu", "edge", "hub"):
        fabric.add_site(name, devices=[0],
                        store_root=f"{root}/{name}" if root else None)
    fabric.connect("gpu", "edge", gbps=10.0, latency_ms=1.0)
    fabric.connect("gpu", "hub", gbps=1.0, latency_ms=5.0)
    fabric.connect("edge", "hub", gbps=1.0, latency_ms=5.0)
    fed = FederatedStore(fabric)
    sched = FairShareScheduler(fed=fed, reconcile_s=0.02,
                               preempt_grace_s=60.0)
    sched.bus.attach_fabric(fabric)
    sched.bus.attach_registry(fabric.metrics)

    # a live monitor subscriber measuring end-to-end lag; subscribed
    # BEFORE any event source so received == published holds exactly
    sub = sched.bus.subscribe(maxlen=8192)
    lag = {"max": 0.0, "n": 0, "kinds": set()}
    stop_mon = threading.Event()

    def monitor():
        while True:
            got = sub.poll(timeout=0.05)
            for ev in got:
                lag["max"] = max(lag["max"], time.time() - ev.ts)
                lag["n"] += 1
                lag["kinds"].add(ev.kind)
            if not got and stop_mon.is_set():
                return

    train_t = sched.create_tenant(TenantSpec("train", priority=0))
    serve_t = sched.create_tenant(TenantSpec("serve", priority=5))
    burst_t = sched.create_tenant(TenantSpec("burst", priority=10,
                                             preemptible=False))
    # one Session per tenant: same verbs, tenant-scoped placement
    train_s = Session(tenant=train_t)
    serve_s = Session(tenant=serve_t)
    burst_s = Session(tenant=burst_t)

    mon = threading.Thread(target=monitor, daemon=True)

    # tenant-billed data staging: the training corpus homes at the hub
    fed.put("datasets/corpus.bin", b"x" * (1 << 18 if fast else 1 << 20),
            "hub")

    steps = 10 if fast else 16
    train_job = TrainJob(
        name="elastic-train", steps=steps, seq_len=32, global_batch=4,
        base_shape=(1, 1), max_data=1, ckpt_every=2, log_every=1,
        rejoin_timeout_s=120.0, verbose=False, site="gpu", devices=1,
        optimizer={"warmup_steps": 2, "decay_steps": 100})

    n_req = 4 if fast else 8
    gen = 4 if fast else 8
    serve_job = ServeJob(
        name="serve-edge", slots=2, prompt_len=8, max_new_tokens=gen,
        site="edge",
        requests=[{"id": i, "prompt": [1 + i] * 8, "max_new_tokens": gen}
                  for i in range(n_req)])

    fired = {"burst": False}

    def fire_burst():
        while fabric.metrics.series("elastic/step").last < 3:
            time.sleep(0.005)
        burst_s.apply(BatchJob(name="burst", devices_per_pod=1,
                               site="gpu"),
                      fn=lambda ctx: time.sleep(0.3) or "hi").wait(120)
        fired["burst"] = True

    with sched:
        mon.start()
        # the trainer's inputs are staged from the hub, billed to it
        train_t.store("gpu").get("datasets/corpus.bin")
        serve_handle = serve_s.apply(serve_job)
        burster = threading.Thread(target=fire_burst, daemon=True)
        burster.start()
        out = train_s.apply(train_job).wait(600)
        burster.join(timeout=120)
        serve_out = serve_handle.wait(300)
        # a final pass so "done" events reach the stream before we stop
        time.sleep(3 * sched.reconcile_s)
    stop_mon.set()
    mon.join(timeout=10)

    rep = out["report"]
    results = serve_out["results"]
    frame = render_frame(sched, [],
                         workloads=train_s.workloads + serve_s.workloads +
                         burst_s.workloads)
    print(frame)
    return {
        "steps": steps,
        "outcomes": [s.outcome for s in rep.segments],
        "preemptions": int(
            fabric.metrics.series("elastic/preemptions").total),
        "steps_lost": rep.steps_lost,
        "ckpt_every": train_job.ckpt_every,
        "completed": rep.segments[-1].end == steps - 1,
        "losses_complete": sorted(out["loss_by_step"]) == list(range(steps)),
        "burst_done": fired["burst"],
        "serve_requests": len(results),
        "serve_tokens": sum(len(v) for v in results.values()),
        "train_bytes_staged": int(fabric.metrics.series(
            "fabric/tenant/train/bytes_moved").total),
        "monitor": {
            "published": sched.bus.published,
            "received": lag["n"],
            "dropped": sub.dropped,
            "kinds": sorted(lag["kinds"]),
            "max_lag_s": round(lag["max"], 4),
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller workloads (monitor smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n_jobs, job_s = (10, 0.05) if args.fast else (12, 0.08)

    # --- 1: fair share vs FIFO on identical contention ------------------
    fair = run_contention("fair", n_jobs=n_jobs, job_s=job_s,
                          device=args.device)
    fifo = run_contention("fifo", n_jobs=n_jobs, job_s=job_s,
                          device=args.device)
    assert fair["makespan_ratio"] <= 1.2, \
        f"equal-share tenants must finish within 20%: {fair}"
    assert fifo["completion_skew"] > 2.0, \
        f"FIFO head-of-line blocking should skew >2x: {fifo}"

    # --- 2+3: preemption/resume + co-existence + monitor ----------------
    with tempfile.TemporaryDirectory(prefix="multitenant-") as root:
        prem = run_preemption_scenario(args.fast, args.device, root)
    assert prem["preemptions"] >= 1, f"burst never preempted: {prem}"
    assert "preempted" in prem["outcomes"], prem
    assert prem["completed"] and prem["losses_complete"], \
        f"preempted training must resume and finish: {prem}"
    assert prem["steps_lost"] <= prem["ckpt_every"], \
        f"resume lost more than the elastic bound: {prem}"
    assert prem["burst_done"]
    assert prem["serve_requests"] == (4 if args.fast else 8), prem
    mon = prem["monitor"]
    assert mon["received"] == mon["published"] and mon["dropped"] == 0, mon
    assert mon["max_lag_s"] < MONITOR_INTERVAL_S, \
        f"monitor lag exceeded one reconcile interval: {mon}"
    assert {"sched", "pod", "transfer", "metric", "workload"} <= \
        set(mon["kinds"]), mon

    print("\nVCLUSTER_REPORT " + json.dumps(
        {"fair": fair, "fifo": fifo, "preemption": prem}))
    print(f"\nOK — fair makespan ratio {fair['makespan_ratio']}x vs FIFO "
          f"skew {fifo['completion_skew']}x; trainer preempted "
          f"{prem['preemptions']}x, lost {prem['steps_lost']} steps, "
          f"finished all {prem['steps']}; served "
          f"{prem['serve_requests']} requests on the same fabric; "
          f"{mon['received']}/{mon['published']} events at "
          f"max lag {mon['max_lag_s']}s.")
    return {"fair": fair, "fifo": fifo, "preemption": prem}


if __name__ == "__main__":
    main()
