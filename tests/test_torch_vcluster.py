"""The port's multi-tenant virtual clusters (``repro_torch.vcluster``)
against the JAX package's ``repro.vcluster``.

Every case of ``tests/test_vcluster.py`` runs against the port with the
same assertions: fair-share scheduling, cooperative preemption
(checkpoint-then-evict), capacity claims, tenant-aware placement, the
near-real-time monitor stream and a preempted elastic trainer resuming
under its tenant.  Fabric sites hold logical slots and compute on
``device="cpu"``.

Across the stacks: the same submission stream, stepped by hand, gives the
same sequence of ``sched`` bus decisions (tenant, action, site) under the
dominant-share and the FIFO policies, and bills ``lease_device_s`` per
tenant namespace on both.  Pods, trainers and the reconcile loop run in
threads, so torch is pinned to two threads a team here.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro import fabric as jfab                                 # noqa: E402
from repro import vcluster as jvc                                # noqa: E402
from repro.core import orchestrator as jorch                     # noqa: E402

from repro_torch.core.orchestrator import (Cluster, JobSpec,     # noqa: E402
                                           PodState)
from repro_torch.fabric import Fabric, FederatedStore            # noqa: E402
from repro_torch.vcluster import (EventBus, FairShareScheduler,  # noqa: E402
                                  TenantSpec, VirtualCluster)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Pods, trainers and engines run in threads, each of which starts an
    OpenMP team of every core for torch's CPU ops; with several test
    workers those teams spin against each other.  Two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def mk_fabric(devs=(2, 2)):
    fabric = Fabric(device="cpu")
    for i, n in enumerate(devs):
        fabric.add_site(f"s{i}", devices=list(range(n)))
    names = list(fabric.sites)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            fabric.connect(a, b, gbps=1.0, latency_ms=1.0)
    return fabric


def hold_fn(release: threading.Event, timeout=20.0):
    def fn(ctx):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if ctx.should_stop():
                return "stopped"
            if release.is_set():
                return "ok"
            time.sleep(0.005)
        return "timeout"
    return fn


def timed_fn(dur):
    def fn(ctx):
        end = time.monotonic() + dur
        while time.monotonic() < end and not ctx.should_stop():
            time.sleep(0.005)
        return "ok"
    return fn


# --------------------------------------------------------------- tenancy

def test_tenant_namespaces_and_quota():
    fabric = mk_fabric((4, 2))
    sched = FairShareScheduler(fabric)
    vc = sched.create_tenant(TenantSpec("acme", site_quota=2))
    assert isinstance(vc, VirtualCluster)
    for site in fabric.sites.values():
        ns = site.cluster.namespaces["tenant-acme"]
        assert ns.device_quota == 2
    # the orchestrator enforces the per-site quota on direct submissions
    with pytest.raises(RuntimeError, match="quota"):
        fabric.sites["s0"].cluster.submit("tenant-acme", JobSpec(
            "big", lambda ctx: 1, devices_per_pod=3))
    assert vc.usage() == {"s0": 0, "s1": 0}
    assert vc.dominant_share() == 0.0


def test_duplicate_tenant_rejected():
    sched = FairShareScheduler(mk_fabric())
    sched.create_tenant(TenantSpec("a"))
    with pytest.raises(ValueError, match="exists"):
        sched.create_tenant(TenantSpec("a"))
    with pytest.raises(ValueError, match="weight"):
        TenantSpec("bad", weight=0.0)


def test_dominant_share_is_weighted():
    fabric = mk_fabric((4,))
    sched = FairShareScheduler(fabric)
    a = sched.create_tenant(TenantSpec("a", weight=1.0))
    b = sched.create_tenant(TenantSpec("b", weight=2.0))
    release = threading.Event()
    ja = a.submit(JobSpec("ja", hold_fn(release), devices_per_pod=2))
    jb = b.submit(JobSpec("jb", hold_fn(release), devices_per_pod=2))
    try:
        sched.step()
        assert ja.state == jb.state == "running"
        # same devices, but b's weight halves its dominant share
        assert a.dominant_share() == pytest.approx(0.5)
        assert b.dominant_share() == pytest.approx(0.25)
    finally:
        release.set()
        with sched:                 # reap needs the reconcile loop
            ja.wait(20), jb.wait(20)


# --------------------------------------------------- fair-share placement

def test_fair_share_interleaves_equal_tenants():
    """With everything queued up-front, placements alternate tenants
    (dominant share re-ranked after every launch), not arrival order."""
    fabric = mk_fabric((2,))
    sched = FairShareScheduler(fabric)
    a = sched.create_tenant(TenantSpec("a"))
    b = sched.create_tenant(TenantSpec("b"))
    release = threading.Event()
    ja = [a.submit(JobSpec(f"a{i}", hold_fn(release), devices_per_pod=1))
          for i in range(2)]
    jb = [b.submit(JobSpec(f"b{i}", hold_fn(release), devices_per_pod=1))
          for i in range(2)]
    try:
        sched.step()
        # one slot each — NOT both of a's jobs (a submitted first)
        assert ja[0].state == "running" and jb[0].state == "running"
        assert ja[1].state == "queued" and jb[1].state == "queued"
    finally:
        release.set()
        with sched:
            for j in ja + jb:
                j.wait(20)


def test_fifo_policy_is_arrival_order():
    fabric = mk_fabric((2,))
    sched = FairShareScheduler(fabric, policy="fifo")
    a = sched.create_tenant(TenantSpec("a"))
    b = sched.create_tenant(TenantSpec("b"))
    release = threading.Event()
    ja = [a.submit(JobSpec(f"a{i}", hold_fn(release), devices_per_pod=1))
          for i in range(2)]
    jb = b.submit(JobSpec("b0", hold_fn(release), devices_per_pod=1))
    try:
        sched.step()
        assert [j.state for j in ja] == ["running", "running"]
        assert jb.state == "queued"            # head-of-line blocked
    finally:
        release.set()
        with sched:
            for j in ja + [jb]:
                j.wait(20)


def test_fairness_under_contention():
    """Acceptance: equal-share tenants on a saturated 2-site fabric
    finish within 20% of each other; FIFO skews >2x.

    Each job runs 0.2 s, long against what a placement adds to it (the
    0.01 s reconcile tick, the job's own 5 ms polling, a thread's start
    in a loaded test worker): at 0.04 s those added 20-35 % to every job,
    a late thread moved one tenant's makespan past 1.2 of the other's and
    FIFO's skew sat at 2.03-2.14, against 2.33 with none."""
    def run(policy):
        fabric = mk_fabric((2, 2))
        sched = FairShareScheduler(fabric, policy=policy, reconcile_s=0.01)
        tenants = [sched.create_tenant(TenantSpec(n)) for n in ("a", "b")]
        t0 = time.monotonic()
        jobs = [[vc.submit(JobSpec(f"{vc.name}{i}", timed_fn(0.2),
                                   devices_per_pod=1)) for i in range(10)]
                for vc in tenants]
        with sched:
            for js in jobs:
                for j in js:
                    j.wait(60)
        mk = [max(j.done_ts for j in js) - t0 for js in jobs]
        mc = [sum(j.done_ts - t0 for j in js) / len(js) for js in jobs]
        return max(mk) / min(mk), max(mc) / min(mc)

    mk_ratio, _ = run("fair")
    assert mk_ratio <= 1.2, f"fair-share makespan ratio {mk_ratio}"
    _, mc_skew = run("fifo")
    assert mc_skew > 2.0, f"FIFO completion skew only {mc_skew}"


def test_tenant_ceiling_enforced():
    fabric = mk_fabric((4,))
    sched = FairShareScheduler(fabric)
    capped = sched.create_tenant(TenantSpec("capped", max_devices=2))
    release = threading.Event()
    jobs = [capped.submit(JobSpec(f"j{i}", hold_fn(release),
                                  devices_per_pod=1)) for i in range(4)]
    try:
        sched.step()
        running = [j for j in jobs if j.state == "running"]
        assert len(running) == 2            # ceiling, not site capacity
    finally:
        release.set()
        with sched:
            for j in jobs:
                j.wait(20)


# ------------------------------------------------------------- preemption

def test_preempt_pod_cooperative_and_no_respawn():
    cluster = Cluster(devices=list(range(2)))
    cluster.create_namespace("default")
    release = threading.Event()
    job = cluster.submit("default", JobSpec("victim", hold_fn(release),
                                            devices_per_pod=2))
    pod = job.pods[0]
    for _ in range(200):
        if pod.state == PodState.RUNNING:
            break
        time.sleep(0.01)
    assert cluster.preempt_pod(pod, reason="test")
    pod.thread.join(timeout=10)
    assert pod.state == PodState.PREEMPTED
    assert pod.result == "stopped"          # cooperative exit value kept
    assert not cluster.leased               # lease returned
    assert cluster.namespaces["default"].used_devices == 0
    assert cluster.reconcile() == 0         # PREEMPTED is never respawned
    assert not cluster.preempt_pod(pod)     # already terminal


def test_preempt_pending_pod_immediate():
    """A pod preempted while still PENDING is evicted on the spot and its
    fn never runs, even if the controller later tries to start it."""
    from repro_torch.core.orchestrator import Pod, PodCtx
    cluster = Cluster(devices=list(range(1)))
    cluster.create_namespace("default")
    ctx = PodCtx("p0", "default", [], cluster.metrics)
    ran = []
    pod = Pod("p0", lambda c: ran.append(1) or "never", ctx)
    assert cluster.preempt_pod(pod, reason="test")
    assert pod.state == PodState.PREEMPTED
    assert pod.ctx.preempt.is_set()
    cluster._start_pod(pod)             # a stale start is fenced out
    pod.thread.join(timeout=10)
    assert not ran and pod.result is None


def test_finish_preempt_hard_evicts_stuck_pod():
    """A pod that ignores the cooperative drain is force-evicted: lease
    freed, terminal PREEMPTED — and its late result is still recorded."""
    cluster = Cluster(devices=list(range(2)))
    cluster.create_namespace("default")
    release = threading.Event()

    def stubborn(ctx):
        release.wait(10)            # never polls should_stop
        return "late"

    job = cluster.submit("default", JobSpec("stub", stubborn,
                                            devices_per_pod=2))
    pod = job.pods[0]
    for _ in range(200):
        if pod.state == PodState.RUNNING:
            break
        time.sleep(0.01)
    assert cluster.preempt_pod(pod)
    assert not cluster.finish_preempt(pod) or True  # idempotence probed below
    cluster.finish_preempt(pod)
    assert pod.state == PodState.PREEMPTED
    assert not cluster.leased
    release.set()
    pod.thread.join(timeout=10)
    assert pod.state == PodState.PREEMPTED          # not resurrected
    assert pod.result == "late"


def test_scheduler_preempts_lower_priority_and_requeues():
    fabric = mk_fabric((2,))
    sched = FairShareScheduler(fabric, preempt_grace_s=5.0)
    low = sched.create_tenant(TenantSpec("low", priority=0))
    high = sched.create_tenant(TenantSpec("high", priority=10,
                                          preemptible=False))
    sub = sched.bus.subscribe(maxlen=4096)
    jl = low.submit(JobSpec("hold", timed_fn(10.0), replicas=2,
                            devices_per_pod=1))
    sched.step()
    assert jl.state == "running"
    jh = high.submit(JobSpec("burst", timed_fn(0.05), devices_per_pod=2))
    with sched:
        jh.wait(30)
        # the preempted low job is requeued and reruns to completion
        jl.wait(30)
    assert jl.preemptions >= 1
    assert jh.results() == ["ok"]
    evs = [e for e in sub.poll(0) if e.data.get("action") == "preempt"]
    assert evs, "preemption must be published to the monitor"
    sub.close()


def test_higher_priority_never_preempted():
    fabric = mk_fabric((2,))
    sched = FairShareScheduler(fabric)
    high = sched.create_tenant(TenantSpec("high", priority=10))
    low = sched.create_tenant(TenantSpec("low", priority=0))
    release = threading.Event()
    jh = high.submit(JobSpec("hold", hold_fn(release), replicas=2,
                             devices_per_pod=1))
    sched.step()
    jl = low.submit(JobSpec("wish", timed_fn(0.01), devices_per_pod=2))
    try:
        for _ in range(5):
            sched.step()
        assert jl.state == "queued"         # waits, never evicts upward
        assert jh.state == "running"
        assert all(not p.ctx.preempt.is_set() for p in jh.job.pods)
    finally:
        release.set()
        with sched:
            jh.wait(20)
            jl.wait(20)


# ------------------------------------------------------- capacity claims

def test_claim_grant_shrink_and_regrow():
    fabric = mk_fabric((2,))
    sched = FairShareScheduler(fabric, preempt_grace_s=5.0)
    low = sched.create_tenant(TenantSpec("low", priority=0))
    high = sched.create_tenant(TenantSpec("high", priority=10,
                                          preemptible=False))
    claim = low.claim("s0", 2)
    assert claim.granted == 2
    view = low.view("s0", claim)
    assert len(view.online_devices) == 2
    # the claim's segment pod occupies the grant
    seg = view.submit("tenant-low", JobSpec("seg", timed_fn(10.0),
                                            devices_per_pod=2,
                                            backoff_limit=0))
    sub = sched.bus.subscribe(maxlen=4096)
    jh = high.submit(JobSpec("burst", timed_fn(0.05), devices_per_pod=1))
    with sched:
        jh.wait(30)
    # the grant was shrunk to make room and the pod preempt-drained
    # (by now regrow may already have restored it — check the stream)
    assert seg.pods[0].state == PodState.PREEMPTED
    assert fabric.metrics.series("vcluster/preemptions/low").total >= 1
    evs = sub.poll(0)
    assert any(e.data.get("action") == "grant" for e in evs), \
        "the re-grow must be published"
    # after the burst finishes, spare devices re-grow the claim
    for _ in range(10):
        sched.step()
        if claim.granted == 2:
            break
        time.sleep(0.02)
    assert claim.granted == 2
    claim.release()
    assert claim.released and claim not in sched._claims
    sub.close()


def test_claim_floor_blocks_preemption():
    fabric = mk_fabric((2,))
    sched = FairShareScheduler(fabric)
    low = sched.create_tenant(TenantSpec("low", priority=0))
    high = sched.create_tenant(TenantSpec("high", priority=10))
    claim = low.claim("s0", 2, min_devices=2)   # guaranteed floor
    view = low.view("s0", claim)
    seg = view.submit("tenant-low", JobSpec("seg", timed_fn(0.3),
                                            devices_per_pod=2,
                                            backoff_limit=0))
    jh = high.submit(JobSpec("burst", timed_fn(0.01), devices_per_pod=1))
    for _ in range(5):
        sched.step()
    assert claim.granted == 2                   # floor held
    assert seg.pods[0].state == PodState.RUNNING
    assert jh.state == "queued"                 # even a prio-10 job waits
    seg.pods[0].thread.join(timeout=20)
    sched.step()
    # the floor is a standing reservation: still blocked after the
    # segment drains; only releasing the claim frees the devices
    assert jh.state == "queued"
    claim.release()
    with sched:
        jh.wait(30)
    assert jh.state == "done"


# ------------------------------------------------ tenant-aware placement

def test_tenant_planner_bills_and_routes_around_backlog():
    fabric = mk_fabric((2, 2, 2))
    fed = FederatedStore(fabric)
    sched = FairShareScheduler(fed=fed)
    me = sched.create_tenant(TenantSpec("me"))
    other = sched.create_tenant(TenantSpec("other"))
    fed.put("d/x", b"z" * 1_000_000, "s0")
    planner = me.planner()
    assert planner.tenant == "me"
    # symmetric links: without backlog the tie-break picks s1
    base = planner.place(["d/x"], devices=1)
    # "other" saturates s0->s1 with a long in-flight pre-stage: the
    # backlog penalty must steer me's step to s2 instead
    with fabric.reserve("s0", "s1", 500_000_000, tenant="other"):
        p = planner.place(["d/x"], devices=1)
        assert p.site in ("s0", "s2") and p.site != "s1"
        # my OWN backlog must not penalize me
        with fabric.reserve("s0", "s2", 500_000_000, tenant="me"):
            p2 = planner.place(["d/x"], devices=1)
            assert p2.site != "s1"
    # staging through the tenant planner bills the tenant's meter
    planner.prestage(["d/x"], "s2")
    assert fabric.metrics.series(
        "fabric/tenant/me/bytes_moved").total == 1_000_000
    assert fabric.metrics.series(
        "fabric/tenant/other/bytes_moved").total == 0
    assert base.site in ("s0", "s1")


def test_workflow_under_tenant():
    import numpy as np
    fabric = mk_fabric((2, 2))
    fed = FederatedStore(fabric)
    sched = FairShareScheduler(fed=fed)
    vc = sched.create_tenant(TenantSpec("lab"))
    sub = sched.bus.subscribe()
    fed.view("s1").put_array("in/x.npy", np.arange(8).astype(np.float64))
    wf = vc.workflow("w")
    from repro_torch.core.workflow import Step
    wf.add(Step("sum", lambda ctx: {
        "s": float(ctx.store.get_array("in/x.npy").sum())},
        inputs=["in/x.npy"]))
    out = wf.run()
    assert out["sum"]["s"] == 28.0
    assert wf.namespace == "tenant-lab"
    evs = sub.poll(0)
    steps = [e for e in evs if e.kind == "step"]
    assert {e.data["status"] for e in steps} >= {"placed", "done"}
    sub.close()


# ----------------------------------------------------------- monitor bus

def test_event_bus_ordering_and_bounded_lag():
    bus = EventBus()
    sub = bus.subscribe(maxlen=100)
    recv = []
    stop = threading.Event()

    def poller():
        while True:
            got = sub.poll(timeout=0.02)
            recv.extend((e, time.time()) for e in got)
            if not got and stop.is_set():
                return

    th = threading.Thread(target=poller)
    th.start()
    for i in range(50):
        bus.publish("sched", source="t", i=i)
        time.sleep(0.001)
    stop.set()
    th.join(timeout=10)
    assert [e.data["i"] for e, _ in recv] == list(range(50))   # in order
    assert sub.dropped == 0
    max_lag = max(ts - e.ts for e, ts in recv)
    assert max_lag < 0.5, f"event lag {max_lag}s"


def test_event_bus_bounded_overflow_drops_oldest():
    bus = EventBus()
    sub = bus.subscribe(maxlen=4)
    for i in range(10):
        bus.publish("x", i=i)
    got = sub.poll(0)
    assert [e.data["i"] for e in got] == [6, 7, 8, 9]    # newest window
    assert sub.dropped == 6
    sub.close()
    bus.publish("x", i=99)          # closed subscriber is detached
    assert bus.published == 11


def test_event_bus_slow_subscriber_at_scenario_scale():
    """A dashboard that stops polling must not stall the platform: many
    concurrent publishers push scenario-scale traffic past one stuck
    subscriber.  Publishers stay unblocked, the oldest events drop and
    are counted, and ``stats()`` exposes the loss for the report card."""
    from repro_torch.core.metrics import Registry
    reg = Registry()
    bus = EventBus(metrics=reg)
    stuck = bus.subscribe(maxlen=64)         # never polled during the storm
    healthy = bus.subscribe(maxlen=100_000)
    n_threads, per_thread = 4, 2000

    def blast(k):
        for i in range(per_thread):
            bus.publish("sched", source=f"t{k}", i=i)

    threads = [threading.Thread(target=blast, args=(k,))
               for k in range(n_threads)]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    wall = time.monotonic() - t0
    total = n_threads * per_thread
    assert wall < 10.0, f"publishers blocked by a stuck subscriber ({wall}s)"
    assert bus.published == total
    # the stuck subscriber kept only its newest window, loss on record
    assert stuck.dropped == total - 64
    assert len(stuck.poll(0)) == 64
    assert len(healthy.poll(0)) == total and healthy.dropped == 0
    st = bus.stats()
    assert st["published"] == total
    by_len = {s["maxlen"]: s for s in st["subscribers"]}
    assert by_len[64]["dropped"] == total - 64
    assert by_len[64]["queued"] == 0         # drained just above
    assert reg.series("monitor/dropped").total == total - 64
    stuck.close(), healthy.close()


def test_stranded_job_requeues_off_dead_site():
    """Whole-site loss mid-run: a placed job whose site dies must not sit
    failed forever (step() only reconciles UP sites) — the scheduler
    retires the stranded pods and requeues the job onto a survivor."""
    fabric = mk_fabric((1, 1))
    sched = FairShareScheduler(fabric, reconcile_s=0.02)
    vc = sched.create_tenant(TenantSpec("a"))
    tj = vc.submit(JobSpec("j", timed_fn(0.25), devices_per_pod=1,
                           backoff_limit=0))
    sched.step()
    assert tj.state == "running"
    doomed = tj.site
    survivor = ({"s0", "s1"} - {doomed}).pop()
    fabric.fail_site(doomed)
    with sched:
        tj.wait(30)
    assert tj.state == "done"
    assert tj.site == survivor
    assert tj.preemptions == 1               # the requeue was counted
    assert tj.results() == ["ok"]


def test_bus_carries_node_pod_and_transfer_events():
    fabric = mk_fabric((2, 2))
    bus = EventBus()
    bus.attach_fabric(fabric)
    sub = bus.subscribe()
    # pod events
    cluster = fabric.sites["s0"].cluster
    cluster.create_namespace("default")
    job = cluster.submit("default", JobSpec("j", lambda ctx: "ok",
                                            devices_per_pod=1))
    cluster.wait(job, timeout=20)
    # node churn + transfer
    cluster.fail_node(cluster.devices[0])
    cluster.join_node(cluster.devices[0])
    fabric.transfer("s0", "s1", 1000, tenant="t")
    kinds = {e.kind for e in sub.poll(0)}
    assert {"pod", "node", "transfer"} <= kinds


def test_registry_listener_streams_metrics():
    from repro_torch.core.metrics import Registry
    reg = Registry()
    bus = EventBus()
    bus.attach_registry(reg, prefixes=("elastic/",))
    sub = bus.subscribe()
    reg.gauge("elastic/loss", 1.5)
    reg.inc("unrelated/x")
    evs = sub.poll(0)
    assert len(evs) == 1
    assert evs[0].data == {"name": "elastic/loss", "value": 1.5}


# ------------------------------------- preempted training resumes (e2e)

def test_elastic_preempt_resume_under_tenant():
    """Acceptance: a fair-share preemption checkpoint-evicts the training
    segment, the burst runs, the grant returns, and training resumes from
    the checkpoint — steps lost within the elastic ckpt_every bound."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.elastic.trainer import ElasticTrainSpec

    fabric = Fabric(device="cpu")
    fabric.add_site("gpu", cluster=Cluster(devices=[torch.device("cpu")]))
    sched = FairShareScheduler(fabric, reconcile_s=0.02,
                               preempt_grace_s=60.0)
    train = sched.create_tenant(TenantSpec("train", priority=0))
    burst = sched.create_tenant(TenantSpec("burst", priority=10,
                                           preemptible=False))
    steps = 10
    spec = ElasticTrainSpec(
        arch_registry.get_smoke("phi4-mini-3.8b"),
        arch_registry.get_parallel("phi4-mini-3.8b"),
        OptimizerConfig(warmup_steps=2, decay_steps=100),
        steps=steps, seq_len=32, global_batch=4, base_shape=(1, 1),
        max_data=1, ckpt_every=2, log_every=1, rejoin_timeout_s=120.0,
        verbose=False, device="cpu")

    def fire_burst():
        while fabric.metrics.series("elastic/step").last < 3:
            time.sleep(0.005)
        burst.submit(JobSpec("burst", timed_fn(0.3),
                             devices_per_pod=1)).wait(120)

    th = threading.Thread(target=fire_burst, daemon=True)
    with sched:
        th.start()
        out = train.run_elastic(spec, site="gpu", devices=1)
        th.join(timeout=120)

    rep = out["report"]
    assert "preempted" in [s.outcome for s in rep.segments]
    assert rep.segments[-1].end == steps - 1            # finished
    assert sorted(out["loss_by_step"]) == list(range(steps))
    assert rep.steps_lost <= spec.ckpt_every            # elastic bound
    assert fabric.metrics.series("elastic/preemptions").total >= 1


# ---------------------------------------------------- across the two stacks
JAX = dict(Fabric=jfab.Fabric, JobSpec=jorch.JobSpec,
           FairShareScheduler=jvc.FairShareScheduler,
           TenantSpec=jvc.TenantSpec, fabric_kw={})
PORT = dict(Fabric=Fabric, JobSpec=JobSpec,
            FairShareScheduler=FairShareScheduler, TenantSpec=TenantSpec,
            fabric_kw={"device": "cpu"})


def _settle(jobs, gate):
    """Block until every pod of the given tenant jobs that is free to
    exit (drained, or its gate open) has exited, so the next ``step()``
    sees the same terminal states on either stack."""
    for tj in jobs:
        for _, job in tj.placements:
            for pod in job.pods:
                if pod.thread is not None and (
                        gate.is_set() or pod.ctx.preempt.is_set()):
                    pod.thread.join(timeout=30)


def _decisions(stack, policy):
    """One submission stream stepped by hand: a capacity claim, four
    equal-size jobs of two tenants on a saturated 2-site fabric, then a
    priority-10 tenant whose 2-device job preempts its way in, a resize,
    a queued cancel and the drain to done.  Returns the ``sched`` bus
    decisions as (tenant, action, site) and the fabric's registry."""
    fabric = stack["Fabric"](**stack["fabric_kw"])
    fabric.add_site("s0", devices=[0, 1])
    fabric.add_site("s1", devices=[0, 1])
    fabric.connect("s0", "s1", gbps=1.0, latency_ms=1.0)
    sched = stack["FairShareScheduler"](fabric, policy=policy,
                                        preempt_grace_s=30.0)
    sub = sched.bus.subscribe(maxlen=100_000)
    spec = stack["TenantSpec"]
    a = sched.create_tenant(spec("a"))
    b = sched.create_tenant(spec("b", weight=2.0))
    hi = sched.create_tenant(spec("hi", priority=10, preemptible=False))
    gate = threading.Event()
    js = stack["JobSpec"]
    claim = a.claim("s1", 1)
    jobs = [vc.submit(js(f"{vc.name}{i}", hold_fn(gate), devices_per_pod=1))
            for i, vc in enumerate((a, a, b, b))]
    sched.step()                        # a0, a1, b2 placed; b3 waits
    burst = hi.submit(js("burst", timed_fn(0.01), devices_per_pod=2),
                      site="s0")
    sched.step()                        # nothing fits: one preemption wave
    _settle(jobs, gate)                 # the victims exit cooperatively
    sched.step()                        # victims requeued, burst placed
    sched.resize_claim(claim, 2)
    late = b.submit(js("late", timed_fn(0.01), devices_per_pod=2),
                    site="s0")
    sched.cancel(late)
    gate.set()
    for _ in range(8):
        _settle(jobs + [burst], gate)
        sched.step()
    claim.release()
    assert all(tj.state == "done" for tj in jobs + [burst]), \
        [(tj.spec.name, tj.state) for tj in jobs + [burst]]
    out = [(e.source, e.data["action"], e.data.get("site"))
           for e in sub.poll(0) if e.kind == "sched"]
    sub.close()
    return out, fabric.metrics


@pytest.mark.parametrize("policy", ["fair", "fifo"])
def test_same_stream_same_sched_decisions_in_both_stacks(policy):
    got, _ = _decisions(PORT, policy)
    want, _ = _decisions(JAX, policy)
    assert got == want
    actions = {a for _, a, _ in got}
    assert {"tenant-created", "claimed", "queued", "placed", "preempt",
            "requeued", "resized", "cancelled", "done",
            "released"} <= actions


def test_lease_billing_per_namespace_in_both_stacks():
    """``lease_device_s/<namespace>``: the device-seconds each tenant's
    pods held, billed on release, on both stacks."""
    _, got = _decisions(PORT, "fair")
    _, want = _decisions(JAX, "fair")
    for ns in ("tenant-a", "tenant-b", "tenant-hi"):
        g = got.series(f"lease_device_s/{ns}").total
        w = want.series(f"lease_device_s/{ns}").total
        assert g > 0 and w > 0, (ns, g, w)


# ------------------------------------------------------ the example twins
def test_multitenant_fabric_example_runs_on_the_cpu(capsys):
    """``repro_torch.examples.multitenant_fabric --fast --device cpu``:
    the JAX example's assertions hold (fair within 20 %, FIFO skewed over
    2x, the trainer preempted and resumed within its checkpoint bound,
    the co-tenant served, every event delivered within one interval)."""
    from repro_torch.examples import multitenant_fabric
    rep = multitenant_fabric.main(["--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "VCLUSTER_REPORT " in out and "\nOK — fair makespan" in out
    prem = rep["preemption"]
    assert prem["preemptions"] >= 1 and prem["completed"]
    assert prem["serve_requests"] == 4 and prem["serve_tokens"] == 16


def test_rl_cotenants_example_runs_on_the_cpu(capsys):
    """``repro_torch.examples.rl_cotenants --fast --device cpu``: the
    actor kill, the fleet regrown through the claim, the learner's
    preemption and crash, bounded staleness, as the JAX example asserts."""
    from repro_torch.examples import rl_cotenants
    rep = rl_cotenants.main(["--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "RL_REPORT " in out and "\nOK — 6/6 learner steps" in out
    assert rep["steps_done"] == 6 and rep["crashes"] == 1
    assert rep["granted_after_resize"] == 3
