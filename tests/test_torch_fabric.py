"""The port's multi-site federation (``repro_torch.fabric``) against the JAX
package's ``repro.fabric``.

The cases of ``tests/test_fabric.py`` run against the port with the same
assertions: the link cost model and its meters, site tags, site failure
and restore, degraded links, replication (dedupe, exactly-once billing,
batching), the ``SiteStore`` pull-through and mirror, every planner case,
federated workflows (placement, resume, a site kill between steps) and
``run_elastic_federated`` (one migration, a loss for every step).  Site
clusters the fabric builds hold logical slots and compute on the fabric's
device, here ``device="cpu"``.

Across the stacks: the same scenarios at ``time_scale`` 0 give equal
placements and equal ``fabric/bytes_moved`` / ``fabric/transfer_s``, and
each workload kind through ``Session(fabric=, planner=)`` reaches the JAX
Session's terminal state, a TrainJob with the JAX losses (1e-5 relative,
f32; params from the JAX ``init_params`` through ``repro_torch.bridge``)
and a ServeJob with the JAX tokens.  Sessions and trainers run in
threads, so torch is pinned to two threads a team here.
"""
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi                                    # noqa: E402
from repro import fabric as jfab                                 # noqa: E402
from repro.api import runners as jrunners                        # noqa: E402
from repro.configs import registry as jreg                       # noqa: E402
from repro.core.orchestrator import Cluster as JCluster          # noqa: E402
from repro.core.workflow import Step as JStep                    # noqa: E402
from repro.core.workflow import Workflow as JWorkflow            # noqa: E402
from repro.models import params as jpr                           # noqa: E402
from repro.models import transformer as jtfm                     # noqa: E402

from repro_torch import bridge                                   # noqa: E402
from repro_torch import fabric as tfab                           # noqa: E402
from repro_torch.api import (BatchJob, RLJob, ServeJob,          # noqa: E402
                             Session, TrainJob, WorkflowRun, WorkloadState)
from repro_torch.api import runners                              # noqa: E402
from repro_torch.configs import registry as treg                 # noqa: E402
from repro_torch.core.orchestrator import (Cluster, JobSpec,     # noqa: E402
                                           PodState)
from repro_torch.core.workflow import Step, Workflow             # noqa: E402
from repro_torch.fabric import (Fabric, FederatedStore, Link,    # noqa: E402
                                PlacementPlanner)
from repro_torch.models import params as tpr                     # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Pods, trainers and engines run in threads, each of which starts an
    OpenMP team of every core for torch's CPU ops; with several test
    workers those teams spin against each other.  Two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def mk_fabric(tmp_path, time_scale=0.0, devs=(2, 1)):
    fabric = Fabric(time_scale=time_scale, device="cpu")
    for i, n in enumerate(devs):
        name = f"s{i}"
        fabric.add_site(name, devices=list(range(n)),
                        store_root=str(tmp_path / name))
    names = list(fabric.sites)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            fabric.connect(a, b, gbps=1.0, latency_ms=10.0)
    return fabric


# ---------------------------------------------------------------- topology
def test_link_cost_model():
    link = Link("a", "b", gbps=1.0, latency_s=0.01)
    assert link.bytes_per_s == 1e9 / 8
    assert link.transfer_s(125_000_000) == pytest.approx(1.01)
    assert link.transfer_s(125_000_000, transfers=5) == pytest.approx(1.05)


def test_fabric_transfer_metering(tmp_path):
    fabric = mk_fabric(tmp_path)
    sim = fabric.transfer("s0", "s1", 125_000_000)
    assert sim == pytest.approx(1.01)
    assert fabric.metrics.series("fabric/bytes_moved").total == 125_000_000
    assert fabric.metrics.series("fabric/transfer_s").total == \
        pytest.approx(1.01)
    assert fabric.transfer("s0", "s0", 10**9) == 0.0
    assert fabric.metrics.series("fabric/bytes_moved").total == 125_000_000


def test_fabric_site_tags_and_cross_site_submit(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 1))
    assert fabric.sites["s0"].cluster.site == "s0"
    site, job = fabric.submit("default", JobSpec(
        "probe", lambda ctx: ctx.site, replicas=1, devices_per_pod=2))
    site.cluster.wait(job, timeout=30)
    assert site.name == "s0"            # only s0 has 2 devices
    assert job.results() == ["s0"]      # pods know their site


def test_built_sites_compute_on_the_fabric_device(tmp_path, monkeypatch):
    """Logical slots compute on the fabric's device; a caller's cluster on
    its own device; without a card the default raises."""
    fabric = mk_fabric(tmp_path)
    assert fabric.sites["s0"].cluster.compute_device == torch.device("cpu")
    own = fabric.add_site("own", cluster=Cluster(devices=[
        torch.device("cpu")]), store_root=str(tmp_path / "own"))
    assert own.cluster.site == "own"
    assert own.cluster.metrics is fabric.metrics
    assert own.cluster.compute_device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no online CUDA or CPU"):
        Cluster(devices=[0, 1]).compute_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fabric()


def test_fail_site_drains_cluster(tmp_path):
    fabric = mk_fabric(tmp_path)
    release = threading.Event()
    site, job = fabric.submit("default", JobSpec(
        "hold", lambda ctx: release.wait(5), replicas=1, devices_per_pod=1))
    fabric.fail_site(site.name)
    release.set()
    assert job.pods[0].state == PodState.FAILED
    assert site.capacity == 0
    with pytest.raises(RuntimeError, match="no live site"):
        fabric.submit("default", JobSpec("x", lambda ctx: 1,
                                         devices_per_pod=2))


def test_fail_site_drains_deviceless_pods(tmp_path):
    fabric = mk_fabric(tmp_path)
    release = threading.Event()
    site, job = fabric.submit("default", JobSpec(
        "cpu-only", lambda ctx: release.wait(5), replicas=1,
        devices_per_pod=0))
    for _ in range(200):
        if job.pods[0].state == PodState.RUNNING:
            break
        time.sleep(0.01)
    fabric.fail_site(site.name)
    assert job.pods[0].state == PodState.FAILED
    assert job.pods[0].ctx.should_stop()
    release.set()


def test_degrade_link_scales_transfer_cost(tmp_path):
    fabric = mk_fabric(tmp_path)
    nbytes = 125_000_000
    base = fabric.transfer_s("s0", "s1", nbytes)
    assert base == pytest.approx(1.01)
    fabric.degrade_link("s0", "s1", gbps=0.1)
    assert fabric.transfer_s("s0", "s1", nbytes) == pytest.approx(10.01)
    assert fabric.transfer_s("s1", "s0", nbytes) == pytest.approx(10.01)
    assert fabric.degraded_links() == [("s0", "s1"), ("s1", "s0")]
    assert fabric.metrics.series("fabric/link_degradations").total == 1
    assert fabric.restore_link("s0", "s1") is True
    assert fabric.transfer_s("s0", "s1", nbytes) == pytest.approx(base)
    assert fabric.degraded_links() == []
    assert fabric.restore_link("s0", "s1") is False


def test_degrade_link_latency_override_and_validation(tmp_path):
    fabric = mk_fabric(tmp_path)
    fabric.degrade_link("s0", "s1", gbps=1.0, latency_ms=500.0)
    assert fabric.transfer_s("s0", "s1", 0) == pytest.approx(0.5)
    fabric.restore_link("s0", "s1")
    assert fabric.transfer_s("s0", "s1", 0) == pytest.approx(0.01)
    with pytest.raises(ValueError, match="gbps"):
        fabric.degrade_link("s0", "s1", gbps=0.0)
    with pytest.raises(ValueError, match="no link"):
        fabric.degrade_link("s0", "nope", gbps=0.5)
    assert fabric.degraded_links() == []


def test_double_degrade_restores_first_original(tmp_path):
    fabric = mk_fabric(tmp_path)
    base = fabric.transfer_s("s0", "s1", 125_000_000)
    fabric.degrade_link("s0", "s1", gbps=0.5)
    fabric.degrade_link("s0", "s1", gbps=0.05)
    assert fabric.transfer_s("s0", "s1", 125_000_000) == \
        pytest.approx(20.01)
    fabric.restore_link("s0", "s1")
    assert fabric.transfer_s("s0", "s1", 125_000_000) == \
        pytest.approx(base)


def test_restore_site_clears_degraded_links(tmp_path):
    fabric = mk_fabric(tmp_path)
    base = fabric.transfer_s("s0", "s1", 125_000_000)
    fabric.degrade_link("s0", "s1", gbps=0.1)
    fabric.fail_site("s1")
    fabric.restore_site("s1")
    assert fabric.degraded_links() == []
    assert fabric.transfer_s("s0", "s1", 125_000_000) == \
        pytest.approx(base)
    assert fabric.sites["s1"].capacity == 1


def test_planner_routes_around_browned_out_link(tmp_path):
    fabric = Fabric(device="cpu")
    fabric.add_site("home", devices=[0], store_root=str(tmp_path / "h"))
    fabric.add_site("s1", devices=[0, 1], store_root=str(tmp_path / "s1"))
    fabric.add_site("s2", devices=[0, 1], store_root=str(tmp_path / "s2"))
    fabric.connect("home", "s1", gbps=10.0, latency_ms=1.0)
    fabric.connect("home", "s2", gbps=10.0, latency_ms=1.0)
    fed = FederatedStore(fabric)
    fed.put("d/x", b"z" * 10_000_000, "home")
    planner = PlacementPlanner(fed)
    scores0 = planner.place(["d/x"], devices=2).scores
    assert scores0["s1"] == pytest.approx(scores0["s2"])
    fabric.degrade_link("home", "s1", gbps=0.001)
    p = planner.place(["d/x"], devices=2)
    assert p.site == "s2", f"placed over the browned-out link: {p.scores}"
    assert p.scores["s1"] > p.scores["s2"]
    fabric.restore_link("home", "s1")
    scores2 = planner.place(["d/x"], devices=2).scores
    assert scores2["s1"] == pytest.approx(scores2["s2"])


# ---------------------------------------------------------- federated store
def test_federated_namespace_and_replicate(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    fed.put("a/x", b"hello", "s0")
    assert fed.exists("a/x") and fed.where("a/x") == ["s0"]
    assert fed.list("a") == ["a/x"]
    assert not fabric.sites["s1"].store.exists("a/x")
    assert fed.replicate("a/x", "s1") > 0
    assert fabric.sites["s1"].store.get("a/x") == b"hello"
    assert fed.replicate("a/x", "s1") == 0.0
    assert fed.where("a/x") == ["s0", "s1"]


def test_replicate_dedupes_inflight(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    fed.put("big", b"z" * 1000, "s0")
    start = threading.Barrier(4, timeout=10)

    def pull():
        start.wait()
        fed.replicate("big", "s1")

    threads = [threading.Thread(target=pull) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert fabric.metrics.series("fabric/bytes_moved").total == 1000
    assert fed.where("big") == ["s0", "s1"]


def test_replicate_concurrent_billing_exactly_once(tmp_path):
    fabric = mk_fabric(tmp_path, time_scale=0.001)
    fed = FederatedStore(fabric)
    fed.put("hot", b"z" * 100_000, "s0")
    n = 8
    start = threading.Barrier(n, timeout=10)
    observed, errors = [], []

    def pull():
        try:
            start.wait()
            fed.replicate("hot", "s1")
            observed.append("s1" in fed.where("hot") and
                            fabric.sites["s1"].store.exists("hot"))
        except Exception as e:          # pragma: no cover - failure capture
            errors.append(e)

    threads = [threading.Thread(target=pull) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors[:1]
    assert all(observed) and len(observed) == n
    m = fabric.metrics
    assert m.series("fabric/bytes_moved").total == 100_000
    assert m.series("fabric/transfers").total == 1
    assert m.series("fabric/link/s0->s1/bytes").total == 100_000
    assert m.series("fabric/replicate_dedup").total <= n - 1


def test_replicate_many_batches_latency(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    for i in range(8):
        fed.put(f"d/{i}", b"x" * 100, "s0")
    moved, sim = fed.replicate_many([f"d/{i}" for i in range(8)], "s1")
    assert moved == 800
    per_key = sum(fabric.transfer_s("s0", "s1", 100) for _ in range(8))
    assert sim < per_key
    assert sim == pytest.approx(fabric.transfer_s("s0", "s1", 800))
    assert fed.replicate_many(["nope"], "s1") == (0, 0.0)


def test_put_to_down_site_fails_loudly(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    fed.put("a", b"x", "s0")
    fabric.fail_site("s1")
    with pytest.raises(RuntimeError, match="down"):
        fed.put("k", b"x", "s1")
    with pytest.raises(RuntimeError, match="down"):
        fed.replicate("a", "s1")
    with pytest.raises(RuntimeError, match="down"):
        fed.replicate_many(["a"], "s1")


def test_partial_topology_scores_instead_of_crashing(tmp_path):
    fabric = Fabric(device="cpu")
    for name, n in (("hub", 2), ("s1", 2), ("s2", 2)):
        fabric.add_site(name, devices=list(range(n)),
                        store_root=str(tmp_path / name))
    fabric.connect("hub", "s1", gbps=1.0)
    fabric.connect("hub", "s2", gbps=1.0)      # s1 <-> s2: no route
    fed = FederatedStore(fabric)
    fed.put("d/x", b"z" * 1_000_000, "s1")
    planner = PlacementPlanner(fed)
    assert fed.best_src("d/x", "s2") is None
    p = planner.place(["d/x"])
    assert p.site == "s1"
    assert planner.score(["d/x"], fabric.sites["s2"]) == float("inf")
    assert fed.replicate_many(["d/x"], "s2") == (0, 0.0)
    assert fabric.metrics.series("fabric/missing_key").points


def test_site_loss_hides_replicas_until_restore(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    fed.put("only-s1", b"data", "s1")
    fabric.fail_site("s1")
    assert not fed.exists("only-s1")
    assert fed.list() == []
    with pytest.raises(FileNotFoundError):
        fed.get("only-s1")
    fabric.restore_site("s1")
    assert fed.exists("only-s1")


def test_sitestore_pull_through_and_mirror(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    fed.view("s0").put_array("data/a.npy", np.arange(4))
    view1 = fed.view("s1")
    np.testing.assert_array_equal(view1.get_array("data/a.npy"),
                                  np.arange(4))
    moved = fabric.metrics.series("fabric/bytes_moved").total
    assert moved > 0
    view1.get_array("data/a.npy")                   # cached: no new bytes
    assert fabric.metrics.series("fabric/bytes_moved").total == moved
    mirrored = fed.view("s0", mirror="s1", mirror_prefixes=("checkpoints/",))
    mirrored.put("checkpoints/c1", b"ck")
    mirrored.put("scratch/tmp", b"no")
    assert fed.where("checkpoints/c1") == ["s0", "s1"]
    assert fed.where("scratch/tmp") == ["s0"]
    assert mirrored.delete("checkpoints/c1")
    assert not fed.exists("checkpoints/c1")
    assert not fabric.sites["s1"].store.exists("checkpoints/c1")


def test_sitestore_mirror_skips_a_dead_mirror(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    mirrored = fed.view("s0", mirror="s1")
    fabric.fail_site("s1")
    mirrored.put("checkpoints/c2", b"ck")
    assert fed.where("checkpoints/c2") == ["s0"]
    assert fabric.metrics.series("fabric/mirror_skipped").total == 1
    assert mirrored.size("checkpoints/c2") == 2
    with pytest.raises(FileNotFoundError):
        mirrored.size("nope")


# ---------------------------------------------------------------- placement
def test_planner_places_at_the_data(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 2))
    fed = FederatedStore(fabric)
    fed.put("big/blob", b"z" * 10_000_000, "s1")
    p = PlacementPlanner(fed).place(["big/blob"])
    assert p.site == "s1" and p.mode == "data-local"
    assert p.bytes_to_move == 0 and not p.migrated


def test_planner_prestages_when_data_site_lacks_devices(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(4, 1))
    fed = FederatedStore(fabric)
    fed.put("big/blob", b"z" * 10_000_000, "s1")
    p = PlacementPlanner(fed).place(["big/blob"], devices=2)
    assert p.site == "s0" and p.mode == "pre-stage"
    assert p.bytes_to_move == 10_000_000
    assert p.migrated_from == "s1"
    moved, sim = PlacementPlanner(fed).prestage(["big/blob"], "s0")
    assert moved == 10_000_000 and sim > 0


def test_planner_queue_depth_breaks_ties(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 2))
    fed = FederatedStore(fabric)
    hold = threading.Event()
    site, job = fabric.submit("default", JobSpec(
        "busy", lambda ctx: hold.wait(5), replicas=2, devices_per_pod=1))
    assert site.name == "s0"
    try:
        assert PlacementPlanner(fed).place([]).site == "s1"
    finally:
        hold.set()
        site.cluster.wait(job, timeout=30)


def test_planner_data_blind_round_robin(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 2))
    fed = FederatedStore(fabric)
    fed.put("d/x", b"z" * 1000, "s0")
    planner = PlacementPlanner(fed, data_blind=True)
    assert [planner.place(["d/x"]).site for _ in range(3)] == \
        ["s0", "s1", "s0"]


def test_planner_glob_expansion(tmp_path):
    fabric = mk_fabric(tmp_path)
    fed = FederatedStore(fabric)
    fed.put("models/ffn/w0", b"a" * 100, "s1")
    fed.put("models/ffn/w1", b"b" * 100, "s1")
    planner = PlacementPlanner(fed)
    assert planner.expand(["models/ffn/*", "k"]) == \
        ["models/ffn/w0", "models/ffn/w1", "k"]
    missing, _ = planner.bytes_missing(planner.expand(["models/ffn/*"]), "s0")
    assert missing == 200


def test_planner_never_places_on_zero_capacity_site(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 1))
    fed = FederatedStore(fabric)
    fed.put("d/x", b"z" * 1000, "s1")
    for d in list(fabric.sites["s1"].cluster.devices):
        fabric.sites["s1"].cluster.fail_node(d)
    planner = PlacementPlanner(fed)
    assert all(s.name != "s1" for s in planner.candidates(0))
    p = planner.place(["d/x"])
    assert p.site == "s0" and p.mode == "pre-stage"


def test_planner_skips_dead_sites_and_records_migration(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 2))
    fed = FederatedStore(fabric)
    fed.put("d/x", b"z" * 1000, "s0")
    fed.replicate("d/x", "s1")
    fabric.fail_site("s0")
    p = PlacementPlanner(fed).place(["d/x"])
    assert p.site == "s1"
    assert p.migrated_from == "s0"


def test_planner_reserve_release_and_tenant_backlog(tmp_path):
    """Placed-but-unfinished steps count as load, and another tenant's
    in-flight bytes on a link raise the score of the sites behind it."""
    fabric = mk_fabric(tmp_path, devs=(2, 2))
    fed = FederatedStore(fabric)
    planner = PlacementPlanner(fed, tenant="a")
    planner.reserve("s0")
    assert planner.place([]).site == "s1"
    planner.release("s0")
    assert planner.load(fabric.sites["s0"]) == 0
    fed.put("d/x", b"z" * 1000, "s0")
    with fabric.reserve("s0", "s1", 125_000_000, tenant="b"):
        assert fabric.link_backlog_s("s0", "s1") == pytest.approx(1.0)
        assert fabric.link_backlog_s("s0", "s1", exclude_tenant="b") == 0
        _, est = planner.bytes_missing(["d/x"], "s1")
        assert est > 1.0
    assert fabric.link_backlog_s("s0", "s1") == 0.0


# ------------------------------------------------------- federated workflow
def test_federated_workflow_places_and_reports(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 2))
    fed = FederatedStore(fabric)
    fed.view("s1").put_array("in/x.npy", np.arange(8).astype(np.float64))
    wf = Workflow("w", planner=PlacementPlanner(fed))
    wf.add(Step("sum", lambda ctx: {
        "s": float(ctx.store.get_array("in/x.npy").sum())},
        inputs=["in/x.npy"], outputs=["out/s"]))
    out = wf.run()
    assert out["sum"]["s"] == 28.0
    rep = wf.reports[0]
    assert rep.site == "s1"
    assert "bytes_moved" in rep.extra and "transfer_s" in rep.extra
    assert "Site" in wf.table_one()
    assert wf.metrics.series("workflow/w/sum/missing_output").points


def test_federated_workflow_resume_skips_across_sites(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(2, 2))
    fed = FederatedStore(fabric)
    calls = {"n": 0}

    def mk_wf():
        wf = Workflow("w", planner=PlacementPlanner(fed))

        def fn(ctx):
            calls["n"] += 1
            return {"ok": True}
        wf.add(Step("a", fn))
        return wf

    mk_wf().run()
    out = mk_wf().run()
    assert calls["n"] == 1 and out["a"]["ok"] is True


def test_federated_workflow_survives_site_kill_between_steps(tmp_path):
    fabric = mk_fabric(tmp_path, devs=(4, 2))
    fed = FederatedStore(fabric)

    def mk_wf():
        wf = Workflow("w", planner=PlacementPlanner(fed))
        wf.add(Step("produce", lambda ctx: (
            ctx.store.put("d/x", b"z" * 1000),
            fed.replicate("d/x", "s1"), {"done": 1})[-1],
            outputs=["d/x"]))
        wf.add(Step("consume", lambda ctx: {
            "n": len(ctx.store.get("d/x"))}, deps=["produce"],
            inputs=["d/x"]))
        return wf

    mk_wf().run(only="produce")
    fabric.fail_site("s0")
    wf = mk_wf()
    out = wf.run()
    assert out["consume"]["n"] == 1000
    rep = next(r for r in wf.reports if r.step == "consume")
    assert rep.site == "s1" and rep.extra.get("migrated") == 1.0


def test_monitor_bus_taps_the_fabric(tmp_path):
    """``EventBus.attach_fabric``: every site's pods and the transfer
    meter stream onto the bus."""
    from repro_torch.vcluster.monitor import EventBus
    fabric = mk_fabric(tmp_path)
    bus = EventBus()
    bus.attach_fabric(fabric)
    sub = bus.subscribe()
    fabric.transfer("s0", "s1", 1000, tenant="t")
    site, job = fabric.submit("default", JobSpec("p", lambda ctx: 1))
    site.cluster.wait(job, timeout=30)
    evs = sub.poll()
    tr = [e for e in evs if e.kind == "transfer"]
    assert [(e.source, e.data["dst"], e.data["bytes"], e.data["tenant"])
            for e in tr] == [("s0", "s1", 1000, "t")]
    assert any(e.kind == "pod" and e.source == site.name for e in evs)


# ------------------------------------------------- cross-site elastic train
def _elastic_spec(steps=8, **kw):
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.elastic.trainer import ElasticTrainSpec
    return ElasticTrainSpec(
        registry.get_smoke(ARCH), registry.get_parallel(ARCH),
        OptimizerConfig(warmup_steps=2, decay_steps=100),
        steps=steps, seq_len=32, global_batch=4, base_shape=(1, 1),
        max_data=1, ckpt_every=2, log_every=4, rejoin_timeout_s=0.5,
        verbose=False, device="cpu", **kw)


def test_elastic_federated_failover(tmp_path):
    from repro_torch.fabric import run_elastic_federated
    fabric = Fabric(time_scale=0.0, device="cpu")
    cpu = torch.device("cpu")
    fabric.add_site("alpha", cluster=Cluster(devices=[cpu]),
                    store_root=str(tmp_path / "alpha"))
    fabric.add_site("beta", cluster=Cluster(devices=[cpu]),
                    store_root=str(tmp_path / "beta"))
    fabric.connect("alpha", "beta", gbps=10.0, latency_ms=1.0)
    planner = PlacementPlanner(FederatedStore(fabric))
    steps = 8
    killed = threading.Event()

    def kill_when_halfway():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if fabric.metrics.series("elastic/step").last >= steps // 2:
                fabric.fail_site("alpha")
                killed.set()
                return
            time.sleep(0.01)

    killer = threading.Thread(target=kill_when_halfway, daemon=True)
    killer.start()
    result = run_elastic_federated(planner, _elastic_spec(steps))
    killer.join(timeout=5)
    assert killed.is_set()
    assert result.sites[0] == "alpha" and result.sites[-1] == "beta"
    assert len(result.migrations) == 1
    mig = result.migrations[0]
    assert mig.from_site == "alpha" and mig.to_site == "beta"
    rep = result.report
    assert rep.segments[-1].end == steps - 1
    losses = result.out["loss_by_step"]
    assert sorted(losses) == list(range(steps))
    assert all(np.isfinite(v) for v in losses.values())
    assert rep.recoveries >= 0 and rep.total_wall_s > 0
    assert result.to_json()["migrations"][0]["to_site"] == "beta"
    assert fabric.metrics.series("fabric/migrations").total == 1


# -------------------------------------------------------- across the stacks
def _scenario(fab, tmp_path, tag, *, blind=False, kill=""):
    """A deterministic three-step federated workflow on three unequal
    sites: produce data at the hub with one off-site replica a key,
    consume it at a 2-device step, summarise; optionally a site killed
    after produce."""
    m = fab
    jax_side = m is jfab
    fabric = m.Fabric(time_scale=0.0) if jax_side \
        else m.Fabric(time_scale=0.0, device="cpu")
    for name, n in (("hub", 4), ("mid", 2), ("edge", 1)):
        fabric.add_site(name, devices=list(range(n)),
                        store_root=str(tmp_path / f"{tag}-{name}"))
    fabric.connect("hub", "mid", gbps=10.0, latency_ms=3.0)
    fabric.connect("hub", "edge", gbps=1.0, latency_ms=12.0)
    fabric.connect("mid", "edge", gbps=1.0, latency_ms=12.0)
    fed = m.FederatedStore(fabric)
    WF, ST = (JWorkflow, JStep) if jax_side else (Workflow, Step)

    def produce(ctx):
        n = 0
        for i in range(3):
            n += ctx.store.put_array(
                f"d/{i}.npy", np.arange(1000 * (i + 1), dtype=np.float32))
        for i, dst in enumerate(("mid", "mid", "edge")):
            fed.replicate(f"d/{i}.npy", dst)
        return {"bytes": n}

    def consume(ctx):
        return {"n": int(sum(ctx.store.get_array(f"d/{i}.npy").size
                             for i in range(3)))}

    def mk():
        wf = WF("scn", planner=m.PlacementPlanner(fed, data_blind=blind))
        wf.add(ST("produce", produce,
                  outputs=[f"d/{i}.npy" for i in range(3)]))
        wf.add(ST("consume", consume, deps=["produce"], devices_per_pod=2,
                  inputs=[f"d/{i}.npy" for i in range(3)]))
        wf.add(ST("summary", lambda ctx: {"ok": 1}, deps=["consume"],
                  inputs=["d/0.npy"]))
        return wf

    if kill:
        mk().run(only="produce")
        fabric.fail_site(kill)
    wf = mk()
    out = wf.run()
    return (out, sorted((r.step, r.site, "migrated" in r.extra)
                        for r in wf.reports),
            fabric.metrics.series("fabric/bytes_moved").total,
            fabric.metrics.series("fabric/transfer_s").total)


@pytest.mark.parametrize("blind,kill", [(False, ""), (True, ""),
                                        (False, "hub")])
def test_same_scenario_places_and_meters_alike_in_both_stacks(tmp_path,
                                                              blind, kill):
    got = _scenario(tfab, tmp_path, "t", blind=blind, kill=kill)
    want = _scenario(jfab, tmp_path, "j", blind=blind, kill=kill)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2] > 0
    assert got[3] == want[3]
    if kill:
        assert any(mig for _, _, mig in got[1])


# ------------------------------------------------------- the fabric Session
def jax_fabric():
    dev = jax.devices()[0]
    fabric = jfab.Fabric()
    fabric.add_site("big", cluster=JCluster(devices=[dev, dev, dev]))
    fabric.add_site("small", cluster=JCluster(devices=[dev]))
    fabric.connect("big", "small", gbps=10.0, latency_ms=1.0)
    return fabric


def port_fabric():
    fabric = Fabric(device="cpu")
    fabric.add_site("big", devices=[0, 1, 2])
    fabric.add_site("small", devices=[0])
    fabric.connect("big", "small", gbps=10.0, latency_ms=1.0)
    return fabric


def _f32_cfgs():
    return (jreg.get_smoke(ARCH).replace(**F32),
            treg.get_smoke(ARCH).replace(**F32))


@pytest.fixture()
def jax_params_in_the_port(monkeypatch):
    """The port's ``init_params`` returns the JAX draw for the generator's
    seed, so both stacks start from the same weights."""
    jcfg = jreg.get_smoke(ARCH).replace(**F32)

    def init(schema, gen, dtype, device="cuda"):
        p = jpr.init_params(jtfm.lm_schema(jcfg),
                            jax.random.key(gen.initial_seed()), dtype)
        return bridge.to_torch(jax.tree.map(np.asarray, p), device=device)
    monkeypatch.setattr(tpr, "init_params", init)


def test_fabric_session_batch_places_and_runs():
    session = Session(fabric=port_fabric())
    h = session.apply(BatchJob(name="fb", devices_per_pod=1),
                      fn=lambda ctx: ctx.site)
    out = h.wait(60)
    want = japi.Session(fabric=jax_fabric()).apply(
        japi.BatchJob(name="fb", devices_per_pod=1),
        fn=lambda ctx: ctx.site).wait(60)
    assert out["results"] == want["results"] == ["big"]
    assert out["site"] == want["site"] == "big"
    h2 = session.apply(BatchJob(name="pin", site="small"),
                       fn=lambda ctx: ctx.site)
    assert h2.wait(60)["results"] == ["small"]
    assert h.state == h2.state == WorkloadState.SUCCEEDED


def test_fabric_session_workflow_needs_planner_and_places():
    fabric = port_fabric()
    h = Session(fabric=fabric).apply(WorkflowRun(name="nope"),
                                     define=lambda wf: None)
    with pytest.raises(RuntimeError, match="planner"):
        h.wait(60)
    assert h.state == WorkloadState.FAILED
    planner = PlacementPlanner(FederatedStore(fabric))
    session = Session(fabric=fabric, planner=planner)
    planner.fed.put("data/x", b"z" * 1024, "small")

    def define(wf):
        wf.add(Step("read", lambda ctx: {"n": len(ctx.store.get("data/x"))},
                    inputs=["data/x"]))

    sub = session.bus.subscribe()
    h = session.apply(WorkflowRun(name="wf"), define=define)
    out = h.wait(60)
    assert out["results"]["read"] == {"n": 1024}
    assert out["reports"][0].site == "small"
    assert h.state == WorkloadState.SUCCEEDED
    steps = [(e.data["status"], e.data.get("site")) for e in sub.poll()
             if e.kind == "step"]
    assert steps == [("placed", "small"), ("done", "small")]


def test_fabric_session_serve_matches_the_jax_session(jax_params_in_the_port,
                                                     monkeypatch):
    jcfg, tcfg = _f32_cfgs()
    monkeypatch.setattr(jrunners, "resolve_serve_cfg", lambda job: jcfg)
    monkeypatch.setattr(runners, "resolve_serve_cfg", lambda job: tcfg)
    job = dict(name="fs", slots=2, prompt_len=8, max_new_tokens=4,
               site="small",
               requests=[{"id": i, "prompt": [1 + i] * 8, "max_new_tokens": 4}
                         for i in range(3)])
    want = japi.Session(fabric=jax_fabric()).apply(
        japi.ServeJob(**job)).wait(300)
    h = Session(fabric=port_fabric()).apply(ServeJob(**job))
    got = h.wait(300)
    assert h.state == WorkloadState.SUCCEEDED
    assert got["site"] == want["site"] == "small"
    assert got["results"] == want["results"]
    assert len(got["results"]) == 3
    assert got["report"].extra["requests"] == 3


def test_fabric_session_train_matches_the_jax_session(jax_params_in_the_port):
    jcfg, tcfg = _f32_cfgs()
    kw = dict(steps=4, seq_len=16, global_batch=2, log_every=1,
              verbose=False)
    jf = jax_fabric()
    want = japi.Session(fabric=jf, planner=jfab.PlacementPlanner(
        jfab.FederatedStore(jf))).apply(japi.TrainJob(
            name="fed", config=jrunners.dataclass_kwargs(jcfg),
            **kw)).wait(600)
    tf = port_fabric()
    h = Session(fabric=tf, planner=PlacementPlanner(FederatedStore(tf))) \
        .apply(TrainJob(name="fed", config=runners.dataclass_kwargs(tcfg),
                        **kw))
    got = h.wait(600)
    assert h.state == WorkloadState.SUCCEEDED
    assert len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["sites"] == want["sites"] and got["sites"]
    assert got["migrations"] == want["migrations"] == []


def test_fabric_session_rl_reaches_the_jax_state(tmp_path):
    job = dict(name="rl", arch=ARCH, smoke=True, learner_steps=2, actors=1,
               rollouts_per_step=2, prompt_len=8, max_new_tokens=4,
               seq_len=16, slots=2, broadcast_every=1, ckpt_every=0,
               learner_site="small")
    jf = jax_fabric()
    jh = japi.Session(fabric=jf, planner=jfab.PlacementPlanner(
        jfab.FederatedStore(jf))).apply(japi.RLJob(**job))
    want = jh.wait(600)
    tf = port_fabric()
    h = Session(fabric=tf, planner=PlacementPlanner(FederatedStore(tf))) \
        .apply(RLJob(**job))
    got = h.wait(600)
    assert h.state.value == jh.state.value == "Succeeded"
    assert got["done"] and want["done"]
    assert (got["site"], got["learner_site"]) == \
        (want["site"], want["learner_site"]) == ("big", "small")
    assert got["steps_done"] == want["steps_done"] == 2
    # the actors pull each published version across the link
    assert tf.metrics.series("fabric/bytes_moved").total > 0


def test_fabric_session_needs_a_planner_for_training_and_rl():
    session = Session(fabric=port_fabric())
    for spec in (TrainJob(name="t", steps=1),
                 RLJob(name="r", learner_steps=1)):
        h = session.apply(spec)
        with pytest.raises(RuntimeError, match="planner"):
            h.wait(60)
        assert h.state == WorkloadState.FAILED


def test_fabric_session_pins_to_a_live_site_only():
    fabric = port_fabric()
    fabric.fail_site("small")
    h = Session(fabric=fabric).apply(BatchJob(name="b", site="small"),
                                     fn=lambda ctx: 1)
    with pytest.raises(RuntimeError, match="down"):
        h.wait(60)
    assert h.state == WorkloadState.FAILED
