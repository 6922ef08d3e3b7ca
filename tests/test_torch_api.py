"""The port's workload API (``repro_torch.api``) against the JAX package's
``repro.api``: manifests, the ``Session`` on a bare cluster, and the
``--manifest`` CLIs.

Twins of ``tests/test_api_manifest.py`` (round trips, field-naming
validation, entrypoints), ``tests/test_api_session.py`` (the cluster
backend's lifecycle, events and cooperative cancel; the tenant backend's
five kinds through ``Session(tenant=)`` against the JAX one) and
``tests/test_api_equivalence.py`` (the same workload through both
Sessions).  Every manifest is held to the JAX schema: the same file
loads to the same ``to_manifest()`` dict in both stacks, and a malformed
one fails with the same ``ManifestError.field``.

Equivalence, all f32 (phi4 smoke, params made by the JAX
``init_params`` and carried over by ``repro_torch.bridge``; the port on
the CPU through its plain paths): a TrainJob's losses within 1e-5
relative (the two frameworks sum the same products in other orders), a
ServeJob's greedy tokens equal.  Sessions run engines, trainers and
actors in threads, so torch is pinned to two threads a team here.
"""
import dataclasses
import json
import pathlib
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi                                    # noqa: E402
from repro.api import runners as jrunners                        # noqa: E402
from repro.configs import registry as jreg                       # noqa: E402
from repro.core.orchestrator import Cluster as JCluster          # noqa: E402
from repro.launch import cli as jcli                             # noqa: E402
from repro.models import params as jpr                           # noqa: E402
from repro.models import transformer as jtfm                     # noqa: E402
from repro import fabric as jfab                                 # noqa: E402
from repro import vcluster as jvc                                # noqa: E402

from repro_torch import api                                      # noqa: E402
from repro_torch import bridge                                   # noqa: E402
from repro_torch.api import (BatchJob, ManifestError, RLJob,     # noqa: E402
                             ServeJob, Session, TrainJob, WorkflowRun,
                             WorkloadState, from_json, from_manifest,
                             resolve_entrypoint)
from repro_torch.api import runners                              # noqa: E402
from repro_torch.api import session as session_mod               # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer        # noqa: E402
from repro_torch.configs import registry as treg                 # noqa: E402
from repro_torch.core.metrics import Registry                    # noqa: E402
from repro_torch.core.orchestrator import Cluster, JobSpec       # noqa: E402
from repro_torch.core.workflow import Step                       # noqa: E402
from repro_torch.data.objectstore import ObjectStore             # noqa: E402
from repro_torch.fabric import Fabric, FederatedStore            # noqa: E402
from repro_torch.models import params as tpr                     # noqa: E402
from repro_torch.vcluster import FairShareScheduler, TenantSpec  # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
MANIFESTS = sorted(pathlib.Path("examples/manifests").glob("*.json"))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Each workload runs in its own thread, and each new thread that runs
    torch's CPU ops starts an OpenMP team of every core: with several test
    workers those teams spin against each other.  Two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def cpu_cluster(**kw):
    return Cluster(devices=[torch.device("cpu")], **kw)


# --------------------------------------------------------------- manifests
@pytest.mark.parametrize("path", MANIFESTS, ids=lambda p: p.name)
def test_example_manifests_load_alike_in_both_stacks(path):
    got, want = api.load_manifest(str(path)), japi.load_manifest(str(path))
    assert got.KIND == want.KIND
    assert got.to_manifest() == want.to_manifest()
    assert from_manifest(want.to_manifest()) == got


def _specs(m):
    """The deterministic round-trip cases of tests/test_api_manifest.py,
    built in the stack ``m``."""
    return [
        m.TrainJob(name="t", steps=7, base_shape=(2, 2), max_data=None,
                   optimizer={"lr": 0.01}, site="gpu", devices=2),
        m.ServeJob(name="s", gen_lens=(4, 2),
                   requests=[{"id": 0, "prompt": [1, 2]}]),
        m.ServeJob(name="s2", paged=True, block_size=4, pool_blocks=12,
                   prefix_cache=False, min_replicas=2, max_replicas=4,
                   target_backlog=2.5, ttft_slo_s=0.5),
        m.BatchJob(name="b", replicas=3, entrypoint="builtins:repr",
                   params={"x": 1}),
        m.WorkflowRun(name="w", only="train",
                      entrypoint="repro.apps.connect.pipeline:"
                                 "add_connect_steps"),
        m.WorkflowRun(name="w2", params={"ffn": {"fov": (8, 16, 16)}}),
        m.TrainJob(name="t2", steps=3, config={"shape": (4, 4)}),
        m.RLJob(name="r", learner_steps=3, learner_site="east", devices=4,
                min_devices=2, paged=True, config={"num_layers": 2}),
    ]


@pytest.mark.parametrize("i", range(len(_specs(api))))
def test_round_trip_is_lossless_and_crosses_stacks(i):
    spec, jspec = _specs(api)[i], _specs(japi)[i]
    wire = json.loads(json.dumps(spec.to_manifest()))
    assert from_manifest(wire) == spec
    assert from_json(spec.to_json()) == spec
    assert wire == jspec.to_manifest()                 # the JAX schema
    assert japi.from_manifest(wire).to_manifest() == wire
    assert from_manifest(jspec.to_manifest()) == spec


def test_runtime_fields_stay_out_of_manifests():
    spec = BatchJob(name="b", entrypoint="builtins:repr")
    with_fn = dataclasses.replace(spec, fn=lambda ctx: "hi")
    assert with_fn == spec                   # compare=False
    assert "fn" not in with_fn.to_manifest()["spec"]
    assert from_manifest(with_fn.to_manifest()) == spec


def manifest(kind="TrainJob", name="t", spec=None, **top):
    m = {"kind": kind, "metadata": {"name": name},
         "spec": {"steps": 5} if spec is None else spec}
    m.update(top)
    return m


@pytest.mark.parametrize("bad,field,hint", [
    (manifest(kind="CronJob"), "kind", "unknown kind"),
    (manifest(kind=None), "kind", "unknown kind"),
    ({"kind": "TrainJob", "metadata": {}}, "metadata.name", "required"),
    (manifest(spec={}), "spec.steps", "required field missing"),
    (manifest(spec={"steps": "ten"}), "spec.steps", "expected an int"),
    (manifest(spec={"steps": True}), "spec.steps", "expected an int"),
    (manifest(spec={"steps": 5, "smoke": "yes"}), "spec.smoke",
     "expected a bool"),
    (manifest(spec={"steps": 5, "base_shape": [1]}), "spec.base_shape",
     "expected 2 items"),
    (manifest(spec={"steps": 5, "warp_drive": 1}), "spec.warp_drive",
     "unknown field"),
    (manifest(spec={"steps": 0}), "spec.steps", ">= 1"),
    (manifest(apiVersion="repro/v2"), "apiVersion", "unsupported version"),
    (manifest(kind="ServeJob", spec={"slots": 0}), "spec.slots", ">= 1"),
    (manifest(kind="ServeJob", spec={"gen_lens": ["a"]}),
     "spec.gen_lens[0]", "expected an int"),
    (manifest(kind="ServeJob", spec={"requests": [{"id": 1}]}),
     "spec.requests[0]", "'id' and 'prompt'"),
    (manifest(kind="BatchJob", spec={"replicas": 0}), "spec.replicas",
     ">= 1"),
    (manifest(kind="BatchJob", spec={"entrypoint": "no-colon"}),
     "spec.entrypoint", "pkg.module:attr"),
    (manifest(kind="WorkflowRun", spec={"resume": 1}), "spec.resume",
     "expected a bool"),
])
def test_malformed_manifests_name_the_same_field(bad, field, hint):
    with pytest.raises(japi.ManifestError) as want:
        japi.from_manifest(bad)
    with pytest.raises(ManifestError) as got:
        from_manifest(bad)
    assert got.value.field == want.value.field == field
    assert str(got.value) == str(want.value)
    assert hint in str(got.value)


def test_direct_construction_validates_too():
    with pytest.raises(ManifestError, match="spec.steps"):
        TrainJob(name="t", steps=0)
    with pytest.raises(ManifestError, match="metadata.name"):
        ServeJob(name="")
    with pytest.raises(ManifestError, match="spec.learner_steps"):
        api.RLJob(name="r", learner_steps=0)


def test_entrypoint_resolution():
    assert resolve_entrypoint("builtins:repr") is repr
    assert resolve_entrypoint("repro_torch.api.runners:train_result") is \
        runners.train_result
    with pytest.raises(ManifestError, match="spec.entrypoint"):
        resolve_entrypoint("not.a.module:thing")
    with pytest.raises(ManifestError, match="spec.entrypoint"):
        resolve_entrypoint("builtins:no_such_attr")
    with pytest.raises(ManifestError, match="spec.entrypoint"):
        resolve_entrypoint("builtins")
    job = BatchJob(name="b", entrypoint="builtins:repr")
    assert job.resolve_fn() is repr
    with pytest.raises(ManifestError, match="spec.entrypoint"):
        BatchJob(name="b").resolve_fn()


def test_from_json_rejects_garbage():
    with pytest.raises(ManifestError, match="not valid JSON"):
        from_json("{nope")
    with pytest.raises(ManifestError, match="must be an object"):
        from_json("[1, 2]")


# ------------------------------------------------------- session: cluster
def test_cluster_batch_lifecycle_and_events():
    session = Session(cluster=cpu_cluster())
    sub = session.bus.subscribe()
    handle = session.apply(BatchJob(name="hello", replicas=2),
                           fn=lambda ctx: f"hi-{ctx.pod_id}")
    out = handle.wait(60)
    assert sorted(out["results"]) == ["hi-hello-0", "hi-hello-1"]
    states = [e["state"] for e in handle.events()]
    assert states == ["Pending", "Placing", "Running", "Succeeded"]
    evs = sub.poll()
    kinds = {(e.kind, e.data.get("state")) for e in evs}
    assert ("workload", "Succeeded") in kinds       # monitor-visible
    pods = [e.data["event"] for e in evs if e.kind == "pod"]
    assert pods.count("running") == 2 and pods.count("succeeded") == 2
    assert session.status()[0].state == WorkloadState.SUCCEEDED


def test_cluster_batch_entrypoint_and_cancel():
    session = Session(cluster=cpu_cluster())
    h = session.apply({"kind": "BatchJob", "metadata": {"name": "decl"},
                       "spec": {"entrypoint": "builtins:repr"}})
    assert "PodCtx" in h.wait(60)["results"][0]

    def slowpoke(ctx):
        while not ctx.should_stop():
            time.sleep(0.005)
        return "drained"

    h2 = session.apply(BatchJob(name="slow"), fn=slowpoke)
    while h2.state != WorkloadState.RUNNING:
        time.sleep(0.005)
    time.sleep(0.02)
    assert h2.cancel(wait=True, timeout=60)
    assert h2.state == WorkloadState.CANCELLED
    assert h2.result()["results"] == ["drained"]
    assert not h2.cancel()                   # already terminal


def test_forget_drops_a_terminal_workload_and_its_result():
    """``Session.forget`` (the port's own verb: a session on the card
    otherwise pins every finished job's params or outputs there)."""
    session = Session(cluster=cpu_cluster())
    gate = threading.Event()
    running = session.apply(BatchJob(name="held"),
                            fn=lambda ctx: gate.wait(60))
    done = session.apply(BatchJob(name="done"), fn=lambda ctx: "out")
    assert done.wait(60)["results"] == ["out"]
    with pytest.raises(ValueError, match="wait or cancel first"):
        session.forget(running)
    session.forget(done)
    assert [h.spec.name for h in session.workloads] == ["held"]
    assert done.result() is None
    assert done.state == WorkloadState.SUCCEEDED
    assert [e["state"] for e in done.events()][-1] == "Succeeded"
    gate.set()
    assert session.wait(60)[0]["results"] == [True]


def test_cluster_workflow_and_cancel(tmp_path):
    session = Session(cluster=cpu_cluster(),
                      store=ObjectStore(str(tmp_path)))
    ran = []

    def define(wf):
        wf.add(Step("a", lambda ctx: ran.append("a") or {"n": 1}))
        wf.add(Step("b", lambda ctx: ran.append("b") or {"n": 2},
                    deps=["a"]))

    out = session.apply(WorkflowRun(name="wf"), define=define).wait(60)
    assert ran == ["a", "b"]
    assert out["results"]["b"] == {"n": 2}
    assert [r.step for r in out["reports"]] == ["a", "b"]

    gate = threading.Event()

    def define_slow(wf):
        wf.add(Step("a", lambda ctx: (gate.wait(10), {"n": 1})[1]))
        wf.add(Step("b", lambda ctx: ran.append("b2"), deps=["a"]))

    h = session.apply(WorkflowRun(name="wf2"), define=define_slow)
    while h.state != WorkloadState.RUNNING:
        time.sleep(0.005)
    h.cancel()
    gate.set()                       # step a finishes AFTER the cancel
    h.wait(60)
    assert h.state == WorkloadState.CANCELLED
    assert "b2" not in ran
    assert h.result()["results"] == {"a": {"n": 1}}
    assert ObjectStore(str(tmp_path)).exists("workflows/wf2/a/_COMPLETE")


def plan_two(ctx):
    return {"chunks": ["c0", "c1"]}


def double(ctx, k=2):
    return {"i": ctx.inputs["index"] * k}


def test_cluster_graph_workflow_from_a_manifest(tmp_path):
    """A WorkflowRun graph declared entirely in a manifest, entrypoints in
    this module: plan -> scatter -> join, on the session's store."""
    mod = __name__
    session = Session(cluster=cpu_cluster(),
                      store=ObjectStore(str(tmp_path)))
    h = session.apply({"kind": "WorkflowRun", "metadata": {"name": "g"},
                       "spec": {"max_workers": 2, "graph": {"nodes": [
                           {"step": "plan", "entrypoint": f"{mod}:plan_two"},
                           {"step": "seg", "deps": ["plan"],
                            "entrypoint": f"{mod}:double",
                            "params": {"k": 3},
                            "scatter": {"over": "plan.chunks"}}]}}})
    out = h.wait(60)
    assert out["results"]["seg"] == [{"i": 0}, {"i": 3}]
    running = [e for e in h.events() if e["state"] == "Running"]
    assert running[0]["mode"] == "graph" and running[0]["steps"] == 2
    assert h.status().observed["steps_done"] == 4
    with pytest.raises(RuntimeError, match=r"store=ObjectStore"):
        Session(cluster=cpu_cluster()).apply(
            WorkflowRun(name="w"), define=lambda wf: None).wait(60)


def tiny_train(name, **kw):
    kw.setdefault("seq_len", 16)
    kw.setdefault("global_batch", 2)
    kw.setdefault("log_every", 1)
    kw.setdefault("verbose", False)
    return TrainJob(name=name, **kw)


def test_cluster_train_cancel_preserves_checkpoint(tmp_path):
    """cancel() drains a RUNNING training workload to CANCELLED via the
    cooperative preempt path, and the goodbye checkpoint is there to
    resume from."""
    session = Session(cluster=cpu_cluster())
    ckpt = str(tmp_path / "ckpt")
    h = session.apply(tiny_train("cancel-me", steps=500, ckpt_every=2,
                                 ckpt_dir=ckpt))
    while h.status().observed.get("step", -1) < 4:
        time.sleep(0.01)
    assert h.cancel(wait=True, timeout=120)
    assert h.state == WorkloadState.CANCELLED
    seg = h.result()["report"].segments[-1]
    assert seg.outcome == "preempted"        # the cooperative drain path
    last = seg.end
    assert last < 499                        # it really stopped early
    assert Checkpointer(ObjectStore(ckpt)).latest_step() == last
    out2 = session.apply(tiny_train("resume", steps=last + 3,
                                    ckpt_dir=ckpt)).wait(300)
    assert out2["report"].segments[0].start == last + 1
    assert len(out2["losses"]) == 2


def test_trainer_probe_reads_only_its_own_trainer():
    h = session_mod.Handle(BatchJob(name="p"), "cluster")
    bind = runners.trainer_probe(h)
    assert "step" not in h.status().observed      # no trainer yet

    class T:
        progress = 7
    bind(T())
    assert h.status().observed["step"] == 7


def test_cluster_reports_capacity_quota_and_pod_events():
    """What the session's bus and a scheduler read from the orchestrator:
    free devices, queue depth, quota changes and pod lifecycle events, as
    in the JAX twin."""
    cluster = Cluster(devices=["slot0", "slot1", "slot2"])
    cluster.create_namespace("ns")
    events = []
    cluster.add_pod_watcher(lambda ev, pod: events.append((ev, pod.pod_id)))
    gate = threading.Event()
    job = cluster.submit("ns", JobSpec(
        "j", lambda ctx: gate.wait(10), replicas=2, devices_per_pod=1,
        priority=3))
    assert job.spec.priority == 3
    assert cluster.free_devices() == 1 and cluster.queue_depth() == 2
    cluster.set_quota("ns", 2)
    with pytest.raises(RuntimeError, match="quota"):
        cluster.submit("ns", JobSpec("k", lambda ctx: 0, devices_per_pod=1))
    gate.set()
    cluster.wait(job)
    assert cluster.free_devices() == 3 and cluster.queue_depth() == 0
    assert sorted(events) == [("running", "j-0"), ("running", "j-1"),
                              ("succeeded", "j-0"), ("succeeded", "j-1")]


def test_bus_streams_registry_gauges_and_timers():
    reg = Registry()
    bus = session_mod.Session(cluster=cpu_cluster(metrics=reg)).bus
    sub = bus.subscribe()
    with reg.timer("serve/step_s"):
        pass
    reg.gauge("other/x", 1.0)
    bus.attach_registry(reg)
    reg.gauge("serve/tok_s", 12.5)
    reg.inc("elastic/steps")
    reg.gauge("other/y", 2.0)
    got = [(e.data["name"], e.data["value"]) for e in sub.poll()
           if e.kind == "metric"]
    assert got == [("serve/tok_s", 12.5), ("elastic/steps", 1.0)]
    assert reg.scrape()["serve/tok_s"] == 12.5
    assert reg.series("serve/step_s").mean() >= 0.0
    assert bus.stats()["published"] >= 2


def test_apply_rejects_non_specs():
    session = Session(cluster=cpu_cluster())
    with pytest.raises(Exception, match="Session.apply"):
        session.apply(42)


def test_session_requires_exactly_one_backend():
    with pytest.raises(TypeError, match="exactly one backend"):
        Session()
    with pytest.raises(TypeError, match="exactly one backend"):
        Session(cluster=cpu_cluster(), fabric=object())


def test_default_cluster_needs_a_card(monkeypatch):
    """``Cluster()`` leases the card; without one the session cannot be
    built, and nothing falls back to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(cluster=Cluster())
    slots = Session(cluster=Cluster(devices=["slot0"]))
    h = slots.apply(ServeJob(name="s", n_requests=1))
    with pytest.raises(RuntimeError, match="failed"):
        h.wait(60)
    assert h.state == WorkloadState.FAILED


# ------------------------------------------------------------ equivalence
def _f32_cfgs():
    return (jreg.get_smoke(ARCH).replace(**F32),
            treg.get_smoke(ARCH).replace(**F32))


@pytest.fixture()
def jax_params_in_the_port(monkeypatch):
    """The port's ``init_params`` returns the JAX ``init_params`` draw for
    the generator's seed (``jax.random`` cannot be reproduced in torch),
    so both stacks start from the same weights."""
    jcfg, _ = _f32_cfgs()

    def init(schema, gen, dtype, device="cuda"):
        p = jpr.init_params(jtfm.lm_schema(jcfg),
                            jax.random.key(gen.initial_seed()), dtype)
        return bridge.to_torch(jax.tree.map(np.asarray, p), device=device)
    monkeypatch.setattr(tpr, "init_params", init)


def test_train_job_matches_the_jax_session(jax_params_in_the_port):
    jcfg, tcfg = _f32_cfgs()
    kw = dict(steps=6, seq_len=16, global_batch=2, log_every=1,
              verbose=False)
    want = japi.Session(cluster=JCluster(devices=jax.devices())).apply(
        japi.TrainJob(name="eq", config=jrunners.dataclass_kwargs(jcfg),
                      **kw)).wait(300)
    got = Session(cluster=cpu_cluster()).apply(
        TrainJob(name="eq", config=runners.dataclass_kwargs(tcfg),
                 **kw)).wait(300)
    assert len(got["losses"]) == len(want["losses"]) == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for f in ("steps", "global_batch", "seq_len"):
        assert getattr(got["report"], f) == getattr(want["report"], f)


def test_serve_job_matches_the_jax_session(jax_params_in_the_port,
                                           monkeypatch):
    jcfg, tcfg = _f32_cfgs()
    monkeypatch.setattr(jrunners, "resolve_serve_cfg", lambda job: jcfg)
    monkeypatch.setattr(runners, "resolve_serve_cfg", lambda job: tcfg)
    job = dict(name="eq", n_requests=5, prompt_len=8, max_new_tokens=8,
               slots=2, gen_lens=(8, 2, 4), paged=True, block_size=4)
    want = japi.Session(cluster=JCluster(devices=jax.devices())).apply(
        japi.ServeJob(**job)).wait(300)
    h = Session(cluster=cpu_cluster()).apply(ServeJob(**job))
    got = h.wait(300)
    assert got["results"] == want["results"]
    assert [len(got["results"][i]) for i in range(5)] == [8, 2, 4, 8, 2]
    for field in ("requests", "tokens"):
        assert got["report"].extra[field] == want["report"].extra[field]
    assert h.status().observed["completed"] == 5


def test_serve_paged_manifest_matches_the_direct_router_run():
    """``serve_paged.json`` (1 to 2 replicas) through the Session gives the
    tokens of the port's direct ``run_serve_replicated``."""
    spec = api.load_manifest("examples/manifests/serve_paged.json")
    h = Session(cluster=cpu_cluster()).apply(spec.to_manifest())
    got = h.wait(300)
    direct = runners.run_serve_replicated(None, spec, Registry(),
                                          device="cpu")
    assert got["results"] == direct["results"]
    assert sorted(got["results"]) == list(range(spec.n_requests))
    reps = [e["replicas"] for e in h.events() if "replicas" in e]
    assert reps[0] == "1→0" and reps[-1].endswith("→0")


# ------------------------------------------------------- the tenant backend
def jax_sched(tmp_path):
    """The JAX tests' tenant fabric: s0 with two devices, s1 with one."""
    dev = jax.devices()[0]
    fabric = jfab.Fabric()
    fabric.add_site("s0", cluster=JCluster(devices=[dev, dev]),
                    store_root=str(tmp_path / "jax-s0"))
    fabric.add_site("s1", cluster=JCluster(devices=[dev]),
                    store_root=str(tmp_path / "jax-s1"))
    fabric.connect("s0", "s1", gbps=10.0, latency_ms=1.0)
    return jvc.FairShareScheduler(fed=jfab.FederatedStore(fabric),
                                  reconcile_s=0.01)


def port_sched(tmp_path):
    """The same fabric on the port: logical slots computing on the CPU."""
    fabric = Fabric(device="cpu")
    fabric.add_site("s0", devices=[0, 1], store_root=str(tmp_path / "s0"))
    fabric.add_site("s1", devices=[0], store_root=str(tmp_path / "s1"))
    fabric.connect("s0", "s1", gbps=10.0, latency_ms=1.0)
    return FairShareScheduler(fed=FederatedStore(fabric), reconcile_s=0.01)


def test_tenant_session_defaults_to_the_schedulers_metrics_and_bus(tmp_path):
    sched = port_sched(tmp_path)
    session = Session(tenant=sched.create_tenant(TenantSpec("alice")))
    assert session.metrics is sched.metrics and session.bus is sched.bus
    assert session._backend.kind == "tenant"


def test_tenant_batch_serve_workflow(tmp_path):
    sched = port_sched(tmp_path)
    vc = sched.create_tenant(TenantSpec("alice"))
    session = Session(tenant=vc)
    with sched:
        out = session.apply(BatchJob(name="tb", devices_per_pod=1),
                            fn=lambda ctx: "ok").wait(60)
        assert out["results"] == ["ok"]

        # a queued job cancelled before placement dequeues cleanly
        blocker = session.apply(
            BatchJob(name="hog", devices_per_pod=2, site="s0"),
            fn=lambda ctx: time.sleep(0.5) or "hog")
        queued = session.apply(
            BatchJob(name="stuck", devices_per_pod=2, site="s0"),
            fn=lambda ctx: "never")
        time.sleep(0.1)
        queued.cancel(wait=True, timeout=30)
        assert queued.state == WorkloadState.CANCELLED
        assert queued.result()["results"] == []
        assert blocker.wait(60)["results"] == ["hog"]

        def define(wf):
            wf.add(Step("t", lambda ctx: {"tenant": ctx.namespace}))

        wout = session.apply(WorkflowRun(name="twf"),
                             define=define).wait(60)
        assert wout["results"]["t"] == {"tenant": "tenant-alice"}

        sout = session.apply(ServeJob(
            name="tserve", slots=2, prompt_len=8, max_new_tokens=4,
            requests=[{"id": i, "prompt": [1 + i] * 8,
                       "max_new_tokens": 4} for i in range(3)])).wait(300)
        assert len(sout["results"]) == 3
        assert all(len(v) == 4 for v in sout["results"].values())
    assert sched.metrics.series("lease_device_s/tenant-alice").total > 0


@pytest.mark.parametrize("missing", ["site", "devices"])
def test_tenant_train_names_the_missing_field_as_jax_does(missing,
                                                         tmp_path):
    kw = {"site": "s0", "devices": 1}
    del kw[missing]
    errors = []
    for sess, job in (
            (Session(tenant=port_sched(tmp_path).create_tenant(
                TenantSpec("bob"))), tiny_train("t", steps=2, **kw)),
            (japi.Session(tenant=jax_sched(tmp_path).create_tenant(
                jvc.TenantSpec("bob"))),
             japi.TrainJob(name="t", steps=2, seq_len=16, global_batch=2,
                           log_every=1, verbose=False, **kw))):
        h = sess.apply(job)
        with pytest.raises(RuntimeError, match=f"spec.{missing}"):
            h.wait(60)
        assert h.state.value == "Failed"
        errors.append(h.events()[-1]["error"])
    assert errors[0] == errors[1]
    assert errors[0].startswith(f"spec.{missing}: TrainJob on a tenant")


def test_tenant_train_job_matches_the_jax_session(jax_params_in_the_port,
                                                 tmp_path):
    jcfg, tcfg = _f32_cfgs()
    kw = dict(steps=4, seq_len=16, global_batch=2, log_every=1,
              verbose=False, site="s0", devices=1)
    jsched = jax_sched(tmp_path)
    with jsched:
        want = japi.Session(tenant=jsched.create_tenant(
            jvc.TenantSpec("research"))).apply(japi.TrainJob(
                name="tt", config=jrunners.dataclass_kwargs(jcfg),
                **kw)).wait(600)
    sched = port_sched(tmp_path)
    with sched:
        h = Session(tenant=sched.create_tenant(TenantSpec("research"))) \
            .apply(TrainJob(name="tt", config=runners.dataclass_kwargs(tcfg),
                            **kw))
        got = h.wait(600)
    assert h.state == WorkloadState.SUCCEEDED
    assert len(got["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    leaf = got["params"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    assert leaf.device.type == "cpu"          # the site's compute device
    for ms in (sched.metrics, jsched.metrics):
        assert ms.series("lease_device_s/tenant-research").total > 0


@pytest.mark.parametrize("replicas", [1, 2])
def test_tenant_serve_job_matches_the_jax_session(jax_params_in_the_port,
                                                 monkeypatch, tmp_path,
                                                 replicas):
    jcfg, tcfg = _f32_cfgs()
    monkeypatch.setattr(jrunners, "resolve_serve_cfg", lambda job: jcfg)
    monkeypatch.setattr(runners, "resolve_serve_cfg", lambda job: tcfg)
    job = dict(name="ts", slots=2, prompt_len=8, max_new_tokens=4,
               max_replicas=replicas,
               requests=[{"id": i, "prompt": [1 + i] * 8, "max_new_tokens": 4}
                         for i in range(3)])
    jsched = jax_sched(tmp_path)
    with jsched:
        want = japi.Session(tenant=jsched.create_tenant(
            jvc.TenantSpec("chat"))).apply(japi.ServeJob(**job)).wait(300)
    sched = port_sched(tmp_path)
    with sched:
        h = Session(tenant=sched.create_tenant(TenantSpec("chat"))).apply(
            ServeJob(**job))
        got = h.wait(300)
    assert h.state == WorkloadState.SUCCEEDED
    assert got["site"] == want["site"] == "s0"
    assert got["results"] == want["results"]
    assert sorted(got["results"]) == [0, 1, 2]
    assert got["report"].extra["requests"] == 3


def test_tenant_rl_job_reaches_the_jax_state(tmp_path):
    job = dict(name="rl", arch=ARCH, smoke=True, learner_steps=2, actors=1,
               rollouts_per_step=2, prompt_len=8, max_new_tokens=4,
               seq_len=16, slots=2, broadcast_every=1, ckpt_every=0,
               site="s0", learner_site="s1")
    jsched = jax_sched(tmp_path)
    with jsched:
        jh = japi.Session(tenant=jsched.create_tenant(
            jvc.TenantSpec("rl"))).apply(japi.RLJob(**job))
        want = jh.wait(600)
    sched = port_sched(tmp_path)
    with sched:
        h = Session(tenant=sched.create_tenant(TenantSpec("rl"))).apply(
            RLJob(**job))
        got = h.wait(600)
    assert h.state.value == jh.state.value == "Succeeded"
    assert got["done"] and want["done"]
    assert (got["site"], got["learner_site"]) == \
        (want["site"], want["learner_site"]) == ("s0", "s1")
    assert got["steps_done"] == want["steps_done"] == 2
    assert got["actors_granted"] == want["actors_granted"] == 1
    # the actors pull each published version across the link, billed to
    # the tenant
    assert sched.metrics.series("fabric/tenant/rl/bytes_moved").total > 0
    assert not sched._claims          # the claim was released


def test_tenant_workflow_and_batch_reach_the_jax_states(tmp_path):
    def define(wf):
        wf.add(Step("ns", lambda ctx: {"ns": ctx.namespace}))

    def jdefine(wf):
        from repro.core.workflow import Step as JStep
        wf.add(JStep("ns", lambda ctx: {"ns": ctx.namespace}))

    out = {}
    for tag, sched, sess_cls, spec, wf_cls, dfn in (
            ("port", port_sched(tmp_path), Session, TenantSpec,
             WorkflowRun, define),
            ("jax", jax_sched(tmp_path), japi.Session, jvc.TenantSpec,
             japi.WorkflowRun, jdefine)):
        with sched:
            session = sess_cls(tenant=sched.create_tenant(spec("lab")))
            wf = session.apply(wf_cls(name="w"), define=dfn)
            b = session.apply({"kind": "BatchJob",
                               "metadata": {"name": "b"},
                               "spec": {"devices_per_pod": 1, "site": "s1"}},
                              fn=lambda ctx: ctx.site)
            out[tag] = (wf.wait(60)["results"], wf.state.value,
                        b.wait(60), b.state.value)
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"ns": {"ns": "tenant-lab"}}
    assert out["port"][2] == {"results": ["s1"], "site": "s1",
                              "preemptions": 0}


# --------------------------------------------------------------- the CLIs
@pytest.fixture()
def applied(monkeypatch):
    """Every spec the CLIs hand to ``Session.apply``."""
    seen = []
    orig = session_mod.Session.apply

    def spy(self, spec, **runtime):
        seen.append(spec)
        return orig(self, spec, **runtime)
    monkeypatch.setattr(session_mod.Session, "apply", spy)
    return seen


@pytest.mark.parametrize("cli,path,want", [
    ("train", "train_smoke.json", "[train] loss "),
    ("serve", "serve_smoke.json", "[serve:continuous] completed 4 requests"),
    ("serve", "serve_paged.json", "[serve:continuous] completed 8 requests"),
    ("rl", "rl_smoke.json", "[rl] steps 4/4 version "),
])
def test_manifest_clis_run_through_the_session(cli, path, want, applied,
                                               capsys):
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{cli}").main
    full = f"examples/manifests/{path}"
    main(["--device", "cpu", "--manifest", full])
    assert want in capsys.readouterr().out
    assert applied == [api.load_manifest(full)]


@pytest.mark.parametrize("cli,path,kind", [
    ("train", "serve_smoke.json", "TrainJob"),
    ("serve", "train_smoke.json", "ServeJob"),
    ("rl", "connect_graph.json", "RLJob"),
])
def test_manifest_of_the_wrong_kind_exits_with_the_jax_message(cli, path,
                                                              kind, applied):
    import argparse
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{cli}").main
    full = f"examples/manifests/{path}"
    with pytest.raises(SystemExit) as want:
        jcli.manifest_spec(argparse.Namespace(manifest=full), kind)
    with pytest.raises(SystemExit) as got:
        main(["--device", "cpu", "--manifest", full])
    assert str(got.value) == str(want.value)
    assert applied == []


def test_static_serving_takes_no_manifest():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="benchmark baseline"):
        serve.main(["--device", "cpu", "--static", "--manifest",
                    "examples/manifests/serve_smoke.json"])


def test_flag_paths_declare_the_jax_specs():
    """The flag surface builds the JAX CLIs' specs, field for field."""
    from repro.launch.serve import serve_job as j_serve_job
    from repro.launch.train import train_job as j_train_job
    from repro_torch.launch import serve, train
    kw = dict(steps=4, seq=16, batch=2, smoke=True, ckpt_every=2,
              fail_at=3, seed=1, device_steps=2)
    assert train.train_job(ARCH, **kw).to_manifest() == \
        j_train_job(ARCH, **kw).to_manifest()
    kw = dict(smoke=True, n_requests=3, prompt_len=8, gen=4, batch=2,
              gen_lens=[4, 2])
    assert serve.serve_job(ARCH, **kw).to_manifest() == \
        j_serve_job(ARCH, **kw).to_manifest()
