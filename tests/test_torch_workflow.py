"""The port's workflow engine (``repro_torch.core.workflow``) against the
JAX package's ``repro.core.workflow``.

Twins of ``tests/test_workflow_resume.py``: a crashed-then-restarted
process (fresh Workflow/Cluster objects over the same store) skips
completed steps via their ``_COMPLETE`` markers, and ``only=`` runs one
step in isolation against its dependencies' STORED outputs.  Then the
store layout across the stacks: the port writes the JAX markers and
output manifests byte for byte, and a graph run killed mid-fan-out under
the JAX ``GraphRunner`` resumes under the port's, running only the
missing branches.
"""
import json
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core.orchestrator import Cluster as JCluster           # noqa: E402
from repro.core.workflow import Step as JStep                     # noqa: E402
from repro.core.workflow import Workflow as JWorkflow             # noqa: E402
from repro.data.objectstore import ObjectStore as JStore          # noqa: E402
from repro.flow import GraphRunner as JGraphRunner                # noqa: E402

from repro_torch.core.orchestrator import Cluster                 # noqa: E402
from repro_torch.core.workflow import Step, Workflow              # noqa: E402
from repro_torch.data.objectstore import ObjectStore              # noqa: E402
from repro_torch.flow import GraphRunner                          # noqa: E402
from repro_torch.vcluster.monitor import EventBus                 # noqa: E402

WIDTH = 6


def build(store, calls, crash_at=None, *, stack="port"):
    """A fresh 3-step chain, as a restarted process would construct it."""
    W, S, C = (Workflow, Step, Cluster) if stack == "port" \
        else (JWorkflow, JStep, JCluster)
    wf = W("pipe", cluster=C(devices=list(range(2))), store=store)

    def mk(name, val):
        def fn(ctx):
            calls.append(name)
            if name == crash_at:
                raise RuntimeError(f"{name} crashed")
            return {"v": val, "saw": {d: ctx.inputs[d]["v"]
                                      for d in ctx.inputs}}
        return fn

    wf.add(S("a", mk("a", 1)))
    wf.add(S("b", mk("b", 2), deps=["a"]))
    wf.add(S("c", mk("c", 3), deps=["b"]))
    return wf


def test_crash_restart_resumes_from_markers(tmp_path):
    store = ObjectStore(str(tmp_path))
    calls = []
    with pytest.raises(RuntimeError, match="b crashed"):
        build(store, calls, crash_at="b").run()
    assert calls == ["a", "b"]
    assert store.exists("workflows/pipe/a/_COMPLETE")
    assert not store.exists("workflows/pipe/b/_COMPLETE")
    out = build(store, calls).run()
    assert calls == ["a", "b", "b", "c"]          # a skipped, b retried
    assert out["c"]["saw"] == {"b": 2}
    assert json.loads(store.get("workflows/pipe/a/output.json"))["v"] == 1


def test_resume_false_reruns_completed_steps(tmp_path):
    store = ObjectStore(str(tmp_path))
    calls = []
    build(store, calls).run()
    build(store, calls).run(resume=False)
    assert calls == ["a", "b", "c"] * 2


def test_only_runs_isolated_step_against_stored_outputs(tmp_path):
    store = ObjectStore(str(tmp_path))
    calls = []
    build(store, calls).run(only="a")
    build(store, calls).run(only="b")
    assert calls == ["a", "b"]
    out = json.loads(store.get("workflows/pipe/b/output.json"))
    assert out["saw"] == {"a": 1}


def test_only_with_resume_false_reruns_completed_step(tmp_path):
    store = ObjectStore(str(tmp_path))
    calls = []
    build(store, calls).run()
    out = build(store, calls).run(only="b", resume=False)
    assert calls == ["a", "b", "c", "b"]
    assert out["b"]["saw"] == {"a": 1}            # dep from the store
    build(store, calls).run(only="b")
    assert calls == ["a", "b", "c", "b"]


def test_missing_output_manifest_names_the_step(tmp_path):
    store = ObjectStore(str(tmp_path))
    calls = []
    build(store, calls).run()
    store.delete("workflows/pipe/a/output.json")    # marker survives
    with pytest.raises(RuntimeError, match=r"step 'a'.*missing"):
        build(store, calls).run(only="b")
    with pytest.raises(RuntimeError, match=r"step 'a'.*missing"):
        build(store, calls).run()                   # resume path too
    store.put("workflows/pipe/a/output.json", b"{not json")
    with pytest.raises(RuntimeError, match=r"step 'a'.*unreadable"):
        build(store, calls).run(only="b")


def test_cancel_emits_workflow_event_and_skips_remaining(tmp_path):
    store = ObjectStore(str(tmp_path))
    calls = []
    bus = EventBus()
    sub = bus.subscribe(maxlen=256)
    wf = build(store, calls)
    wf.bus = bus
    hits = {"n": 0}

    def stop_after_a():
        hits["n"] += 1
        return hits["n"] > 1            # a runs, then the signal trips

    out = wf.run(should_stop=stop_after_a)
    assert calls == ["a"] and "b" not in out
    evs = [(e.kind, e.data.get("step"), e.data.get("status"),
            e.data.get("reason"), e.data.get("remaining"))
           for e in sub.poll()]
    assert ("workflow", None, "cancelled", None, 2) in evs
    assert ("step", "b", "skipped", "cancelled", None) in evs
    assert ("step", "c", "skipped", "cancelled", None) in evs


def test_reset_clears_markers(tmp_path):
    store = ObjectStore(str(tmp_path))
    calls = []
    wf = build(store, calls)
    wf.run()
    wf.reset()
    assert not store.exists("workflows/pipe/a/_COMPLETE")
    build(store, calls).run()
    assert calls == ["a", "b", "c"] * 2


# ------------------------------------------------------------ across stacks
def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_store_layout_is_the_jax_one_byte_for_byte(tmp_path):
    """The same chain in both stacks writes the same keys and bytes; a
    chain the JAX engine crashed in resumes under the port."""
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    calls = []
    build(JStore(str(jroot)), calls, stack="jax").run()
    build(ObjectStore(str(troot)), calls).run()
    assert _files(troot) == _files(jroot)
    assert len(_files(troot)) == 6

    root = tmp_path / "cross"
    calls = []
    with pytest.raises(RuntimeError, match="b crashed"):
        build(JStore(str(root)), calls, crash_at="b", stack="jax").run()
    out = build(ObjectStore(str(root)), calls).run()
    assert calls == ["a", "b", "b", "c"]
    assert out["c"]["saw"] == {"b": 2}


def _plan(ctx):
    return {"chunks": [f"c{i}" for i in range(WIDTH)]}


def _fan(work):
    return {"nodes": [
        {"step": "plan", "fn": _plan},
        {"step": "seg", "deps": ["plan"], "fn": work,
         "scatter": {"over": "plan.chunks"}},
        {"step": "join", "deps": ["seg"],
         "fn": lambda ctx: {"segs": [o["i"] for o in ctx.inputs["seg"]]}},
    ]}


def test_jax_run_killed_mid_fanout_resumes_under_the_port(tmp_path):
    started = []

    def work(ctx):
        started.append(ctx.inputs["index"])
        time.sleep(0.04)
        return {"i": ctx.inputs["index"]}

    jwf = JWorkflow("g", cluster=JCluster(devices=list(range(2))),
                    store=JStore(str(tmp_path)))
    JGraphRunner(jwf, _fan(work), max_workers=2).run(
        should_stop=lambda: len(started) >= 3)
    store = ObjectStore(str(tmp_path))
    done_first = {i for i in range(WIDTH)
                  if store.exists(f"workflows/g/seg#{i}/_COMPLETE")}
    assert 0 < len(done_first) < WIDTH, sorted(done_first)
    assert not store.exists("workflows/g/seg/_COMPLETE")

    ran = []

    def work2(ctx):
        ran.append(ctx.inputs["index"])
        return {"i": ctx.inputs["index"]}

    bus = EventBus()
    sub = bus.subscribe(maxlen=1024)
    wf = Workflow("g", cluster=Cluster(devices=["slot0"]), store=store,
                  bus=bus)
    out = GraphRunner(wf, _fan(work2), max_workers=4).run()
    assert sorted(ran) == sorted(set(range(WIDTH)) - done_first)
    assert out["join"] == {"segs": list(range(WIDTH))}
    skipped = {e.data["branch"] for e in sub.poll() if e.kind == "branch"
               and e.data.get("status") == "skipped"}
    assert skipped == done_first
