"""The port's workflow programs (``repro_torch.flow``) against the JAX
package's ``repro.flow``.

Twins of ``tests/test_flow_spec.py`` and ``tests/test_flow_exec.py``:
every malformed graph fails in both stacks with a ``ManifestError``
naming the same manifest field; the expression language evaluates the
same values; and the graph executor's program semantics (concurrent
fan-out, a kill mid-fan-out that resumes only the missing branches, a
failed branch that keeps the finished markers, ``when:``, ``repeat:`` /
``until:``, nested subworkflows, ``only=``) hold on a bare ``Cluster`` +
``ObjectStore``, the port's single-cluster mode, where the JAX tests use
a three-site fabric.  One repair: the port rejects dunder attribute
access (``x.__class__``), which the JAX whitelist admits.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.api import ManifestError as JManifestError            # noqa: E402
from repro.api import WorkflowRun as JWorkflowRun                # noqa: E402
from repro.flow import compile_graph as j_compile_graph          # noqa: E402
from repro.flow import eval_expr as j_eval_expr                  # noqa: E402
from repro.flow import parse_expr as j_parse_expr                # noqa: E402
from repro.flow import validate_graph as j_validate_graph        # noqa: E402

from repro_torch.api import ManifestError, WorkflowRun           # noqa: E402
from repro_torch.core.orchestrator import Cluster                # noqa: E402
from repro_torch.core.workflow import Workflow                   # noqa: E402
from repro_torch.data.objectstore import ObjectStore             # noqa: E402
from repro_torch.flow import (GraphRunner, compile_graph,     # noqa: E402
                              eval_expr, parse_expr, run_graph,
                              validate_graph)
from repro_torch.vcluster.monitor import EventBus                # noqa: E402

WIDTH = 8
UNSAFE = ["__import__('os')", "open('/etc/passwd')", "x.__class__",
          "(lambda: 1)()", "[i for i in x]", "f'{x}'", "x := 3",
          "exec('1')", "x ** 9", "{1: 2}"]


def node(step, **kw):
    return {"step": step, "entrypoint": "builtins:repr", **kw}


def graph(*nodes):
    return {"nodes": list(nodes)}


# ------------------------------------------------------------------- spec
@pytest.mark.parametrize("text", UNSAFE)
def test_unsafe_expressions_never_parse(text):
    """The ten strings of ``tests/test_flow_spec.py``: all rejected by the
    port, naming the field."""
    with pytest.raises(ManifestError) as e:
        parse_expr(text, "spec.graph.nodes[0].when")
    assert e.value.field == "spec.graph.nodes[0].when"


def test_jax_still_parses_a_dunder_attribute():
    """The seed's fault stays in the JAX package (the reference is not
    edited): its whitelist admits ``x.__class__``, which the port
    rejects."""
    tree = j_parse_expr("x.__class__", "spec.graph.nodes[0].when")
    assert j_eval_expr(tree, {"x": 1}) is int
    with pytest.raises(ManifestError, match="dunder"):
        parse_expr("x.__class__", "spec.graph.nodes[0].when")
    # a plain attribute still reads a mapping key, as in JAX
    assert eval_expr(parse_expr("x.cls", "f"), {"x": {"cls": 3}}) == 3


MALFORMED = [
    (graph(node("a", deps=["b"]), node("b", deps=["a"])),
     "spec.graph.nodes", "cycle"),
    (graph(node("a", deps=["a"])), "spec.graph.nodes[0].deps[0]",
     "cannot depend on itself"),
    (graph(node("a"), node("b", deps=["ghost"])),
     "spec.graph.nodes[1].deps[0]", "unknown dependency"),
    (graph(node("a"), node("b", deps=["a"], scatter={"over": []})),
     "spec.graph.nodes[1].scatter.over", "may not be empty"),
    (graph(node("a"), node("b", deps=["a"], scatter={"ovr": "a.x"})),
     "spec.graph.nodes[1].scatter.ovr", "unknown scatter keys"),
    (graph(node("a"), node("b", deps=["a"],
                           scatter={"over": "ghost.chunks"})),
     "spec.graph.nodes[1].scatter.over", "not in this node's deps"),
    (graph(node("a"), node("b", deps=["a"], when="ghost.ok")),
     "spec.graph.nodes[1].when", "not in this node's deps"),
    (graph(node("a"), node("b", deps=["a"],
                           repeat={"until": "output.v > 1"})),
     "spec.graph.nodes[1].repeat.max", "bounded"),
    (graph(node("a"), node("b", deps=["a"],
                           repeat={"times": 2, "until": "i > 1",
                                   "max": 3})),
     "spec.graph.nodes[1].repeat", "exactly one"),
    (graph(node("a"), node("b", deps=["a"], scatter={"over": "a.x"},
                           repeat={"times": 2})),
     "spec.graph.nodes[1].scatter", "cannot combine"),
    (graph(node("bad name!")), "spec.graph.nodes[0].step", "must match"),
    (graph(node("a"), node("a")), "spec.graph.nodes[1].step", "duplicate"),
    (graph({"step": "a"}), "spec.graph.nodes[0].entrypoint",
     "exactly one of"),
    (graph(node("a", when="__import__('os').system('x')")),
     "spec.graph.nodes[0].when", "may be called"),
    (graph(node("a", when="[i for i in x]")),
     "spec.graph.nodes[0].when", "may not contain"),
    ({"nodes": []}, "spec.graph.nodes", "non-empty"),
    ({"nodes": [node("a")], "edges": []}, "spec.graph.edges",
     "unknown graph keys"),
]


@pytest.mark.parametrize("bad,field,hint", MALFORMED)
def test_malformed_graphs_name_the_same_field(bad, field, hint):
    with pytest.raises(JManifestError) as want:
        j_validate_graph(bad, field="spec.graph")
    with pytest.raises(ManifestError) as got:
        validate_graph(bad, field="spec.graph")
    assert got.value.field == want.value.field == field
    assert str(got.value) == str(want.value)
    assert hint in str(got.value)


def test_workflowrun_validates_graph_eagerly():
    with pytest.raises(ManifestError, match=r"spec\.graph\.nodes"):
        WorkflowRun(name="w", graph=graph(node("a", deps=["a"])))
    with pytest.raises(ManifestError, match=r"spec\.graph"):
        WorkflowRun(name="w", graph=graph(node("a")),
                    entrypoint="builtins:repr")
    with pytest.raises(ManifestError, match=r"spec\.max_workers"):
        WorkflowRun(name="w", graph=graph(node("a")), max_workers=0)
    ok = WorkflowRun(name="w", graph=graph(node("a")))
    assert ok.to_manifest() == \
        JWorkflowRun(name="w", graph=graph(node("a"))).to_manifest()


@pytest.mark.parametrize("text", [
    "train.loss < 0.1", "train.hist[2] == 1 and not (i > 9)",
    "len(train.hist) + i == 7", "min(train.hist) <= train.loss",
    "0 < i <= 4", "max(train.hist) - 1", "round(train.loss * 100) % 3",
    "train.hist", "-i // 3", "i in [1, 4] or i is None"])
def test_expressions_evaluate_as_jax(text):
    ns = {"train": {"loss": 0.07, "hist": [3, 2, 1]}, "i": 4}
    assert expr_value(text, ns) == j_eval_expr(j_parse_expr(text, "f"), ns)
    with pytest.raises(KeyError, match="ghost"):
        eval_expr(parse_expr("ghost.x", "f"), ns)


def expr_value(text, ns):
    return eval_expr(parse_expr(text, "f"), ns)


def test_compile_resolves_entrypoints_and_nested_graphs():
    g = graph(
        node("a"),
        {"step": "sub", "deps": ["a"],
         "graph": graph(node("x"), node("y", deps=["x"]))},
        node("fan", deps=["a"], scatter={"over": "a.items"}),
        node("loop", deps=["a"], repeat={"until": "output.v > 1",
                                         "max": 5}))
    prog, jprog = compile_graph(g), j_compile_graph(g)
    assert prog.nodes["a"].fn is repr
    assert prog.nodes["sub"].subgraph.nodes["y"].deps == ("x",)
    assert prog.nodes["fan"].scatter_over == "a.items"
    assert prog.nodes["loop"].repeat.bound == 5
    assert prog.size == jprog.size == 6
    assert list(prog.nodes) == list(jprog.nodes)


# --------------------------------------------------------------- executor
def mk_wf(root, bus=None, name="g"):
    """A fresh workflow over a bare cluster + store, as a restarted
    process would build it."""
    return Workflow(name, cluster=Cluster(devices=["slot0", "slot1"]),
                    store=ObjectStore(str(root)), bus=bus)


def plan(ctx, n=WIDTH):
    return {"chunks": [f"c{i}" for i in range(n)]}


def diamond(work_fn, left_fn=None):
    """plan -> (scatter seg, left) -> join: the diamond with fan-out."""
    return {"nodes": [
        {"step": "plan", "fn": plan},
        {"step": "seg", "deps": ["plan"], "fn": work_fn,
         "scatter": {"over": "plan.chunks"}},
        {"step": "left", "deps": ["plan"],
         "fn": left_fn or (lambda ctx: {
             "n": len(ctx.inputs["plan"]["chunks"])})},
        {"step": "join", "deps": ["seg", "left"],
         "fn": lambda ctx: {"segs": len(ctx.inputs["seg"]),
                            "left": ctx.inputs["left"]["n"]}},
    ]}


def test_fanout_runs_branches_concurrently(tmp_path):
    """With a worker pool, the 8-branch scatter overlaps: peak in-flight
    > 1 and makespan well under the serial sum."""
    in_flight = {"now": 0, "peak": 0}
    lock = threading.Lock()

    def work(ctx):
        with lock:
            in_flight["now"] += 1
            in_flight["peak"] = max(in_flight["peak"], in_flight["now"])
        time.sleep(0.05)
        with lock:
            in_flight["now"] -= 1
        return {"i": ctx.inputs["index"]}

    bus = EventBus()
    sub = bus.subscribe(maxlen=2048)
    t0 = time.perf_counter()
    out = GraphRunner(mk_wf(tmp_path, bus), diamond(work),
                      max_workers=8).run()
    makespan = time.perf_counter() - t0
    assert out["join"] == {"segs": WIDTH, "left": WIDTH}
    assert [o["i"] for o in out["seg"]] == list(range(WIDTH))
    assert in_flight["peak"] > 1, "branches never overlapped"
    assert makespan < 0.05 * WIDTH, f"no speedup: {makespan:.2f}s"
    evs = sub.poll()
    done = [e for e in evs if e.kind == "branch"
            and e.data.get("status") == "done" and e.data["of"] == "seg"]
    assert sorted(e.data["branch"] for e in done) == list(range(WIDTH))
    assert {e.data["site"] for e in done} == {"local"}
    scatter = [e for e in evs if e.data.get("status") == "scatter"]
    assert scatter and scatter[0].data["width"] == WIDTH


def test_kill_mid_fanout_resumes_only_missing_branches(tmp_path):
    """Cancel once 3 branches have started; finished branches keep their
    markers, queued ones are revoked, and the re-run executes exactly the
    complement (verified by markers AND by the branch events)."""
    started = []

    def work(ctx):
        started.append(ctx.inputs["index"])
        time.sleep(0.04)
        return {"i": ctx.inputs["index"]}

    bus = EventBus()
    sub = bus.subscribe(maxlen=2048)
    wf = mk_wf(tmp_path, bus)
    GraphRunner(wf, diamond(work), max_workers=2).run(
        should_stop=lambda: len(started) >= 3)
    evs = sub.poll()
    assert any(e.kind == "workflow" and e.data["status"] == "cancelled"
               for e in evs), "no workflow-level cancelled event"
    store = ObjectStore(str(tmp_path))
    done_first = {i for i in range(WIDTH)
                  if store.exists(f"workflows/g/seg#{i}/_COMPLETE")}
    assert 0 < len(done_first) < WIDTH, sorted(done_first)
    assert not store.exists("workflows/g/seg/_COMPLETE"), \
        "incomplete fan-out must not gather"
    ev_done = {e.data["branch"] for e in evs if e.kind == "branch"
               and e.data.get("status") == "done"}
    assert ev_done == done_first     # events agree with the markers

    ran = []

    def work2(ctx):
        ran.append(ctx.inputs["index"])
        return {"i": ctx.inputs["index"]}

    bus2 = EventBus()
    sub2 = bus2.subscribe(maxlen=2048)
    out = GraphRunner(mk_wf(tmp_path, bus2), diamond(work2),
                      max_workers=4).run()
    assert out["join"]["segs"] == WIDTH
    assert sorted(ran) == sorted(set(range(WIDTH)) - done_first), \
        "resume must run ONLY the missing branches"
    skipped = {e.data["branch"] for e in sub2.poll() if e.kind == "branch"
               and e.data.get("status") == "skipped"}
    assert skipped == done_first

    # a third run marker-skips the whole gathered fan-out wholesale
    ran.clear()
    out3 = GraphRunner(mk_wf(tmp_path), diamond(work2)).run()
    assert out3["join"]["segs"] == WIDTH and ran == []


def test_failed_branch_fails_run_but_keeps_finished_markers(tmp_path):
    def work(ctx):
        if ctx.inputs["index"] == 5:
            raise ValueError("branch 5 exploded")
        return {"i": ctx.inputs["index"]}

    with pytest.raises(ValueError, match="branch 5"):
        GraphRunner(mk_wf(tmp_path), diamond(work), max_workers=3).run()
    store = ObjectStore(str(tmp_path))
    assert not store.exists("workflows/g/seg#5/_COMPLETE")
    done = [i for i in range(WIDTH)
            if store.exists(f"workflows/g/seg#{i}/_COMPLETE")]
    assert done, "finished branches must keep their markers"

    def fixed(ctx):
        return {"i": ctx.inputs["index"]}

    out = GraphRunner(mk_wf(tmp_path), diamond(fixed)).run()
    assert out["join"]["segs"] == WIDTH


def test_when_false_skips_node_and_cascades(tmp_path):
    g = {"nodes": [
        {"step": "plan", "fn": plan},
        {"step": "gated", "deps": ["plan"],
         "when": f"len(plan.chunks) > {WIDTH}",
         "fn": lambda ctx: {"ran": True}},
        {"step": "after", "deps": ["gated"],
         "fn": lambda ctx: {"ran": True}},
        {"step": "always", "deps": ["plan"],
         "when": f"len(plan.chunks) == {WIDTH}",
         "fn": lambda ctx: {"ran": True}},
    ]}
    bus = EventBus()
    sub = bus.subscribe(maxlen=256)
    out = GraphRunner(mk_wf(tmp_path, bus), g).run()
    assert out["always"]["ran"] and "gated" not in out and "after" not in out
    reasons = {e.data["step"]: e.data.get("reason") for e in sub.poll()
               if e.data.get("status") == "skipped"}
    assert reasons == {"gated": "when", "after": "when-upstream"}
    # when-skips write no markers: conditions re-evaluate on resume
    assert not ObjectStore(str(tmp_path)).exists(
        "workflows/g/gated/_COMPLETE")


def test_repeat_until_iterates_with_markers_and_resumes(tmp_path):
    runs = []

    def bump(ctx):
        prev = ctx.inputs["prev"] or {"v": 0}
        runs.append(ctx.inputs["i"])
        return {"v": prev["v"] + 1}

    g = {"nodes": [
        {"step": "init", "fn": lambda ctx: {"v": 0}},
        {"step": "tune", "deps": ["init"], "fn": bump,
         "repeat": {"until": "output.v >= 3", "max": 10}},
        {"step": "use", "deps": ["tune"],
         "fn": lambda ctx: {"got": ctx.inputs["tune"]["v"]}},
    ]}
    out = GraphRunner(mk_wf(tmp_path), g).run()
    assert out["use"]["got"] == 3 and runs == [0, 1, 2]
    store = ObjectStore(str(tmp_path))
    assert store.exists("workflows/g/tune#2/_COMPLETE")
    assert not store.exists("workflows/g/tune#3/_COMPLETE")
    # resume: the loop's own marker skips it wholesale
    out2 = GraphRunner(mk_wf(tmp_path), g).run()
    assert out2["use"]["got"] == 3 and runs == [0, 1, 2]


def test_nested_subworkflow_flattens_and_collects(tmp_path):
    g = {"nodes": [
        {"step": "a", "fn": lambda ctx: {"x": 1}},
        {"step": "sub", "deps": ["a"], "graph": {"nodes": [
            {"step": "b",
             "fn": lambda ctx: {"y": ctx.inputs["a"]["x"] + 1}},
            {"step": "c", "deps": ["b"],
             "fn": lambda ctx: {"z": ctx.inputs["b"]["y"] * 10}},
        ]}},
        {"step": "d", "deps": ["sub"],
         "fn": lambda ctx: {"f": ctx.inputs["sub"]["c"]["z"]}},
    ]}
    out = GraphRunner(mk_wf(tmp_path), g).run()
    assert out["d"]["f"] == 20
    assert out["sub"] == {"b": {"y": 2}, "c": {"z": 20}}
    assert ObjectStore(str(tmp_path)).exists("workflows/g/sub.b/_COMPLETE")
    # only= reaches INTO the flattened subworkflow (deps from the store)
    out2 = GraphRunner(mk_wf(tmp_path), g).run(only="sub.c")
    assert out2["sub.c"]["z"] == 20


def test_only_missing_dep_raises_clear_error(tmp_path):
    g = {"nodes": [
        {"step": "a", "fn": lambda ctx: {"x": 1}},
        {"step": "b", "deps": ["a"],
         "fn": lambda ctx: ctx.inputs["a"]},
    ]}
    with pytest.raises(RuntimeError, match=r"depends on 'a'"):
        run_graph(mk_wf(tmp_path), g, only="b")


def test_branch_pods_lease_the_cluster_devices(tmp_path):
    """Nodes with ``pods`` > 1 run as a gang Job on the cluster: each
    branch's pod leases ``devices_per_pod`` devices and returns them."""
    wf = mk_wf(tmp_path)
    leased = []

    def work(ctx):
        leased.append(len(ctx.cluster.leased))
        return {"i": ctx.inputs["index"]}

    g = {"nodes": [
        {"step": "plan", "fn": lambda ctx: plan(ctx, 2)},
        {"step": "seg", "deps": ["plan"], "fn": work, "pods": 2,
         "devices_per_pod": 1, "scatter": {"over": "plan.chunks"}},
    ]}
    out = GraphRunner(wf, g, max_workers=1).run()
    assert [o["i"] for o in out["seg"]] == [0, 1]
    assert leased == [1, 1] and wf.cluster.free_devices() == 2
