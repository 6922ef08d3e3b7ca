"""Workflow programs on the federation, on the port: CONNECT as a
declarative graph.

    PYTHONPATH=src python -m repro_torch.examples.graph_workflow \\
        [--fast] [--device cpu]

The twin of ``examples/graph_workflow.py``, over the port's ``fabric`` and
``api``: the CONNECT case study as a ``WorkflowRun.spec.graph`` manifest
(``repro_torch/apps/connect/connect_graph.json``, the twin of
``examples/manifests/connect_graph.json``, naming the port's
entrypoints): five declarative nodes (plan, fetch scattered over chunks,
train, segment scattered over chunks and placed at the data, analyze)
run concurrently across a 3-site fabric of logical slots computing on one
device (the card unless ``--device cpu``).  Then:

  1. the straight run: every scatter shard shows ``branch`` events on the
     Session's bus;
  2. a second run is cancelled mid-fan-out (after the first segment
     branch completes): it drains cleanly, CANCELLED, with a
     workflow-level ``cancelled`` event;
  3. re-applying the same manifest resumes only the branches that never
     finished: completed shards skip through their markers.

Prints a ``GRAPH_REPORT {json}`` line.
"""
import argparse
import dataclasses
import json
import pathlib
import time

import repro_torch.apps.connect.pipeline as pipeline
from repro_torch.api import Session
from repro_torch.api.resources import load_manifest
from repro_torch.api.session import TERMINAL_STATES, WorkloadState
from repro_torch.fabric import Fabric, FederatedStore, PlacementPlanner

MANIFEST = pathlib.Path(pipeline.__file__).with_name("connect_graph.json")


def build_fabric(device="cuda") -> Fabric:
    fabric = Fabric(time_scale=0.0, device=device)
    fabric.add_site("sdsc", devices=list(range(4)))
    fabric.add_site("calit2", devices=list(range(2)))
    fabric.add_site("edge", devices=list(range(1)))
    fabric.connect("sdsc", "calit2", gbps=10.0, latency_ms=3.0)
    fabric.connect("sdsc", "edge", gbps=1.0, latency_ms=12.0)
    fabric.connect("calit2", "edge", gbps=1.0, latency_ms=12.0)
    return fabric


def branch_events(events, of, status):
    return [e for e in events
            if e.kind == "branch" and e.data.get("of") == of
            and e.data.get("status") == status]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="kept for CI-flag symmetry; the manifest is "
                         "already CI-sized")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = load_manifest(str(MANIFEST))
    n_chunks = spec.graph["nodes"][0]["params"]["n_chunks"]

    # --- 1: straight-through run on a fresh 3-site fabric ----------------
    fabric = build_fabric(args.device)
    session = Session(fabric=fabric,
                      planner=PlacementPlanner(FederatedStore(fabric)))
    sub = session.bus.subscribe(maxlen=8192)
    t0 = time.perf_counter()
    out = session.apply(spec).wait(timeout=600)
    makespan = time.perf_counter() - t0
    events = sub.poll()
    res = out["results"]
    assert res["analyze"]["objects"] >= 1, res
    assert len(res["segment"]) == n_chunks
    fetched = branch_events(events, "fetch", "done")
    segmented = branch_events(events, "segment", "done")
    assert len(fetched) == n_chunks and len(segmented) == n_chunks, \
        (len(fetched), len(segmented))
    sites = {e.data["site"] for e in fetched}
    print(out["table"])
    print(f"graph run OK: {n_chunks}-way fan-out across sites {sorted(sites)}"
          f" in {makespan:.2f}s")

    # --- 2: cancel mid-fan-out ------------------------------------------
    fabric2 = build_fabric(args.device)
    session2 = Session(fabric=fabric2,
                       planner=PlacementPlanner(FederatedStore(fabric2)))
    sub2 = session2.bus.subscribe(maxlen=8192)
    # max_workers=1 serializes the segment branches, so cancelling right
    # after the first one completes deterministically strands the rest
    handle = session2.apply(dataclasses.replace(spec, max_workers=1))
    ev2 = []
    while handle.state not in TERMINAL_STATES:
        for ev in sub2.poll(timeout=0.2):
            ev2.append(ev)
            if (ev.kind == "branch" and ev.data.get("of") == "segment"
                    and ev.data.get("status") == "done"):
                handle.cancel()
    handle.cancel(wait=True, timeout=600)
    ev2.extend(sub2.poll())
    assert handle.state is WorkloadState.CANCELLED, handle.state
    done_first = {e.data["branch"] for e in branch_events(
        ev2, "segment", "done")}
    assert 0 < len(done_first) < n_chunks, \
        f"cancel landed outside the fan-out: {sorted(done_first)}"
    wf_cancelled = [e for e in ev2 if e.kind == "workflow"
                    and e.data.get("status") == "cancelled"]
    assert wf_cancelled, "no workflow-level cancelled event"
    print(f"cancelled mid-fan-out with segment branches "
          f"{sorted(done_first)} of {set(range(n_chunks))} complete")

    # --- 3: resume: only the stranded branches run -----------------------
    sub3 = session2.bus.subscribe(maxlen=8192)
    out3 = session2.apply(spec).wait(timeout=600)
    ev3 = sub3.poll()
    assert out3["results"]["analyze"]["objects"] >= 1
    resumed = {e.data["branch"] for e in branch_events(
        ev3, "segment", "done")}
    skipped = {e.data["branch"] for e in branch_events(
        ev3, "segment", "skipped")}
    assert skipped == done_first, (skipped, done_first)
    assert resumed == set(range(n_chunks)) - done_first, \
        (resumed, done_first)
    print(f"resume re-ran only branches {sorted(resumed)} "
          f"(markers skipped {sorted(skipped)})")

    report = {"n_chunks": n_chunks, "makespan_s": round(makespan, 3),
              "fanout_sites": sorted(sites),
              "cancelled_after": sorted(done_first),
              "resumed": sorted(resumed)}
    print("GRAPH_REPORT " + json.dumps(report))
    print("\nOK: graph manifest ran concurrently, cancelled cleanly "
          "mid-fan-out, and resumed only the missing branches.")
    return report


if __name__ == "__main__":
    main()
