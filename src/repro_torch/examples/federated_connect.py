"""The CONNECT pipeline across a 3-site federation (paper §I, §IV), on
the port.

The twin of ``examples/federated_connect.py``: a ``WorkflowRun`` applied
to a ``Session(fabric=..., planner=...)`` over three unequal sites (a
4-slot hub, a 2-slot and a 1-slot spoke; 10 Gbps in the core, 1 Gbps to
the edge), all computing on one device (the card unless ``--device cpu``):

  1. locality-aware placement: each step lands on the site that
     minimizes  bytes_to_move / link_bw + queue_depth  — the per-step
     Table-I report gains `Site`, `bytes_moved`, `transfer_s` columns;
  2. data-blind placement (round-robin) serves identical results but
     drags chunks across the 1 Gbps links — asserted to move MORE bytes;
  3. a whole-site kill after the download step: the planner routes the
     remaining steps around the dead appliance (raw chunks survive via
     their one off-site replica), the workflow completes on the
     survivors, and the migrated step is recorded in its report.

    PYTHONPATH=src python -m repro_torch.examples.federated_connect \\
        [--fast] [--device cpu]

Prints a ``FABRIC_REPORT {json}`` line.
"""
import argparse
import json
import time

from repro_torch.api import Session, WorkflowRun
from repro_torch.apps.connect.pipeline import ConnectConfig, add_connect_steps
from repro_torch.data.volumes import VolumeSpec
from repro_torch.fabric import Fabric, FederatedStore, PlacementPlanner
from repro_torch.models.ffn3d import FFNConfig


SITES = (("sdsc", 4), ("calit2", 2), ("edge", 1))


def build_fabric(time_scale: float, device="cuda", root: str = "") -> Fabric:
    """Three unequal PRP-ish sites: a big hub and two smaller spokes,
    10 Gbps in the core, 1 Gbps to the edge.  Each site's store lives
    under ``root`` when given, else in a new temporary directory."""
    fabric = Fabric(time_scale=time_scale, device=device)
    for name, slots in SITES:
        fabric.add_site(name, devices=list(range(slots)),
                        store_root=f"{root}/{name}" if root else None)
    fabric.connect("sdsc", "calit2", gbps=10.0, latency_ms=3.0)
    fabric.connect("sdsc", "edge", gbps=1.0, latency_ms=12.0)
    fabric.connect("calit2", "edge", gbps=1.0, latency_ms=12.0)
    return fabric


def run_once(cc: ConnectConfig, *, data_blind: bool, kill_site: str = "",
             time_scale: float = 0.0, device="cuda", root: str = ""):
    fabric = build_fabric(time_scale, device, root)
    planner = PlacementPlanner(FederatedStore(fabric), data_blind=data_blind)
    session = Session(fabric=fabric, planner=planner)

    def run(only=""):
        spec = WorkflowRun(name="connect", namespace="atmos-science",
                           only=only or None,
                           define=lambda wf: add_connect_steps(wf, cc))
        return session.apply(spec).wait(timeout=3600)

    t0 = time.perf_counter()
    if kill_site:
        run(only="download")           # chunks scattered + 1 replica each
        print(f">>> site {kill_site!r} unplugged (whole appliance)")
        fabric.fail_site(kill_site)
        out = run()                    # resume: download skipped, rest placed
    else:
        out = run()
    makespan = time.perf_counter() - t0
    reports = out["reports"]
    stats = {
        "planner": "blind" if data_blind else "locality",
        "bytes_moved": int(fabric.metrics.series("fabric/bytes_moved").total),
        "transfer_s": round(fabric.metrics.series("fabric/transfer_s").total, 4),
        "makespan_s": round(makespan, 3),
        "sites": {r.step: r.site for r in reports},
        "migrated": [r.step for r in reports if "migrated" in r.extra],
    }
    return fabric, out, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller volumes (fabric smoke)")
    ap.add_argument("--time-scale", type=float, default=0.02,
                    help="real seconds slept per simulated transfer second")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cc = ConnectConfig(
        n_chunks=3, download_workers=3, inference_workers=2,
        vol=VolumeSpec(lat=32, lon=48, frames=8, events=2) if args.fast
        else VolumeSpec(lat=48, lon=72, frames=16, events=2),
        ffn=FFNConfig(depth=3, width=12, fov=(8, 16, 16), flood_iters=2),
        train_steps=10 if args.fast else 30)
    kw = dict(time_scale=args.time_scale, device=args.device)

    # --- 1+2: locality-aware vs data-blind on identical inputs -----------
    _, out_loc, loc = run_once(cc, data_blind=False, **kw)
    _, out_bld, bld = run_once(cc, data_blind=True, **kw)
    res_loc, res_bld = out_loc["results"], out_bld["results"]
    assert res_bld["analyze"]["objects"] == res_loc["analyze"]["objects"], \
        "placement must not change results"
    assert loc["bytes_moved"] < bld["bytes_moved"], \
        f"locality planner must move fewer bytes: {loc} vs {bld}"
    assert loc["transfer_s"] <= bld["transfer_s"]

    # --- 3: whole-site failure after download ----------------------------
    # chunk 0 (the training input) homes at the hub; kill the hub
    fabric_kill, out_kill, kill = run_once(cc, data_blind=False,
                                           kill_site="sdsc", **kw)
    res_kill = out_kill["results"]
    assert res_kill["analyze"]["objects"] >= 1, "workflow must complete"
    post_kill = [r for r in out_kill["reports"] if r.step != "download"]
    assert post_kill and all(r.site != "sdsc" for r in post_kill), \
        f"steps ran on a dead site: {[(r.step, r.site) for r in post_kill]}"
    assert kill["migrated"], "site kill must be recorded as a migration"
    skipped = fabric_kill.metrics.series("workflow/connect/download/skipped")
    assert skipped.points, "download must resume, not rerun, after the kill"

    print("\n--- locality-aware (Table I with Site / bytes_moved rows) ---")
    print(out_loc["table"])
    print("\n--- after killing 'sdsc' mid-workflow ---")
    print(out_kill["table"])
    print("\nFABRIC_REPORT " + json.dumps(
        {"locality": loc, "blind": bld, "site_kill": kill}))
    saved = bld["bytes_moved"] - loc["bytes_moved"]
    print(f"\nOK — locality placement moved {loc['bytes_moved']:,}B vs "
          f"{bld['bytes_moved']:,}B data-blind (saved {saved:,}B, "
          f"{bld['transfer_s'] - loc['transfer_s']:.2f} simulated link-s); "
          f"site-kill migrated {kill['migrated']} and still finished "
          f"({res_kill['analyze']['objects']} objects).")
    return {"locality": loc, "blind": bld, "site_kill": kill}


if __name__ == "__main__":
    main()
