"""The paper's CONNECT case study (§III) end to end on the port: download
-> FFN train -> distributed flood-fill inference -> CONNECT object
analysis, as a measured, resumable 4-step workflow declared through the
unified API.  Prints the paper's Table I for this run.

    PYTHONPATH=src python -m repro_torch.examples.connect_workflow \\
        [--full] [--device cpu] [--root DIR]

The twin of ``examples/connect_workflow.py``: the ``WorkflowRun`` names
the ``repro_torch.apps.connect.pipeline:add_connect_steps`` entrypoint and
sizes the run through plain-JSON ``params``.  --full uses the
paper-shaped grid (361x576, 24 frames) and the default FFN (depth 8,
width 32); the default is a reduced grid.  The run computes on the card
unless ``--device cpu`` is given.  Run it twice with the same --root to
see workflow-level resume (all steps skip).
"""
import argparse
import tempfile

from repro_torch.api import Session, WorkflowRun
from repro_torch.core.orchestrator import Cluster
from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device

FULL = dict(n_chunks=4, download_workers=4, inference_workers=4,
            vol=dict(lat=361, lon=576, frames=24), train_steps=120)
REDUCED = dict(n_chunks=2, download_workers=2, inference_workers=2,
               vol=dict(lat=48, lon=72, frames=16, events=2),
               ffn=dict(depth=3, width=12, fov=(8, 16, 16), flood_iters=3),
               train_steps=30, train_batch=4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="connect-")
    params = FULL if args.full else REDUCED

    session = Session(cluster=Cluster(devices=[resolve_device(args.device)]),
                      store=ObjectStore(root))
    out = session.apply(WorkflowRun(
        name="connect", namespace="atmos-science",
        entrypoint="repro_torch.apps.connect.pipeline:add_connect_steps",
        params=params)).wait(timeout=3600)
    results = out["results"]
    print(f"\nworkflow state in {root}")
    for step, res in results.items():
        print(f"  {step}: {res}")
    print("\n" + out["table"])
    tr = results["train"]
    assert tr["last_loss"] < tr["first_loss"], "FFN training must improve"
    assert results["analyze"]["objects"] >= 1, "CONNECT should find objects"
    print("\nOK — objects tracked through time+space:",
          results["analyze"]["objects"])
    return out


if __name__ == "__main__":
    main()
