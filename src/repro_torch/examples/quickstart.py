"""Quickstart on the port: declare workloads, let the platform run them.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The twin of ``examples/quickstart.py``: a ``TrainJob`` and a ``ServeJob``
declared as manifests, applied through one ``Session`` on a one-device
cluster (the card unless ``--device cpu``), observed through the same
Handle verbs every workload kind shares.  Checks what the original
checks: the manifest round-trips, the loss falls, both workloads end
Succeeded.
"""
import argparse

from repro_torch.api import ServeJob, Session, TrainJob, from_manifest
from repro_torch.core.orchestrator import Cluster
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    session = Session(cluster=Cluster(devices=[resolve_device(args.device)]))

    print("=== train (reduced phi4-family config, declared as a manifest) ===")
    train = TrainJob(name="quickstart-train", steps=20, seq_len=64,
                     global_batch=4, log_every=5)
    manifest = train.to_manifest()          # dict/JSON: the declaration
    assert from_manifest(manifest) == train, "manifest round-trip is lossless"
    out = session.apply(manifest).wait()
    losses = out["losses"]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training should reduce loss"

    print("\n=== serve (batched requests through the work queue) ===")
    handle = session.apply(ServeJob(name="quickstart-serve", n_requests=6,
                                    prompt_len=16, max_new_tokens=8,
                                    slots=2))
    out = handle.wait()
    results, metrics = out["results"], out["metrics"]
    print(f"served {len(results)} requests; "
          f"sample generation: {results[0][:8]}")
    print(metrics.to_csv())

    print("\n=== one lifecycle stream for both workloads ===")
    for status in session.status():
        print("  " + status.brief())
    states = [s.state.value for s in session.status()]
    assert states == ["Succeeded", "Succeeded"], states
    return out


if __name__ == "__main__":
    main()
