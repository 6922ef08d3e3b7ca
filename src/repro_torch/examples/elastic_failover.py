"""Self-healing elastic training on the port (paper §V: "nodes can join
and leave the cluster at any time").

    PYTHONPATH=src python -m repro_torch.examples.elastic_failover \\
        [--fast] [--ranks] [--device cpu]

The twin of ``examples/elastic_failover.py``.  All the control lives in
the platform: a ``TrainJob`` declared through ``repro_torch.api.Session``
runs as a supervised elastic workload, and this script only injects a
churn schedule against the cluster, as an unplugged appliance would.  The
cluster holds 8 logical slots (the card unless ``--device cpu``).  With
``--ranks`` the slots are ranks, as the reference's 8 devices are: each
segment runs its mesh as one process a slot (gloo on the CPU; on a card
the slots name the host's cards in turn, so several ranks share one over
gloo) and restores the newest checkpoint onto that mesh.  Without it the
slots compute on one device, and a mesh shape is the trainer's plan over
them whose data axis sets the gradient accumulation:

  1. training starts on the (4 data, 2 model) plan over the 8 slots;
  2. two slots FAIL mid-run: the cluster drains their pod, the trainer
     restores the latest checkpoint onto the (2, 2) plan and DOUBLES the
     accumulation, so the global batch is unchanged;
  3. the slots REJOIN: the trainer preempts gracefully (checkpointing)
     and scales back up to (4, 2), the accumulation back to 1.

Checks, as the original: the run reaches its final step, every plan kept
batch x accum constant, there is a loss for every step, the loss improved
end to end, the accumulation doubled on (2, 2).  Prints a ``CHURN_REPORT
{json}`` line.
"""
import argparse
import json
import threading
import time

import torch

from repro_torch.api import Session, TrainJob
from repro_torch.core.orchestrator import Cluster
from repro_torch.device import resolve_device

SLOTS = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="shorter run (CI churn smoke)")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", action="store_true",
                    help="one process a slot on each segment's mesh")
    args = ap.parse_args(argv)
    steps = args.steps or (24 if args.fast else 45)
    fail_after = steps // 4          # churn points, in completed steps
    rejoin_after = steps // 2

    slots = [f"slot{i}" for i in range(SLOTS)]
    ranks = args.ranks
    if ranks and resolve_device(args.device).type == "cuda":
        cards = torch.cuda.device_count()
        ranks = {s: f"cuda:{i % cards}" for i, s in enumerate(slots)}
    cluster = Cluster(devices=slots, compute=args.device, ranks=ranks)
    session = Session(cluster=cluster)
    handle = session.apply(TrainJob(
        name="elastic-demo", steps=steps, seq_len=64, global_batch=16,
        base_shape=(4, 2), max_data=None,
        ckpt_every=3 if args.fast else 5, log_every=5,
        rejoin_timeout_s=120.0,
        optimizer={"lr": 1e-3, "warmup_steps": 2, "decay_steps": 200}))

    victims = cluster.devices[6:]

    def progress() -> int:
        return handle.status().observed.get("step", -1)

    def inject_churn():
        """The outside world: two slots die, then come back."""
        while progress() < fail_after:
            time.sleep(0.002)
        print(f">>> churn: unplugging {len(victims)} slots")
        for d in victims:
            cluster.fail_node(d)
        while progress() < rejoin_after:
            time.sleep(0.002)
        print(f">>> churn: {len(victims)} slots rejoin")
        for d in victims:
            cluster.join_node(d)

    churn = threading.Thread(target=inject_churn, daemon=True)
    churn.start()
    out = handle.wait(timeout=3600)
    churn.join(timeout=10)
    report = out["report"]

    # --- the §V contract, checked end to end -----------------------------
    losses = out["loss_by_step"]
    assert sorted(losses) == list(range(steps)), "missing per-step losses"
    assert report.global_batch_constant, \
        "global batch (batch x accum) changed across plans"
    shapes = [s.mesh_shape for s in report.segments]
    assert (2, 2) in shapes, f"never trained on the shrunk plan: {shapes}"
    assert shapes[-1] == (4, 2), f"never scaled back up: {shapes}"
    assert report.recoveries >= 1, "slot failure was not recovered"
    accums = {s.mesh_shape: s.accum_steps for s in report.segments}
    assert accums[(2, 2)] == 2 * accums[(4, 2)], accums
    assert out["losses"][-1] < out["losses"][0], "loss did not improve"
    assert handle.state.value == "Succeeded", handle.state

    print("CHURN_REPORT " + json.dumps(report.to_json()))
    print(f"OK: self-healed across fail({fail_after})/rejoin({rejoin_after}) "
          f"churn: {report.recoveries} recovery, "
          f"{report.steps_lost} steps lost, "
          f"{report.tokens_per_s:,.0f} tokens/s overall "
          f"(final step {steps - 1}, plan history {shapes})")
    return out


if __name__ == "__main__":
    main()
