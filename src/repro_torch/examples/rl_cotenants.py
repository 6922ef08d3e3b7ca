"""Distributed RL as fair-share co-tenants (paper §I, §IV, §VI), on the
port.

The twin of ``examples/rl_cotenants.py``: the same fleet, learner and
chaos over sites of logical slots that compute on one device (the card
unless ``--device cpu``).  Two differences, both because the port's
learner can take all its steps before an actor is caught holding a
lease: the burst that preempts the learner fires from its own thread
once the learner has taken 2 steps (the JAX example fires it only after
the actor kill and the resize), and the fleet is torn down only once the
survivors have re-leased every ticket the killed actor held (the JAX
example's learner outlasts that by itself).

The first workload that exercises every plane of the repro at once: a
serving-plane **actor fleet** (continuous-batching engines, paged KV)
generates rollouts against the latest policy, a training-plane
**learner** takes fused policy-gradient steps on the chunked-scan hot
loop, and the two planes meet only through platform primitives — a
lease-heartbeat rollout queue and a versioned policy store over the
federated fabric (every weight pull is a metered cross-link transfer
billed to the pulling tenant).

Chaos is injected mid-run and the platform contracts must hold:

  1. **actor kill, zero loss** — one actor is killed while it provably
     holds ticket leases; its engine nacks them back to the shared
     queue and the survivors finish them (requeued attempts > 1);
  2. **elastic fleet width** — the fleet resizes 2 -> 3 through
     ``resize_claim`` on the actor tenant's capacity claim;
  3. **learner preemption** — a high-priority burst tenant
     checkpoint-evicts the learner pod; the fair-share scheduler
     requeues the whole job and the next placement restores from the
     goodbye checkpoint (zero lost steps);
  4. **learner crash** — an injected hard failure (no goodbye save)
     respawns via pod backoff and restores from the latest *periodic*
     checkpoint: ``steps_lost <= ckpt_every``;
  5. **bounded staleness** — zero trained-on rollouts exceed
     ``max_policy_lag`` weight versions; stale ones are dropped and
     metered separately; every surviving actor observes >= 1 weight
     version bump through the federated store.

    PYTHONPATH=src python -m repro_torch.examples.rl_cotenants \
        [--fast] [--device cpu]

Prints an ``RL_REPORT {json}`` line.
"""
import argparse
import json
import tempfile
import threading
import time

import numpy as np

from repro_torch.api import RLJob
from repro_torch.api.runners import build_rl_engine, rl_pieces
from repro_torch.core.metrics import Registry
from repro_torch.core.orchestrator import JobSpec
from repro_torch.fabric import Fabric, FederatedStore
from repro_torch.rl import (ActorFleet, PolicyStore, RLLearner,
                            RLLearnerSpec, RolloutActor, RolloutQueue,
                            ticket_queue)
from repro_torch.vcluster import FairShareScheduler, TenantSpec


def requeued_tickets(tickets) -> int:
    """Tickets leased more than once: a killed actor's, re-leased by a
    survivor."""
    return sum(1 for _, _, attempts, _, _ in tickets.snapshot()["tasks"]
               if attempts > 1)


def run_scenario(fast: bool, device="cuda", root: str = "") -> dict:
    """The whole co-tenant run; each site's store lives under ``root``
    when given."""
    steps = 6 if fast else 8
    # the declarative carrier: the same resource a Session would apply —
    # here we drive the repro.rl primitives directly so the chaos hooks
    # (kill / resize / burst) can reach into the run
    job = RLJob(name="rl-cotenants", learner_steps=steps, actors=2,
                rollouts_per_step=2, prompt_len=8, max_new_tokens=8,
                seq_len=24, slots=2, max_policy_lag=2, broadcast_every=2,
                ckpt_every=2, fail_at=steps - 2, site="serve",
                learner_site="train")

    fabric = Fabric(device=device)
    sr = (lambda name: f"{root}/{name}") if root else (lambda name: None)
    fabric.add_site("serve", devices=list(range(4)),   # actor appliance
                    store_root=sr("serve"))
    fabric.add_site("train", devices=[0],              # learner appliance
                    store_root=sr("train"))
    fabric.connect("serve", "train", gbps=10.0, latency_ms=1.0)
    fed = FederatedStore(fabric)
    sched = FairShareScheduler(fed=fed, reconcile_s=0.02,
                               preempt_grace_s=60.0)
    actor_t = sched.create_tenant(TenantSpec("actors", priority=0))
    learner_t = sched.create_tenant(TenantSpec("learner", priority=0))
    burst_t = sched.create_tenant(TenantSpec("burst", priority=10,
                                             preemptible=False))

    metrics = Registry()
    dev = fabric.sites["serve"].cluster.compute_device
    cfg, par, ocfg = rl_pieces(job)
    tickets = ticket_queue(lease_timeout=job.lease_timeout)
    rollouts = RolloutQueue(lease_timeout=job.lease_timeout,
                            registry=metrics)
    # the learner publishes into ITS site's tenant-billed store view;
    # actors subscribe through THEIRS — each pull-on-bump crosses the
    # serve<->train link and is metered against the pulling tenant
    publish = PolicyStore(learner_t.store("train"), registry=metrics)
    subscribe = PolicyStore(actor_t.store("serve"), registry=metrics)
    prompts = {}

    def make_actor(name):
        return RolloutActor(name, build_rl_engine(job, cfg, device=dev),
                            tickets, rollouts, subscribe, prompts=prompts,
                            registry=metrics)

    claim = actor_t.claim("serve", job.actors, min_devices=1)
    fleet = ActorFleet(make_actor, width=job.actors,
                       capacity=lambda w: sched.resize_claim(claim, w),
                       registry=metrics, name="actor")
    spec = RLLearnerSpec(cfg, par, ocfg, steps=steps, seq_len=job.seq_len,
                         batch=job.rollouts_per_step,
                         ckpt_every=job.ckpt_every,
                         broadcast_every=job.broadcast_every,
                         max_policy_lag=job.max_policy_lag,
                         fail_at=job.fail_at,
                         device=fabric.sites["train"].cluster.compute_device)
    learner = RLLearner(spec, rollouts, publish,
                        store=learner_t.store("train"), registry=metrics)

    # ---------------------------------------------------- ticket feeder
    rng = np.random.default_rng(101)
    stop_feed = threading.Event()
    burst = max(job.rollouts_per_step, 3 * job.slots)
    backlog_cap = 2 * job.rollouts_per_step

    def feed():
        n = 0
        while not stop_feed.is_set():
            if (tickets.pending > 0 or tickets.leased > 0
                    or rollouts.pending >= backlog_cap):
                time.sleep(2e-3)
                continue
            for _ in range(burst):
                rid = f"t{n:05d}"
                n += 1
                prompt = [int(x) for x in rng.integers(
                    1, cfg.vocab_size, size=job.prompt_len)]
                prompts[rid] = prompt
                tickets.put({"id": rid, "prompt": prompt,
                             "max_new_tokens": job.max_new_tokens})

    # ------------------------------------------------- chaos controller
    chaos = {"held_at_kill": 0, "width_after_kill": 0, "granted": 0}

    def controller():
        # (1) kill actor-0 at a moment it PROVABLY holds ticket leases:
        # the engine's stop path nacks them back for the survivors
        while learner.report.steps_done < 1:
            time.sleep(5e-3)
        while tickets.leased_by("actor-0") == 0:
            time.sleep(1e-3)
        chaos["held_at_kill"] = tickets.leased_by("actor-0")
        fleet.kill("actor-0")
        chaos["width_after_kill"] = fleet.width
        # (2) regrow wider than before through the fair-share claim
        chaos["granted"] = fleet.resize(3)

    def burster():
        # (3) burst tenant forces checkpoint-then-evict of the learner
        while learner.report.steps_done < 2:
            time.sleep(5e-3)
        bj = burst_t.submit(JobSpec("burst", lambda ctx: time.sleep(0.3)
                                    or "hi", devices_per_pod=1),
                            site="train")
        bj.wait(120)

    # ------------------------------------------ the learner tenant pod
    # one resumable segment per placement: preemption goodbye-saves and
    # the scheduler requeues the WHOLE job (next placement restores);
    # the injected hard crash propagates and pod backoff respawns it
    def learner_pod(ctx):
        return learner.run(ctx.should_stop)

    t0 = time.monotonic()
    feeder = threading.Thread(target=feed, daemon=True)
    ctrl = threading.Thread(target=controller, daemon=True)
    burst_th = threading.Thread(target=burster, daemon=True)
    with sched:
        fleet.start()
        feeder.start()
        ctrl.start()
        burst_th.start()
        tj = learner_t.submit(JobSpec("rl-learner", learner_pod,
                                      devices_per_pod=1, backoff_limit=3),
                              site="train")
        tj.wait(600)
        ctrl.join(timeout=120)
        burst_th.join(timeout=120)
        # the survivors finish the killed actor's tickets before teardown
        deadline = time.monotonic() + 30.0
        while requeued_tickets(tickets) < chaos["held_at_kill"] and \
                time.monotonic() < deadline:
            time.sleep(5e-3)
        # let the (now idle) actors observe the final published version
        deadline = time.monotonic() + 10.0
        while fleet.min_syncs() < 1 and time.monotonic() < deadline:
            time.sleep(5e-3)
        min_syncs = fleet.min_syncs()
        stop_feed.set()
        fleet.stop_all()
        feeder.join(timeout=10)
    wall = time.monotonic() - t0
    claim.release()

    # the checkpoint extra carries the rollout-queue snapshot; the same
    # snapshot/restore round-trip rebuilds the buffer with its audit
    # trail intact (lease state intentionally does not survive)
    clone = RolloutQueue()
    clone.restore(rollouts.snapshot())
    assert clone.trained == rollouts.trained
    assert clone.pending == rollouts.pending
    assert clone.stale_dropped == rollouts.stale_dropped

    rep = learner.report
    requeued = requeued_tickets(tickets)
    tok_total = metrics.series("rl/rollout_tokens").total
    lag_series = metrics.series("rl/policy_lag")
    return {
        "steps": steps,
        "steps_done": rep.steps_done,
        "steps_lost": rep.steps_lost,
        "ckpt_every": job.ckpt_every,
        "outcomes": [s["outcome"] for s in rep.segments],
        "preemptions": rep.preemptions,
        "crashes": sum(1 for s in rep.segments
                       if s["outcome"] == "failed"),
        "job_preemptions": tj.preemptions,
        "publishes": rep.publishes,
        "final_version": rep.final_version,
        "trained": rollouts.trained,
        "stale_dropped": rollouts.stale_dropped,
        "max_lag_trained": rollouts.max_lag_trained(),
        "policy_lag_p99": lag_series.percentile(99),
        "rollouts_pushed": rollouts.pushed,
        "rollout_tokens": int(tok_total),
        "rollout_tok_s": round(tok_total / wall, 2),
        "learner_steps_s": round(rep.steps_done / wall, 3),
        "held_at_kill": chaos["held_at_kill"],
        "width_after_kill": chaos["width_after_kill"],
        "granted_after_resize": chaos["granted"],
        "requeued_tickets": requeued,
        "dead_tickets": len(tickets.dead),
        "min_actor_syncs": min_syncs,
        "weight_syncs": int(metrics.series("rl/weight_syncs").total),
        "weight_bytes_pulled": int(fabric.metrics.series(
            "fabric/tenant/actors/bytes_moved").total),
        "wall_s": round(wall, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller run (smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="rl-cotenants-") as root:
        out = run_scenario(args.fast, args.device, root)

    # --- 1: actor kill loses no trajectories ----------------------------
    assert out["held_at_kill"] >= 1, out
    assert out["requeued_tickets"] >= 1, \
        f"killed actor's leases must requeue: {out}"
    assert out["dead_tickets"] == 0, out
    # --- 2: elastic fleet width through the fair-share claim ------------
    assert out["width_after_kill"] == 1 and \
        out["granted_after_resize"] == 3, out
    # --- 3+4: learner survives one preemption and one hard crash --------
    assert out["steps_done"] == out["steps"], out
    assert out["preemptions"] >= 1 and "preempted" in out["outcomes"], out
    assert out["crashes"] == 1 and "failed" in out["outcomes"], out
    assert out["steps_lost"] <= out["ckpt_every"], \
        f"crash resume lost more than the checkpoint bound: {out}"
    # --- 5: bounded staleness + observed broadcast ----------------------
    assert out["max_lag_trained"] <= 2, \
        f"trained on a rollout beyond max_policy_lag: {out}"
    assert out["min_actor_syncs"] >= 1, out
    assert out["weight_bytes_pulled"] > 0, out

    print("\nRL_REPORT " + json.dumps(out))
    print(f"\nOK — {out['steps_done']}/{out['steps']} learner steps "
          f"through {out['preemptions']} preemption(s) + "
          f"{out['crashes']} crash(es) (lost {out['steps_lost']} <= "
          f"ckpt_every {out['ckpt_every']}); killed an actor holding "
          f"{out['held_at_kill']} lease(s), {out['requeued_tickets']} "
          f"ticket(s) requeued, fleet regrown to "
          f"{out['granted_after_resize']}; trained {out['trained']} "
          f"rollouts at max lag {out['max_lag_trained']} "
          f"(dropped {out['stale_dropped']} stale), "
          f"{out['rollout_tok_s']} rollout tok/s, "
          f"{out['weight_bytes_pulled']} weight bytes over the fabric.")
    return out


if __name__ == "__main__":
    main()
