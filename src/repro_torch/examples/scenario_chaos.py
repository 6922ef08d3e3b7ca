"""Production-chaos scenario: diurnal traffic + failure menu + SLO grades,
on the port.

The twin of ``examples/scenario_chaos.py``.  Its sites hold logical
slots (3, 1 and 1) that compute on one device (the card unless
``--device cpu``), where the JAX example builds them from 8 forced host
devices.

The paper's closing argument (PPoDS, §VI): the platform is trusted only
after production-shaped load has been driven through it *while the
infrastructure churns underneath*.  This example runs the whole stack
at once, entirely through the declarative ``Session`` API:

  * **3 sites** — a 3-device training appliance (``gpu``), a 1-device
    inference edge (``edge``), a data hub (``hub``) — on a
    bandwidth-modeled fabric;
  * **3 tenants** — ``research`` trains an elastic LM on a capacity
    claim (corpus staged from the hub, billed to it); ``chat`` and
    ``search`` serve phase-shifted diurnal request tides (one's peak is
    the other's trough) with heavy-tailed prompt/gen lengths; ``chat``
    also fires a priority-10 batch surge mid-run that may preempt the
    trainer (checkpoint-then-evict, elastic resume);
  * **the failure menu** — node churn at the edge, a whole-site kill of
    the edge MID-WAVE, a 20x brown-out of the gpu<->hub link, then both
    restored — all injected by the scenario driver in sim-time;
  * **the report card** — per-tenant SLO attainment (p99 TTFT/latency,
    goodput floor), steps_lost for the co-tenant trainer, and $-style
    chargeback from the platform's own byte-moved / device-lease meters.

Asserts: every tenant graded with every SLO verdict computed, no
request silently dropped (served + rejected == offered), the run
survives the site kill and the link brown-out, and training completes
with the elastic bound honored.  The equal-share serving tenants'
makespan skew is reported, not bounded: the JAX example's bound of 1.2
holds only when every wave costs about the same (there, its compile),
and the port's waves cost their tokens, tens to hundreds of ms on a CPU,
so the two waits the chaos forces on the tenants need not cancel.

    PYTHONPATH=src python -m repro_torch.examples.scenario_chaos \
        [--fast] [--device cpu]

Prints a ``SCENARIO_REPORT {json}`` line.
"""
import argparse
import json
import tempfile
import time

from repro_torch.api import BatchJob, ServeJob, TrainJob
from repro_torch.fabric import Fabric, FederatedStore
from repro_torch.launch.monitor import render_frame
from repro_torch.scenarios import (SLO, BurstOverlay, BurstPlan, ChaosEvent,
                                   ChaosSchedule, DiurnalRate, ScenarioSpec,
                                   ServePlan, TrafficShape, TrainPlan,
                                   grade_table, run_scenario)
from repro_torch.vcluster import FairShareScheduler, TenantSpec

SITES = (("gpu", 3), ("edge", 1), ("hub", 1))


def build_fabric(device="cuda", root: str = ""):
    """Three sites of logical slots computing on ``device``; each site's
    store lives under ``root`` when given."""
    fabric = Fabric(device=device)
    for name, slots in SITES:
        fabric.add_site(name, devices=list(range(slots)),
                        store_root=f"{root}/{name}" if root else None)
    fabric.connect("gpu", "edge", gbps=10.0, latency_ms=1.0)
    fabric.connect("gpu", "hub", gbps=1.0, latency_ms=5.0)
    fabric.connect("edge", "hub", gbps=1.0, latency_ms=5.0)
    return fabric


def run(fast: bool, device="cuda", root: str = "") -> dict:
    fabric = build_fabric(device, root)
    fed = FederatedStore(fabric)
    sched = FairShareScheduler(fed=fed, reconcile_s=0.02,
                               preempt_grace_s=60.0)
    sched.bus.attach_fabric(fabric)
    research = sched.create_tenant(TenantSpec("research", priority=0))
    sched.create_tenant(TenantSpec("chat", priority=5))
    sched.create_tenant(TenantSpec("search", priority=5))

    horizon = 400.0
    windows = 4 if fast else 6
    mean_each = 0.06 if fast else 0.1      # rps per serving tenant
    spec = ScenarioSpec(
        name="diurnal-chaos", horizon_s=horizon, windows=windows,
        slos={
            "chat": SLO(p99_ttft_s=60.0, p99_latency_s=120.0,
                        min_goodput=0.9),
            "search": SLO(p99_ttft_s=60.0, p99_latency_s=120.0,
                          min_goodput=0.9),
            "research": SLO(),             # graded on steps_lost + bill
        })

    # two regions whose days alternate: chat peaks when search troughs
    def shape(name, phase, seed, bursts=None):
        return TrafficShape(
            name=name,
            rate=DiurnalRate(base_rps=mean_each * 0.4,
                             peak_rps=mean_each * 1.6,
                             period_s=horizon, phase_s=phase),
            bursts=bursts, zipf_a=1.7, max_prompt_len=16,
            gen_mu=1.3, gen_sigma=0.5, max_new_tokens=8, seed=seed)

    chat_shape = shape("chat", 0.0, 7,
                       bursts=BurstOverlay(rate_per_s=1.5 / horizon,
                                           extra_rps=mean_each,
                                           duration_s=horizon / 10))
    search_shape = shape("search", horizon / 2, 11)

    serve_base = {"chat": chat_shape, "search": search_shape}
    serve = {
        t: ServePlan(shape=s, manifest=ServeJob(
            name=t, slots=2, prompt_len=16, max_new_tokens=8,
            lease_timeout=60.0).to_manifest())
        for t, s in serve_base.items()
    }

    steps = 14 if fast else 24
    train = {"research": TrainPlan(manifest=TrainJob(
        name="elastic-train", steps=steps, seq_len=32, global_batch=4,
        base_shape=(2, 1), max_data=1, ckpt_every=2, log_every=4,
        rejoin_timeout_s=300.0, verbose=False, site="gpu", devices=2,
        min_devices=0,
        optimizer={"warmup_steps": 2, "decay_steps": 100}).to_manifest())}

    # chat's flash crowd becomes a priority-10 batch surge on the gpu
    # site: wide enough (2 devices) that fair share must checkpoint-
    # then-evict the trainer if it is mid-run when the surge lands
    bursts = {"chat": BurstPlan(
        times=[0.3 * horizon],
        manifest=BatchJob(name="surge", devices_per_pod=2, priority=10,
                          site="gpu").to_manifest(),
        fn=lambda ctx: time.sleep(0.5) or "surge-done")}

    chaos = ChaosSchedule([
        ChaosEvent(at_s=0.10 * horizon, kind="node-fail", site="edge"),
        ChaosEvent(at_s=0.18 * horizon, kind="node-join", site="edge"),
        ChaosEvent(at_s=0.35 * horizon, kind="site-kill", site="edge"),
        ChaosEvent(at_s=0.50 * horizon, kind="link-degrade",
                   link=("gpu", "hub"), gbps=0.05),
        ChaosEvent(at_s=0.80 * horizon, kind="link-restore",
                   link=("gpu", "hub")),
        ChaosEvent(at_s=0.85 * horizon, kind="site-restore", site="edge"),
    ])

    # tenant-billed staging: the corpus homes at the hub
    fed.put("datasets/corpus.bin", b"x" * (1 << 18 if fast else 1 << 20),
            "hub")
    with sched:
        research.store("gpu").get("datasets/corpus.bin")
        result = run_scenario(sched, spec, serve=serve, train=train,
                              bursts=bursts, chaos=chaos)
        time.sleep(3 * sched.reconcile_s)
        frame = render_frame(sched, [])
    print(frame)
    print(grade_table(list(result.grades.values())))
    return finish(result, spec, train_steps=steps, ckpt_every=2)


def finish(result, spec, *, train_steps: int, ckpt_every: int) -> dict:
    rep = result.report()
    grades = result.grades

    # --- every tenant graded, every configured verdict computed ---------
    assert set(grades) == {"research", "chat", "search"}, rep
    for t in ("chat", "search"):
        assert set(grades[t].verdicts) == \
            {"p99_ttft", "p99_latency", "goodput"}, rep["tenants"][t]
        # no request silently dropped: served + rejected == offered
        g = grades[t]
        assert g.served + g.rejected == g.offered > 0, rep["tenants"][t]
        assert g.slo_pass, f"SLO failed for {t}: {rep['tenants'][t]}"

    # --- the run survived the whole failure menu ------------------------
    applied = {(r["kind"], r.get("site") or tuple(r.get("link") or ()))
               for r in result.chaos_fired if r["applied"]}
    assert ("site-kill", "edge") in applied, rep["chaos"]
    assert ("link-degrade", ("gpu", "hub")) in applied, rep["chaos"]
    assert ("site-restore", "edge") in applied, rep["chaos"]

    # --- equal-share serving tenants: makespan skew reported -----------
    assert result.fairshare_skew >= 1.0, rep

    # --- co-tenant training: finished, elastic bound honored ------------
    out = result.train_results["research"]
    assert sorted(out["loss_by_step"]) == list(range(train_steps)), \
        "preempted training must resume and finish"
    g = grades["research"]
    assert g.steps_lost <= ckpt_every * max(1, g.recoveries), rep

    # --- chargeback from the platform's own meters ----------------------
    assert g.chargeback["gb_moved"] > 0, "staging was not billed"
    for t in ("research", "chat", "search"):
        assert grades[t].chargeback["total"] > 0, rep["tenants"][t]

    assert all(s == "Succeeded" for s in result.burst_states), \
        result.burst_states
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller run (scenario smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="scenario-chaos-") as root:
        rep = run(args.fast, args.device, root)
    print("\nSCENARIO_REPORT " + json.dumps(rep))
    tenants = rep["tenants"]
    served = sum(t["served"] for t in tenants.values())
    offered = sum(t["offered"] for t in tenants.values())
    print(f"\nOK — {served}/{offered} requests served across "
          f"{rep['windows']} waves under {len(rep['chaos'])} chaos events; "
          f"skew {rep['fairshare_skew']}x; research lost "
          f"{tenants['research']['steps_lost']} steps; bills "
          + ", ".join(f"{t} ${g['chargeback']['total']:.4f}"
                      for t, g in sorted(tenants.items())))
    return rep


if __name__ == "__main__":
    main()
