"""The port's production-chaos scenario harness
(``repro_torch.scenarios``) against the JAX package's ``repro.scenarios``.

Every case of ``tests/test_scenarios.py`` runs against the port with the
same assertions: traffic-generator determinism, chaos-schedule
validation, SLO grading, and the end-to-end chaos regression (site kill
+ link brown-out mid-run, graded tenants) through ``Session(tenant=)``
on a fabric computing on ``device="cpu"``.

Across the stacks: for fixed seeds the traces equal JAX's element for
element, ``ChaosSchedule`` rejects the same schedules with the same
messages, and ``grade_tenant`` / ``chargeback`` give equal outputs on
equal inputs.  The end-to-end case runs the scheduler, pods, engines and
a trainer in threads, so torch is pinned to two threads a team here.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as jsc                               # noqa: E402

from repro_torch import scenarios as jsc_port                    # noqa: E402
from repro_torch.scenarios import (SLO, BurstOverlay,            # noqa: E402
                                   ChaosEvent, ChaosInjector, ChaosSchedule,
                                   DiurnalRate, Price, ScenarioSpec,
                                   ServePlan, TrafficShape, TrainPlan,
                                   chargeback, grade_table, grade_tenant,
                                   run_scenario, slice_window)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:              # optional dev dependency
    HAVE_HYPOTHESIS = False


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Pods, trainers and engines run in threads, each of which starts an
    OpenMP team of every core for torch's CPU ops; with several test
    workers those teams spin against each other.  Two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------- traffic generators

def check_same_seed_same_trace(shape):
    """The replay contract: one seed == one trace, bit for bit — arrivals,
    lengths and the fully rendered request list."""
    horizon = shape.rate.period_s
    a1, a2 = shape.arrivals(horizon), shape.arrivals(horizon)
    assert np.array_equal(a1, a2)
    assert np.array_equal(shape.prompt_lengths(64), shape.prompt_lengths(64))
    assert np.array_equal(shape.gen_lengths(64), shape.gen_lengths(64))
    r1 = shape.requests(horizon, vocab_size=128)
    r2 = shape.requests(horizon, vocab_size=128)
    assert r1 == r2


def check_arrival_count_tracks_mean_rate(shape):
    """Over one full diurnal period the Poisson count concentrates around
    mean_rps * period (6-sigma + slack tolerance, so it never flakes)."""
    horizon = shape.rate.period_s
    arrivals = shape.arrivals(horizon)
    assert all(0.0 <= t < horizon for t in arrivals)
    assert list(arrivals) == sorted(arrivals)
    expected = shape.mean_rps() * horizon
    tol = 6.0 * np.sqrt(expected) + 10.0
    assert abs(len(arrivals) - expected) <= tol, \
        f"{len(arrivals)} arrivals vs expected {expected:.1f} (tol {tol:.1f})"


def check_lengths_always_in_bounds(shape, n):
    """Heavy tails are clamped: Zipf prompts in [1, max_prompt_len],
    lognormal gen lengths in [1, max_new_tokens] — never 0, never over."""
    p = shape.prompt_lengths(n)
    g = shape.gen_lengths(n)
    assert p.min() >= 1 and p.max() <= shape.max_prompt_len
    assert g.min() >= 1 and g.max() <= shape.max_new_tokens
    for r in shape.requests(shape.rate.period_s, vocab_size=64):
        assert 1 <= len(r["prompt"]) <= shape.max_prompt_len
        assert 1 <= r["max_new_tokens"] <= shape.max_new_tokens
        assert all(0 <= tok < 64 for tok in r["prompt"])


def fixed_shape(seed=0, max_prompt_len=24, max_new_tokens=12):
    """Deterministic fallback when hypothesis is absent: still exercises
    every traffic invariant, just on fixed parameters."""
    return TrafficShape(
        name="t",
        rate=DiurnalRate(base_rps=0.8, peak_rps=3.2, period_s=120.0,
                         phase_s=30.0),
        zipf_a=1.6, max_prompt_len=max_prompt_len,
        max_new_tokens=max_new_tokens, seed=seed)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_traffic_invariants_fixed_seeds(seed):
    shape = fixed_shape(seed=seed)
    check_same_seed_same_trace(shape)
    check_arrival_count_tracks_mean_rate(shape)
    check_lengths_always_in_bounds(shape, 256)


def test_different_seed_different_trace():
    a = fixed_shape(seed=1).arrivals(120.0)
    b = fixed_shape(seed=2).arrivals(120.0)
    assert not np.array_equal(a, b)


if HAVE_HYPOTHESIS:
    @st.composite
    def shapes(draw):
        """Burst-free diurnal shapes with rates high enough that the
        mean-count property has statistical teeth."""
        base = draw(st.floats(min_value=0.5, max_value=5.0))
        peak = draw(st.floats(min_value=0.5, max_value=5.0))
        period = draw(st.floats(min_value=50.0, max_value=200.0))
        return TrafficShape(
            name="t",
            rate=DiurnalRate(base_rps=min(base, peak),
                             peak_rps=max(base, peak),
                             period_s=period,
                             phase_s=draw(st.floats(min_value=0.0,
                                                    max_value=period))),
            zipf_a=draw(st.floats(min_value=1.2, max_value=3.0)),
            max_prompt_len=draw(st.integers(min_value=1, max_value=64)),
            max_new_tokens=draw(st.integers(min_value=1, max_value=64)),
            seed=draw(st.integers(min_value=0, max_value=2**20)))

    @settings(max_examples=60, deadline=None)
    @given(shape=shapes())
    def test_same_seed_same_trace(shape):
        check_same_seed_same_trace(shape)

    @settings(max_examples=60, deadline=None)
    @given(shape=shapes())
    def test_arrival_count_tracks_mean_rate(shape):
        check_arrival_count_tracks_mean_rate(shape)

    @settings(max_examples=60, deadline=None)
    @given(shape=shapes(), n=st.integers(min_value=1, max_value=256))
    def test_lengths_always_in_bounds(shape, n):
        check_lengths_always_in_bounds(shape, n)


def test_burst_overlay_raises_mean_rate():
    base = DiurnalRate(base_rps=1.0, peak_rps=1.0, period_s=100.0)
    quiet = TrafficShape(name="q", rate=base, seed=3)
    bursty = TrafficShape(name="b", rate=base, seed=3,
                          bursts=BurstOverlay(rate_per_s=0.05, extra_rps=4.0,
                                              duration_s=10.0))
    assert bursty.mean_rps() > quiet.mean_rps()
    assert bursty.max_rps() >= quiet.max_rps() + 4.0


def test_slice_window_partitions_trace():
    shape = TrafficShape(
        name="w", rate=DiurnalRate(base_rps=2.0, peak_rps=2.0,
                                   period_s=60.0), seed=1)
    reqs = shape.requests(60.0, vocab_size=32)
    parts = [slice_window(reqs, w * 20.0, (w + 1) * 20.0) for w in range(3)]
    assert sum(len(p) for p in parts) == len(reqs)
    assert [r["id"] for p in parts for r in p] == [r["id"] for r in reqs]


# ------------------------------------------------------- chaos validation

def check_alternating_failures_validate(events):
    sched = ChaosSchedule(events)
    assert len(sched.events) == len(events)
    # ...and injecting a second failure inside any open window is rejected
    kill = next(e for e in sched.events if e.kind == "site-kill")
    dup = ChaosEvent(at_s=kill.at_s + 0.5, kind="site-kill", site=kill.site)
    with pytest.raises(ValueError, match="overlapping"):
        ChaosSchedule(events + [dup])
    # ...unless overlap is explicitly permitted
    ChaosSchedule(events + [dup], allow_overlap=True)


def test_sequential_failures_validate():
    """kill -> restore -> kill again on one site is a well-formed
    schedule; a second kill inside the open window is not."""
    events = []
    for site, t0 in (("s0", 0.0), ("s1", 5.5)):
        for k in range(3):
            events.append(ChaosEvent(at_s=t0 + 2 * k, kind="site-kill",
                                     site=site))
            events.append(ChaosEvent(at_s=t0 + 2 * k + 1,
                                     kind="site-restore", site=site))
    check_alternating_failures_validate(events)


if HAVE_HYPOTHESIS:
    @st.composite
    def alternating_schedules(draw):
        """Well-formed schedules: per target, strictly alternating
        fail -> restore pairs (any number, any start time)."""
        events = []
        for i in range(draw(st.integers(min_value=1, max_value=3))):
            site = f"s{i}"
            t0 = draw(st.floats(min_value=0.0, max_value=100.0))
            for k in range(draw(st.integers(min_value=1, max_value=3))):
                events.append(ChaosEvent(at_s=t0 + 2 * k, kind="site-kill",
                                         site=site))
                events.append(ChaosEvent(at_s=t0 + 2 * k + 1,
                                         kind="site-restore", site=site))
        return events

    @settings(max_examples=60, deadline=None)
    @given(events=alternating_schedules())
    def test_alternating_failures_always_validate(events):
        check_alternating_failures_validate(events)


def test_overlap_rules_per_target():
    kill = ChaosEvent(at_s=10, kind="site-kill", site="a")
    # distinct sites may fail concurrently
    ChaosSchedule([kill, ChaosEvent(at_s=11, kind="site-kill", site="b")])
    # node-fail while the same site is killed is an overlap...
    with pytest.raises(ValueError, match="overlapping"):
        ChaosSchedule([kill, ChaosEvent(at_s=11, kind="node-fail",
                                        site="a")])
    # ...but a link brown-out is a different target even if it names "a"
    ChaosSchedule([kill, ChaosEvent(at_s=11, kind="link-degrade",
                                    link=("a", "b"), gbps=0.1)])
    # double brown-out of one link (either endpoint order) is an overlap
    with pytest.raises(ValueError, match="overlapping"):
        ChaosSchedule([
            ChaosEvent(at_s=1, kind="link-degrade", link=("a", "b"),
                       gbps=0.1),
            ChaosEvent(at_s=2, kind="link-degrade", link=("b", "a"),
                       gbps=0.2)])


def test_event_field_validation():
    with pytest.raises(ValueError, match="unknown chaos kind"):
        ChaosEvent(at_s=0, kind="meteor", site="a")
    with pytest.raises(ValueError, match="at_s"):
        ChaosEvent(at_s=-1, kind="site-kill", site="a")
    with pytest.raises(ValueError, match="needs site"):
        ChaosEvent(at_s=0, kind="node-fail")
    with pytest.raises(ValueError, match="needs link"):
        ChaosEvent(at_s=0, kind="link-degrade", gbps=1.0)
    with pytest.raises(ValueError, match="gbps"):
        ChaosEvent(at_s=0, kind="link-degrade", link=("a", "b"))


def test_injector_fires_each_event_exactly_once():
    from repro_torch.fabric import Fabric
    fabric = Fabric(device="cpu")
    fabric.add_site("a", devices=[0, 1])
    fabric.add_site("b", devices=[0])
    fabric.connect("a", "b", gbps=1.0, latency_ms=1.0)
    inj = ChaosInjector(fabric, ChaosSchedule([
        ChaosEvent(at_s=5, kind="node-fail", site="a"),
        ChaosEvent(at_s=10, kind="site-kill", site="b"),
        ChaosEvent(at_s=20, kind="node-join", site="a"),
        ChaosEvent(at_s=30, kind="site-restore", site="b"),
    ]))
    assert [r["kind"] for r in inj.fire_due(10)] == ["node-fail",
                                                     "site-kill"]
    assert len(fabric.sites["a"].cluster.online_devices) == 1
    assert not fabric.sites["b"].up
    assert inj.fire_due(10) == []            # idempotent
    late = inj.fire_due(1e9)
    assert [r["kind"] for r in late] == ["node-join", "site-restore"]
    assert all(r["applied"] for r in inj.fired)
    assert len(fabric.sites["a"].cluster.online_devices) == 2
    assert fabric.sites["b"].up


# ---------------------------------------------------------------- grading

def test_grade_tenant_verdicts_and_chargeback():
    g = grade_tenant(
        "chat", SLO(p99_ttft_s=1.0, p99_latency_s=2.0, min_goodput=0.9),
        offered=100, served=95, ttft_s=[0.1] * 90 + [5.0] * 10,
        latency_s=[0.2] * 100, horizon_s=100.0,
        price=Price(per_gb=1.0, per_device_s=0.01),
        bytes_moved=2e9, device_s=50.0)
    assert g.rejected == 5
    assert g.goodput_ratio == pytest.approx(0.95)
    assert g.verdicts == {"p99_ttft": False, "p99_latency": True,
                          "goodput": True}
    assert not g.slo_pass                      # one verdict fails => fail
    assert g.chargeback["gb_moved"] == pytest.approx(2.0)
    assert g.chargeback["total"] == pytest.approx(2.0 + 0.5)
    assert "chat" in grade_table([g])
    row = g.to_json()
    assert row["offered"] == 100 and row["slo_pass"] is False


def test_grade_rejects_overcounted_served():
    with pytest.raises(ValueError, match="served"):
        grade_tenant("t", SLO(), offered=1, served=2, horizon_s=10.0)


def test_chargeback_zero_usage_is_free():
    bill = chargeback(Price(), bytes_moved=0.0, device_s=0.0)
    assert bill["total"] == 0.0


# ------------------------------------------- end-to-end chaos regression

def test_scenario_survives_site_kill_and_preemption():
    """Tiny diurnal run through the declarative surface: the serving
    site is killed mid-wave and a gated priority burst preempts the
    trainer exactly once.  The run must terminate, every tenant must be
    graded with nothing silently dropped, and the elastic bound must
    hold strictly (steps_lost <= ckpt_every)."""
    from repro_torch.api import ServeJob, TrainJob
    from repro_torch.core.orchestrator import Cluster, JobSpec
    from repro_torch.fabric import Fabric, FederatedStore
    from repro_torch.vcluster import FairShareScheduler, TenantSpec

    fabric = Fabric(device="cpu")
    fabric.add_site("gpu", cluster=Cluster(devices=[torch.device("cpu")]))
    fabric.add_site("edge", devices=[0, 1])
    fabric.add_site("hub", devices=[0])
    fabric.connect("gpu", "edge", gbps=10.0, latency_ms=1.0)
    fabric.connect("gpu", "hub", gbps=1.0, latency_ms=5.0)
    fabric.connect("edge", "hub", gbps=1.0, latency_ms=5.0)
    fed = FederatedStore(fabric)
    sched = FairShareScheduler(fed=fed, reconcile_s=0.02,
                               preempt_grace_s=60.0)
    sched.create_tenant(TenantSpec("research", priority=0))
    sched.create_tenant(TenantSpec("chat", priority=5))
    surge = sched.create_tenant(TenantSpec("surge", priority=10,
                                           preemptible=False))

    horizon, windows, steps, ckpt_every = 120.0, 3, 12, 2
    spec = ScenarioSpec(
        name="e2e-chaos", horizon_s=horizon, windows=windows,
        slos={"chat": SLO(p99_ttft_s=60.0, p99_latency_s=120.0,
                          min_goodput=0.5)})
    serve = {"chat": ServePlan(
        shape=TrafficShape(
            name="chat",
            rate=DiurnalRate(base_rps=0.05, peak_rps=0.15,
                             period_s=horizon),
            zipf_a=1.7, max_prompt_len=16, gen_mu=1.3, gen_sigma=0.5,
            max_new_tokens=8, seed=5),
        manifest=ServeJob(name="chat", slots=2, prompt_len=16,
                          max_new_tokens=8,
                          lease_timeout=60.0).to_manifest())}
    train = {"research": TrainPlan(manifest=TrainJob(
        name="t", steps=steps, seq_len=32, global_batch=4,
        base_shape=(1, 1), max_data=1, ckpt_every=ckpt_every, log_every=4,
        rejoin_timeout_s=300.0, verbose=False, site="gpu", devices=1,
        min_devices=0,
        optimizer={"warmup_steps": 2, "decay_steps": 100}).to_manifest())}
    chaos = ChaosSchedule([
        ChaosEvent(at_s=50.0, kind="site-kill", site="edge"),
        ChaosEvent(at_s=50.0, kind="link-degrade", link=("gpu", "hub"),
                   gbps=0.05),
        ChaosEvent(at_s=100.0, kind="link-restore", link=("gpu", "hub")),
        ChaosEvent(at_s=110.0, kind="site-restore", site="edge"),
    ])

    # deterministic single preemption: the burst fires only once the
    # trainer has taken >= 3 steps, so one checkpoint window is at risk
    def fire_burst():
        while fabric.metrics.series("elastic/step").last < 3:
            time.sleep(0.005)
        surge.submit(JobSpec("burst", lambda ctx: time.sleep(0.3) or "ok",
                             devices_per_pod=1), site="gpu").wait(120)

    th = threading.Thread(target=fire_burst, daemon=True)
    with sched:
        th.start()
        result = run_scenario(sched, spec, serve=serve, train=train,
                              chaos=chaos)
        th.join(timeout=120)

    assert set(result.grades) == {"chat", "research"}
    g = result.grades["chat"]
    assert g.served + g.rejected == g.offered > 0
    assert set(g.verdicts) == {"p99_ttft", "p99_latency", "goodput"}
    applied = {(r["kind"], r.get("site") or tuple(r.get("link") or ()))
               for r in result.chaos_fired if r["applied"]}
    assert {("site-kill", "edge"), ("link-degrade", ("gpu", "hub")),
            ("link-restore", ("gpu", "hub")),
            ("site-restore", "edge")} <= applied
    # the preempted trainer resumed from its checkpoint and finished
    out = result.train_results["research"]
    assert sorted(out["loss_by_step"]) == list(range(steps))
    rep = out["report"]
    assert "preempted" in [s.outcome for s in rep.segments], \
        "gated burst must preempt the trainer"
    assert fabric.metrics.series("elastic/preemptions").total >= 1
    r = result.grades["research"]
    assert r.steps_lost <= ckpt_every, \
        f"lost {r.steps_lost} steps > ckpt_every={ckpt_every}"


# ---------------------------------------------------- across the two stacks
def _shape(mod, seed, bursts=False):
    return mod.TrafficShape(
        name="x",
        rate=mod.DiurnalRate(base_rps=0.5, peak_rps=2.5, period_s=90.0,
                             phase_s=20.0),
        bursts=mod.BurstOverlay(rate_per_s=0.04, extra_rps=3.0,
                                duration_s=6.0) if bursts else None,
        zipf_a=1.7, max_prompt_len=20, gen_mu=1.3, gen_sigma=0.6,
        max_new_tokens=10, seed=seed)


@pytest.mark.parametrize("seed,bursts", [(0, False), (5, True),
                                         (12345, True)])
def test_traces_equal_jax_element_for_element(seed, bursts):
    got, want = _shape(jsc_port, seed, bursts), _shape(jsc, seed, bursts)
    assert got.mean_rps() == want.mean_rps()
    assert got.max_rps() == want.max_rps()
    np.testing.assert_array_equal(got.arrivals(90.0), want.arrivals(90.0))
    np.testing.assert_array_equal(got.prompt_lengths(64),
                                  want.prompt_lengths(64))
    np.testing.assert_array_equal(got.gen_lengths(64), want.gen_lengths(64))
    reqs = got.requests(90.0, vocab_size=97)
    assert reqs and reqs == want.requests(90.0, vocab_size=97)
    assert [r["id"] for r in slice_window(reqs, 30.0, 60.0)] == \
        [r["id"] for r in jsc.slice_window(reqs, 30.0, 60.0)]


BAD_EVENTS = [
    dict(at_s=0, kind="meteor", site="a"),
    dict(at_s=-1, kind="site-kill", site="a"),
    dict(at_s=0, kind="node-fail"),
    dict(at_s=0, kind="link-degrade", gbps=1.0),
    dict(at_s=0, kind="link-degrade", link=("a", "b")),
]
BAD_SCHEDULES = [
    [dict(at_s=10, kind="site-kill", site="a"),
     dict(at_s=11, kind="node-fail", site="a")],
    [dict(at_s=1, kind="link-degrade", link=("a", "b"), gbps=0.1),
     dict(at_s=2, kind="link-degrade", link=("b", "a"), gbps=0.2)],
    [dict(at_s=0, kind="site-kill", site="s0"),
     dict(at_s=1, kind="site-restore", site="s0"),
     dict(at_s=2, kind="site-kill", site="s0"),
     dict(at_s=2.5, kind="site-kill", site="s0")],
]


def _error(fn):
    try:
        fn()
    except Exception as e:          # the message is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", BAD_EVENTS)
def test_chaos_event_validation_errors_match_jax(kw):
    got = _error(lambda: ChaosEvent(**kw))
    assert got is not None and got == _error(lambda: jsc.ChaosEvent(**kw))


@pytest.mark.parametrize("events", BAD_SCHEDULES)
def test_chaos_schedule_validation_errors_match_jax(events):
    got = _error(lambda: ChaosSchedule([ChaosEvent(**e) for e in events]))
    want = _error(lambda: jsc.ChaosSchedule(
        [jsc.ChaosEvent(**e) for e in events]))
    assert got is not None and got == want
    # allowed overlap builds on both, in the same order
    ok = ChaosSchedule([ChaosEvent(**e) for e in events], allow_overlap=True)
    jok = jsc.ChaosSchedule([jsc.ChaosEvent(**e) for e in events],
                            allow_overlap=True)
    assert [(e.at_s, e.kind) for e in ok.events] == \
        [(e.at_s, e.kind) for e in jok.events]


GRADE_CASES = [
    dict(tenant="chat", slo=dict(p99_ttft_s=1.0, p99_latency_s=2.0,
                                 min_goodput=0.9),
         offered=100, served=95, ttft_s=[0.1] * 90 + [5.0] * 10,
         latency_s=[0.2] * 100, horizon_s=100.0,
         price=dict(per_gb=1.0, per_device_s=0.01),
         bytes_moved=2e9, device_s=50.0),
    dict(tenant="research", slo={}, offered=0, served=0, horizon_s=60.0,
         bytes_moved=1.5e8, device_s=12.25, steps_lost=2, recoveries=1,
         makespan_s=40.0),
    dict(tenant="search", slo=dict(p99_ttft_s=0.5, min_goodput=0.5),
         offered=7, served=3, ttft_s=[0.3, 0.7, 0.2], latency_s=[],
         horizon_s=30.0, price=dict(per_gb=0.5, per_device_s=0.002),
         device_s=3.0),
]


@pytest.mark.parametrize("case", GRADE_CASES, ids=lambda c: c["tenant"])
def test_grades_and_chargeback_equal_jax(case):
    def grade(mod):
        kw = dict(case)
        name, slo = kw.pop("tenant"), mod.SLO(**kw.pop("slo"))
        if "price" in kw:
            kw["price"] = mod.Price(**kw["price"])
        return mod.grade_tenant(name, slo, **kw)

    got, want = grade(jsc_port), grade(jsc)
    assert got.to_json() == want.to_json()
    assert got.verdicts == want.verdicts and got.slo_pass == want.slo_pass
    assert grade_table([got]) == jsc.grade_table([want])
    price = case.get("price", {})
    assert chargeback(Price(**price), bytes_moved=case.get("bytes_moved", 0),
                      device_s=case.get("device_s", 0)) == \
        jsc.chargeback(jsc.Price(**price),
                       bytes_moved=case.get("bytes_moved", 0),
                       device_s=case.get("device_s", 0))
    for q in (50, 90, 99, 100):
        assert jsc_port.percentile(case.get("ttft_s", []), q) == \
            jsc.percentile(case.get("ttft_s", []), q)


def test_scenario_chaos_example_runs_on_the_cpu(capsys):
    """``repro_torch.examples.scenario_chaos --fast --device cpu``: every
    tenant graded, nothing dropped, the whole failure menu survived,
    training finished within its bound, as the JAX example asserts.  The
    serving tenants' makespan skew is reported, not bounded by 1.2 as in
    JAX: the port's waves cost their tokens, not a compile each."""
    from repro_torch.examples import scenario_chaos
    rep = scenario_chaos.main(["--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "SCENARIO_REPORT " in out and "\nOK — " in out
    assert set(rep["tenants"]) == {"chat", "research", "search"}
    assert [c["kind"] for c in rep["chaos"]] == [
        "node-fail", "node-join", "site-kill", "link-degrade",
        "link-restore", "site-restore"]
    assert all(c["applied"] for c in rep["chaos"])
    assert rep["fairshare_skew"] >= 1.0
