"""The port's router, autoscaler and static batcher against the JAX ones.

The router tests of ``tests/test_serving_paged.py`` run on the port's
``ReplicaSet``/``Autoscaler``/``serve_replicated`` with the same stub
engines (one test per JAX test, same names), and the engine's stop
contract on the port's ``ServingEngine``.  Then real engines: phi4 smoke
in f32 with the same params (JAX ``init_params`` carried over by
``bridge``) and the same requests through the JAX and the port's
``serve_replicated`` and ``serve_static``.

Tolerance: none — greedy tokens, request counts and token counts must be
equal, not close.  The requests share no prompt prefix, so no request
replays a cached prefix and a request's tokens do not depend on which
replica or slot served it.
"""
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                       # noqa: E402

from repro.configs import registry as jreg                       # noqa: E402
from repro.core.metrics import Registry as JRegistry             # noqa: E402
from repro.launch.mesh import single_device_mesh                 # noqa: E402
from repro.launch.serve import serve_static as j_serve_static    # noqa: E402
from repro.models import params as jpr                           # noqa: E402
from repro.models import transformer as jtfm                     # noqa: E402
from repro.serving.engine import ServingEngine as JEngine         # noqa: E402
from repro.serving.router import serve_replicated as j_serve_replicated  # noqa: E402

from repro_torch import bridge                                   # noqa: E402
from repro_torch.api.resources import ServeJob                   # noqa: E402
from repro_torch.api.runners import run_serve_replicated         # noqa: E402
from repro_torch.configs import registry as treg                # noqa: E402
from repro_torch.core.metrics import Registry                    # noqa: E402
from repro_torch.core.queue import WorkQueue                     # noqa: E402
from repro_torch.launch import serve as tserve                   # noqa: E402
from repro_torch.serving import (Autoscaler, ReplicaSet,          # noqa: E402
                                 serve_replicated)
from repro_torch.serving.engine import ServingEngine             # noqa: E402
from repro_torch.serving.report import GAUGES                    # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Replicas are engine threads, each with its own OpenMP team of every
    core: with several test workers on one machine those teams spin
    against each other.  Two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def mk_requests(gens, prompt=(5, 6, 7)):
    return [{"id": i, "prompt": list(prompt), "max_new_tokens": g}
            for i, g in enumerate(gens)]


# ------------------------------------------------------ router / autoscaler

class FakeEngine:
    """Queue-draining stand-in for ServingEngine: acks instantly, nacks
    in-flight work on stop, records the fleet-shared serve gauges."""

    def __init__(self, registry, delay=0.0):
        self.metrics = registry
        self.delay = delay

    def run(self, queue, *, worker="server", should_stop=None,
            exit_on_drain=False, **_):
        results = {}
        while not (should_stop is not None and should_stop()):
            got = queue.lease(worker)
            if got is None:
                if exit_on_drain and queue.drained():
                    break
                time.sleep(0.001)
                continue
            tid, item = got
            if self.delay:
                time.sleep(self.delay)
            if should_stop is not None and should_stop():
                queue.nack(tid, worker)
                break
            queue.ack(tid, worker)
            n = int(item.get("max_new_tokens", 1))
            results[item["id"]] = [7] * n
            self.metrics.inc(GAUGES.COMPLETED)
            self.metrics.inc(GAUGES.TOKENS, n)
        return results, self.metrics


class IdleEngine:
    """Never consumes; exists so routing/draining can be observed."""

    def __init__(self, registry):
        self.metrics = registry

    def run(self, queue, *, worker="server", should_stop=None, **_):
        while not (should_stop is not None and should_stop()):
            time.sleep(0.001)
        return {}, self.metrics


def idle(name, reg, device):
    return IdleEngine(reg)


def test_serve_replicated_scales_up_and_serves_everything():
    reg = Registry()
    reqs = mk_requests([2] * 24)
    results, metrics, events = serve_replicated(
        lambda name, r, dev: FakeEngine(r, delay=0.01), reqs, device="cpu",
        min_replicas=1, max_replicas=3, target_backlog=2.0,
        registry=reg, reconcile_interval=0.005, timeout_s=30.0)
    assert sorted(results) == list(range(24))
    assert all(v == [7, 7] for v in results.values())
    reasons = [e[3] for e in events]
    assert reasons[0] == "startup" and "shutdown" in reasons
    # the 24-deep backlog over target 2 forced a scale-up past 1 replica
    assert metrics.series(GAUGES.REPLICAS).max >= 2
    assert metrics.series(GAUGES.SCALE_EVENTS).total == len(events)
    assert metrics.series(GAUGES.TOK_S).last > 0


def test_router_session_affinity_and_least_loaded():
    rset = ReplicaSet(idle, device="cpu")
    rset.scale_to(2)
    a1 = rset.submit({"id": 0, "prompt": [1], "session": "alice"})
    a2 = rset.submit({"id": 1, "prompt": [1], "session": "alice"})
    assert a1 == a2                     # pinned: the replica's prefix
    b = rset.submit({"id": 2, "prompt": [1], "session": "bob"})
    assert b != a1                      # least-loaded breaks the tie
    rset.stop_all()


def test_scale_down_drains_queue_with_enqueue_time_preserved():
    clock = FakeClock(t=5.0)
    rset = ReplicaSet(idle, device="cpu", clock=clock)
    rset.scale_to(2)
    for i in range(4):
        rset.submit({"id": i, "prompt": [1]})
    clock.advance(40.0)                 # well past any lease window
    rset.scale_to(1, reason="drain-test")
    [survivor] = rset._replicas
    assert survivor.queue.pending == 4  # nothing lost in the retirement
    order = []
    while True:
        got = survivor.queue.lease("w")
        if got is None:
            break
        tid, item = got
        # migrated requests keep charging TTFT from the FIRST enqueue
        assert survivor.queue.enqueued_at(tid) == 5.0
        order.append(item["id"])
    assert sorted(order) == [0, 1, 2, 3]
    rset.stop_all()


def test_autoscaler_recommend_clamps_and_slo_bump():
    class StubSet:
        def __init__(self):
            self.metrics = Registry()
            self.backlog = 0
            self.n = 1

        def total_backlog(self):
            return self.backlog

        def observed(self):
            return self.n

    stub = StubSet()
    sc = Autoscaler(stub, min_replicas=1, max_replicas=4,
                    target_backlog=4.0, ttft_slo_s=0.5)
    assert sc.recommend() == 1          # empty backlog, SLO series empty
    stub.backlog = 9
    assert sc.recommend() == math.ceil(9 / 4.0)
    stub.backlog = 100
    assert sc.recommend() == 4          # max clamp
    stub.backlog = 0
    stub.metrics.gauge(GAUGES.SERVICE_TTFT_S, 2.0)
    assert sc.recommend() == stub.n + 1     # latency breach: +1
    with pytest.raises(ValueError, match="min_replicas"):
        Autoscaler(stub, min_replicas=3, max_replicas=2)


def test_replicaset_capacity_gates_scale_up():
    granted = []

    def capacity(want):
        granted.append(want)
        return min(want, 2)             # the fair share caps the fleet

    rset = ReplicaSet(idle, device="cpu", capacity=capacity)
    rset.scale_to(4)
    assert rset.observed() == 2
    rset.scale_to(0)
    assert granted == [4]               # scale-down never asks


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_scale_up_after_a_burst_serves_none_of_it(stack):
    """A fault of the JAX router, copied as it is: ``serve_replicated``
    routes the whole up-front burst to the one startup replica before its
    first reconcile, so the replica the scale-up adds serves none of it
    (ROADMAP queue C)."""
    served = {}

    class Recording(FakeEngine):
        def run(self, queue, *, worker="server", **kw):
            results, reg = super().run(queue, worker=worker, **kw)
            served[worker] = sorted(results)
            return results, reg

    kw = dict(min_replicas=1, max_replicas=2, target_backlog=2.0,
              reconcile_interval=0.005, timeout_s=30.0)
    if stack == "jax":
        results, _, events = j_serve_replicated(
            lambda name, r: Recording(r, delay=0.01), mk_requests([1] * 12),
            registry=JRegistry(), **kw)
    else:
        results, _, events = serve_replicated(
            lambda name, r, dev: Recording(r, delay=0.01),
            mk_requests([1] * 12), device="cpu", registry=Registry(), **kw)
    assert (events[1][1], events[1][2]) == (1, 2)       # it scaled up
    assert sorted(results) == list(range(12))
    assert served == {"replica-0": list(range(12)), "replica-1": []}


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_a_capped_scale_up_leaves_no_scale_event(stack):
    """A fault of the JAX router, copied as it is: when the capacity grant
    clamps a scale-up to the replicas already running,
    ``ReplicaSet.scale_to`` returns before recording anything, so neither
    ``scale_events`` nor ``on_scale`` (a Session's ``replicas:
    desired→observed`` detail) ever shows the desired count; only the
    grant's own records do (the tenant scheduler's ``resized`` events,
    ROADMAP queue C)."""
    from repro.serving.router import ReplicaSet as JReplicaSet
    asked, scaled = [], []

    def capacity(want):
        asked.append(want)
        return 1                        # another tenant holds the rest

    def on_scale(desired, observed, reason):
        scaled.append((desired, observed, reason))

    if stack == "jax":
        rset = JReplicaSet(lambda name, reg: IdleEngine(reg),
                           registry=JRegistry(), capacity=capacity,
                           on_scale=on_scale)
    else:
        rset = ReplicaSet(idle, device="cpu", registry=Registry(),
                          capacity=capacity, on_scale=on_scale)
    try:
        rset.scale_to(1, reason="startup")
        rset.scale_to(2, reason="reconcile")
        assert asked == [1, 2] and rset.observed() == 1
        assert [e[1:] for e in rset.scale_events] == [(0, 1, "startup")]
        assert scaled == [(1, 1, "startup")]
    finally:
        rset.scale_to(0, reason="shutdown")


def test_router_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_replicated(idle, mk_requests([1]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaSet(idle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_static(ARCH, smoke=True, n_requests=1, prompt_len=4,
                            gen=2)


# ------------------------------------------------- the engine's stop path

@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke(ARCH).replace(**F32)
    tcfg = treg.get_smoke(ARCH).replace(**F32)
    jp = jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(0), "float32")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.to_torch(jax.tree.map(np.asarray, jp),
                                   device="cpu"))


def _port_engine(s, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prompt_len", 8)
    kw.setdefault("max_new_tokens", 8)
    return ServingEngine(s["tcfg"], device="cpu", params=s["tp"], **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_stop_nacks_within_one_step_not_one_timeout(setup, paged):
    """Cooperative stop with a huge visibility timeout: the in-flight
    requests must be re-servable immediately (nack), not after the lease
    expires — the preempted-replica acceptance bound."""
    reqs = [{"id": i, "prompt": [1 + i] * 4, "max_new_tokens": 3}
            for i in range(4)]
    queue = WorkQueue(reqs, lease_timeout=1000.0)
    # paged: a cache of 8 rows in blocks of 2
    kw = dict(prompt_len=4, max_new_tokens=4 if paged else 3, paged=paged,
              block_size=2)
    engine = _port_engine(setup, **kw)
    calls = {"n": 0}

    def stop_after_two():
        calls["n"] += 1
        return calls["n"] > 2

    results, metrics = engine.run(queue, should_stop=stop_after_two)
    assert len(results) < 4
    assert queue.leased == 0            # nacked, not left to expire
    assert queue.pending == 4 - queue.completed
    assert metrics.series(GAUGES.PREEMPTED).total >= 1
    if paged:
        assert engine.block_pool.in_use == 0    # the nacked slots' blocks
    # a replacement engine re-serves them NOW — no sleep, no timeout wait
    engine2 = _port_engine(setup, **kw)
    results2, _ = engine2.run(queue)
    done = dict(results)
    done.update(results2)
    assert sorted(done) == [0, 1, 2, 3]
    assert queue.drained()


def test_engine_without_exit_on_drain_idles_until_stopped(setup):
    """A replica behind the router: the queue drains, the loop keeps
    polling, a request put later is served, then the stop ends it."""
    import threading
    queue = WorkQueue([{"id": 0, "prompt": [3, 4], "max_new_tokens": 2}])
    engine = _port_engine(setup)
    stop = threading.Event()
    out = {}
    t = threading.Thread(target=lambda: out.update(
        zip(("results", "metrics"),
            engine.run(queue, should_stop=stop.is_set,
                       exit_on_drain=False))))
    t.start()
    deadline = time.monotonic() + 60
    while queue.completed < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert t.is_alive()                 # drained, still serving
    queue.put({"id": 1, "prompt": [5, 6], "max_new_tokens": 3})
    while queue.completed < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(timeout=60)
    assert not t.is_alive()
    assert {k: len(v) for k, v in out["results"].items()} == {0: 2, 1: 3}


# ---------------------------------------- real engines, the two stacks

def _requests(cfg, gens, *, seed=1, prompt_len=8):
    rng = np.random.RandomState(seed)
    return [{"id": i, "prompt": rng.randint(1, cfg.vocab_size,
                                            prompt_len).tolist(),
             "max_new_tokens": g} for i, g in enumerate(gens)]


ENGINE = dict(num_slots=2, prompt_len=8, max_new_tokens=8)
FLEET = dict(min_replicas=1, max_replicas=2, target_backlog=2.0,
             reconcile_interval=0.005, timeout_s=300.0)


def test_serve_replicated_tokens_equal_jax(setup):
    """Both stacks' fleets scale 1 -> 2 on a 12-deep burst and every
    request's greedy tokens are the same."""
    reqs = _requests(setup["tcfg"], [8, 3, 6, 1, 8, 2] * 2)
    par, mesh = jreg.get_parallel(ARCH), single_device_mesh()
    want, jm, jevents = j_serve_replicated(
        lambda name, reg: JEngine(setup["jcfg"], par, mesh,
                                  params=setup["jp"], registry=reg,
                                  **ENGINE),
        [dict(r) for r in reqs], registry=JRegistry(), **FLEET)
    got, tm, events = serve_replicated(
        lambda name, reg, dev: ServingEngine(
            setup["tcfg"], device=dev, params=setup["tp"], registry=reg,
            **ENGINE),
        [dict(r) for r in reqs], device="cpu", registry=Registry(), **FLEET)
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    assert got == want
    assert all(len(got[r["id"]]) == r["max_new_tokens"] for r in reqs)
    assert tm.series(GAUGES.REPLICAS).max == 2 == jm.series(
        GAUGES.REPLICAS).max
    assert [e[2] for e in events if e[3] == "reconcile"][:1] == [2]
    assert tm.series(GAUGES.TOKENS).total == jm.series(GAUGES.TOKENS).total


class StubHandle:
    """The JAX Handle's surface as the runners use it."""

    def __init__(self):
        self.probes, self.states = {}, []

    def probe(self, name, fn):
        self.probes[name] = fn

    def _transition(self, state, **detail):
        self.states.append((state, detail))

    def should_stop(self):
        return False


@pytest.mark.parametrize("with_handle", [False, True])
def test_run_serve_replicated_serves_a_serve_job(with_handle):
    """The ServeJob driver: two replicas pinned (min == max), each request
    served with its stop length; a handle sees the probes and a
    ``replicas`` transition per scale event."""
    job = ServeJob(name="fleet", n_requests=6, prompt_len=8,
                   max_new_tokens=4, slots=2, gen_lens=(4, 2, 1),
                   min_replicas=2, max_replicas=2)
    handle = StubHandle() if with_handle else None
    out = run_serve_replicated(handle, job, Registry(), device="cpu")
    assert sorted(out["results"]) == list(range(6))
    assert [len(out["results"][i]) for i in range(6)] == [4, 2, 1] * 2
    assert out["metrics"].series(GAUGES.REPLICAS).max == 2
    assert out["scale_events"][0][3] == "startup"
    if with_handle:
        assert handle.probes["completed"]() == 6
        assert [d.get("replicas") for _, d in handle.states] == \
            ["2→0", "2→2", "0→0"]


@pytest.mark.parametrize("batch,warmup", [(2, False), (4, True)])
def test_serve_static_matches_jax(setup, batch, warmup):
    """The drain-then-refill batcher: spread stop lengths, prompts
    shorter and longer than the pad, the last batch not full; the warmup
    prefill and decode step change no token."""
    reqs = _requests(setup["tcfg"], [8, 1, 5, 2, 7, 3, 6], prompt_len=6)
    reqs[1]["prompt"] = reqs[1]["prompt"] + [9, 9, 9]     # truncated at 8
    kw = dict(smoke=True, n_requests=len(reqs), prompt_len=8, gen=8,
              batch=batch, warmup=warmup)
    want, jm = j_serve_static(ARCH, requests=[dict(r) for r in reqs],
                              cfg_override=setup["jcfg"], **kw)
    got, tm = tserve.serve_static(ARCH, requests=[dict(r) for r in reqs],
                                  cfg_override=setup["tcfg"],
                                  params=setup["tp"], device="cpu", **kw)
    assert got == want
    for name in (GAUGES.COMPLETED, GAUGES.TOKENS):
        assert tm.series(name).total == jm.series(name).total, name
    assert tm.series(GAUGES.COMPLETED).total == len(reqs)
    assert tm.series(GAUGES.PREFILL_S).stats()["count"] == \
        math.ceil(len(reqs) / batch)


def test_static_cli_serves_on_the_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--static", "--requests", "5",
                 "--prompt-len", "8", "--gen", "4", "--slots", "2",
                 "--spread"])
    out = capsys.readouterr().out
    assert "[serve:static] completed 5 requests" in out
    assert "| requests | 5 |" in out
