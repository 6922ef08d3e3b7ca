"""The port's serving engine against the JAX engine, and its host copies.

Greedy tokens must be equal, not close: phi4 smoke in f32 with the same
params (JAX ``init_params`` carried over by ``bridge``) and the same
requests, through the slotted and the paged cache.  The scheduler, pool
and queue are copies; they are driven with a fake clock next to the JAX
originals and must record the same events.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                       # noqa: E402

from repro.configs import registry as jreg                       # noqa: E402
from repro.core.metrics import Registry as JRegistry             # noqa: E402
from repro.core.queue import WorkQueue as JQueue                 # noqa: E402
from repro.launch.mesh import single_device_mesh                 # noqa: E402
from repro.models import params as jpr                           # noqa: E402
from repro.models import transformer as jtfm                     # noqa: E402
from repro.serving.engine import ServingEngine as JEngine         # noqa: E402
from repro.serving.pool import BlockPool as JPool                # noqa: E402
from repro.serving.scheduler import ContinuousScheduler as JSched  # noqa: E402

from repro_torch import bridge                                   # noqa: E402
from repro_torch.configs import registry as treg                # noqa: E402
from repro_torch.core.metrics import Registry as TRegistry       # noqa: E402
from repro_torch.core.queue import WorkQueue as TQueue           # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.pool import BlockPool as TPool          # noqa: E402
from repro_torch.serving.report import GAUGES                    # noqa: E402
from repro_torch.serving.scheduler import ContinuousScheduler as TSched  # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke(ARCH).replace(**F32)
    tcfg = treg.get_smoke(ARCH).replace(**F32)
    jp = jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(0), "float32")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.to_torch(jax.tree.map(np.asarray, jp),
                                   device="cpu"))


def prompt_requests(cfg, gens, *, seed=0, shared_prefix=0, prompt_len=8):
    rng = np.random.RandomState(seed)
    head = rng.randint(1, cfg.vocab_size, shared_prefix).tolist()
    return [{"id": i,
             "prompt": head + rng.randint(1, cfg.vocab_size,
                                          prompt_len - shared_prefix).tolist(),
             "max_new_tokens": g}
            for i, g in enumerate(gens)]


def _engines(s, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prompt_len", 8)
    kw.setdefault("max_new_tokens", 8)
    j = JEngine(s["jcfg"], jreg.get_parallel(ARCH), single_device_mesh(),
                params=s["jp"], **kw)
    t = TEngine(s["tcfg"], device="cpu", params=s["tp"], **kw)
    return j, t


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_equal_jax_engine(setup, paged):
    gens = [8, 3, 5, 8, 2]
    kw = dict(paged=paged)
    if paged:
        kw.update(block_size=4, prefix_cache=False)
    j, t = _engines(setup, **kw)
    assert t.paged == paged
    reqs = prompt_requests(setup["tcfg"], gens)
    r_j, _ = j.run(JQueue(reqs))
    r_t, m = t.run(TQueue(reqs))
    assert r_t == r_j
    assert [len(r_t[i]) for i in range(len(gens))] == gens
    assert m.summary()[GAUGES.TOKENS]["total"] == sum(gens)


def test_paged_equals_slotted(setup):
    gens = [6, 2, 7, 4]
    reqs = prompt_requests(setup["tcfg"], gens, seed=5)
    slot = TEngine(setup["tcfg"], device="cpu", params=setup["tp"],
                   num_slots=3, prompt_len=8, max_new_tokens=8, paged=False)
    page = TEngine(setup["tcfg"], device="cpu", params=setup["tp"],
                   num_slots=3, prompt_len=8, max_new_tokens=8, paged=True,
                   block_size=4, prefix_cache=False)
    assert slot.run(TQueue(reqs))[0] == page.run(TQueue(reqs))[0]


def test_prefix_cache_hits_and_matches_jax(setup):
    """Shared system prefix through one slot: later requests retain the
    cached block and replay their suffix through the decode step; the
    tokens and hit counts equal the JAX engine's."""
    kw = dict(num_slots=1, paged=True, block_size=4, prefix_cache=True)
    j, t = _engines(setup, **kw)
    reqs = prompt_requests(setup["tcfg"], [4, 4, 4], seed=3, shared_prefix=4)
    r_j, m_j = j.run(JQueue(reqs))
    r_t, m_t = t.run(TQueue(reqs))
    assert r_t == r_j
    hits = m_t.summary()[GAUGES.PREFIX_HITS]["total"]
    assert hits == 2 == m_j.summary()[GAUGES.PREFIX_HITS]["total"]
    assert m_t.summary()[GAUGES.PREFIX_BYTES_SAVED]["total"] > 0
    assert t.block_pool.in_use == 0 and t.block_pool.cached_blocks >= 1


def test_pool_pressure_preempts_and_recovers(setup):
    t = TEngine(setup["tcfg"], device="cpu", params=setup["tp"], num_slots=2,
                prompt_len=8, max_new_tokens=8, paged=True, block_size=4,
                prefix_cache=False, pool_blocks=7)
    queue = TQueue(prompt_requests(setup["tcfg"], [8, 8, 8], seed=1),
                   max_attempts=100)
    results, metrics = t.run(queue)
    assert sorted(results) == [0, 1, 2]
    assert all(len(v) == 8 for v in results.values())
    assert metrics.summary()[GAUGES.PREEMPTED]["total"] >= 1
    assert queue.drained() and t.block_pool.in_use == 0


def _drive_scheduler(Sched, Queue, Registry, clock):
    reg = Registry()
    q = Queue([{"id": i, "prompt": [5, 6, 7], "max_new_tokens": g}
               for i, g in enumerate([3, 1, 4, 2])], lease_timeout=2.5,
              clock=clock)
    sched = Sched(q, 2, registry=reg, clock=clock)
    trace = []
    while not sched.finished():
        for slot in sched.admit():
            clock.advance(0.5)
            trace.append(("start", slot.index,
                          sched.start(slot, 100 + slot.index, 8)))
        if sched.active():
            clock.advance(1.0)
            trace.append(("step", sched.positions(), sched.last_tokens(),
                          sched.observe([7] * 2)))
            trace.append(("renew", sched.renew_leases()))
    return trace, sched.results(), reg.summary()


def test_scheduler_copy_behaves_like_reference():
    want = _drive_scheduler(JSched, JQueue, JRegistry, FakeClock())
    got = _drive_scheduler(TSched, TQueue, TRegistry, FakeClock())
    assert got == want


def test_block_pool_copy_behaves_like_reference():
    def drive(Pool):
        pool = Pool(6, 2, bytes_per_block=10)
        a = pool.alloc(3)
        pool.cache_prefix([1, 2, 3, 4, 5, 6], a)
        pool.release(a)
        hit = pool.match([1, 2, 3, 4, 9, 9], max_blocks=2)
        b = pool.alloc(3)            # pressure: evicts the LRU cached block
        out = (a, hit, b, pool.free_blocks, pool.in_use, pool.cached_blocks)
        pool.release(hit + b)
        return out + (pool.free_blocks, pool.metrics.summary())
    assert drive(TPool) == drive(JPool)
