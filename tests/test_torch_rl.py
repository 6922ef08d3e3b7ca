"""The port's RL workload against the JAX package's ``repro.rl``.

Host pieces (replay staleness, the rollout queue, the policy store's
files) are ported from ``tests/test_rl.py`` and held to the JAX ones; the
device pieces run phi4 smoke in f32 with two layers, params made by the
JAX ``init_params`` and carried over by ``bridge``, on the CPU (the xent
and AdamW kernels' plain versions; the JAX side as its own tests run it).

Tolerances, all f32:
  * ``rl_loss_fn``: the loss within 1e-6 relative, every grad leaf within
    1e-4 of its largest element — the bound ``tests/test_torch_train.py``
    holds the supervised loss's grads to: the two frameworks sum the same
    products in other orders, which moves a random-init model's grads by
    up to 7e-5 relative there (both sides within 1e-4 of a float64 run)
    and by 1.7e-5 to 6.3e-5 here (seeds 0-2; the loss itself was equal);
  * ``rl_train_chunk`` and the learner: per-step losses within 1e-5
    relative; the params after two Adam steps within 2e-4 absolute, the
    bound ``tests/test_torch_train.py`` holds its Adam steps to: Adam
    divides by sqrt(v), so where a grad is near eps its rounding moves a
    step of up to lr (one element of 4096 of one leaf moved by 2.2e-5
    here; every other within 1e-5);
  * a crash-and-resume run against a clean one, and ``encode`` and the
    policy store's files against JAX: exactly equal.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.configs.base import ShapeConfig                      # noqa: E402
from repro.core.queue import WorkQueue as JQueue                # noqa: E402
from repro.data.objectstore import ObjectStore as JStore        # noqa: E402
from repro.launch.mesh import single_device_mesh                # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.models.layers import ModelCtx                        # noqa: E402
from repro.optim import adamw as jadamw                         # noqa: E402
from repro.rl import PolicyStore as JPolicyStore                # noqa: E402
from repro.rl import RLLearner as JLearner                      # noqa: E402
from repro.rl import RLLearnerSpec as JLearnerSpec              # noqa: E402
from repro.rl import RolloutQueue as JRolloutQueue              # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.api.resources import RLJob                     # noqa: E402
from repro_torch.api.runners import run_rl_fleet               # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.core.metrics import Registry                   # noqa: E402
from repro_torch.core.queue import WorkQueue                    # noqa: E402
from repro_torch.data.objectstore import ObjectStore            # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.rl import (PolicyStore, RLLearner, RLLearnerSpec,  # noqa: E402
                            RolloutQueue, Trajectory, is_stale,
                            split_stale)
from repro_torch.runtime import steps as tsteps                 # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32", num_layers=2)
SCHEDULE = dict(lr=1e-3, warmup_steps=1, decay_steps=8)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Actors are engine threads, each with its own OpenMP team of every
    core: with several test workers on one machine those teams spin
    against each other.  Two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def traj(version: int, *, ticket="t0", reward=1.0) -> Trajectory:
    return Trajectory(ticket=ticket, prompt=(1, 2), tokens=(3, 4),
                      reward=reward, policy_version=version, actor="a")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ------------------------------------------------------------- staleness
def test_is_stale_boundary():
    assert not is_stale(3, 5, max_policy_lag=2)     # gap == lag: trainable
    assert is_stale(2, 5, max_policy_lag=2)         # gap > lag: stale
    assert not is_stale(5, 5, max_policy_lag=0)


def test_split_stale():
    ts = [traj(0), traj(1), traj(2)]
    fresh, stale = split_stale(ts, current_version=2, max_policy_lag=1)
    assert [t.policy_version for t in fresh] == [1, 2]
    assert [t.policy_version for t in stale] == [0]


def test_take_fresh_drops_and_meters_stale():
    reg = Registry()
    q = RolloutQueue(registry=reg)
    for v in (0, 0, 2, 1):
        q.push(traj(v, ticket=f"t{v}"))
    got = q.take_fresh(10, worker="learner", current_version=2,
                       max_policy_lag=1)
    assert [t.policy_version for _, t in got] == [2, 1]
    assert q.stale_dropped == 2
    assert reg.series("rl/stale_dropped").total == 2
    q.ack_trained(got, worker="learner", current_version=2)
    assert q.trained == 2
    assert q.max_lag_trained() == 1
    assert q.pending == 0                           # stale ones consumed


def test_release_returns_batch_to_pending():
    q = RolloutQueue()
    q.push(traj(0))
    held = q.take_fresh(1, worker="learner", current_version=0,
                        max_policy_lag=2)
    assert len(held) == 1 and q.pending == 0
    q.release(held, worker="learner")               # preempted mid-drain
    assert q.pending == 1
    again = q.take_fresh(1, worker="learner", current_version=0,
                         max_policy_lag=2)
    assert len(again) == 1                          # at-least-once


def _queue_ops(q):
    """One sequence of pushes, drops, acks and a release."""
    for v in (0, 0, 1):
        q.push(traj(v))
    got = q.take_fresh(1, worker="learner", current_version=1,
                       max_policy_lag=0)            # drops the two v=0
    q.ack_trained(got, worker="learner", current_version=1)
    q.push(traj(1))
    q.push(traj(1, ticket="t1"))
    held = q.take_fresh(1, worker="learner", current_version=1,
                        max_policy_lag=0)
    q.release(held, worker="learner")


def test_rollout_queue_snapshot_restore_roundtrip():
    q = RolloutQueue()
    _queue_ops(q)
    snap = q.snapshot()
    clone = RolloutQueue()
    clone.restore(snap)
    assert clone.pushed == q.pushed == 5
    assert clone.trained == q.trained == 1
    assert clone.stale_dropped == q.stale_dropped == 2
    assert clone.lag_trained == q.lag_trained == [0]
    assert clone.pending == q.pending == 2
    got2 = clone.take_fresh(1, worker="learner", current_version=1,
                            max_policy_lag=0)
    assert [t.policy_version for _, t in got2] == [1]


def test_snapshots_equal_jax():
    """The same operations on the port's and the JAX rollout queue (and
    their work queues) give the same snapshot, and each stack restores
    the other's."""
    clock = FakeClock()
    port, ref = RolloutQueue(clock=clock), JRolloutQueue(clock=clock)
    for q in (port, ref):
        _queue_ops(q)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    json.dumps(snap)                                # checkpoint-manifest safe
    back = JRolloutQueue()
    back.restore(snap)
    mine = RolloutQueue()
    mine.restore(ref.snapshot())
    assert back.snapshot() == mine.snapshot()
    wq, jq = WorkQueue(["a", "b", "c"]), JQueue(["a", "b", "c"])
    for q in (wq, jq):
        q.lease("w")
        q.ack(q.lease("w")[0], "w")
    assert (wq.pending, wq.leased, wq.completed) == \
        (jq.pending, jq.leased, jq.completed) == (1, 1, 1)


def test_rewind_returns_lost_rollouts_and_keeps_later_ones():
    """After a crash the learner rewinds to its checkpoint's snapshot: the
    rollouts trained on since return to pending in their order, and those
    pushed since stay queued behind them with their enqueue times."""
    clock = FakeClock()
    q = RolloutQueue(clock=clock)
    for i in range(4):
        q.push(traj(0, ticket=f"a{i}"))
    first = q.take_fresh(2, worker="learner", current_version=0,
                         max_policy_lag=2)
    q.ack_trained(first, worker="learner", current_version=0)
    snap = q.snapshot()                             # the checkpoint
    lost = q.take_fresh(2, worker="learner", current_version=0,
                        max_policy_lag=2)
    q.ack_trained(lost, worker="learner", current_version=0)
    clock.advance(5.0)
    q.push(traj(1, ticket="b0"))                    # after the checkpoint
    q.rewind(snap)
    assert (q.pushed, q.trained, q.pending) == (5, 2, 3)
    got = q.take_fresh(3, worker="learner", current_version=1,
                       max_policy_lag=2)
    assert [t.ticket for _, t in got] == ["a2", "a3", "b0"]
    assert q.q.enqueued_at(got[-1][0]) == 5.0


def test_trajectory_item_roundtrip_is_jsonable():
    t = Trajectory(ticket="r1", prompt=(np.int32(1), 2),
                   tokens=(np.int32(7),), reward=np.float32(0.5),
                   policy_version=3, actor="a0")
    item = t.to_item()
    json.dumps(item)                                # checkpoint-manifest safe
    assert Trajectory.from_item(item) == Trajectory(
        ticket="r1", prompt=(1, 2), tokens=(7,), reward=0.5,
        policy_version=3, actor="a0")


def test_nack_preserves_enqueued_at():
    clock = FakeClock()
    q = WorkQueue(lease_timeout=10.0, clock=clock)
    clock.advance(5.0)
    tid = q.put("traj")
    clock.advance(1.0)
    assert q.lease("w1")[0] == tid
    clock.advance(2.0)
    assert q.nack(tid, "w1")                    # early return at t=8
    assert q.enqueued_at(tid) == 5.0            # NOT reset to nack time
    assert q.lease("w2")[0] == tid              # re-leased by a survivor
    assert q.enqueued_at(tid) == 5.0


def test_lease_expiry_reclaim_preserves_enqueued_at():
    clock = FakeClock()
    q = WorkQueue(lease_timeout=10.0, clock=clock)
    clock.advance(3.0)
    tid = q.put("traj")
    q.lease("w1")
    clock.advance(11.0)                         # w1 died; lease expired
    got = q.lease("w2")                         # reclaim happens here
    assert got is not None and got[0] == tid
    assert q.enqueued_at(tid) == 3.0            # survives the reclaim


def test_leased_counts_live_leases_only():
    clock = FakeClock()
    q = WorkQueue(["a", "b", "c"], lease_timeout=10.0, clock=clock)
    q.lease("w1")
    q.lease("w2")
    assert (q.leased, q.pending) == (2, 1)
    clock.advance(11.0)                         # both leases expired
    assert q.leased == 0


def test_staleness_bound_property():
    """Actors holding versions v-k feed a learner at version v: whatever
    the push/bump interleaving, nothing older than max_policy_lag is
    ever trained on, and every drop lands on the stale meter."""
    pytest.importorskip("hypothesis", reason="optional dev dependency")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(lag=st.integers(min_value=0, max_value=3),
           events=st.lists(
               st.one_of(st.tuples(st.just("push"),
                                   st.integers(min_value=0, max_value=5)),
                         st.tuples(st.just("bump"), st.just(0))),
               min_size=1, max_size=40))
    def prop(lag, events):
        reg = Registry()
        q = RolloutQueue(registry=reg)
        version = 0
        pushed = []
        for kind, k in events:
            if kind == "bump":
                version += 1
            else:                       # an actor holding version - k
                v = max(version - k, 0)
                pushed.append(v)
                q.push(traj(v, ticket=f"t{len(pushed)}"))
        held = q.take_fresh(len(pushed) + 1, worker="learner",
                            current_version=version, max_policy_lag=lag)
        q.ack_trained(held, worker="learner", current_version=version)
        expect_stale = sum(1 for v in pushed if version - v > lag)
        assert q.max_lag_trained() <= lag
        assert all(version - t.policy_version <= lag for _, t in held)
        assert q.stale_dropped == expect_stale
        assert q.trained == len(pushed) - expect_stale
        assert reg.series("rl/stale_dropped").total == expect_stale
        assert reg.series("rl/trained_rollouts").total == q.trained

    prop()


# ----------------------------------------------------------- policy store
TREE = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": np.float32(2.5),
        "h": (np.arange(8, dtype=np.float32) / 3).astype(jnp.bfloat16)}


def _files(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_policy_store_files_equal_jax_in_both_directions(tmp_path):
    """A policy published by the port is fetched by the JAX store and one
    published by JAX by the port, leaf for leaf equal; the two stores'
    files are the same bytes."""
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    tree = bridge.to_torch(TREE, device="cpu")
    PolicyStore(ObjectStore(str(port_root))).publish(1, tree, step=4)
    JPolicyStore(JStore(str(jax_root))).publish(
        1, jax.tree.map(jnp.asarray, TREE), step=4)
    assert _files(port_root) == _files(jax_root)
    assert len(_files(port_root)) == 4              # 3 leaves + manifest

    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            TREE)
    got, version = JPolicyStore(JStore(str(port_root))).fetch(abstract)
    assert version == 1
    for k in TREE:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(TREE[k], np.float32))
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}
    got, version = PolicyStore(ObjectStore(str(jax_root))).fetch(
        meta, device="cpu")
    assert version == 1
    for k in TREE:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k]), k


def test_policy_store_roundtrip(tmp_path):
    reg = Registry()
    store = ObjectStore(str(tmp_path))
    pub = PolicyStore(store, registry=reg)
    assert pub.latest_version() == -1
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    pub.publish(1, {"w": w}, step=4)
    pub.publish(2, {"w": w * 2}, step=8)
    sub = PolicyStore(store)                # a separate subscriber view
    assert sub.latest_version() == 2
    got, version = sub.fetch({"w": torch.empty(2, 3, device="meta")},
                             device="cpu")
    assert version == 2                     # learner_step must NOT clobber it
    assert torch.equal(got["w"], w * 2)
    assert reg.series("rl/weights_published").total == 2


def test_policy_store_empty_fetch(tmp_path):
    sub = PolicyStore(ObjectStore(str(tmp_path)))
    got, version = sub.fetch({"w": torch.empty(1, device="meta")},
                             device="cpu")
    assert got is None and version == -1


def test_policy_store_defaults_to_the_card(tmp_path, monkeypatch):
    PolicyStore(ObjectStore(str(tmp_path))).publish(
        1, {"w": torch.ones(2)}, step=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyStore(ObjectStore(str(tmp_path))).fetch(
            {"w": torch.empty(2, device="meta")})


# ------------------------------------------------------------ loss, steps
def _cfgs():
    return jreg.get_smoke(ARCH).replace(**F32), \
        treg.get_smoke(ARCH).replace(**F32)


def _rl_batch(cfg, B=3, S=16, seed=0, K=None):
    """A batch as the learner encodes one: prompts of 5, generations to
    the end of the row or shorter, one row with a zero advantage."""
    rng = np.random.RandomState(seed)
    shape = (B, S) if K is None else (K, B, S)
    tokens = rng.randint(1, cfg.vocab_size, shape).astype(np.int32)
    labels = rng.randint(1, cfg.vocab_size, shape).astype(np.int32)
    mask = np.zeros(shape, np.float32)
    mask[..., 4:S - 2] = 1.0
    mask[..., 1, S - 6:] = 0.0
    adv = rng.standard_normal(shape[:-1]).astype(np.float32)
    adv[..., 2] = 0.0
    return {"tokens": tokens, "labels": labels, "mask": mask,
            "advantages": adv}


@pytest.fixture(scope="module")
def jax_init():
    jcfg, _ = _cfgs()
    schema = jtfm.lm_schema(jcfg)
    p = jpr.init_params(schema, jax.random.key(0), "float32")
    o = jpr.init_params(jadamw.opt_state_schema(schema, JOpt(**SCHEDULE)),
                        jax.random.key(1), "float32")
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o)


def _walk(want, got, check, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _walk(want[k], got[k], check, f"{path}/{k}")
        return
    check(np.asarray(want, np.float32), got.detach().float().numpy(), path)


def test_rl_loss_fn_and_grads_match_jax(jax_init):
    jcfg, tcfg = _cfgs()
    batch = _rl_batch(tcfg)
    ctx = ModelCtx(jcfg, jreg.get_parallel(ARCH), None)
    jl, jg = jax.value_and_grad(lambda q: jtfm.rl_loss_fn(
        ctx, q, {k: jnp.asarray(v) for k, v in batch.items()}))(
            jax.tree.map(jnp.asarray, jax_init[0]))
    tp = bridge.to_torch(jax_init[0], device="cpu")
    par = treg.get_parallel(ARCH)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tg = tsteps._value_and_grad(tcfg, par, tp, tb, ttfm.rl_loss_fn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)

    def rel(want, got, path):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), path
    _walk(jax.tree.map(np.asarray, jg), tg, rel)

    # labels under a zero weight (mask 0 or advantage 0) move nothing
    zero = (batch["mask"] * batch["advantages"][:, None]) == 0
    moved = dict(tb, labels=torch.where(torch.as_tensor(zero),
                                        (tb["labels"] + 7) % tcfg.vocab_size,
                                        tb["labels"]))
    ml, mg = tsteps._value_and_grad(tcfg, par, tp, moved, ttfm.rl_loss_fn)
    assert zero.sum() > 0 and float(ml) == float(tl)
    _walk(bridge.to_numpy(tg), mg,
          lambda want, got, path: np.testing.assert_array_equal(got, want,
                                                                err_msg=path))


def test_rl_train_chunk_matches_jax(jax_init):
    """K=2 steps in one chunk against the JAX ``build_rl_train_chunk``."""
    jcfg, tcfg = _cfgs()
    batches = _rl_batch(tcfg, K=2)
    par, mesh = jreg.get_parallel(ARCH), single_device_mesh()
    fn = jsteps.build_rl_train_chunk(
        jcfg, par, JOpt(**SCHEDULE), mesh, ShapeConfig("rl", 16, 3, "train"),
        2).jit()
    with mesh:
        jp, jo, jms = fn(jax.tree.map(jnp.asarray, jax_init[0]),
                         jax.tree.map(jnp.asarray, jax_init[1]),
                         {k: jnp.asarray(v) for k, v in batches.items()})
    tp, topt, tms = tsteps.rl_train_chunk(
        tcfg, treg.get_parallel(ARCH), OptimizerConfig(**SCHEDULE),
        bridge.to_torch(jax_init[0], device="cpu"),
        bridge.to_torch(jax_init[1], device="cpu"), batches, device="cpu")
    assert tms["loss"].shape == (2,)
    np.testing.assert_allclose(tms["loss"].numpy(), np.asarray(jms["loss"]),
                               rtol=1e-5)
    _walk(jax.tree.map(np.asarray, jp), tp,
          lambda want, got, path: np.testing.assert_allclose(
              got, want, rtol=0, atol=2e-4, err_msg=path))
    assert int(topt["count"]) == int(jo["count"]) == 2


def test_rl_batch_specs_name_what_the_chunk_moves():
    specs = tsteps.rl_batch_specs(3, 16)
    assert tuple(specs) == tsteps.RL_KEYS
    assert {k: (tuple(v.shape), v.dtype) for k, v in specs.items()} == {
        "tokens": ((3, 16), torch.int32), "labels": ((3, 16), torch.int32),
        "mask": ((3, 16), torch.float32), "advantages": ((3,), torch.float32)}
    _, tcfg = _cfgs()
    lm_only = {k: v for k, v in _rl_batch(tcfg, K=1).items()
               if k in ("tokens", "labels")}
    with pytest.raises(KeyError, match="mask"):
        tsteps.rl_train_chunk(tcfg, treg.get_parallel(ARCH),
                              OptimizerConfig(**SCHEDULE), {}, {}, lm_only,
                              device="cpu")


# -------------------------------------------------------------- learner
STEPS, BATCH, SEQ = 6, 2, 12


def _trajectories(cfg, n=STEPS * BATCH, seed=5):
    rng = np.random.RandomState(seed)
    return [Trajectory(ticket=f"t{i}",
                       prompt=tuple(rng.randint(1, cfg.vocab_size, 5)),
                       tokens=tuple(rng.randint(1, cfg.vocab_size,
                                                3 + i % 6)),
                       reward=float(rng.uniform()), policy_version=0)
            for i in range(n)]


def _spec_kw(**kw):
    return dict(dict(steps=STEPS, seq_len=SEQ, batch=BATCH, device_steps=2,
                     ckpt_every=2, broadcast_every=2, max_policy_lag=3,
                     keep=None, drain_timeout_s=20.0), **kw)


def _port_learner(root, init, **kw):
    _, tcfg = _cfgs()
    rollouts = RolloutQueue()
    for t in _trajectories(tcfg):
        rollouts.push(t)
    store = ObjectStore(str(root))
    spec = RLLearnerSpec(tcfg, treg.get_parallel(ARCH),
                         OptimizerConfig(**SCHEDULE), device="cpu",
                         **_spec_kw(**kw))
    return RLLearner(spec, rollouts, PolicyStore(store), store=store,
                     init=(bridge.to_torch(init[0], device="cpu"),
                           bridge.to_torch(init[1], device="cpu")))


@pytest.fixture(scope="module")
def port_clean(tmp_path_factory, jax_init):
    learner = _port_learner(tmp_path_factory.mktemp("clean"), jax_init)
    out = learner.run_supervised()
    return learner, out


def test_encode_equals_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    trajs = _trajectories(tcfg, n=4) + [
        Trajectory("long", tuple(range(1, 9)), tuple(range(20, 40)), 0.3, 0),
        Trajectory("empty", (4,), (), 1.0, 0)]
    store = JStore(str(tmp_path))
    jl = JLearner(JLearnerSpec(jcfg, jreg.get_parallel(ARCH),
                               JOpt(**SCHEDULE), steps=1, seq_len=SEQ,
                               batch=len(trajs)),
                  JRolloutQueue(), JPolicyStore(store), store=store)
    tl = RLLearner(RLLearnerSpec(tcfg, treg.get_parallel(ARCH),
                                 OptimizerConfig(**SCHEDULE), steps=1,
                                 seq_len=SEQ, batch=len(trajs),
                                 device="cpu"),
                   RolloutQueue(), PolicyStore(ObjectStore(str(tmp_path))),
                   store=ObjectStore(str(tmp_path)))
    want, got = jl.encode(trajs), tl.encode(trajs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_learner_losses_match_jax(tmp_path, jax_init, port_clean):
    """A fixed list of trajectories, no actors, the same initial state:
    the port's learner and the JAX learner take the same steps."""
    jcfg, _ = _cfgs()
    rollouts = JRolloutQueue()
    for t in _trajectories(jcfg):
        rollouts.push(t)
    store = JStore(str(tmp_path))
    jl = JLearner(JLearnerSpec(jcfg, jreg.get_parallel(ARCH),
                               JOpt(**SCHEDULE), **_spec_kw()),
                  rollouts, JPolicyStore(store), store=store)
    jl._init_state = lambda: tuple(jax.tree.map(jnp.asarray, s)
                                   for s in jax_init)
    jout = jl.run_supervised()
    learner, out = port_clean
    assert out["done"] and jout["done"]
    np.testing.assert_allclose(learner.report.losses, jl.report.losses,
                               rtol=1e-5)
    rep, jrep = learner.report, jl.report
    assert (rep.steps_done, rep.publishes, rep.final_version,
            rep.host_syncs) == (jrep.steps_done, jrep.publishes,
                                jrep.final_version, jrep.host_syncs) == \
        (STEPS, 3, 3, 3)
    assert len(rep.grad_norms) == len(rep.chunk_s) * 2 == STEPS
    assert learner.rollouts.trained == STEPS * BATCH
    assert learner.rollouts.lag_trained == jl.rollouts.lag_trained
    # the learner's last save and the final policy, in the JAX layout
    jck = JCheckpointer(JStore(str(learner.ckpt.store.root)),
                        prefix=f"rl/{learner.name}", keep=None)
    assert jck.all_steps() == [1, 3, 5]
    assert learner.policies.latest_version() == 3


def test_crash_and_resume_repeats_the_clean_losses(tmp_path, jax_init,
                                                   port_clean):
    """Chunks of 2, a checkpoint every 4 steps: a crash after the chunk of
    steps 4-5 restores step 3, rewinds the rollouts to that checkpoint
    and repeats steps 4-5 on the same rollouts: every loss bit for bit
    the clean run's."""
    clean = port_clean[0].report.losses
    learner = _port_learner(tmp_path, jax_init, fail_at=4, ckpt_every=4)
    out = learner.run_supervised()
    rep = learner.report
    assert out["done"] and rep.recoveries == 1
    assert [(s["start"], s["end"], s["outcome"]) for s in rep.segments] == \
        [(0, 5, "failed"), (4, 5, "done")]
    assert rep.steps_lost == 2 <= learner.spec.ckpt_every
    assert rep.losses == clean + clean[4:]
    assert learner.rollouts.trained == STEPS * BATCH
    assert learner.rollouts.pending == 0


def test_jax_learner_crash_trains_on_later_rollouts(tmp_path, jax_init,
                                                    port_clean):
    """The JAX learner's fault the port does not copy: its crash loop
    restores the checkpoint but not the rollout queue, so the re-executed
    steps 4-5 drain the next rollouts (the lost steps' ones were acked)
    and their losses are not the clean run's (ROADMAP queue C)."""
    jcfg, _ = _cfgs()
    rollouts = JRolloutQueue()
    for t in _trajectories(jcfg, n=(STEPS + 2) * BATCH):
        rollouts.push(t)
    store = JStore(str(tmp_path))
    jl = JLearner(JLearnerSpec(jcfg, jreg.get_parallel(ARCH),
                               JOpt(**SCHEDULE),
                               **_spec_kw(fail_at=4, ckpt_every=4)),
                  rollouts, JPolicyStore(store), store=store)
    jl._init_state = lambda: tuple(jax.tree.map(jnp.asarray, s)
                                   for s in jax_init)
    jl.run_supervised()
    clean = port_clean[0].report.losses
    got = jl.report.losses
    assert len(got) == STEPS + 2 and jl.report.steps_lost == 2
    np.testing.assert_allclose(got[:STEPS], clean, rtol=1e-5)
    assert not np.allclose(got[STEPS:], clean[4:], rtol=1e-3)
    assert rollouts.trained == (STEPS + 2) * BATCH and rollouts.pending == 0


def test_crash_before_any_checkpoint_restarts_from_the_start(tmp_path,
                                                             jax_init,
                                                             port_clean):
    clean = port_clean[0].report.losses
    learner = _port_learner(tmp_path, jax_init, fail_at=0, ckpt_every=4)
    learner.run_supervised()
    rep = learner.report
    assert [(s["start"], s["outcome"]) for s in rep.segments] == \
        [(0, "failed"), (0, "done")]
    assert rep.steps_lost == 2
    assert rep.losses == clean[:2] + clean


# ------------------------------------------------------ fleet and CLI
class StubHandle:
    """The JAX Handle's surface as the runners use it."""

    def __init__(self):
        self.probes, self.states, self.hooks = {}, [], []
        self.cancelled = False

    def probe(self, name, fn):
        self.probes[name] = fn

    def _transition(self, state, **detail):
        self.states.append((state, detail))

    def add_cancel_hook(self, hook):
        self.hooks.append(hook)

    def should_stop(self):
        return self.cancelled


def test_rl_fleet_end_to_end_with_a_handle(tmp_path):
    """Two actors + learner: completes inside the staleness bound, every
    actor observes >= 1 published version, and the handle sees the
    probes and the RUNNING transition (the JAX cluster e2e's contract)."""
    job = RLJob(name="rl-e2e", learner_steps=2, actors=2,
                rollouts_per_step=2, prompt_len=4, max_new_tokens=4,
                seq_len=12, slots=2, max_policy_lag=2, broadcast_every=1,
                ckpt_every=2)
    handle = StubHandle()
    out = run_rl_fleet(handle, job, learner_store=ObjectStore(str(tmp_path)),
                       metrics=Registry(), device="cpu")
    assert out["done"] and out["steps_done"] == 2
    assert out["trained"] == 4
    assert out["max_lag_trained"] <= job.max_policy_lag
    assert out["min_actor_syncs"] >= 1
    assert out["final_version"] >= 1
    assert out["steps_lost"] == 0
    assert handle.states == [("Running", {"actors": 2, "steps": 2})]
    assert handle.probes["learner_step"]() == 2
    assert handle.probes["rollouts_trained"]() == 4
    assert len(handle.hooks) == 1


def test_cli_declares_the_jax_rl_job():
    """The port's flags and defaults build the JAX CLI's RLJob, field for
    field (the port's job leaves out the tenant and fabric routing)."""
    import dataclasses
    from repro.launch.rl import rl_job as j_rl_job
    from repro_torch.launch import rl
    kw = dict(learner_steps=5, fail_at=2, slots=3)
    got, want = rl.rl_job(ARCH, **kw), j_rl_job(ARCH, **kw)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    from repro.api import RLJob as JRLJob
    from repro.launch import rl as jrl
    defaults = _flag_defaults(lambda: rl.main([]))
    assert defaults.pop("device") == "cuda"
    assert defaults == _flag_defaults(jrl.main)
    jfields = {g.name: g.default for g in dataclasses.fields(JRLJob)}
    for f in dataclasses.fields(RLJob):
        assert f.default == jfields[f.name], f.name


def _flag_defaults(main):
    """{flag: default} of the parser ``main`` builds, without running it."""
    import argparse
    seen = {}

    class Stop(Exception):
        pass

    def parse(self, *a, **k):
        seen.update((x.dest, x.default) for x in self._actions
                    if x.dest != "help")
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(Stop):
            main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


def test_cli_runs_the_smoke_manifest(capsys):
    """``examples/manifests/rl_smoke.json`` through the port's CLI: the
    contract of the JAX cluster end-to-end test."""
    from repro_torch.launch import rl
    rl.main(["--device", "cpu", "--manifest",
             "examples/manifests/rl_smoke.json"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[rl] steps 4/4 version ")
    fields = line.split()
    got = dict(zip(fields[3::2], fields[4::2]))
    assert int(got["trained"]) == 4 * 2
    assert int(got["max_lag"]) <= 2 and int(got["lost"]) == 0
    assert int(got["version"]) >= 1
    assert int(line.rsplit("actor_syncs>=", 1)[1]) >= 1


def test_cli_raises_without_a_card_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.launch import rl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.main(["--smoke", "--learner-steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RLLearner(RLLearnerSpec(_cfgs()[1], treg.get_parallel(ARCH),
                                OptimizerConfig(), steps=1, seq_len=4,
                                batch=1),
                  RolloutQueue(), None, store=None)
