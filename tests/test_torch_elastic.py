"""The port's training runtime against the JAX package's: checkpoints,
elastic recovery and node churn.

phi4-mini smoke config with two stacked layers, on the CPU (the port
through the plain versions of its xent and AdamW kernels).  Parity runs
are in f32 with a fixed schedule (warmup 1, decay over 100 steps) on both
sides, so a run cut at step 1 and resumed does not change its schedule.

Tolerances:
  * checkpoints of the same state: the same manifest and the same bytes in
    every shard file, bf16 and f32;
  * a run resumed across the two stacks against the other stack's
    uninterrupted run, f32: losses 1e-5 relative; params, m and v as
    tests/test_torch_train.py holds 3 JAX steps (2e-4 absolute on params
    at lr 1e-3 — Adam's step is lr where |g| is near eps; moments 1e-3
    relative + 2e-5 / 1e-6 absolute); count exact;
  * within the port: a crash-and-resume run and a chunked run repeat the
    clean run's losses bit for bit (same arithmetic, same order); a churn
    run changes the accumulation and so the order of the sums: 1e-5
    relative.
"""
import json
import pathlib
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.core.elastic import rescale_plan as j_rescale_plan   # noqa: E402
from repro.core.orchestrator import Cluster as JCluster         # noqa: E402
from repro.data.objectstore import ObjectStore as JStore        # noqa: E402
from repro.elastic import ChurnController as JController        # noqa: E402
from repro.elastic import ElasticTrainer as JTrainer            # noqa: E402
from repro.elastic import ElasticTrainSpec as JSpec             # noqa: E402
from repro.elastic import batch_plan as j_batch_plan            # noqa: E402
from repro.elastic.trainer import chunk_schedule as j_chunk_schedule  # noqa: E402
from repro.elastic.trainer import snap_cadence as j_snap_cadence  # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer      # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.core.elastic import rescale_plan               # noqa: E402
from repro_torch.core.orchestrator import (Cluster, JobSpec, Pod,  # noqa: E402
                                           PodCtx, PodState)
from repro_torch.data.objectstore import ObjectStore            # noqa: E402
from repro_torch.data.tokens import ChunkPrefetcher, TokenPipeline  # noqa: E402
from repro_torch.elastic import (ChurnController, ElasticTrainer,  # noqa: E402
                                 ElasticTrainSpec, batch_plan)
from repro_torch.elastic import trainer as trainer_mod          # noqa: E402
from repro_torch.elastic.trainer import chunk_schedule, snap_cadence  # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32", num_layers=2)
SCHEDULE = dict(warmup_steps=1, decay_steps=100)
RUN = dict(steps=6, seq_len=32, global_batch=4, base_shape=(1, 1),
           max_data=1, ckpt_every=2, keep=None, log_every=100,
           verbose=False)
PARAMS = dict(rtol=0, atol=2e-4)
M_TOL = dict(rtol=1e-3, atol=2e-5)
V_TOL = dict(rtol=1e-3, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Each training segment is a new thread, and each new thread that
    runs torch's CPU ops starts its own OpenMP team of every core: with
    several test workers on one machine those teams spin against each
    other and a smoke run takes 20 times as long.  Two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port_spec(**kw):
    cfg = treg.get_smoke(ARCH).replace(**F32)
    return ElasticTrainSpec(cfg, treg.get_parallel(ARCH),
                            OptimizerConfig(**SCHEDULE),
                            **{**RUN, "device": "cpu", **kw})


def _port_run(root, *, cluster=None, **kw):
    trainer = ElasticTrainer(cluster or Cluster(devices=["slot0"]),
                             _port_spec(**kw), store=ObjectStore(str(root)))
    return trainer.run()


def _jax_run(root, **kw):
    cfg = jreg.get_smoke(ARCH).replace(**F32)
    spec = JSpec(cfg, jreg.get_parallel(ARCH), JOpt(**SCHEDULE),
                 **{**RUN, **kw})
    return JTrainer(JCluster(devices=jax.devices()), spec,
                    store=JStore(str(root))).run()


def _only_step(src, dst, step):
    """A store holding only ``src``'s checkpoint of ``step``."""
    name = f"checkpoints/step_{step:010d}"
    shutil.copytree(pathlib.Path(src) / name, pathlib.Path(dst) / name)
    return dst


@pytest.fixture(scope="module")
def jax_full(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_full")
    return root, _jax_run(root)


@pytest.fixture(scope="module")
def port_full(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_full")
    return root, _port_run(root)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


def _walk(want, got, tol, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _walk(want[k], got[k], tol, f"{path}/{k}")
        return
    np.testing.assert_allclose(_np(got), _np(want), err_msg=path, **tol)


def _check_resumed(resumed, reference):
    """``resumed`` ran steps 2..5 from a step-1 checkpoint of the other
    stack; ``reference`` ran 0..5 uninterrupted."""
    got, want = resumed["loss_by_step"], reference["loss_by_step"]
    assert sorted(got) == [2, 3, 4, 5]
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(got)], rtol=1e-5)
    _walk(reference["params"], resumed["params"], PARAMS)
    _walk(reference["opt"]["m"], resumed["opt"]["m"], M_TOL)
    _walk(reference["opt"]["v"], resumed["opt"]["v"], V_TOL)
    assert int(resumed["opt"]["count"]) == int(reference["opt"]["count"]) == 6


# ---------------------------------------------------------- same layout

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_files_are_byte_identical_to_jax(tmp_path, dtype):
    """phi4 smoke params from JAX ``init_params`` and the AdamW state after
    one port step, saved by both checkpointers: same manifest, same bytes."""
    jcfg = jreg.get_smoke(ARCH)
    tcfg = treg.get_smoke(ARCH).replace(param_dtype=dtype)
    jparams = jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(0), dtype)
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    ocfg = OptimizerConfig(**SCHEDULE)
    opt = tsteps.init_opt_state(tcfg, ocfg, device="cpu")
    params, opt, _ = tsteps.train_step(
        tcfg, treg.get_parallel(ARCH), ocfg, params, opt,
        TokenPipeline(tcfg.vocab_size, 16, 2, seed=3).batch(0), device="cpu")
    state = {"params": params, "opt": opt}
    # the bf16 leaves come back as JAX's bfloat16 (the moments are f32)
    jstate = jax.tree.map(jnp.asarray, bridge.to_numpy(
        state, like={"params": jparams, "opt": None}))
    JCheckpointer(JStore(str(tmp_path / "jax")), keep=None).save(
        1, jstate, extra={"note": "x"})
    Checkpointer(ObjectStore(str(tmp_path / "port")), keep=None).save(
        1, state, extra={"note": "x"})
    files = {side: {p.relative_to(tmp_path / side): p.read_bytes()
                    for p in sorted((tmp_path / side).rglob("*"))
                    if p.is_file()} for side in ("jax", "port")}
    assert sorted(files["jax"]) == sorted(files["port"])
    assert len(files["jax"]) == 3 * len(tpr.leaves(ttfm.lm_schema(tcfg))) + 2
    for key, data in files["jax"].items():
        assert files["port"][key] == data, key
    manifest = json.loads(files["port"][pathlib.Path(
        "checkpoints/step_0000000001/MANIFEST.json")])
    dtypes = {e["key"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes["params/embed"] == dtype
    assert dtypes["opt/m/embed"] == "float32"
    assert dtypes["opt/count"] == "int32"
    assert "params/blocks/0_attn/wq" in dtypes


def test_restore_is_bit_exact_and_casts_to_the_schema(tmp_path):
    ck = Checkpointer(ObjectStore(str(tmp_path)), keep=None)
    gen = torch.Generator().manual_seed(0)
    tree = {"b": {"w": torch.randn(3, 5, generator=gen).to(torch.bfloat16)},
            "a": torch.randn(7, generator=gen),
            "n": torch.tensor(5, dtype=torch.int32)}
    ck.save(4, tree)
    got = ck.restore(4, tree, device="cpu")
    for key in ("a", "n"):
        assert torch.equal(got[key], tree[key])
    assert torch.equal(got["b"]["w"].view(torch.int16),
                       tree["b"]["w"].view(torch.int16))
    as_f32 = ck.restore(4, {"b": {"w": torch.empty(3, 5, device="meta")},
                            "a": tree["a"], "n": tree["n"]}, device="cpu")
    assert as_f32["b"]["w"].dtype == torch.float32
    assert torch.equal(as_f32["b"]["w"], tree["b"]["w"].float())
    assert ck.saves[0]["bytes"] == 3 * 5 * 2 + 7 * 4 + 4
    assert ck.restores[-1]["step"] == 4


# --------------------------------------------------- across the stacks

def test_port_resumes_a_jax_checkpoint(jax_full, tmp_path):
    """JAX writes step 1; the port's trainer resumes and runs to step 5,
    matching JAX's uninterrupted run."""
    root, ref = jax_full
    store = _only_step(root, tmp_path, 1)
    _check_resumed(_port_run(store), ref)


def test_jax_resumes_a_port_checkpoint(port_full, tmp_path):
    """The reverse: the port writes step 1, JAX's trainer resumes."""
    root, ref = port_full
    store = _only_step(root, tmp_path, 1)
    _check_resumed(_jax_run(store), ref)


# ------------------------------------------------------------ recovery

def test_crash_and_resume_repeats_the_clean_losses(port_full, tmp_path):
    """A crash inside chunk [2,3] at device_steps=2: the restored segment
    resumes from step 1's checkpoint, and every loss is the clean run's."""
    _, clean = port_full
    out = _port_run(tmp_path, device_steps=2, fail_at=3)
    rep = out["report"]
    outcomes = [s.outcome for s in rep.segments]
    assert outcomes[0] == "error" and outcomes[-1] == "done"
    assert rep.global_batch_constant
    assert rep.steps_executed == 6 and rep.steps_lost == 0
    assert out["losses"] == clean["losses"]


@pytest.mark.parametrize("device_steps", [3, 4])
def test_chunked_run_repeats_the_per_step_losses(port_full, tmp_path,
                                                  device_steps):
    _, clean = port_full
    out = _port_run(tmp_path, device_steps=device_steps)
    assert out["losses"] == clean["losses"]
    assert out["report"].host_syncs < clean["report"].host_syncs


def test_save_async_snapshots_before_an_in_place_step(tmp_path):
    """save_async at step k, then one more in-place AdamW step: restoring
    k gives step k's state, bit for bit."""
    cfg = treg.get_smoke(ARCH).replace(**F32)
    ocfg = OptimizerConfig(**SCHEDULE)
    params = tpr.init_params(ttfm.lm_schema(cfg),
                             torch.Generator().manual_seed(0), "float32",
                             "cpu")
    opt = tsteps.init_opt_state(cfg, ocfg, device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, 16, 2, seed=1)
    par = treg.get_parallel(ARCH)
    params, opt, _ = tsteps.train_step(cfg, par, ocfg, params, opt,
                                       pipe.batch(0), device="cpu")
    at_k = tsteps._map(torch.clone, {"params": params, "opt": opt})
    ck = Checkpointer(ObjectStore(str(tmp_path)), keep=None)
    ck.save_async(0, {"params": params, "opt": opt})
    params, opt, _ = tsteps.train_step(cfg, par, ocfg, params, opt,
                                       pipe.batch(1), device="cpu")
    ck.wait()
    assert not torch.equal(params["embed"], at_k["params"]["embed"])
    got = ck.restore(0, at_k, device="cpu")
    pairs = list(zip(tsteps.tree_leaves(got), tsteps.tree_leaves(at_k)))
    assert len(pairs) == 3 * len(tpr.leaves(ttfm.lm_schema(cfg))) + 1
    assert all(torch.equal(g, w) for g, w in pairs)


# --------------------------------------------------------------- churn

def test_churn_shrinks_and_grows_the_logical_mesh(tmp_path):
    """8 logical slots on a (4, 2) mesh, global batch 8.  A watcher fails
    two slots once training passes a step, then rejoins them: the run
    shrinks to (2, 2) with accumulation 2 and grows back to (4, 2), a loss
    for every step, the losses within 1e-5 of a run without churn."""
    steps, fail_after, rejoin_after = 10, 2, 6
    kw = dict(steps=steps, global_batch=8, base_shape=(4, 2), max_data=None,
              ckpt_every=1)
    clean = _port_run(tmp_path / "clean",
                      cluster=Cluster(devices=[f"slot{i}" for i in range(8)]),
                      **kw)
    cluster = Cluster(devices=[f"slot{i}" for i in range(8)])
    trainer = ElasticTrainer(cluster, _port_spec(**kw),
                             store=ObjectStore(str(tmp_path / "churn")))
    victims = cluster.devices[6:]
    seen = [-1]
    done = threading.Event()

    def watcher():
        phase = "fail"
        while not done.is_set():
            p = trainer.progress
            if phase == "fail" and p >= fail_after:
                for d in victims:
                    cluster.fail_node(d)
                phase = "join"
            elif phase == "join" and p >= rejoin_after and \
                    len(cluster.jobs) >= 2:
                for d in victims:
                    cluster.join_node(d)
                cluster.jobs[-1].pods[0].ctx.stop.wait(30)
                phase = "over"
            seen[0] = p
            time.sleep(0.002)

    real_chunk = trainer_mod.steps_mod.train_chunk

    def paced_chunk(cfg, par, ocfg, params, opt, batches, *, device):
        # each chunk waits until the watcher has seen the previous one, so
        # the churn lands while the run still has steps to take
        start = trainer.progress
        deadline = time.monotonic() + 30
        while seen[0] < start and time.monotonic() < deadline:
            time.sleep(0.001)
        return real_chunk(cfg, par, ocfg, params, opt, batches,
                          device=device)

    t = threading.Thread(target=watcher, daemon=True)
    t.start()
    try:
        trainer_mod.steps_mod.train_chunk = paced_chunk
        out = trainer.run()
    finally:
        trainer_mod.steps_mod.train_chunk = real_chunk
        done.set()
        t.join(timeout=10)
    assert not t.is_alive()
    rep = out["report"]
    shapes = [s.mesh_shape for s in rep.segments]
    assert shapes[0] == (4, 2) and (2, 2) in shapes and shapes[-1] == (4, 2)
    assert shapes.index((2, 2)) < len(shapes) - 1
    accums = {s.mesh_shape: s.accum_steps for s in rep.segments}
    assert accums == {(4, 2): 1, (2, 2): 2}
    assert rep.recoveries >= 1 and rep.global_batch_constant
    assert sorted(out["loss_by_step"]) == list(range(steps))
    np.testing.assert_allclose(out["losses"], clean["losses"], rtol=1e-5)


# ------------------------------------------------------------------ CLI

def test_cli_declares_the_jax_train_job(monkeypatch):
    """The port's CLI builds the spec the JAX CLI's TrainJob declares: the
    batches from data seed 17 (not ``--seed``), 2 checkpoints kept, a
    (1, 1) mesh, the same optimizer recipe."""
    from repro.api.runners import elastic_spec
    from repro.launch.train import train_job
    from repro_torch.launch import train

    seen = {}

    class Spy(ElasticTrainer):
        def __init__(self, cluster, spec, **kw):
            seen["spec"], seen["devices"] = spec, cluster.devices
            super().__init__(cluster, spec, **kw)

    # the CLI applies a TrainJob through a Session, whose cluster backend
    # builds the trainer
    monkeypatch.setattr(trainer_mod, "ElasticTrainer", Spy)
    kw = dict(steps=4, seq=16, batch=2, smoke=True, ckpt_every=2,
              log_every=3, device_steps=2)
    out = train.train(ARCH, device="cpu", **kw)
    want, got = elastic_spec(train_job(ARCH, **kw)), seen["spec"]
    for name in ("steps", "seq_len", "global_batch", "mesh_axes",
                 "base_shape", "max_data", "name", "namespace",
                 "ckpt_every", "keep", "log_every", "device_steps", "seed",
                 "data_seed", "fail_at", "backoff_limit"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("lr", "warmup_steps", "decay_steps", "schedule", "b1", "b2",
                 "eps", "weight_decay", "grad_clip", "accum_steps"):
        assert getattr(got.ocfg, name) == getattr(want.ocfg, name), name
    assert got.data_seed == 17 and seen["devices"] == [torch.device("cpu")]
    assert len(out["losses"]) == 4 and out["params"] is not None
    assert [s.outcome for s in out["report"].segments] == ["done"]


def test_cli_self_heals_an_injected_crash(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--smoke", "--device", "cpu", "--steps", "8", "--seq", "16",
                "--batch", "2", "--device-steps", "2", "--log-every", "4",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                "--fail-at", "5"])
    out = capsys.readouterr()
    assert out.out.startswith("[train] loss ") and "->" in out.out
    assert "segment 0 failed (attempt 1/2) -> restore + retry" in out.err
    assert "[elastic]" not in out.out
    ck = Checkpointer(ObjectStore(str(tmp_path)), keep=None)
    assert ck.all_steps() == [5, 7]                 # keep=2


# ---------------------------------------------------------- unit cases

def test_cadence_and_schedule_match_jax():
    for every in range(0, 9):
        for k in range(1, 6):
            assert snap_cadence(every, k) == j_snap_cadence(every, k)
    for start in range(0, 12):
        for k in range(1, 6):
            assert chunk_schedule(start, 11, k) == \
                j_chunk_schedule(start, 11, k)


def _plan(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except (RuntimeError, ValueError) as e:
        return type(e).__name__


def test_batch_and_rescale_plans_match_jax():
    for g in (1, 4, 8, 12, 16, 20, 24):
        for d in (1, 2, 3, 4, 8):
            for per in (None, 1, 2, 3, 5, 16):
                got = _plan(batch_plan, g, d, per_replica=per)
                want = _plan(j_batch_plan, g, d, per_replica=per)
                assert str(got) == str(want), (g, d, per)
    for axes, shape in ((("data", "model"), (4, 2)),
                        (("pod", "data", "model"), (2, 4, 2)),
                        (("data", "model"), (1, 1))):
        for n in range(0, 19):
            for cap in (None, 1, 2):
                got = _plan(rescale_plan, axes, shape, n, max_data=cap)
                want = _plan(j_rescale_plan, axes, shape, n, max_data=cap)
                assert str(got) == str(want), (axes, shape, n, cap)


def test_churn_controller_decides_as_jax():
    kw = dict(axes=("data", "model"), base_shape=(4, 2), global_batch=16)
    port, jx = Cluster(devices=list(range(8))), JCluster(devices=list(range(8)))
    pc, jc = ChurnController(port, **kw), JController(jx, **kw)
    active = (pc.decide(None), jc.decide(None))
    assert str(active[0]) == str(active[1])
    for event, dev in (("fail", 7), ("fail", 6), ("fail", 5), ("join", 5),
                       ("join", 6), ("join", 7), ("fail", 0)):
        for c in (port, jx):
            (c.fail_node if event == "fail" else c.join_node)(dev)
        assert str(pc.decide(None)) == str(jc.decide(None))
        assert str(pc.decide(active[0])) == str(jc.decide(active[1]))
    assert [e.kind for e in pc.events] == [e.kind for e in jc.events]


def test_cluster_and_spec_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster()
    spec_args = (treg.get_smoke(ARCH), treg.get_parallel(ARCH),
                 OptimizerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainSpec(*spec_args, steps=1)
    assert ElasticTrainSpec(*spec_args, steps=1, device="cpu").device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert Cluster().devices == [torch.device("cuda", 0),
                                 torch.device("cuda", 1)]
    assert ElasticTrainSpec(*spec_args, steps=1).device == "cuda"


@pytest.mark.parametrize("arch,match", [
    ("zamba2-2.7b", "ROADMAP queue B, item 7"),
    ("rwkv6-1.6b", "ROADMAP queue B, item 7"),
    ("granite-moe-1b-a400m", "ROADMAP queue B, item 8"),
])
def test_kinds_the_port_cannot_train_raise_unwrapped(tmp_path, arch, match):
    cfg = treg.get_smoke(arch)
    spec = ElasticTrainSpec(cfg, treg.get_parallel(arch), OptimizerConfig(),
                            steps=2, seq_len=8, global_batch=2,
                            max_data=1, verbose=False, device="cpu")
    trainer = ElasticTrainer(Cluster(devices=["slot0"]), spec,
                             store=ObjectStore(str(tmp_path)))
    with pytest.raises(NotImplementedError, match=match):
        trainer.run()
    assert len(trainer.cluster.jobs) == 1          # no retry


def test_unschedulable_segment_is_bounded(tmp_path):
    cluster = Cluster(devices=["slot0"])
    cluster.create_namespace("elastic", device_quota=0)
    trainer = ElasticTrainer(cluster, _port_spec(rejoin_timeout_s=0.5),
                             store=ObjectStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="unschedulable"):
        trainer.run()


def test_chunk_prefetcher_contract():
    pipe = TokenPipeline(97, 16, 2, seed=3)
    schedule = [(0, 2), (2, 2), (4, 1)]
    with ChunkPrefetcher(pipe, schedule, depth=2) as pf:
        for start, k in schedule:
            got_start, batches = pf.get()
            assert got_start == start and batches["tokens"].shape == (k, 2, 16)
            np.testing.assert_array_equal(batches["tokens"],
                                          pipe.chunk(start, k)["tokens"])
        with pytest.raises(StopIteration):
            pf.get()

    class Boom(TokenPipeline):
        def chunk(self, start, device_steps):
            raise ValueError("boom at chunk build")

    with ChunkPrefetcher(Boom(97, 16, 2), [(0, 2)], depth=1) as pf:
        with pytest.raises(ValueError, match="boom"):
            pf.get(timeout=10.0)
    pf = ChunkPrefetcher(pipe, [(i, 2) for i in range(0, 40, 2)], depth=1)
    pf.get()                     # consume one, leave the producer blocked
    pf.close()
    assert not pf._thread.is_alive()


# --------- orchestrator on logical slots (tests/test_system.py's and
# tests/test_vcluster.py's cases)

@pytest.fixture()
def slots():
    c = Cluster(devices=[f"slot{i}" for i in range(8)])
    c.create_namespace("default")
    return c


def _until_running(pod):
    for _ in range(500):
        if pod.state == PodState.RUNNING:
            return
        time.sleep(0.01)
    raise AssertionError(f"pod {pod.pod_id} never ran: {pod.state}")


def test_cluster_respawns_a_crashed_pod_up_to_its_backoff(slots):
    attempts = []

    def flaky(ctx):
        attempts.append(ctx.attempt)
        if ctx.attempt < 2:
            raise RuntimeError("pod crash")
        return "ok"

    job = slots.submit("default", JobSpec("flaky", flaky, backoff_limit=3))
    slots.wait(job, timeout=30)
    assert job.succeeded and job.pods[0].restarts == 2
    assert attempts == [0, 1, 2]
    dead = slots.submit("default", JobSpec("dead", lambda ctx: 1 / 0,
                                           backoff_limit=1))
    with pytest.raises(RuntimeError, match="failed after backoff"):
        slots.wait(dead, timeout=30)
    assert slots.metrics.summary()["pod_failures/default"]["total"] == 4


def test_cluster_quota_is_enforced_and_returned(slots):
    slots.create_namespace("tight", device_quota=4)
    with pytest.raises(RuntimeError, match="quota"):
        slots.submit("tight", JobSpec("big", lambda ctx: 1,
                                      devices_per_pod=6))
    for _ in range(3):
        job = slots.submit("tight", JobSpec(
            "j", lambda ctx: sorted(ctx.devices), replicas=2,
            devices_per_pod=2))
        slots.wait(job, timeout=30)
        assert job.succeeded
        assert len({d for r in job.results() for d in r}) == 4
    assert slots.namespaces["tight"].used_devices == 0 and not slots.leased


def test_fail_node_drains_and_reconcile_reallocates(slots):
    release = threading.Event()

    def fn(ctx):
        if ctx.attempt == 0:
            release.wait(timeout=10)   # stay RUNNING until drained
        return sorted(ctx.devices)

    job = slots.submit("default", JobSpec("train", fn, devices_per_pod=2))
    pod = job.pods[0]
    _until_running(pod)
    victim = pod.ctx.devices[0]
    slots.fail_node(victim)
    assert pod.state == PodState.FAILED and "NodeFailure" in pod.error
    assert pod.ctx.should_stop()
    assert victim not in slots.online_devices
    release.set()
    slots.wait(job, timeout=30)
    assert job.succeeded and pod.restarts == 1
    assert victim not in job.pods[0].ctx.devices
    slots.join_node(victim)
    assert len(slots.online_devices) == 8
    assert slots.namespaces["default"].used_devices == 0


def test_preempted_running_pod_is_never_respawned(slots):
    def cooperative(ctx):
        while not ctx.should_stop():
            time.sleep(0.005)
        return "stopped"

    job = slots.submit("default", JobSpec("victim", cooperative,
                                          devices_per_pod=2))
    pod = job.pods[0]
    _until_running(pod)
    assert slots.preempt_pod(pod, reason="test")
    pod.thread.join(timeout=10)
    assert pod.state == PodState.PREEMPTED and pod.result == "stopped"
    assert not slots.leased
    assert slots.reconcile() == 0
    assert not slots.preempt_pod(pod)             # already terminal


def test_preempted_pending_pod_never_runs(slots):
    ran = []
    pod = Pod("p0", lambda c: ran.append(1) or "never",
              PodCtx("p0", "default", [], slots.metrics))
    assert slots.preempt_pod(pod, reason="test")
    assert pod.state == PodState.PREEMPTED and pod.ctx.preempt.is_set()
    slots._start_pod(pod)                         # a stale start is fenced
    pod.thread.join(timeout=10)
    assert not ran and pod.result is None


def test_finish_preempt_hard_evicts_a_stuck_pod(slots):
    release = threading.Event()

    def stubborn(ctx):
        release.wait(10)                          # never polls should_stop
        return "late"

    job = slots.submit("default", JobSpec("stub", stubborn,
                                          devices_per_pod=2))
    pod = job.pods[0]
    _until_running(pod)
    assert not slots.finish_preempt(pod)          # not preempted yet
    assert slots.preempt_pod(pod)
    assert slots.finish_preempt(pod)
    assert pod.state == PodState.PREEMPTED and not slots.leased
    assert not slots.finish_preempt(pod)          # already evicted
    release.set()
    pod.thread.join(timeout=10)
    assert pod.state == PodState.PREEMPTED and pod.result == "late"


def test_retire_pod_takes_a_failed_pod_out_of_reconcile(slots):
    job = slots.submit("default", JobSpec("dead", lambda ctx: 1 / 0,
                                          backoff_limit=3))
    pod = job.pods[0]
    pod.thread.join(timeout=10)
    assert pod.state == PodState.FAILED
    assert slots.retire_pod(pod) and pod.state == PodState.PREEMPTED
    assert not slots.retire_pod(pod)
    assert slots.reconcile() == 0 and pod.restarts == 0


def test_fail_all_nodes_drains_device_less_pods_too(slots):
    release = threading.Event()
    jobs = [slots.submit("default", JobSpec(name, lambda ctx: release.wait(10),
                                            devices_per_pod=n,
                                            backoff_limit=0))
            for name, n in (("gpu", 2), ("cpu", 0))]
    for job in jobs:
        _until_running(job.pods[0])
    slots.fail_all_nodes()
    assert not slots.online_devices and not slots.leased
    assert [j.pods[0].state for j in jobs] == [PodState.FAILED] * 2
    assert "NodeFailure" in jobs[1].pods[0].error
    assert slots.metrics.summary()["node_drained_pods"]["total"] == 2
    release.set()
    for job in jobs:
        job.pods[0].thread.join(timeout=10)


# ------------------- checkpoint GC and keep (tests/test_system.py's cases)

@pytest.fixture()
def store(tmp_path):
    return ObjectStore(str(tmp_path / "store"))


def _ones(n=2):
    return {"x": torch.ones(n)}


def test_checkpoint_roundtrip_and_gc(store):
    ck = Checkpointer(store, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        ck.save(step, tree, extra={"loss": 0.5})
    assert ck.all_steps() == [2, 3]
    restored, meta = ck.restore_latest(tree, device="cpu")
    assert meta["step"] == 3 and meta["loss"] == 0.5
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_async_and_atomic_commit(store):
    ck = Checkpointer(store, keep=5)
    ck.save_async(1, _ones(3))
    ck.wait()
    assert ck.latest_step() == 1
    # a crashed save: shard written, no manifest — invisible to resume
    store.put_array("checkpoints/step_0000000002/x/shard0.npy", np.ones(3))
    assert ck.latest_step() == 1


def test_checkpoint_keep_semantics(store):
    ck0 = Checkpointer(store, prefix="k0", keep=0)
    ck0.save(1, _ones())
    assert ck0.all_steps() == []
    ck_off = Checkpointer(store, prefix="koff", keep=None)
    for s in (1, 2, 3, 4, 5):
        ck_off.save(s, _ones())
    assert ck_off.all_steps() == [1, 2, 3, 4, 5]


def test_checkpoint_gc_deletes_manifest_first(store):
    deleted = []
    orig = store.delete

    def spy(key):
        deleted.append(key)
        return orig(key)

    store.delete = spy
    ck = Checkpointer(store, keep=1)
    ck.save(1, _ones())
    ck.save(2, _ones())                      # GCs step 1
    gc_keys = [k for k in deleted if "step_0000000001" in k]
    assert gc_keys and gc_keys[0].endswith("MANIFEST.json")


def test_checkpoint_gc_sweeps_orphaned_shards(store):
    ck = Checkpointer(store, keep=1)
    ck.save(1, _ones())
    store.put_array("checkpoints/step_0000000000/x/shard0.npy", np.ones(2))
    store.put_array("checkpoints/step_0000000004/x/shard0.npy", np.ones(2))
    ck.save(3, _ones())
    assert not store.list("checkpoints/step_0000000000/")   # swept
    assert store.list("checkpoints/step_0000000004/")       # untouched


def test_checkpoint_gc_vs_concurrent_restore_latest(store):
    ck = Checkpointer(store, keep=1)
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    ck.save(0, tree)
    stop = threading.Event()
    errors = []

    def reader():
        reader_ck = Checkpointer(store, keep=1)
        while not stop.is_set():
            try:
                restored, _ = reader_ck.restore_latest(tree, device="cpu")
                assert torch.equal(restored["w"], tree["w"])
            except Exception as e:     # pragma: no cover - failure capture
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for s in range(1, 40):             # each save GCs the previous step
        ck.save(s, tree)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]


# --------------------- ObjectStore paths (tests/test_objectstore.py's cases)

def test_store_rejects_escapes_and_allows_interior_dotdot(store, tmp_path):
    with pytest.raises(ValueError, match="escapes"):
        store.put("../outside", b"x")
    (tmp_path / "store2").mkdir()
    (tmp_path / "store2" / "leak").write_bytes(b"secret")
    with pytest.raises(ValueError, match="escapes"):
        store.get("../store2/leak")
    with pytest.raises(ValueError, match="escapes"):
        store.put("a/../../store2/new", b"x")
    store.put("a/b/../c", b"x")
    assert store.get("a/c") == b"x"


def test_store_list_is_path_aware(store):
    store.put("ab/y", b"1")
    store.put("abc/x", b"2")
    assert store.list("ab") == ["ab/y"]
    assert store.list("ab/") == ["ab/y"]
    assert store.list("abc") == ["abc/x"]
    assert sorted(store.list("")) == ["ab/y", "abc/x"]
    store.put("w/f/only", b"1")
    assert store.list("w/f/only") == ["w/f/only"]
    assert store.list("w/f/only/") == []
    assert store.list("nope") == [] and store.list("w/nope/") == []
    store.put("p", b"12345")
    store.put("p2/big", b"x" * 100)
    assert store.total_bytes("p") == 5


def test_store_list_walks_only_the_prefix_subtree(store, monkeypatch):
    for i in range(5):
        store.put(f"other{i}/k", b"x")
    store.put("mine/a", b"1")
    store.put("mine/b/c", b"2")
    walked = []
    orig = pathlib.Path.rglob

    def spy(self, pattern):
        walked.append(str(self))
        return orig(self, pattern)

    monkeypatch.setattr(pathlib.Path, "rglob", spy)
    assert store.list("mine/") == ["mine/a", "mine/b/c"]
    assert walked == [str(store.root / "mine")]
