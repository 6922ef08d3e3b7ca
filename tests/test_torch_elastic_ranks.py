"""Elastic training segments on ranks (gloo on the CPU) against the JAX
package on the same meshes.

The port's ``ElasticTrainer`` on a cluster whose slots are ranks runs
each segment's ``("data", "model")`` mesh as one process a slot
(``elastic.segment``), restores the newest checkpoint onto that mesh's
blocks and checkpoints from the ranks in the reference's file format.
The reference runs in three subprocesses on four forced host devices with
one XLA thread each (``python tests/test_torch_elastic_ranks.py DIR
TASK``), on ``jax.sharding.Mesh`` meshes of ``jax.devices()[:n]``, while
the port's own cases run:

  * ``phi4``: phi4-mini smoke (2 layers, f32, pure FSDP wherever the
    batch of 4 divides the ranks) through the JAX ``ElasticTrainer`` on
    (2, 2) for ``STEPS`` steps, from the TrainJob manifest the port's
    Session applies (checkpoints every 2 steps, all kept); then its step-1
    checkpoint restored onto (1, 2) at accum 2 (``build_train``'s
    shardings) and two steps taken, their losses, grad norms (the step's
    and the f64 norm of ``jax.grad`` at its params) and final params;
    and every param and moment leaf's ``NamedSharding.shard_shape`` on
    (1, 2), (2, 2) and (1, 4);
  * ``granite``: granite-moe smoke (2 layers, f32, ``ParallelConfig()``:
    tensor, sequence and expert parallelism on ``model``) through the JAX
    trainer on (2, 2) for 2 steps, and its shard shapes on (1, 2) and
    (2, 2);
  * ``zamba2``: zamba2 smoke at one ``mamba`` and one ``mamba_attn``
    layer (f32, its own layout: pure FSDP; the shared attention a
    top-level leaf) through the JAX trainer on (2, 2) for 2 steps, its
    step-1 checkpoint resumed on (1, 2) at accum 2 as phi4's, and its
    shard shapes on (1, 2) and (2, 2).

Held, in f32 at lr 3e-4 and Adam eps 1e-5 (``OPT``):
  (a) a JAX step-1 checkpoint restored by port ranks onto (1, 2), (2, 2)
      and (1, 4) (granite, zamba2: (1, 2), (2, 2)) and saved again at
      once: every
      ``.npy`` and the manifest equal JAX's byte for byte; each rank's
      blocks equal ``local_shard`` of the whole leaf, their shapes the
      reference's ``shard_shape``;
  (b) that checkpoint (phi4's, zamba2's) resumed by the ranks on (1, 2)
      at accum 2: losses
      within 1e-5 relative of the reference's, grad norms within 1e-5 of
      the f64 norm of its grads (and 1e-4 of the f32 norm its step
      reports, as tests/test_torch_ranks_fsdp.py holds; zamba2's norms
      within ``ZAMBA_NORM_RTOL``, as tests/test_torch_ranks_scan.py holds
      them), the final params put back together within 1e-4;
  (c) a TrainJob through the port's Session on 4 slots as ranks, base
      (2, 2), seeded with the JAX step-1 checkpoint: 2 slots fail once
      progress passes step 3 and rejoin past step 7, (2, 2) -> (1, 2) at
      accum 2 -> (2, 2); each step's loss within 1e-5 relative of the JAX
      trainer's uninterrupted (2, 2) run, the reference's outcomes, the
      global batch constant, ``steps_lost`` within the cadence, no rank
      process left;
  (d) on (1, 2): an injected ``fail_at`` and a drain (a slot fails, then
      rejoins) each repeat the clean run's losses bit for bit, each rank's
      blocks after a restore and before a save are the cut of that
      checkpoint (``segment.digest_probe``), and no rank process outlives
      its segment;
  (e) MoE under pure FSDP on a model axis of 2, and rwkv6 under tensor and
      sequence parallelism, raise ``NotImplementedError`` unwrapped before
      any rank spawns.

Each rank runs one torch thread, at most four ranks a call.
"""
import dataclasses
import json
import math
import multiprocessing
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge                                  # noqa: E402
from repro_torch.api import Session, TrainJob                   # noqa: E402
from repro_torch.api.runners import dataclass_kwargs            # noqa: E402
from repro_torch.checkpoint.checkpoint import (Checkpointer,     # noqa: E402
                                               flatten_with_paths,
                                               gather_whole)
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,           # noqa: E402
                                      ParallelConfig)
from repro_torch.core.orchestrator import Cluster               # noqa: E402
from repro_torch.data.objectstore import ObjectStore            # noqa: E402
from repro_torch.data.tokens import TokenPipeline               # noqa: E402
from repro_torch.elastic import ElasticTrainer, ElasticTrainSpec  # noqa: E402
from repro_torch.elastic.segment import block_digest             # noqa: E402
from repro_torch.launch import ranks                            # noqa: E402
from repro_torch.launch.mesh import make_mesh                   # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.optim import adamw                             # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.sharding import specs                          # noqa: E402

PHI4, GRANITE, ZAMBA = ("phi4-mini-3.8b", "granite-moe-1b-a400m",
                        "zamba2-2.7b")
TASKS = {PHI4: "phi4", GRANITE: "granite", ZAMBA: "zamba2"}
S, B, STEPS, CADENCE, SEED_STEP = 32, 4, 12, 2, 1
FAIL_AFTER, REJOIN_AFTER = 3, 7
F32 = dict(param_dtype="float32", compute_dtype="float32", num_layers=2)
# zamba2 at one layer of each of its kinds (tests/test_torch_ranks_scan.py's
# cut), and its grad norms' tolerance against the reference's: f32
# rounding moves zamba2's norm by more than LOSS_RTOL on either stack
ZAMBA_CUT = dict(block_pattern=("mamba", "mamba_attn"))
ZAMBA_NORM_RTOL = 5e-5
# lr 3e-4, Adam eps 1e-5: at the TrainJob's default lr of 1e-3 f32 Adam
# amplifies the two stacks' rounding until the port's losses lie 4.1e-5
# (one device) and 4.4e-5 (ranks on (2, 2)) from JAX's ten steps after the
# seed checkpoint; at 3e-4 both stay within 1.2e-6
OPT = dict(lr=3e-4, warmup_steps=1, decay_steps=100, eps=1e-5)
MESHES = {PHI4: ((1, 2), (2, 2), (1, 4)), GRANITE: ((1, 2), (2, 2)),
          ZAMBA: ((1, 2), (2, 2))}
RESUME_MESH, RESUME_ACCUM, RESUME_STEPS = (1, 2), 2, 2
LOSS_RTOL = 1e-5
STEP_NORM_RTOL = 1e-4
PARAM_TOL = dict(rtol=0, atol=1e-4)
SRC = Path(__file__).resolve().parents[1] / "src"
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
                 "--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1")


def _cfg(cfg):
    return cfg.replace(**F32, **(ZAMBA_CUT if cfg.name == ZAMBA else {}))


def _job(arch, cfg, steps, root):
    """The TrainJob both stacks' Sessions and trainers take: ``cfg`` (its
    stack's f32 smoke config) on a (2, 2) base mesh, a checkpoint every
    ``CADENCE`` steps into ``root``, all kept."""
    return dict(name=f"ranks-{arch.split('-')[0]}", arch=arch,
                config=dataclass_kwargs(cfg), steps=steps, seq_len=S,
                global_batch=B, base_shape=(2, 2), max_data=None,
                ckpt_dir=str(root), ckpt_every=CADENCE, keep=None,
                log_every=100, rejoin_timeout_s=120.0, verbose=False,
                optimizer=dict(OPT))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: np.asarray(tree)}


# ---------------------------------------------------------------------------
# the reference, in a subprocess of four forced host devices
# ---------------------------------------------------------------------------

def _reference(out_dir: str, task: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.api import TrainJob as JTrainJob
    from repro.api.runners import elastic_spec
    from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import registry as jreg
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.base import ShapeConfig
    from repro.core.orchestrator import Cluster as JCluster
    from repro.data.objectstore import ObjectStore as JStore
    from repro.data.tokens import TokenPipeline as JPipe
    from repro.elastic import ElasticTrainer as JTrainer
    from repro.models import params as jpr
    from repro.models import transformer as jtfm
    from repro.models.layers import ModelCtx
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    out = Path(out_dir)
    arch = {t: a for a, t in TASKS.items()}[task]
    cfg = _cfg(jreg.get_smoke(arch))
    jpar = jreg.get_parallel(arch)
    devs = jax.devices()

    def mesh_of(shape):
        return Mesh(np.array(devs[:math.prod(shape)]).reshape(shape),
                    ("data", "model"))

    def bundle(shape, accum=1):
        return jsteps.build_train(cfg, jpar, JOpt(**OPT, accum_steps=accum),
                                  mesh_of(shape), ShapeConfig("t", S, B,
                                                              "train"))

    steps = STEPS if task == "phi4" else SEED_STEP + 1
    spec = elastic_spec(JTrainJob(**_job(arch, cfg, steps, out / task)))
    run = JTrainer(JCluster(devices=devs[:4]), spec,
                   store=JStore(str(out / task))).run()
    schema = jtfm.lm_schema(cfg)
    abstract = {"params": jpr.abstract_params(schema, cfg.param_dtype),
                "opt": jpr.abstract_params(jadamw.opt_state_schema(
                    schema, JOpt(**OPT)), "float32")}
    shapes = {}
    for shape in MESHES[arch]:
        shd = bundle(shape).in_shardings
        for key, tree, leaf_shd in (
                ("params", abstract["params"], shd[0]),
                ("m", abstract["opt"]["m"], shd[1]["m"]),
                ("v", abstract["opt"]["v"], shd[1]["v"])):
            got = jax.tree.map(lambda a, s: list(s.shard_shape(a.shape)),
                               tree, leaf_shd)
            for path, v in _flat(got).items():
                shapes[f"{shape[0]}x{shape[1]}:{key}:{path}"] = \
                    [int(n) for n in v]
    result = {"losses": {str(k): v for k, v in run["loss_by_step"].items()},
              "shapes": shapes}
    if task in ("phi4", "zamba2"):
        # (b): the step-1 checkpoint onto (1, 2) at accum 2
        b = bundle(RESUME_MESH, RESUME_ACCUM)
        state = JCheckpointer(JStore(str(out / task)), keep=None).restore(
            SEED_STEP, abstract, {"params": b.in_shardings[0],
                                  "opt": b.in_shardings[1]})
        p, o = state["params"], state["opt"]
        par = dataclasses.replace(jpar, pure_fsdp=True) \
            if jpar.pure_fsdp_train and B % 2 == 0 else jpar
        ctx = ModelCtx(cfg, par, mesh_of(RESUME_MESH))
        grad = jax.jit(jax.grad(lambda pp, bb: jtfm.loss_fn(ctx, pp, bb)),
                       in_shardings=b.in_shardings[::2])
        pipe = JPipe(cfg.vocab_size, S, B, seed=17)
        step = b.jit()
        losses, norms, exact = [], [], []
        for j in range(SEED_STEP + 1, SEED_STEP + 1 + RESUME_STEPS):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch(j).items()}
            exact.append(math.sqrt(sum(
                float(np.sum(np.square(np.asarray(g, np.float64))))
                for g in jax.tree.leaves(grad(p, batch)))))
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        result["resume"] = {"losses": losses, "norms": norms,
                            "exact_norms": exact}
        np.savez(out / f"resume_params_{task}.npz",
                 **_flat(jax.tree.map(np.asarray, p)))
    (out / f"{task}.json").write_text(json.dumps(result))


class _Reference:
    """The three reference subprocesses, started at once;
    ``result(task)`` waits for one."""

    def __init__(self, out: Path):
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=REF_XLA_FLAGS,
                   PYTHONPATH=os.pathsep.join(
                       [str(SRC), os.environ.get("PYTHONPATH", "")]))
        self.out = out
        self.procs = {task: subprocess.Popen(
            [sys.executable, __file__, str(out), task], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for task in TASKS.values()}
        self.done = {}

    def result(self, task):
        if task not in self.done:
            _, err = self.procs[task].communicate(timeout=900)
            assert self.procs[task].returncode == 0, err[-4000:]
            self.done[task] = json.loads(
                (self.out / f"{task}.json").read_text())
        return self.done[task]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("elastic_ranks_reference"))
    yield ref
    ref.close()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The trainer's pods run in threads; each rank takes the parent's
    threads over the ranks (one here)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# what a rank runs (spawned ranks import this module by name)
# ---------------------------------------------------------------------------

def _layout(cfg, rm, accum=1):
    ocfg = OptimizerConfig(**OPT, accum_steps=accum)
    par = tsteps.train_par(treg.get_parallel(_arch(cfg)), global_batch=B,
                           chips=rm.world_size)
    schema = tsteps._model_module(cfg).lm_schema(cfg)
    opt_schema = adamw.opt_state_schema(schema, ocfg)
    abstract = {"params": tpr.abstract_params(schema, cfg.param_dtype),
                "opt": tpr.abstract_params(opt_schema, "float32")}
    return ocfg, par, abstract, {"mesh": rm, "par": par, "schema": {
        "params": schema, "opt": opt_schema}}


def _arch(cfg):
    return ZAMBA if cfg.name == ZAMBA else (
        GRANITE if cfg.moe is not None else PHI4)


def _rank_jobs(rm, jobs):
    """Each job of ``jobs`` in turn on this rank: ("roundtrip", cfg, src,
    dst) restores ``src``'s newest checkpoint and saves it into ``dst`` at
    once -> the rank's blocks; ("resume", cfg, src, batches) restores it at
    accum ``RESUME_ACCUM`` and takes a step a batch -> losses, grad norms
    and (rank 0) the final params whole."""
    out = []
    for kind, cfg, src, arg in jobs:
        accum = RESUME_ACCUM if kind == "resume" else 1
        ocfg, par, abstract, layout = _layout(cfg, rm, accum)
        tree, meta = Checkpointer(ObjectStore(src), keep=None).restore_latest(
            abstract, **layout)
        if kind == "roundtrip":
            Checkpointer(ObjectStore(arg), keep=None).save(
                meta["step"], tree, {k: v for k, v in meta.items()
                                     if k != "step"}, **layout)
            out.append({"coords": rm.coords, "blocks": {
                k: v.numpy().copy() for k, v in flatten_with_paths(tree)}})
            continue
        params, opt, rows = tree["params"], tree["opt"], []
        for j in range(arg["tokens"].shape[0]):
            params, opt, m = tsteps.train_step(
                cfg, par, ocfg, params, opt, {k: v[j] for k, v in arg.items()},
                device="cpu", mesh=rm)
            rows.append({k: float(v) for k, v in m.items()})
        whole = gather_whole({"params": params}, rm, par,
                             {"params": layout["schema"]["params"]})
        out.append({"steps": rows, "params": None if whole is None else
                    bridge.to_numpy(whole["params"])})
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _only_step(src, dst, step):
    """A store holding only ``src``'s checkpoint of ``step``."""
    name = f"checkpoints/step_{step:010d}"
    shutil.copytree(pathlib.Path(src) / name, pathlib.Path(dst) / name)
    return dst


def _files(root):
    root = pathlib.Path(root)
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _gone(pid) -> bool:
    """The process has exited and been reaped."""
    return not os.path.exists(f"/proc/{pid}")


def _port_cfg(arch):
    return _cfg(treg.get_smoke(arch))


# ---------------------------------------------------------------------------
# (e) refusals, (d) crash and drain: the port alone, while the reference runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,par,match", [
    (GRANITE, ParallelConfig(pure_fsdp=True), "pure_fsdp"),
    ("rwkv6-1.6b", ParallelConfig(), "tp_inner")])
def test_unported_layouts_raise_before_any_rank_spawns(reference, tmp_path,
                                                       arch, par, match):
    spec = ElasticTrainSpec(
        treg.get_smoke(arch), par or treg.get_parallel(arch),
        OptimizerConfig(), steps=2, seq_len=8, global_batch=2,
        base_shape=(1, 2), max_data=None, verbose=False, device="cpu",
        ranks=True)
    cluster = Cluster(devices=["slot0", "slot1"], compute="cpu", ranks=True)
    trainer = ElasticTrainer(cluster, spec, store=ObjectStore(str(tmp_path)))
    with pytest.raises(NotImplementedError, match=match):
        trainer.run()
    assert trainer.rank_pids == [] and len(cluster.jobs) == 1


def _d_spec(**kw):
    cfg = _port_cfg(PHI4)
    return ElasticTrainSpec(
        cfg, treg.get_parallel(PHI4), OptimizerConfig(**OPT), steps=6,
        seq_len=S, global_batch=B, base_shape=(1, 2), max_data=None,
        ckpt_every=CADENCE, keep=None, log_every=100, verbose=False,
        device="cpu", ranks=True, rejoin_timeout_s=120.0, **kw)


def _d_run(root, drain=False, probe=None, **kw):
    cluster = Cluster(devices=["slot0", "slot1"], compute="cpu", ranks=True)
    trainer = ElasticTrainer(cluster, _d_spec(**kw),
                             store=ObjectStore(str(root)), probe=probe)
    checked = {}
    stop = threading.Event()

    def drainer():
        # slot1 fails once step 2 is done; once its segment's pod has
        # ended, its ranks must be gone; then the slot rejoins
        while trainer.progress < 2 and not stop.is_set():
            time.sleep(0.002)
        cluster.fail_node("slot1")
        pod = cluster.jobs[0].pods[0]
        pod.thread.join(timeout=120)
        checked["drained_ranks_gone"] = all(map(_gone, trainer.rank_pids[0]))
        cluster.join_node("slot1")

    t = threading.Thread(target=drainer, daemon=True) if drain else None
    if t is not None:
        t.start()
    try:
        out = trainer.run()
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=120)
    return out, trainer, checked


def test_crash_and_drain_repeat_the_clean_losses_bit_for_bit(reference,
                                                            tmp_path):
    with ThreadPoolExecutor(max_workers=3) as pool:
        clean = pool.submit(_d_run, tmp_path / "clean")
        crash = pool.submit(_d_run, tmp_path / "crash", fail_at=3,
                            probe="repro_torch.elastic.segment:digest_probe")
        drain = pool.submit(_d_run, tmp_path / "drain", drain=True)
        (clean, t_clean, _), (crash, t_crash, _), (drain, t_drain, seen) = (
            clean.result(timeout=600), crash.result(timeout=600),
            drain.result(timeout=600))
    assert [s.outcome for s in crash["report"].segments] == ["error", "done"]
    assert [s.outcome for s in drain["report"].segments] == [
        "node-failure", "done"]
    assert seen["drained_ranks_gone"]
    for out in (crash, drain):
        assert sorted(out["loss_by_step"]) == list(range(6))
        assert out["losses"] == clean["losses"]
        assert out["report"].steps_lost <= CADENCE
    # a restored run ends where the clean one does, bit for bit
    for a, b in zip(_flat(bridge.to_numpy(clean["params"])).items(),
                    _flat(bridge.to_numpy(crash["params"])).items()):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])
    for trainer in (t_clean, t_crash, t_drain):
        assert trainer.rank_pids and all(
            _gone(pid) for pids in trainer.rank_pids for pid in pids)
    assert len(t_crash.rank_pids) == 2 and len(t_drain.rank_pids) == 2
    # the spy: each rank's blocks after the restore and before every save
    # are the cut of the checkpoint's whole leaves, bit for bit
    events = _probed_blocks_match(tmp_path / "crash", t_crash)
    assert ("restore", 1) in events and ("save", 5) in events


def _probed_blocks_match(root, trainer):
    """Every ``digest_probe`` record of ``trainer`` against the cut of its
    step's checkpoint for that segment's mesh -> the (event, step) seen."""
    cfg = _port_cfg(PHI4)
    ck = Checkpointer(ObjectStore(str(root)), keep=None)
    seen = set()
    for rec in trainer.rank_segments:
        mesh = make_mesh(rec["mesh"], ("data", "model"))
        leaf_specs = _leaf_specs(cfg, tsteps.train_par(
            treg.get_parallel(PHI4), global_batch=B,
            chips=math.prod(rec["mesh"])), mesh)
        for r, probes in enumerate(rec.get("probes", [])):
            coords = dict(zip(mesh.axis_names, divmod(r, mesh.sizes[1])))
            for event, step, digests in probes:
                whole = dict(flatten_with_paths(ck.restore(
                    step, _whole_abstract(cfg), "cpu")))
                assert sorted(digests) == sorted(whole)
                for key, t in whole.items():
                    assert digests[key] == block_digest(specs.local_shard(
                        t, leaf_specs[key], mesh, coords)), (event, key)
                seen.add((event, step))
    return seen


# ---------------------------------------------------------------------------
# (a), (b): JAX's checkpoints on the port's ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def restored(reference, tmp_path_factory):
    """Every mesh's roundtrips and (1, 2)'s resume, one ``run_ranks`` call
    a mesh, two at a time -> {mesh: [each rank's job results]} and the
    stores."""
    ref = {task: reference.result(task) for task in TASKS.values()}
    root = tmp_path_factory.mktemp("elastic_ranks_port")
    srcs = {arch: str(_only_step(reference.out / task, root / f"src_{task}",
                                 SEED_STEP))
            for arch, task in TASKS.items()}
    cfgs = {arch: _port_cfg(arch) for arch in MESHES}
    batches = TokenPipeline(cfgs[PHI4].vocab_size, S, B, seed=17).chunk(
        SEED_STEP + 1, RESUME_STEPS)
    calls, index = {}, {}
    for arch, shapes in MESHES.items():
        for shape in shapes:
            dst = str(root / f"dst_{arch}_{shape[0]}x{shape[1]}")
            index[arch, shape] = len(calls.setdefault(shape, []))
            calls[shape].append(("roundtrip", cfgs[arch], srcs[arch], dst))
    for arch in (PHI4, ZAMBA):
        index["resume", arch] = len(calls[RESUME_MESH])
        calls[RESUME_MESH].append(("resume", cfgs[arch], srcs[arch],
                                   batches))

    def call(shape):
        return shape, ranks.run_ranks(_rank_jobs, shape,
                                      args=(calls[shape],), device="cpu",
                                      threads=1)

    with ThreadPoolExecutor(max_workers=2) as pool:
        done = dict(pool.map(call, sorted(calls, key=lambda s: -math.prod(s))))
    return {"ref": ref, "root": root, "index": index, "done": done,
            "srcs": srcs, "out": reference.out}


@pytest.mark.parametrize("arch,shape", [
    (arch, shape) for arch, shapes in MESHES.items() for shape in shapes])
def test_jax_checkpoint_restored_and_saved_by_ranks_is_byte_identical(
        restored, arch, shape):
    dst = restored["root"] / f"dst_{arch}_{shape[0]}x{shape[1]}"
    want, got = _files(restored["srcs"][arch]), _files(dst)
    assert sorted(got) == sorted(want)
    for key, data in want.items():
        assert got[key] == data, key
    # each rank's blocks: the cut of the whole leaf, in the reference's
    # shard shapes
    whole = dict(flatten_with_paths(Checkpointer(
        ObjectStore(restored["srcs"][arch]), keep=None).restore(
            SEED_STEP, _whole_abstract(_port_cfg(arch)), "cpu")))
    mesh = make_mesh(shape, ("data", "model"))
    cfg = _port_cfg(arch)
    par = tsteps.train_par(treg.get_parallel(arch), global_batch=B,
                           chips=math.prod(shape))
    leaf_specs = _leaf_specs(cfg, par, mesh)
    ref_shapes = restored["ref"][TASKS[arch]]["shapes"]
    results = [r[restored["index"][arch, shape]]
               for r in restored["done"][shape]]
    assert len(results) == math.prod(shape)
    split = 0
    for res in results:
        for key, block in res["blocks"].items():
            np.testing.assert_array_equal(block, specs.local_shard(
                whole[key], leaf_specs[key], mesh, res["coords"]).numpy(),
                err_msg=key)
            group, _, path = key.partition("/")
            tag = "params" if group == "params" else path.split("/")[0]
            if tag in ("m", "v"):
                path = path.partition("/")[2]
            elif tag != "params":
                continue                        # the step count
            assert list(block.shape) == ref_shapes[
                f"{shape[0]}x{shape[1]}:{tag}:{path}"], key
            split += block.shape != whole[key].shape
    assert split > 0                            # the layout cuts something


def _whole_abstract(cfg):
    schema = tsteps._model_module(cfg).lm_schema(cfg)
    return {"params": tpr.abstract_params(schema, cfg.param_dtype),
            "opt": tpr.abstract_params(adamw.opt_state_schema(
                schema, OptimizerConfig()), "float32")}


def _leaf_specs(cfg, par, mesh):
    rules = specs.logical_rules(par)
    schema = tsteps._model_module(cfg).lm_schema(cfg)
    opt_schema = adamw.opt_state_schema(schema, OptimizerConfig())
    return {key: specs.spec_for(p.shape, p.axes, mesh, rules)
            for key, p in flatten_with_paths({"params": schema,
                                              "opt": opt_schema})}


def test_resume_on_a_reshaped_mesh_matches_jax(restored):
    _resume_matches(restored, PHI4, LOSS_RTOL)


def test_zamba2_resume_on_a_reshaped_mesh_matches_jax(restored):
    """The shared attention restored onto (1, 2) from a checkpoint saved
    on (2, 2), gathered whole a microbatch, trained on."""
    _resume_matches(restored, ZAMBA, ZAMBA_NORM_RTOL)


def _resume_matches(restored, arch, norm_rtol):
    task = TASKS[arch]
    want = restored["ref"][task]["resume"]
    results = [r[restored["index"]["resume", arch]]
               for r in restored["done"][RESUME_MESH]]
    for res in results:
        got = res["steps"]
        np.testing.assert_allclose([r["loss"] for r in got], want["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        norms = [r["grad_norm"] for r in got]
        np.testing.assert_allclose(norms, want["exact_norms"],
                                   rtol=norm_rtol, atol=0)
        np.testing.assert_allclose(norms, want["norms"],
                                   rtol=max(norm_rtol, STEP_NORM_RTOL),
                                   atol=0)
    with np.load(restored["out"] / f"resume_params_{task}.npz") as z:
        final = {k: z[k] for k in z.files}
    got = _flat(results[0]["params"])
    assert sorted(got) == sorted(final)
    for key, v in final.items():
        np.testing.assert_allclose(got[key], v, err_msg=key, **PARAM_TOL)


# ---------------------------------------------------------------------------
# (c): churn through the Session
# ---------------------------------------------------------------------------

def test_churn_through_the_session_matches_the_uninterrupted_jax_run(
        reference, tmp_path):
    want = {int(k): v for k, v in reference.result("phi4")["losses"].items()}
    assert sorted(want) == list(range(STEPS))
    root = _only_step(reference.out / "phi4", tmp_path / "port", SEED_STEP)
    cluster = Cluster(devices=[f"slot{i}" for i in range(4)], compute="cpu",
                      ranks=True)
    handle = Session(cluster=cluster).apply(
        TrainJob(**_job(PHI4, _port_cfg(PHI4), STEPS, root)))
    victims = cluster.devices[2:]

    def progress():
        return handle.status().observed.get("step", -1)

    def churn():
        deadline = time.monotonic() + 600
        while progress() < FAIL_AFTER and time.monotonic() < deadline:
            time.sleep(0.002)
        for d in victims:
            cluster.fail_node(d)
        while (progress() < REJOIN_AFTER or len(cluster.jobs) < 2) and \
                time.monotonic() < deadline:
            time.sleep(0.002)
        for d in victims:
            cluster.join_node(d)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    out = handle.wait(timeout=600)
    t.join(timeout=60)
    rep = out["report"]
    assert [s.mesh_shape for s in rep.segments] == [(2, 2), (1, 2), (2, 2)]
    assert [s.outcome for s in rep.segments] == [
        "node-failure", "preempted", "done"]
    assert {s.mesh_shape: s.accum_steps for s in rep.segments} == {
        (2, 2): 1, (1, 2): 2}
    assert rep.global_batch_constant and rep.recoveries >= 1
    assert rep.steps_lost <= CADENCE
    got = out["loss_by_step"]
    assert sorted(got) == list(range(SEED_STEP + 1, STEPS))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(got)],
                               rtol=LOSS_RTOL, atol=0)
    assert out["params"]["embed"].device.type == "cpu"
    assert multiprocessing.active_children() == []


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
