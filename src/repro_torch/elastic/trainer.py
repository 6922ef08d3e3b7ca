"""ElasticTrainer — training as a supervised, self-healing Cluster Job.

A port of the JAX package's ``elastic/trainer.py``.  The paper's §V
contract ("nodes can join and leave the cluster at any time ... pods will
be rescheduled ... re-spawn them if any errors occur") applied to
training, with no human in the loop:

    +-------------------- ElasticTrainer.run() ---------------------+
    |  ChurnController.wait_for_capacity()                          |
    |        |                                                      |
    |        v            submit(JobSpec(segment))                  |
    |  Decision(plan, batch) ------------------> Cluster pod        |
    |        ^                                     |                |
    |        |   supervise: poll pod + decide()    |  train chunks  |
    |        |     - node joined & bigger mesh     |  ckpt every k  |
    |        |       -> graceful preempt (save)    |                |
    |        |     - fail_node drained the pod     |                |
    |        |       -> pod FAILED, lease freed    |                |
    |        +---- restore latest ckpt, accum  ----+                |
    |              rescaled so batch x accum stays constant         |
    +---------------------------------------------------------------+

Each *segment* is one pod: it restores the newest checkpoint and steps
until it finishes, is preempted (scale-up), or is drained (node failure).
Where the cluster's slots are ranks (``Cluster(..., ranks=...)``, handed
to ``spec.ranks``), a segment runs the plan's ``("data", "model")`` mesh
as one process a leased slot (``core.elastic.make_elastic_mesh``,
``launch.ranks.run_ranks``, ``elastic.segment``): it restores the newest
checkpoint onto that mesh's blocks and checkpoints from the ranks in the
reference's format, so a lost node costs one restore onto a reshaped
mesh, as in the reference; ``steps.check_layout`` refuses an unported
layout before any rank spawns.  Otherwise the segment trains on the
trainer's one device (``spec.device``): the cluster's slots are leased as
names (the card, or logical slots in tests), and the plan's data axis
only sets the accumulation (``BatchPlan``), so a mesh change becomes an
accumulation rescale.  The data pipeline is stateless (batch i is a pure
function of ``spec.data_seed``), so a restored segment re-sees exactly the
batches the lost one saw, and the trajectory is the uninterrupted one,
modulo steps re-executed since the last checkpoint (``steps_lost`` in the
report).

Each chunk of ``spec.device_steps`` optimizer steps is one
``runtime.steps.train_chunk`` call (xent and AdamW kernels on the card);
its losses stay on the device until a checkpoint or log cadence flushes
them with one copy (on ranks, rank 0 sends each chunk's losses to the
trainer, whose ``progress`` moves with them).  Every family whose batches
are tokens alone trains here (the dense kinds, MoE, the recurrent kinds;
on ranks the kinds ``check_layout`` admits).  Whisper and the VLM
train only on batches that carry their ``extras`` (``runtime.steps``),
which the trainer's ``TokenPipeline`` does not make: the JAX trainer
builds its chunk step with the extras in its batch specs, feeds it those
batches all the same and fails each attempt on the batch's structure.  The
port refuses such a spec up front (``NotImplementedError``), and that
error, as any ``NotImplementedError`` from a segment, ends the run as it
is: retrying cannot help it.  The trainer's ``[elastic]`` lines go to
stderr.
"""
from __future__ import annotations

import dataclasses
import gc
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelConfig)
from repro_torch.core.elastic import make_elastic_mesh
from repro_torch.core.metrics import Registry
from repro_torch.core.orchestrator import Cluster, JobSpec, Pod, PodState
from repro_torch.data.objectstore import ObjectStore
from repro_torch.data.tokens import ChunkPrefetcher, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.elastic.batch import BatchPlan
from repro_torch.elastic.controller import ChurnController, Decision
from repro_torch.launch.mesh import mesh_num_chips
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.runtime import steps as steps_mod


@dataclass
class ElasticTrainSpec:
    cfg: ModelConfig
    par: ParallelConfig
    ocfg: OptimizerConfig
    steps: int
    seq_len: int = 64
    global_batch: int = 16
    mesh_axes: Tuple[str, ...] = ("data", "model")
    base_shape: Tuple[int, ...] = (1, 1)   # preferred full-cluster mesh
    max_data: Optional[int] = None         # cap the data axis (launchers)
    name: str = "elastic-train"
    namespace: str = "elastic"
    ckpt_every: int = 5                    # periodic async saves (durability)
    keep: Optional[int] = 3
    log_every: int = 10
    # optimizer steps a chunk (one train_chunk call, losses flushed only
    # at cadences); should_stop/fail/preemption are observed at chunk
    # boundaries.  ckpt_every and log_every snap UP to multiples of it.
    device_steps: int = 1
    prefetch_depth: int = 2                # chunks built ahead
    seed: int = 0
    data_seed: int = 17
    fail_at: int = -1                      # inject ONE crash at this step
    backoff_limit: int = 2                 # non-churn failures tolerated
    # A drained pod's node is "dead": by default it does NOT write a final
    # checkpoint (recovery cost = steps since the last periodic save).
    # Graceful scale-up preemptions always save.
    save_on_drain: bool = False
    rejoin_timeout_s: float = 60.0
    poll_s: float = 0.02
    join_timeout_s: float = 120.0
    verbose: bool = True
    device: Any = "cuda"                   # where every segment trains
    # the cluster's slots are ranks: False (one device), True (each slot's
    # own device, else the CPU or card r for rank r) or {slot: device}
    # naming each one's (several ranks on one card)
    ranks: Any = False

    def __post_init__(self):
        resolve_device(self.device)        # raises without a card


@dataclass
class SegmentRecord:
    index: int
    start: int
    end: int                  # last executed step (start-1 if none ran)
    mesh_shape: Tuple[int, ...]
    accum_steps: int
    microbatch: int
    global_batch: int
    wall_s: float
    outcome: str              # done | preempted | node-failure | error
    # seconds from segment start to the FIRST chunk's results being ready
    # (restore + first chunk): the restart latency a rescale pays
    t_first_s: float = 0.0

    @property
    def steps_run(self) -> int:
        return max(0, self.end - self.start + 1)


@dataclass
class ElasticRunReport:
    global_batch: int = 0
    seq_len: int = 0
    steps: int = 0
    segments: List[SegmentRecord] = field(default_factory=list)
    recoveries: int = 0               # node-churn induced restarts
    steps_lost: int = 0               # re-executed since last checkpoint
    recovery_s: List[float] = field(default_factory=list)
    total_wall_s: float = 0.0
    # host round-trips during training: one per chunk dispatch + one per
    # loss flush / first-chunk latency probe
    host_syncs: int = 0

    @property
    def tokens_executed(self) -> int:
        return sum(s.steps_run for s in self.segments) * \
            self.global_batch * self.seq_len

    @property
    def tokens_useful(self) -> int:
        return self.steps * self.global_batch * self.seq_len

    @property
    def tokens_per_s(self) -> float:
        """Useful tokens/s: the trained run's throughput including every
        recovery cost (restore, re-executed steps)."""
        return self.tokens_useful / max(self.total_wall_s, 1e-9)

    @property
    def steps_executed(self) -> int:
        return sum(s.steps_run for s in self.segments)

    @property
    def host_syncs_per_step(self) -> float:
        return self.host_syncs / max(self.steps_executed, 1)

    @property
    def t_first_s(self) -> float:
        """Time-to-first-step of the run: the FIRST segment's (later
        segments' t_first_s measure per-recovery restart latency)."""
        return self.segments[0].t_first_s if self.segments else 0.0

    @property
    def global_batch_constant(self) -> bool:
        return all(s.global_batch == self.global_batch and
                   s.microbatch * s.accum_steps == self.global_batch
                   for s in self.segments)

    def to_json(self) -> Dict[str, Any]:
        return {
            "steps": self.steps,
            "global_batch": self.global_batch,
            "seq_len": self.seq_len,
            "segments": [dataclasses.asdict(s) for s in self.segments],
            "recoveries": self.recoveries,
            "steps_lost": self.steps_lost,
            "recovery_s": [round(r, 3) for r in self.recovery_s],
            "total_wall_s": round(self.total_wall_s, 3),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "tokens_executed": self.tokens_executed,
            "global_batch_constant": self.global_batch_constant,
            "host_syncs": self.host_syncs,
            "host_syncs_per_step": round(self.host_syncs_per_step, 4),
            "t_first_s": round(self.t_first_s, 3),
        }


class UnschedulableError(RuntimeError):
    """A segment's submit was rejected (stale plan, quota, no devices) —
    retryable by replanning, unlike other trainer RuntimeErrors."""


@dataclass
class _SegmentResult:
    start: int
    last: int                 # last executed step (start-1 if none)
    done: bool
    preempted: bool
    # perf_counter after the first chunk's results are ready (one device
    # sync, once)
    t_first_done: Optional[float]
    wall_s: float
    host_syncs: int = 0
    t_first_s: float = 0.0    # t_first_done relative to segment start


def snap_cadence(every: int, device_steps: int) -> int:
    """Snap a per-step cadence UP to chunk granularity (0 = off stays off).
    Checkpoint/log actions only happen at chunk boundaries, so the
    effective cadence is the smallest multiple of ``device_steps`` >= the
    requested one."""
    if not every:
        return 0
    k = max(device_steps, 1)
    return ((every + k - 1) // k) * k


def chunk_schedule(start: int, steps: int, device_steps: int):
    """Chunks covering [start, steps), aligned to the ABSOLUTE step grid
    (boundaries at multiples of device_steps from step 0), so snapped
    cadences fire exactly on boundaries no matter where a restore lands.
    First/last chunks may be partial."""
    k = max(device_steps, 1)
    out, i = [], start
    while i < steps:
        bound = min(steps, (i // k + 1) * k)
        out.append((i, bound - i))
        i = bound
    return out


class ElasticTrainer:
    """Supervised elastic training on a Cluster.  See module docstring."""

    def __init__(self, cluster: Cluster, spec: ElasticTrainSpec, *,
                 store: Optional[ObjectStore] = None,
                 metrics: Optional[Registry] = None,
                 report: Optional[ElasticRunReport] = None,
                 stop: Optional[threading.Event] = None,
                 probe: Optional[str] = None):
        self.cluster = cluster
        self.spec = spec
        self.device = resolve_device(spec.device)
        # cooperative cancel: when set, the supervisor preempt-drains the
        # live segment (which checkpoints on the way out) and run() returns
        # the partial result instead of resubmitting
        self._stop = stop or threading.Event()
        self._ephemeral_store = store is None
        if store is None:
            store = ObjectStore(tempfile.mkdtemp(prefix="elastic-ckpt-"))
        self.store = store
        self.ckpt = Checkpointer(store, keep=spec.keep)
        self.metrics = metrics or cluster.metrics
        self.controller = ChurnController(
            cluster, axes=spec.mesh_axes, base_shape=spec.base_shape,
            global_batch=spec.global_batch, max_data=spec.max_data)
        self.report = report or ElasticRunReport(
            global_batch=spec.global_batch, seq_len=spec.seq_len,
            steps=spec.steps)
        self.cfg = spec.cfg
        self.schema = steps_mod._model_module(self.cfg).lm_schema(self.cfg)
        self.opt_schema = adamw.opt_state_schema(self.schema, spec.ocfg)
        self.progress = -1                # last completed step, any segment
        self._seg_start = 0               # current segment's restore point
        self._seg_last = -1               # current segment's last step
        self._losses: Dict[int, float] = {}     # step -> loss (host)
        self._injected = False
        self._final: Dict[str, Any] = {}
        self._fatal: Optional[NotImplementedError] = None
        self._saves_logged = 0
        # on ranks: "module:function" each rank calls on its blocks after a
        # restore and before a save (``elastic.segment``); each segment's
        # rank pids, and its mesh, start-up, checkpoint, memory, launch
        # and probe records
        self.probe = probe
        self.rank_pids: List[List[int]] = []
        self.rank_segments: List[Dict[str, Any]] = []

    def _log(self, msg: str) -> None:
        if self.spec.verbose:
            print(msg, file=sys.stderr, flush=True)

    def _wait_ckpt(self) -> None:
        """Let the in-flight save commit, and log each save committed
        since the last call."""
        self.ckpt.wait()
        for rec in self.ckpt.saves[self._saves_logged:]:
            self._log(f"[elastic] saved step {rec['step']}: host snapshot "
                      f"{rec['snapshot_s']:.2f} s, write {rec['write_s']:.2f} "
                      f"s, {rec['bytes'] / 1e9:.3f} GB")
        self._saves_logged = len(self.ckpt.saves)

    # ------------------------------------------------------------- segments
    def _abstract(self):
        return {"params": pr.abstract_params(self.schema,
                                             self.cfg.param_dtype),
                "opt": pr.abstract_params(self.opt_schema, "float32")}

    def _refuse_extras(self) -> None:
        if steps_mod.extras_specs(self.cfg, 1) is not None:
            raise NotImplementedError(
                f"the {self.cfg.family!r} family ({self.cfg.name}) trains on "
                f"batches with extras (runtime.steps.extras_specs), which "
                f"the trainer's TokenPipeline does not make; the JAX "
                f"trainer feeds it those batches all the same and fails on "
                f"the batch's structure; train it through "
                f"runtime.steps.train_chunk with extras")

    def _train_segment(self, ctx, plan, bplan: BatchPlan,
                       graceful: threading.Event) -> _SegmentResult:
        """One pod: restore, run CHUNKS of ``spec.device_steps`` optimizer
        steps, checkpoint at boundaries.  Chunk k+1's batches are built by
        a background thread while chunk k runs, and the host syncs (loss
        flush, checkpoint, log, stop/fail checks) only at chunk
        boundaries, so preemption latency is bounded by one chunk."""
        spec, dev = self.spec, self.device
        self._refuse_extras()
        if spec.ranks:
            return self._train_segment_ranks(ctx, plan, bplan, graceful)
        t0 = time.perf_counter()

        if dev.type == "cuda":
            # one segment's state on the card at a time: a dead segment's
            # tensors held only by reference cycles go before this one
            # allocates.  A full collection stops every thread of the
            # process (0.6-0.7 s in a loaded test worker, which a live
            # event subscriber sees as lag), so host runs, where no
            # device memory is at stake, leave the cycles to the
            # collector's own schedule.
            gc.collect()
            allocated = torch.cuda.memory_allocated(dev)
            self.metrics.gauge("elastic/segment_start_allocated_bytes",
                               allocated)
            self._log(f"[elastic] segment on {dev}: "
                      f"{allocated / 1e9:.3f} GB allocated at its start")
        ocfg = dataclasses.replace(spec.ocfg, accum_steps=bplan.accum_steps)
        K = max(spec.device_steps, 1)
        # a save the last segment left in flight commits before this one
        # picks the newest checkpoint
        self._wait_ckpt()
        restored, meta = self.ckpt.restore_latest(self._abstract(), dev)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = int(meta["step"]) + 1
            saved_at = int(meta["step"])
            rec = self.ckpt.restores[-1]
            self._log(f"[elastic] restored step {saved_at}: "
                      f"{rec['seconds']:.2f} s, {rec['bytes'] / 1e9:.3f} GB")
        else:
            start, saved_at = 0, -1
        self._seg_start = start       # supervisor-visible even if we crash
        self._seg_last = start - 1    # this segment's own extent
        if restored is None:
            params = pr.init_params(
                self.schema, torch.Generator(device=dev).manual_seed(spec.seed),
                self.cfg.param_dtype, dev)
            opt = steps_mod.init_opt_state(self.cfg, ocfg, dev)

        eff_ckpt = snap_cadence(spec.ckpt_every, K)
        eff_log = snap_cadence(spec.log_every, K)
        pipe = TokenPipeline(self.cfg.vocab_size, spec.seq_len,
                             spec.global_batch, seed=spec.data_seed)
        schedule = chunk_schedule(start, spec.steps, K)
        last = start - 1
        t_first: Optional[float] = None
        preempted = False
        host_syncs = 0
        pending: Dict[int, torch.Tensor] = {}   # chunk start -> (k,) losses

        def flush_losses():
            # one device-to-host copy at points that already sync
            nonlocal host_syncs
            if pending:
                vals = torch.cat(list(pending.values())).cpu().tolist()
                steps = [s + j for s, v in pending.items()
                         for j in range(len(v))]
                self._losses.update(zip(steps, vals))
                pending.clear()
                host_syncs += 1

        prefetch = ChunkPrefetcher(pipe, schedule, depth=spec.prefetch_depth)
        try:
            for cstart, k in schedule:
                cend = cstart + k - 1
                if ctx.should_stop():
                    preempted = True
                    break
                if cstart <= spec.fail_at <= cend and not self._injected:
                    self._injected = True
                    raise RuntimeError(
                        f"injected failure at step {spec.fail_at}")
                _, batches = prefetch.get()
                params, opt, ms = steps_mod.train_chunk(
                    self.cfg, spec.par, ocfg, params, opt, batches,
                    device=dev)
                host_syncs += 1             # one dispatch per chunk
                pending[cstart] = ms["loss"]
                last = cend
                self.progress = cend
                self._seg_last = cend
                if t_first is None:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    host_syncs += 1
                    t_first = time.perf_counter()
                if eff_ckpt and (cend + 1) % eff_ckpt == 0:
                    flush_losses()  # keeps the loss log >= the restore
                    self.ckpt.save_async(cend, {"params": params,
                                                "opt": opt})
                    saved_at = cend
                if eff_log and (cstart % eff_log == 0 or
                                cend == spec.steps - 1):
                    flush_losses()      # includes this chunk's losses
                    loss = self._losses[cend]
                    self.metrics.gauge("elastic/loss", loss)
                    self.metrics.gauge("elastic/step", cend)
                    self._log(f"[elastic] step {cend} loss {loss:.4f} "
                              f"mesh {plan.new_shape} "
                              f"accum {bplan.accum_steps}")
            flush_losses()
        finally:
            prefetch.close()
            # a crashed segment's round-trips count too
            self.report.host_syncs += host_syncs
        self._wait_ckpt()
        done = (last == spec.steps - 1 and not preempted) or \
            start >= spec.steps
        # graceful preemptions (scale-up) and scheduler preemptions always
        # persist their last step; drained pods only when the spec
        # pretends the node survived.  A COMPLETED run skips the terminal
        # save when nobody could ever read it (checkpointing off +
        # trainer-owned throwaway store).
        want_final_save = (not preempted) or graceful.is_set() \
            or ctx.preempt.is_set() or spec.save_on_drain
        if done and self._ephemeral_store and not spec.ckpt_every:
            want_final_save = False
        if last >= start and saved_at != last and want_final_save:
            self.ckpt.save(last, {"params": params, "opt": opt})
            self._wait_ckpt()
        if done:
            self._final = {"params": params, "opt": opt}
        return _SegmentResult(start=start, last=last, done=done,
                              preempted=preempted, t_first_done=t_first,
                              wall_s=time.perf_counter() - t0,
                              host_syncs=host_syncs,
                              t_first_s=(t_first - t0)
                              if t_first is not None else 0.0)

    def _train_segment_ranks(self, ctx, plan, bplan: BatchPlan,
                             graceful: threading.Event) -> _SegmentResult:
        """One pod as one process a leased slot on the plan's mesh
        (``elastic.segment.train_segment``).  Rank 0's reports move
        ``progress`` and the loss log live; the pod's drain or preempt
        stops every rank at the same chunk boundary, saving on the way
        out as ``_train_segment`` does; a rank's exception is the
        segment's failure.  ``t_first_s`` counts from before the ranks
        spawn, so it holds their start-up, which is logged beside it."""
        from repro_torch.elastic.segment import train_segment
        from repro_torch.launch.ranks import Channel, run_ranks
        spec = self.spec
        t0 = time.perf_counter()
        named = spec.ranks if isinstance(spec.ranks, Mapping) else None
        mesh, devices = make_elastic_mesh(plan, ctx.devices,
                                          compute=self.device, named=named)
        n = mesh_num_chips(mesh)
        ocfg = dataclasses.replace(spec.ocfg, accum_steps=bplan.accum_steps)
        par = steps_mod.train_par(spec.par, global_batch=spec.global_batch,
                                  chips=n)
        # an unported layout ends the run here, before any rank spawns
        steps_mod.check_layout(self.cfg, par, ocfg, mesh, seq=spec.seq_len)
        backend = "nccl" if self.device.type == "cuda" and \
            len(set(devices)) == n else "gloo"
        self._wait_ckpt()
        seen: Dict[str, Optional[float]] = {"up": None, "first": None}

        def on_report(msg):
            now = time.perf_counter()
            if "started" in msg:
                seen["up"] = now
            if "start" in msg:
                self._seg_start = record["start"] = msg["start"]
                self._seg_last = record["last"] = msg["start"] - 1
            if "last" in msg:
                self._losses.update(msg["losses"])
                self.progress = self._seg_last = record["last"] = msg["last"]
                if seen["first"] is None:
                    seen["first"] = now

        def stop_when():
            # a drain, a graceful (scale-up) or a scheduler preempt: the
            # last two always save on the way out, a drain only where the
            # spec pretends the node survived
            if not ctx.should_stop():
                return None
            return graceful.is_set() or ctx.preempt.is_set() or \
                spec.save_on_drain

        channel = Channel()
        # what the segment's ranks did; "start" and "last" move live
        record: Dict[str, Any] = {"mesh": mesh.sizes,
                                  "accum": bplan.accum_steps,
                                  "devices": devices, "backend": backend}
        self.rank_segments.append(record)
        try:
            results = run_ranks(
                train_segment, mesh.sizes, kwargs=dict(
                    spec=spec, accum=bplan.accum_steps,
                    store_root=str(self.store.root),
                    fail_at=-1 if self._injected else spec.fail_at,
                    ephemeral=self._ephemeral_store, probe=self.probe),
                device=self.device, devices=devices, backend=backend,
                threads=max(1, torch.get_num_threads() // n),
                channel=channel, on_report=on_report, stop_when=stop_when)
        except RuntimeError as e:
            if f"injected failure at step {spec.fail_at}" in str(e):
                self._injected = True
            raise
        finally:
            self.rank_pids.append(channel.pids)
            if seen["up"] is not None:
                record["rank_start_s"] = seen["up"] - t0
        r0 = results[0]
        wall = time.perf_counter() - t0
        t_first_s = seen["first"] - t0 if seen["first"] is not None else 0.0
        record.update(
            t_first_s=t_first_s, wall_s=wall, saves=r0["saves"],
            restores=[r["restores"] for r in results],
            peak_bytes=[r["peak_bytes"] for r in results],
            launches=[r["launches"] for r in results],
            probes=[r["probes"] for r in results])
        self._log(f"[elastic] segment on {n} ranks ({backend}) mesh "
                  f"{mesh.sizes} accum {bplan.accum_steps}: ranks started "
                  f"in {record.get('rank_start_s', 0.0):.2f} s, t_first_s "
                  f"{t_first_s:.2f}, steps {r0['start']}..{r0['last']}")
        self.report.host_syncs += r0["host_syncs"]
        self.ckpt.saves.extend(r0["saves"])
        self.ckpt.restores.extend(r0["restores"])
        self._wait_ckpt()                       # logs the ranks' saves
        if r0["done"]:
            final = r0["final"]
            if final is None:           # its last step is a kept checkpoint
                final = self.ckpt.restore(r0["last"], self._abstract(),
                                          "cpu")
                self.ckpt.restores.pop()
            self._final = final
        return _SegmentResult(start=r0["start"], last=r0["last"],
                              done=r0["done"], preempted=r0["preempted"],
                              t_first_done=seen["first"], wall_s=wall,
                              host_syncs=r0["host_syncs"],
                              t_first_s=t_first_s)

    def _supervise(self, idx: int, decision: Decision) -> Pod:
        """Submit one segment Job and watch it + the cluster until it ends."""
        spec = self.spec
        graceful = threading.Event()
        plan, bplan = decision.plan, decision.batch

        def segment_fn(ctx):
            try:
                return self._train_segment(ctx, plan, bplan, graceful)
            except NotImplementedError as e:
                self._fatal = e         # no retry can train this kind
                raise

        # a node can die between the capacity decision and this submit; the
        # stale plan then over-asks and the caller replans on the survivors
        try:
            job = self.cluster.submit(spec.namespace, JobSpec(
                name=f"{spec.name}-seg{idx}", fn=segment_fn, replicas=1,
                devices_per_pod=plan.devices_used,
                backoff_limit=0))   # respawn is OUR job, on a new plan
        except RuntimeError as e:
            raise UnschedulableError(str(e)) from e
        pod = job.pods[0]
        while pod.state in (PodState.PENDING, PodState.RUNNING):
            time.sleep(spec.poll_s)
            if pod.ctx.stop.is_set() or pod.ctx.preempt.is_set():
                continue        # draining already — never grow a dying pod
            if self._stop.is_set():
                # external cancel: checkpoint-then-evict the segment
                self.cluster.preempt_pod(pod, reason="stop requested")
                continue
            try:
                grow = self.controller.decide(decision)
            except RuntimeError:
                # total-loss churn mid-poll: no grow — the drain path ends
                # this segment and wait_for_capacity rides out the outage
                grow = None
            if grow is not None:
                # nodes rejoined and a larger mesh fits: preempt gracefully
                graceful.set()
                pod.ctx.stop.set()
        # the segment thread MUST be dead before the next segment starts:
        # two live segments would race on the shared Checkpointer, the
        # trainer's progress/loss state, and the card's memory
        if pod.thread is not None:
            for _ in range(3):
                pod.thread.join(timeout=spec.join_timeout_s)
                if not pod.thread.is_alive():
                    break
                self._log(f"[elastic] segment {idx}: waiting for the "
                          f"drained pod thread to exit...")
            if pod.thread.is_alive():
                raise RuntimeError(
                    f"segment {idx} thread did not exit within "
                    f"{3 * spec.join_timeout_s:.0f}s of its drain — "
                    f"refusing to start a concurrent segment")
        return pod

    # ----------------------------------------------------------------- stop
    def request_stop(self) -> None:
        """Cooperative cancel: the live segment is preempt-drained (it
        checkpoints and exits), no further segment is submitted, and
        ``run()`` returns the partial result."""
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    # ------------------------------------------------------------------ run
    def run(self) -> Dict[str, Any]:
        """Train to ``spec.steps`` across any node-churn schedule.

        Raises ``CapacityLostError`` (from the controller) when the whole
        cluster drops below one model replica for longer than the rejoin
        window, and the ``NotImplementedError`` of a kind the port cannot
        train."""
        spec = self.spec
        if spec.namespace not in self.cluster.namespaces:
            self.cluster.create_namespace(spec.namespace)
        t_run0 = time.perf_counter()
        try:
            self._run_segments(len(self.report.segments))
        finally:
            self.report.total_wall_s += time.perf_counter() - t_run0
        if not self.report.global_batch_constant:
            raise RuntimeError("elastic invariant violated: global batch "
                               "changed across meshes")
        if self._ephemeral_store and not self._stop.is_set():
            # trainer-owned throwaway checkpoint dir (kept on error paths
            # and on cancel, so the goodbye checkpoint survives)
            shutil.rmtree(self.store.root, ignore_errors=True)
        losses = dict(self._losses)
        self.metrics.gauge("elastic/tokens_per_s", self.report.tokens_per_s)
        # the final state goes to the caller only: the trainer sits in
        # reference cycles (its pods' closures), so state it kept would
        # outlive the run until a cycle collection (10.2 GB on the card
        # for phi4 at 4 layers)
        final, self._final = self._final, {}
        return {"losses": [losses[i] for i in sorted(losses)],
                "loss_by_step": losses,
                "params": final.get("params"),
                "opt": final.get("opt"),
                "report": self.report}

    def _run_segments(self, seg_idx: int) -> None:
        spec = self.spec
        failures = 0
        pending_lost_from: Optional[int] = None
        t_fail: Optional[float] = None
        done = False
        unsched_since: Optional[float] = None
        while not done:
            if self._stop.is_set():
                break           # cancelled: the last segment checkpointed
            decision = self.controller.wait_for_capacity(
                spec.rejoin_timeout_s)
            try:
                pod = self._supervise(seg_idx, decision)
            except UnschedulableError as e:  # decision went stale mid-churn
                now = time.monotonic()
                if unsched_since is None:
                    unsched_since = now
                elif now - unsched_since > spec.rejoin_timeout_s:
                    raise RuntimeError(
                        f"segment unschedulable for "
                        f"{spec.rejoin_timeout_s:.0f}s: {e}") from e
                self._log(f"[elastic] segment {seg_idx} unschedulable "
                          f"({e}) -> replan")
                self.metrics.inc("elastic/replans")
                time.sleep(0.1)     # let the churn settle; never spin hot
                seg_idx += 1
                continue
            if self._fatal is not None:
                raise self._fatal
            unsched_since = None
            res: Optional[_SegmentResult] = pod.result
            if res is not None and pending_lost_from is not None:
                # steps the failure forced us to re-execute
                self.report.steps_lost += max(
                    0, pending_lost_from - res.start + 1)
                if t_fail is not None and res.t_first_done is not None:
                    self.report.recovery_s.append(res.t_first_done - t_fail)
                pending_lost_from, t_fail = None, None
            if pod.state == PodState.FAILED:
                churn = pod.error is not None and "NodeFailure" in pod.error
                if churn:
                    self.report.recoveries += 1
                    self.metrics.inc("elastic/recoveries")
                    self._log(f"[elastic] segment {seg_idx}: {pod.error!s}"
                              .splitlines()[0] + " -> rescale + restore")
                else:
                    failures += 1
                    if failures > spec.backoff_limit:
                        raise RuntimeError(
                            f"elastic training failed after {failures} "
                            f"attempts: {pod.error}")
                    self._log(f"[elastic] segment {seg_idx} failed "
                              f"(attempt {failures}/{spec.backoff_limit}) "
                              f"-> restore + retry")
                pending_lost_from = res.last if res is not None \
                    else self._seg_last
                t_fail = time.perf_counter()
                outcome = "node-failure" if churn else "error"
            elif res is not None and res.done:
                done = True
                outcome = "done"
            else:
                # graceful scale-up preempt OR a scheduler eviction: both
                # checkpointed
                outcome = "preempted"
                if pod.state == PodState.PREEMPTED:
                    self.metrics.inc("elastic/preemptions")
                    self._log(f"[elastic] segment {seg_idx} preempted "
                              f"({pod.error}) -> awaiting re-grant")
            # a crashed pod (res None) is still one segment of history:
            # reconstruct its extent from the trainer-side progress marks
            start = res.start if res is not None else self._seg_start
            end = res.last if res is not None \
                else max(start - 1, self._seg_last)
            self.report.segments.append(SegmentRecord(
                index=seg_idx, start=start, end=end,
                mesh_shape=tuple(decision.plan.new_shape),
                accum_steps=decision.batch.accum_steps,
                microbatch=decision.batch.microbatch,
                global_batch=decision.batch.global_batch,
                wall_s=res.wall_s if res is not None else 0.0,
                outcome=outcome,
                t_first_s=res.t_first_s if res is not None else 0.0))
            seg_idx += 1
