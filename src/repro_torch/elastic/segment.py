"""One elastic training segment on ranks: what each rank process runs.

``ElasticTrainer`` on a cluster whose slots are ranks
(``ElasticTrainSpec.ranks``) runs each segment as ``launch.ranks.run_ranks
(train_segment, plan.new_shape, ..., channel=)``: one process a leased
slot, laid out as ``core.elastic.make_elastic_mesh`` lays the slots out.
Each rank

  * restores the newest checkpoint onto the plan's mesh: the step rank 0
    picks, each rank's blocks cut from the whole leaves under
    ``steps.train_par``'s layout for this mesh and batch
    (``Checkpointer.restore_latest(mesh=)``); with none, draws the whole
    params from ``spec.seed`` on its own device's generator, as the
    one-device trainer draws them on its device (so every mesh of one
    device type starts from the same weights), and keeps its blocks, with
    zero moments (``steps.init_opt_state(mesh=)``);
  * runs chunks of ``spec.device_steps`` steps, each
    ``steps.train_chunk(..., mesh=rm)`` (the xent, AdamW and, for MoE,
    gmm kernels on a card), on the absolute chunk grid
    (``trainer.chunk_schedule``);
  * at each chunk boundary reads the parent's stop through rank 0
    (``Channel.stopped``), so every rank breaks at the same boundary, and
    raises ``spec``'s injected failure (``fail_at``) on every rank at the
    same chunk;
  * rank 0 reports each chunk's last step and losses to the parent
    (``Channel.report``), which moves the trainer's ``progress``;
  * checkpoints on ``snap_cadence(spec.ckpt_every)`` from the ranks' blocks
    in the reference's format (rank 0 writes), and on the way out as the
    one-device segment does: always when it finished or a graceful or
    scheduler preempt stopped it, after a drain only under
    ``spec.save_on_drain`` (the stop's ``save`` flag).

Rank 0's result carries the segment's extent, its checkpoint records and,
when the segment finished the run and its last step is not a kept
checkpoint, the whole state gathered to the CPU.  ``probe`` (a
module-level function, imported by name in each rank) sees each rank's
blocks after a restore and before each save: ``probe(event, step, tree,
rm)`` with ``event`` "restore" or "save"; its picklable results come back
in each rank's result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import sys
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpoint import (Checkpointer,
                                               flatten_with_paths,
                                               gather_whole)
from repro_torch.data.objectstore import ObjectStore
from repro_torch.data.tokens import ChunkPrefetcher, TokenPipeline
from repro_torch.launch.mesh import RankMesh
from repro_torch.launch.ranks import kernel_counts
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.runtime import steps


def block_digest(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes, on the host."""
    data = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(data.cpu().numpy().tobytes()).hexdigest()


def digest_probe(event: str, step: int, tree, rm: RankMesh) -> dict:
    """A ``probe`` (``ElasticTrainer(probe="repro_torch.elastic.segment:
    digest_probe")``): each of this rank's blocks' ``block_digest``, keyed
    as the checkpoint keys its leaves."""
    return {key: block_digest(t) for key, t in flatten_with_paths(tree)}


def _import(name: Optional[str]):
    """``"module:function"`` -> the function (None stays None)."""
    if name is None:
        return None
    module, attr = name.split(":")
    return getattr(importlib.import_module(module), attr)


def train_segment(rm: RankMesh, spec, *, accum: int, store_root: str,
                  fail_at: int, ephemeral: bool, channel,
                  probe: Optional[str] = None) -> dict:
    """One segment of ``spec`` (an ``ElasticTrainSpec``) on this rank at
    ``accum`` microbatches a step, checkpointing into ``store_root``;
    ``ephemeral``: the store is the trainer's throwaway one.  See the
    module docstring."""
    t0 = time.perf_counter()
    channel.report(rm, started=True)
    dev, cfg = rm.device, spec.cfg
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernel_counts()
    say = (lambda msg: print(msg, file=sys.stderr, flush=True)) \
        if spec.verbose and rm.rank == 0 else (lambda msg: None)
    probe_fn, probes = _import(probe), []
    ocfg = dataclasses.replace(spec.ocfg, accum_steps=accum)
    par = steps.train_par(spec.par, global_batch=spec.global_batch,
                          chips=rm.world_size)
    schema = steps._model_module(cfg).lm_schema(cfg)
    opt_schema = adamw.opt_state_schema(schema, spec.ocfg)
    layout = {"mesh": rm, "par": par,
              "schema": {"params": schema, "opt": opt_schema}}
    abstract = {"params": pr.abstract_params(schema, cfg.param_dtype),
                "opt": pr.abstract_params(opt_schema, "float32")}
    ckpt = Checkpointer(ObjectStore(store_root), keep=spec.keep)
    restored, meta = ckpt.restore_latest(abstract, **layout)
    if restored is not None:
        params, opt = restored["params"], restored["opt"]
        start = saved_at = int(meta["step"])
        start += 1
        rec = ckpt.restores[-1]
        say(f"[elastic] restored step {saved_at} onto mesh {rm.mesh.sizes}: "
            f"{rec['seconds']:.2f} s, {rec['bytes'] / 1e9:.3f} GB read a "
            f"rank")
        if probe_fn is not None:
            probes.append(("restore", saved_at, probe_fn(
                "restore", saved_at, restored, rm)))
    else:
        start, saved_at = 0, -1
        whole = pr.init_params(
            schema, torch.Generator(device=dev).manual_seed(spec.seed),
            cfg.param_dtype, dev)
        params = steps.shard_params(cfg, par, whole, rm)
        del whole
        opt = steps.init_opt_state(cfg, ocfg, dev, mesh=rm, par=par)
    del restored
    channel.report(rm, start=start)

    # the trainer's own cadence and chunk grid (imported here: the
    # trainer module imports this one)
    from repro_torch.elastic.trainer import chunk_schedule, snap_cadence
    K = max(spec.device_steps, 1)
    eff_ckpt = snap_cadence(spec.ckpt_every, K)
    eff_log = snap_cadence(spec.log_every, K)
    pipe = TokenPipeline(cfg.vocab_size, spec.seq_len, spec.global_batch,
                         seed=spec.data_seed)
    schedule = chunk_schedule(start, spec.steps, K)
    last, t_first, preempted, save_on_stop = start - 1, None, False, False
    host_syncs = 0

    def save(step, sync):
        if probe_fn is not None:
            probes.append(("save", step, probe_fn(
                "save", step, {"params": params, "opt": opt}, rm)))
        (ckpt.save if sync else ckpt.save_async)(
            step, {"params": params, "opt": opt}, **layout)

    prefetch = ChunkPrefetcher(pipe, schedule, depth=spec.prefetch_depth)
    try:
        for cstart, k in schedule:
            cend = cstart + k - 1
            stop, save_on_stop = channel.stopped(rm)
            if stop:
                preempted = True
                break
            if cstart <= fail_at <= cend:
                raise RuntimeError(f"injected failure at step {fail_at}")
            _, batches = prefetch.get()
            params, opt, ms = steps.train_chunk(
                cfg, par, ocfg, params, opt, batches, device=dev, mesh=rm)
            losses = ms["loss"].tolist()    # every rank's: the global loss
            host_syncs += 2                 # the dispatch and the readback
            last = cend
            if t_first is None:
                t_first = time.perf_counter()
            channel.report(rm, last=cend, losses={
                cstart + j: v for j, v in enumerate(losses)})
            if eff_ckpt and (cend + 1) % eff_ckpt == 0:
                save(cend, sync=False)
                saved_at = cend
            if eff_log and (cstart % eff_log == 0 or cend == spec.steps - 1):
                say(f"[elastic] step {cend} loss {losses[-1]:.4f} mesh "
                    f"{rm.mesh.sizes} accum {accum}")
    finally:
        prefetch.close()
    ckpt.wait()
    done = (last == spec.steps - 1 and not preempted) or start >= spec.steps
    want_final_save = (not preempted) or save_on_stop
    if done and ephemeral and not spec.ckpt_every:
        want_final_save = False
    if last >= start and saved_at != last and want_final_save:
        save(last, sync=True)
        saved_at = last
    # the finished state goes back whole: read from its checkpoint where
    # one is kept, else gathered here
    final = None
    if done and not (saved_at == last and spec.keep != 0):
        final = gather_whole({"params": params, "opt": opt}, **layout)
    after = kernel_counts()
    return {"rank": rm.rank, "coords": rm.coords, "start": start,
            "last": last, "done": done, "preempted": preempted,
            "saved_at": saved_at, "host_syncs": host_syncs,
            "t_first_s": None if t_first is None else t_first - t0,
            "saves": ckpt.saves, "restores": ckpt.restores, "final": final,
            "probes": probes,
            "launches": {k: after[k] - before[k] for k in after},
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else None}
