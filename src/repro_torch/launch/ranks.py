"""One process a rank: the port's train step across ranks.

The counterpart of the reference's ``jax.devices()`` laid out as a mesh.
``run_ranks(fn, mesh_shape)`` spawns one process a rank (``spawn``, so
each starts from a fresh import), joins them into a ``torch.distributed``
process group through a file store in a temporary directory of its own
(two calls at once never share a port or a store), gives each its device
and its ``launch.mesh.RankMesh``, runs ``fn(rank_mesh, *args, **kwargs)``
there and returns each rank's result, in rank order.  ``fn`` must be
importable (a module-level function; the ones here are ``train_ranks`` and
``moe_ranks``) and its result picklable.

The backend is NCCL on CUDA and gloo on the CPU unless the caller names
one.  Rank r takes ``cuda:r``: a mesh larger than the cards raises unless
the caller passes ``devices=`` itself.  NCCL takes one card a rank; two
ranks on one card (``devices=["cuda:0", "cuda:0"]``) run over gloo.

A segment of the elastic trainer (``elastic.segment``) runs through
``run_ranks(..., channel=Channel(), on_report=, stop_when=)``, which hands
``fn`` the channel as ``channel=`` and keeps two channels open while the
ranks run:

  * progress, rank 0 to the parent: ``channel.report(rm, **msg)`` on rank
    0 reaches ``on_report(msg)`` in the parent as it happens (a chunk's
    last step and losses, so the trainer's ``progress`` moves live);
  * stop, the parent to every rank: the parent polls ``stop_when()``
    (None: go on; True or False: stop, saving on the way out or not) and
    sets the channel's stop; ``channel.stopped(rm)`` reads it on rank 0
    at a chunk boundary and hands it to every rank, so all break at the
    same boundary.

A rank's exception ends the call with a ``RuntimeError`` holding the
rank's traceback; the other ranks are terminated first.  No rank process
outlives the call, however it ends (``channel.pids`` names them).

    python -m repro_torch.launch.ranks --arch granite-moe-1b-a400m \\
        --mesh 1,2 --steps 2 --layers 4 --devices cuda:0,cuda:0 \\
        --backend gloo
    python -m repro_torch.launch.ranks --arch phi4-mini-3.8b --mesh 1,2 \\
        --layers 4 --devices cuda:0,cuda:0 --backend gloo
    python -m repro_torch.launch.ranks --arch zamba2-2.7b --mesh 1,2 \\
        --layers 6 --devices cuda:0,cuda:0 --backend gloo
    python -m repro_torch.launch.ranks --smoke --mesh 2,2 --steps 2 \\
        --device cpu

trains under the arch's own ``ParallelConfig`` (``registry.get_parallel``:
tensor and sequence parallelism on ``model`` for granite-moe; for phi4,
gemma2, codeqwen, deepseek, zamba2 and rwkv6 pure FSDP wherever
``--batch`` divides the mesh, ``steps.train_par``, and their tensor- and
sequence-parallel defaults where it does not, which zamba2 and rwkv6 do
not run), with ``--layout ep`` under ``RANK_PARALLEL``,
or with ``--layout fsdp`` under ``ParallelConfig(pure_fsdp=True)``; an
arch whose layout ``steps.check_layout`` refuses on the mesh raises
before any rank starts.  It prints each step's loss, ms and collective
bytes per rank and each rank's peak memory (``--device cpu``: none; the
CPU has no allocator counter).
"""
from __future__ import annotations

import argparse
import math
import os
import pickle
import queue
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelConfig)
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.grad_check import contracted_attention_init_
from repro_torch.kernels import adamw_update, moe_gmm, ssm_scan, wkv6, xent
from repro_torch.launch.mesh import RankMesh, make_mesh, make_rank_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as pr
from repro_torch.runtime import steps
from repro_torch.sharding import collectives, specs

# the expert-parallel-only layout across ranks: the reference's rules with
# ZeRO-3 on data and experts on model, tensor and sequence parallelism off
# (the dense part replicated over model); ``main``'s ``--layout ep``.  An
# arch's own layout is ``registry.get_parallel(arch)``: for granite-moe
# and kimi ``ParallelConfig()``, with both on; for phi4, gemma2, codeqwen
# and deepseek ``ParallelConfig(pure_fsdp_train=True)``, pure FSDP on a
# train step whose global batch divides the ranks
RANK_PARALLEL = ParallelConfig(tensor_parallel=False, sequence_parallel=False)
# how often the parent of a segment's ranks serves its channels (seconds)
POLL_S = 0.01


def _worker(rank: int, fn, shape, devices, backend: str, threads: int,
            root: str, args, kwargs) -> None:
    torch.set_num_threads(threads)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{root}/store",
                            rank=rank, world_size=len(devices))
    try:
        out = fn(make_rank_mesh(tuple(shape), dev), *args, **kwargs)
        with open(f"{root}/rank{rank}.part", "wb") as f:
            pickle.dump(out, f)
        os.replace(f"{root}/rank{rank}.part", f"{root}/rank{rank}.pkl")
    finally:
        dist.destroy_process_group()


class Channel:
    """A segment's progress and stop channels between the parent of
    ``run_ranks`` and its ranks (see the module docstring).  Made in the
    parent before the call; it reaches the ranks as they spawn."""

    def __init__(self):
        ctx = torch.multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._stop = ctx.Event()
        self._save = ctx.Event()
        self.pids: List[int] = []          # the parent's record of its ranks

    # ------------------------------------------------------------- parent
    def stop(self, save: bool) -> None:
        if save:
            self._save.set()
        self._stop.set()

    @property
    def stopping(self) -> bool:
        return self._stop.is_set()

    def drain(self, timeout: float = 0.0) -> list:
        """The messages rank 0 sent since the last call (waiting up to
        ``timeout`` seconds for the first)."""
        out = []
        try:
            out.append(self._queue.get(timeout=timeout) if timeout
                       else self._queue.get_nowait())
            while True:
                out.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        return out

    # -------------------------------------------------------------- ranks
    def report(self, rm: RankMesh, **msg) -> None:
        """Rank 0's message to the parent (other ranks send nothing)."""
        if rm.rank == 0:
            self._queue.put(msg)

    def stopped(self, rm: RankMesh):
        """(stop, save) as rank 0 reads them, on every rank: every rank
        calls it at the same boundary."""
        stop, save = rm.from_rank0([self._stop.is_set(), self._save.is_set()])
        return bool(stop), bool(save)


def run_ranks(fn, mesh_shape: Sequence[int], *, args=(), kwargs=None,
              device="cuda", backend: Optional[str] = None,
              devices: Optional[Sequence[str]] = None,
              threads: Optional[int] = None,
              channel: Optional[Channel] = None,
              on_report: Optional[Callable[[dict], None]] = None,
              stop_when: Optional[Callable[[], Optional[bool]]] = None
              ) -> list:
    """``fn(rank_mesh, *args, **kwargs)`` on one process a rank of a
    ``("data", "model")`` mesh of ``mesh_shape`` -> each rank's result.

    ``device`` is the ranks' device type (``"cuda"``, which raises without
    a card, or ``"cpu"``); rank r takes ``cuda:r`` unless ``devices``
    names each rank's.  ``threads`` sets each rank's
    ``torch.set_num_threads`` (default: the host's cores over the ranks).
    ``channel`` (passed to ``fn`` as ``channel=``) carries rank 0's
    reports to ``on_report`` and the stop ``stop_when`` asks for, every
    ``POLL_S`` seconds.
    """
    world = math.prod(int(n) for n in mesh_shape)
    kind = resolve_device(device).type
    if devices is None:
        if kind == "cuda":
            cards = torch.cuda.device_count()
            if cards < world:
                raise RuntimeError(
                    f"a mesh of {tuple(mesh_shape)} needs {world} cards, "
                    f"this host has {cards}; pass devices=[...] to put "
                    f"several ranks on one card (over gloo)")
            devices = [f"cuda:{r}" for r in range(world)]
        else:
            devices = ["cpu"] * world
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != world or any(torch.device(d).type != kind
                                    for d in devices):
        raise ValueError(f"devices {devices}: one {kind} device for each of "
                         f"the {world} ranks")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and len(set(devices)) < world:
        raise ValueError(f"NCCL takes one card a rank, not {devices}; ranks "
                         f"sharing a card run over gloo")
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    kwargs = dict(kwargs or {})
    if channel is not None:
        kwargs["channel"] = channel
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as root:
        ctx = torch.multiprocessing.start_processes(
            _worker, args=(fn, tuple(mesh_shape), devices, backend, threads,
                           root, tuple(args), kwargs),
            nprocs=world, join=False, start_method="spawn")
        if channel is not None:
            channel.pids = [p.pid for p in ctx.processes]
        try:
            _join(ctx, channel, on_report, stop_when)
        except ProcessException as e:
            raise RuntimeError(f"a rank of mesh {tuple(mesh_shape)} "
                               f"failed: {e}") from None
        finally:
            for p in ctx.processes:          # no rank outlives the call
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(f"{root}/rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
    return out


def _join(ctx, channel, on_report, stop_when) -> None:
    """Wait for every rank, serving the segment channels meanwhile."""
    if channel is None:
        ctx.join()
        return
    while True:
        done = ctx.join(timeout=0)
        for msg in channel.drain(timeout=0 if done else POLL_S):
            if on_report is not None:
                on_report(msg)
        if done:
            return
        if stop_when is not None and not channel.stopping:
            save = stop_when()
            if save is not None:
                channel.stop(save)


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------

def kernel_counts() -> dict:
    """This process's launches of the kernels a train step across ranks
    runs (each wrapper's count): the grouped matmul, the xent kernels,
    AdamW and the two scans."""
    return {"moe_gmm": moe_gmm.launches, "xent_fwd": xent.fwd_launches,
            "xent_bwd": xent.bwd_launches,
            "adamw_update": adamw_update.launches,
            "ssd_scan": ssm_scan.launches, "wkv6": wkv6.launches}


def seeded_params(cfg: ModelConfig, seed: int):
    """Whole params of ``cfg`` from ``seed``, drawn on the CPU (so the
    ranks of every mesh and device start from the same weights) as the
    train phases of ``chip_smoke.py`` draw theirs: the reference init,
    every attention at its contracted fan-in, in ``cfg.param_dtype``."""
    gen = torch.Generator().manual_seed(seed)
    params = pr.init_params(steps._model_module(cfg).lm_schema(cfg), gen,
                            "float32", "cpu")
    contracted_attention_init_(cfg, params)
    return steps._map(lambda t: t.to(pr.torch_dtype(cfg.param_dtype)),
                      params)


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}" if path else k))
        return out
    return {path: tuple(tree.shape)}


def fsdp_step_bytes(cfg: ModelConfig, par: ParallelConfig, shape,
                    accum: int = 1, rl: bool = False) -> dict:
    """The bytes ``collectives.bytes_sent`` counts on every rank in one
    pure-FSDP train step (``par.pure_fsdp``) on a ``("data", "model")``
    mesh of ``shape``, from the leaf shapes alone: per microbatch each
    split leaf's block is all-gathered (a layer's twice under remat: the
    forward and its recompute; a top-level leaf, zamba2's shared
    attention among them, once) and its whole gradient reduce-scattered,
    in the param dtype; per step a leaf that some axis of more than one
    rank does not split has its block's gradient all-reduced over it (in
    f32 when ``accum`` > 1 sums the microbatches' grads), and so do the
    loss metric and the squared norm (4 bytes each).  ``rl``: the RL
    loss also all-reduces its mask sum (4 bytes) a microbatch."""
    if not par.pure_fsdp:
        raise ValueError("fsdp_step_bytes counts the pure-FSDP layout")
    mesh = make_mesh(tuple(shape), ("data", "model"))
    rules = specs.logical_rules(par)
    item = torch.empty((), dtype=pr.torch_dtype(cfg.param_dtype)
                       ).element_size()
    grad_item = 4 if accum > 1 else item
    out = {"all_gather": 0, "reduce_scatter": 0, "all_to_all": 0,
           "all_reduce": 8 + (4 * accum if rl else 0)}
    for path, p in pr.leaves(steps._model_module(cfg).lm_schema(cfg)):
        spec = specs.spec_for(p.shape, p.axes, mesh, rules)
        whole = math.prod(p.shape)
        block = math.prod(specs.shard_shape(p.shape, spec, mesh))
        if block < whole:
            gathers = 2 if par.remat and path.startswith("blocks/") else 1
            out["all_gather"] += block * item * gathers * accum
            out["reduce_scatter"] += whole * item * accum
        if any(mesh.shape[a] > 1 and specs.axis_dim(spec, a) is None
               for a in mesh.axis_names):
            out["all_reduce"] += block * grad_item
    return out


def train_ranks(rm: RankMesh, cfg: ModelConfig, par: ParallelConfig,
                ocfg: OptimizerConfig, batches, *, params=None,
                seed: int = 0, keep: bool = False, rl: bool = False) -> dict:
    """One train step on this rank for each step of ``batches`` ((K, B,
    S) numpy "tokens" and "labels", the global batch of each step), a
    one-step ``steps.train_chunk``, or with ``rl`` ``steps.rl_train_chunk``
    (the RL learner's loss; ``batches`` then also carry "mask" (K, B, S)
    and "advantages" (K, B)), from whole ``params`` (numpy, as
    ``bridge.to_numpy`` gives them) or, where None, ``seeded_params(cfg,
    seed)``.  -> {"rank", "coords",
    "steps": per step loss, grad_norm, lr, ms, collective bytes and peak
    bytes, "launches": the step's kernel launches, "shapes": every param
    and moment block's shape, "params": the blocks as numpy where
    ``keep``}."""
    dev = rm.device
    # the blocks are laid out as the step will run: under pure FSDP
    # wherever ``par`` asks for it on train steps and the batch divides
    # the ranks (the reference's ``_train_pieces`` switches before it
    # lays out its shardings)
    par = steps.train_par(par, global_batch=batches["tokens"].shape[1],
                          chips=rm.world_size)
    whole = (seeded_params(cfg, seed) if params is None
             else bridge.to_torch(params, device="cpu"))
    local = steps._map(lambda t: t.to(dev),
                       steps.shard_params(cfg, par, whole, rm))
    del whole
    opt = steps.init_opt_state(cfg, ocfg, dev, mesh=rm, par=par)
    cuda = dev.type == "cuda"
    step = steps.rl_train_chunk if rl else steps.train_chunk
    before = kernel_counts()
    rows = []
    for j in range(batches["tokens"].shape[0]):
        collectives.reset_counts()
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        local, opt, m = step(
            cfg, par, ocfg, local, opt,
            {k: v[j:j + 1] for k, v in batches.items()}, device=dev, mesh=rm)
        m = {k: float(v[0]) for k, v in m.items()}
        if cuda:
            torch.cuda.synchronize(dev)
        rows.append({**m, "ms": (time.perf_counter() - t0) * 1e3,
                     "bytes": dict(collectives.bytes_sent),
                     "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if cuda else None)})
    after = kernel_counts()
    out = {"rank": rm.rank, "coords": rm.coords, "steps": rows,
           "launches": {k: after[k] - before[k] for k in after},
           "shapes": {"params": _shapes(local), "m": _shapes(opt["m"]),
                      "v": _shapes(opt["v"])}}
    if keep:
        out["params"] = bridge.to_numpy(local)
    return out


def moe_ranks(rm: RankMesh, cfg: ModelConfig, p, x, dy) -> dict:
    """The MoE block's routed MLP in train mode on this rank, and its
    gradients: ``p`` one layer's whole ``router`` (D, E) and ``moe_w*``
    (E, ...) (numpy), ``x`` and ``dy`` (B, S, D) the global activations
    and the cotangent of the output.  The rank takes its rows of x (over
    ``data``) and its experts (over ``model``) and differentiates
    ``sum(out * dy) + aux``.  -> {"out", "aux", "grads": {"x", "router",
    "moe_wg", ...} of its blocks} as numpy."""
    dev = rm.device
    tp, m = rm.size("model"), rm.coords["model"]
    dp, d = rm.size("data"), rm.coords["data"]
    E_local = cfg.moe.num_experts // tp
    whole = bridge.to_torch(p, device=dev)
    local = {k: (v[m * E_local:(m + 1) * E_local] if k.startswith("moe_")
                 else v).clone().requires_grad_() for k, v in whole.items()}
    rows = x.shape[0] // dp
    xs = torch.as_tensor(x[d * rows:(d + 1) * rows], device=dev)
    xs.requires_grad_()
    with torch.enable_grad():
        out, aux = moe_mod.moe_mlp(cfg, local, xs, train=True, mesh=rm)
        loss = (out * torch.as_tensor(dy[d * rows:(d + 1) * rows],
                                      device=dev)).sum() + aux
        grads = torch.autograd.grad(loss, [xs, *local.values()])
    return {"out": out.detach().cpu().numpy(), "aux": float(aux),
            "grads": {k: g.cpu().numpy()
                      for k, g in zip(["x", *local], grads)}}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (f32)")
    ap.add_argument("--mesh", default="1,2", help="data,model sizes")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all), a "
                         "multiple of the block pattern's length (6 for "
                         "zamba2-2.7b: five mamba layers and one with the "
                         "shared attention)")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2, help="global batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default="",
                    help="comma-separated device of each rank, e.g. "
                         "cuda:0,cuda:0 (several ranks a card need gloo)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--layout", default="own",
                    choices=["own", "ep", "fsdp"],
                    help="own: the arch's ParallelConfig; ep: "
                         "RANK_PARALLEL (experts on model, nothing else); "
                         "fsdp: ParallelConfig(pure_fsdp=True)")
    args = ap.parse_args(argv)
    shape = tuple(int(n) for n in args.mesh.split(","))
    cfg = (registry.get_smoke if args.smoke else registry.get_config)(
        args.arch)
    if args.layers % len(cfg.block_pattern):
        ap.error(f"--layers {args.layers}: {args.arch} stacks its layers in "
                 f"groups of {len(cfg.block_pattern)} "
                 f"{cfg.block_pattern}")
    dtype = "float32" if args.smoke else "bfloat16"
    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype,
                      num_layers=args.layers or cfg.num_layers)
    ocfg = OptimizerConfig(warmup_steps=2)
    batches = TokenPipeline(cfg.vocab_size, args.seq, args.batch,
                            seed=args.seed).chunk(0, args.steps)
    par = {"own": registry.get_parallel(args.arch), "ep": RANK_PARALLEL,
           "fsdp": ParallelConfig(pure_fsdp=True)}[args.layout]
    # refuse an unported layout here, before any rank starts
    steps.check_layout(cfg, steps.train_par(par, global_batch=args.batch,
                                            chips=math.prod(shape)),
                       ocfg, make_mesh(shape, ("data", "model")),
                       seq=args.seq)
    results = run_ranks(
        train_ranks, shape, args=(cfg, par, ocfg, batches),
        kwargs={"seed": args.seed}, device=args.device,
        backend=args.backend, threads=args.threads,
        devices=[d for d in args.devices.split(",") if d] or None)
    for j in range(args.steps):
        for res in results:
            row = res["steps"][j]
            print(f"[ranks] mesh {args.mesh} rank {res['rank']} "
                  f"{res['coords']} step {j + 1} loss {row['loss']:.6f} "
                  f"grad_norm {row['grad_norm']:.6f} ms {row['ms']:.1f} "
                  f"bytes {row['bytes']}")
    for res in results:
        peak = max((row["peak_bytes"] or 0) for row in res["steps"])
        print(f"[ranks] rank {res['rank']} peak memory "
              f"{peak / 1e9:.3f} GB launches {res['launches']}")
    return results


if __name__ == "__main__":
    main()
