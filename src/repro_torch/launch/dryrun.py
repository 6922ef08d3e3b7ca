"""Dry run: every (arch x shape) cell's per-device bytes and FLOPs, on
``meta`` tensors, for the production meshes.  No card and no kernel.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \
        --shape train_4k [--multi-pod | --both-meshes]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        --out experiments/dryrun_torch

The reference lowers and compiles each cell's step onto 256 or 512 host
devices and reads XLA's memory and cost analyses.  One card hosts no such
mesh, so this pass does the same arithmetic itself, per cell:

  * bytes — the step's arguments, built as the reference's ``build_step``
    builds them (params, optimizer state and batch for train; params,
    tokens and extras for prefill, whose cache is an output; params,
    cache, token and pos for decode) as ``meta`` tensors at the cell's
    global shape, each counted at its shard shape under the ported specs
    (``sharding.specs``) with the rules ``build_step`` picks (a train step
    switches to pure FSDP when ``pure_fsdp_train`` is set and the global
    batch divides the chips).  ``argument_bytes`` is the counterpart of
    XLA's ``argument_size_in_bytes``; ``per_device_bytes`` is the
    reference's arguments + outputs - donated, without its temporaries:
    torch has no compiler memory analysis, so ``temp_bytes`` is None.
    ``state_fits_one_card`` holds the state alone (params, optimizer
    state, cache) against the card's 80 GB;
  * FLOPs — the cell's step (the train loss's forward, the prefill step,
    the whole-batch decode step) traced on ``meta`` tensors at one pattern
    group of layers and the full global shape under
    ``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of
    XLA's cost analysis), beside ``roofline.flops.forward_flops`` of the
    same cut config; the trace is the same on both meshes, so each cell
    is traced once.  The kernel wrappers take their plain versions on a
    ``meta`` tensor (``kernels.build.takes_plain``), so nothing launches.
    The record also carries the analytic ``step_flops`` and
    ``model_flops`` per device from ``roofline.flops.accounting``.

There are no collective bytes (the reference's ``--collectives``): the
port has no partitioner whose collectives it could count.  One record a
cell and mesh, ``{arch}__{shape}__{16x16|2x16x16}.json`` under ``--out``;
a cell whose file exists is skipped as cached; any failure exits 1.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import (SHAPES, ModelConfig, OptimizerConfig,
                                      ParallelConfig, ShapeConfig)
from repro_torch.launch import cli
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     mesh_num_chips)
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.roofline import flops as flops_mod
from repro_torch.runtime import steps
from repro_torch.sharding import specs as sh

CARD_BYTES = 80e9          # one H100's HBM, as the state must fit it


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _reduced_cfg(cfg: ModelConfig, groups: int) -> ModelConfig:
    L = len(cfg.block_pattern)
    kw = dict(num_layers=L * groups)
    if cfg.family == "audio":
        kw["encoder_layers"] = groups
    return cfg.replace(**kw)


@dataclass
class StepIO:
    """One step's arguments and outputs as ``meta`` trees with their
    logical axes, in the reference's argument order."""
    par: ParallelConfig              # after the train step's FSDP switch
    rules: dict
    args: Dict[str, Tuple]           # name -> (tree, axes tree)
    outputs: Dict[str, Tuple]
    donated: Tuple[str, ...]


def step_io(cfg: ModelConfig, par: ParallelConfig, ocfg: OptimizerConfig,
            mesh: Mesh, shape: ShapeConfig) -> StepIO:
    """The step ``build_step`` would build for the cell, as meta trees."""
    cfg = steps.resolve_cfg(cfg, shape)
    mod = steps._model_module(cfg)
    schema = mod.lm_schema(cfg)
    B, S = shape.global_batch, shape.seq_len
    params = (pr.abstract_params(schema, cfg.param_dtype),
              pr.axes_tree(schema))
    if shape.kind == "train":
        par = steps.train_par(par, global_batch=B,
                              chips=mesh_num_chips(mesh))
        opt_schema = adamw.opt_state_schema(schema, ocfg)
        opt = (pr.abstract_params(opt_schema, "float32"),
               pr.axes_tree(opt_schema))
        metrics = ({k: _meta((), torch.float32)
                    for k in ("loss", "grad_norm", "lr")},
                   {k: () for k in ("loss", "grad_norm", "lr")})
        return StepIO(par, sh.logical_rules(par),
                      {"params": params, "opt_state": opt,
                       "batch": steps.batch_specs(cfg, shape)},
                      {"params": params, "opt_state": opt,
                       "metrics": metrics},
                      ("params", "opt_state"))
    rules = sh.logical_rules(par)
    cache_schema = mod.cache_schema(cfg, B, S)
    cache = (pr.abstract_params(cache_schema, cfg.param_dtype),
             pr.axes_tree(cache_schema))
    if shape.kind == "prefill":
        T = steps.token_len(cfg, shape)
        args = {"params": params,
                "tokens": (_meta((B, T), torch.int32), ("batch", "seq"))}
        extras = steps.extras_specs(cfg, B)
        if extras is not None:
            args["extras"] = (extras, {k: steps.EXTRAS_AXES[k]
                                       for k in extras})
        last = (_meta((B, cfg.vocab_size), pr.torch_dtype(cfg.compute_dtype)),
                ("batch", "act_vocab"))
        return StepIO(par, rules, args,
                      {"last": last, "cache": cache}, ())
    token = (_meta((B, 1), torch.int32), ("batch", None))
    return StepIO(par, rules,
                  {"params": params, "cache": cache, "token": token,
                   "pos": (_meta((), torch.int32), ())},
                  {"token": token, "cache": cache}, ("cache",))


def _is_axes(x) -> bool:
    """Whether ``x`` is one leaf's logical axes (a tuple of names or None)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def leaves(tree, axes, path: str = ""):
    """(path, tensor, axes) of every leaf of a (tree, axes tree) pair, in
    sorted-key order (JAX's)."""
    if _is_axes(axes):
        yield path, tree, axes
        return
    for k in sorted(axes):
        yield from leaves(tree[k], axes[k], f"{path}/{k}" if path else k)


def shard_bytes(tree, axes, mesh: Mesh, rules) -> int:
    """One device's bytes of a (tree, axes tree) pair under ``rules``."""
    total = 0
    for _path, t, ax in leaves(tree, axes):
        block = sh.shard_shape(t.shape, sh.spec_for(t.shape, ax, mesh, rules),
                               mesh)
        total += math.prod(block) * t.element_size()
    return total


def io_bytes(io: StepIO, mesh: Mesh) -> dict:
    """Per-device bytes of a step: by group, arguments, outputs, donated,
    their net (``per_device_bytes``) and the state against one card."""
    def of(group):
        return {name: shard_bytes(tree, axes, mesh, io.rules)
                for name, (tree, axes) in group.items()}
    args, outs = of(io.args), of(io.outputs)
    state = ("params", "opt_state", "cache")
    groups = {"params": args["params"],
              "opt_state": args.get("opt_state", 0),
              "cache": args.get("cache", outs.get("cache", 0)),
              "batch": sum(v for k, v in args.items() if k not in state)}
    argument = sum(args.values())
    output = sum(outs.values())
    alias = sum(args[k] for k in io.donated)
    state_bytes = groups["params"] + groups["opt_state"] + groups["cache"]
    return {"bytes": groups, "argument_bytes": argument,
            "output_bytes": output, "alias_bytes": alias,
            "per_device_bytes": argument + output - alias,
            "temp_bytes": None, "state_bytes": state_bytes,
            "state_fits_one_card": state_bytes <= CARD_BYTES}


def traced_flops(cfg: ModelConfig, par: ParallelConfig,
                 shape: ShapeConfig) -> Tuple[float, ModelConfig]:
    """FLOPs ``FlopCounterMode`` counts in the cell's step on ``meta``
    tensors at one pattern group and the full global shape -> (flops, the
    cut config).  ``par`` is the step's (after the FSDP switch)."""
    cut = _reduced_cfg(steps.resolve_cfg(cfg, shape), 1)
    mod = steps._model_module(cut)
    params = pr.abstract_params(mod.lm_schema(cut), cut.param_dtype)
    B, S = shape.global_batch, shape.seq_len
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        if shape.kind == "train":
            batch, _axes = steps.batch_specs(cut, shape)
            mod.loss_fn(cut, par, params, batch)
        elif shape.kind == "prefill":
            tokens = _meta((B, steps.token_len(cut, shape)), torch.int32)
            steps.prefill_step(cut, params, tokens,
                               extras=steps.extras_specs(cut, B))
        else:
            cache = pr.abstract_params(mod.cache_schema(cut, B, S),
                                       cut.param_dtype)
            steps.slot_decode_step(cut, params, cache,
                                   _meta((B, 1), torch.int32),
                                   _meta((), torch.int32))
    return float(counter.get_total_flops()), cut


def run_cell(arch: str, shape_name: str, *, mesh: Optional[Mesh] = None,
             trace: Optional[dict] = None, verbose: bool = True) -> dict:
    """One cell's record on ``mesh`` (the single-pod production mesh by
    default).  ``trace`` reuses an earlier ``trace_cell`` of the cell."""
    cfg = registry.get_config(arch)
    par = registry.get_parallel(arch)
    ocfg = registry.get_optimizer(arch)
    shape = SHAPES[shape_name]
    mesh = mesh or make_production_mesh()
    chips = mesh_num_chips(mesh)
    t0 = time.perf_counter()
    io = step_io(cfg, par, ocfg, mesh, shape)
    nbytes = io_bytes(io, mesh)
    bytes_s = time.perf_counter() - t0
    trace = trace or trace_cell(arch, shape_name, mesh=mesh)
    acc = flops_mod.accounting(cfg, shape, chips, ocfg)
    analytic = flops_mod.forward_flops(trace["cut"], shape, chips)
    rec = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": mesh.tag, "chips": chips,
        "recipe": {"moment_dtype": ocfg.moment_dtype,
                   "second_moment": ocfg.second_moment},
        "pure_fsdp": io.par.pure_fsdp,
        **nbytes,
        "trace_layers": trace["cut"].num_layers,
        "trace_mesh": trace["mesh"],
        "counted_flops": trace["flops"],
        "analytic_flops": analytic,
        "counted_over_analytic": trace["flops"] / analytic,
        "step_flops": acc.step_flops_global / chips,
        "model_flops": acc.model_flops / chips,
        "bytes_s": bytes_s, "trace_s": trace["seconds"],
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {rec['mesh']}: args "
              f"{rec['argument_bytes'] / 2**30:.2f} GiB, state "
              f"{rec['state_bytes'] / 2**30:.2f} GiB "
              f"(fits one card: {rec['state_fits_one_card']}); counted/"
              f"analytic {rec['counted_over_analytic']:.3f} over "
              f"{rec['trace_layers']} layer(s)")
    return rec


def trace_cell(arch: str, shape_name: str, *,
               mesh: Optional[Mesh] = None) -> dict:
    """The cell's meta trace under the rules of ``mesh`` (the single-pod
    production mesh by default): {"flops", "cut", "mesh", "seconds"}."""
    shape = SHAPES[shape_name]
    mesh = mesh or make_production_mesh()
    par = registry.get_parallel(arch)
    if shape.kind == "train":
        par = steps.train_par(par, global_batch=shape.global_batch,
                              chips=mesh_num_chips(mesh))
    t0 = time.perf_counter()
    flops, cut = traced_flops(registry.get_config(arch), par, shape)
    return {"flops": flops, "cut": cut, "mesh": mesh.tag,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_arch(ap)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every assigned (arch x shape) cell")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = registry.cells()
    else:
        cells = [(args.arch, SHAPES[args.shape], False)]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    failures = []
    t0 = time.perf_counter()
    for arch, shape, _ in cells:
        trace = None
        for mp in meshes:
            mesh = make_production_mesh(multi_pod=mp)
            tag = f"{arch}__{shape.name}__{mesh.tag}"
            path = out_dir / f"{tag}.json"
            if path.exists():
                print(f"[dryrun] skip cached {tag}")
                continue
            try:
                trace = trace or trace_cell(arch, shape.name)
                rec = run_cell(arch, shape.name, mesh=mesh, trace=trace)
                path.write_text(json.dumps(rec, indent=1))
            except Exception as e:  # a failure here is a bug in the port
                failures.append((tag, repr(e)))
                print(f"[dryrun] FAIL {tag}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print(f"\nall dry-run cells passed in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
