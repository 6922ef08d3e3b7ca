"""Where training time goes on the card: a few full-width train steps.

    python -m repro_torch.launch.profile_train
    python -m repro_torch.launch.profile_train --arch zamba2-2.7b
    python -m repro_torch.launch.profile_train --arch gemma2-9b --layers 14
    python -m repro_torch.launch.profile_train --arch llama-3.2-vision-90b \
        --layers 2 --pattern attn,cross
    python -m repro_torch.launch.profile_train --arch kimi-k2-1t-a32b \
        --layers 2 --experts 64

Builds full-width training of ``--arch`` (default ``phi4-mini-3.8b``; bf16
params, the arch's own moments (f32; kimi's int8 + factored), random
weights from ``SEED`` as ``chip_smoke.py`` draws them, remat on), its depth
cut to ``--layers`` where given (with the block pattern ``--pattern`` where
the config's does not divide it) and an MoE's experts to ``--experts``
(kimi's 384 at two layers are 56 B params: 64 fit one card), takes
one untimed step (kernel build, cuBLAS set-up), then runs ``STEPS``
optimizer steps of ``BATCH`` x ``SEQ`` tokens (whisper: its decoder
length, with ``SEQ`` frames), each under ``torch.profiler``.  For each
step it prints the profiler's table and then one JSON line: host wall
time, device busy time (the union of kernel intervals), the device's idle
share, the time in the port's kernels (xent, AdamW, the scans, gmm) and in
matrix products, the kernel count, and the top kernels by device time.
Needs a CUDA card.

``train_setup`` is the set-up ``chip_smoke.py``'s train phases share: the
reference init with every attention rescaled by
``grad_check.contracted_attention_init_`` (under the reference's own init
the grads grow with depth: ROADMAP queue C), the VLM's cross gates drawn
nonzero (the reference zeroes them, and a zero gate passes no gradient
into the cross block), and the family's extras drawn from the seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.configs.base import OptimizerConfig, ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.grad_check import contracted_attention_init_
from repro_torch.launch.profile_serve import _kernel_stats
from repro_torch.models import params as pr
from repro_torch.runtime import steps

ARCH = "phi4-mini-3.8b"
BATCH, SEQ, STEPS, SEED = 2, 1024, 2, 0
GROUPS = {"xent_ms": ("xent_fwd", "xent_bwd"), "adamw_ms": ("adamw",),
          "ssd_ms": ("ssd_fwd",), "wkv6_ms": ("wkv_fwd",),
          "gmm_ms": ("gmm_",),
          "matmul_ms": ("gemm", "nvjet", "cutlass", "sm90_xmma")}


def cut_config(cfg, layers: int = 0, pattern: Optional[Sequence[str]] = None,
               experts: int = 0):
    """``cfg`` at full width with ``layers`` layers (all when 0), in groups
    of ``pattern`` (the config's own by default, which must divide it), and
    an MoE config cut to ``experts`` experts (all when 0; top-k and the
    capacity factor kept)."""
    if experts:
        if cfg.moe is None or not cfg.moe.top_k <= experts <= \
                cfg.moe.num_experts:
            raise ValueError(f"{cfg.name}: cannot cut to {experts} experts")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=experts))
    if pattern:
        unknown = set(pattern) - set(cfg.block_pattern)
        if unknown:
            raise ValueError(f"{cfg.name} has no block kinds {sorted(unknown)}")
        cfg = cfg.replace(block_pattern=tuple(pattern))
    layers = layers or cfg.num_layers
    if layers % len(cfg.block_pattern):
        raise ValueError(f"{layers} layers do not divide into groups of "
                         f"{cfg.block_pattern}")
    return cfg.replace(num_layers=layers)


def train_setup(arch: str, *, layers: int = 0, pattern=None, experts: int = 0,
                seq: int = SEQ, batch: int = BATCH, seed: int = SEED,
                device="cuda", smoke: bool = False, dtype: str = "bfloat16"):
    """Full-width (with ``smoke``, the smoke config's) training state for
    ``arch`` on ``device``, cut by ``cut_config``: -> (cfg, par, ocfg,
    params (in ``dtype``, the config's compute dtype too), opt (the arch's
    own moment recipe: f32 moments, or kimi's int8 + factored), chunk),
    where
    ``chunk(start, K)`` gives steps start..start+K-1 stacked (K, B, ...)
    for ``steps.train_chunk``: TokenPipeline tokens of the family's train
    length and, where it has them, its extras, random normal from the
    seed."""
    dev = torch.device(device)
    cfg = cut_config((registry.get_smoke if smoke else registry.get_config)(
        arch), layers, pattern, experts).replace(param_dtype=dtype,
                                                 compute_dtype=dtype)
    cfg = steps.resolve_cfg(cfg, ShapeConfig("train", seq, batch, "train"))
    par = registry.get_parallel(arch)
    own = registry.get_optimizer(arch)
    ocfg = OptimizerConfig(warmup_steps=2, moment_dtype=own.moment_dtype,
                           second_moment=own.second_moment)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = pr.init_params(steps._model_module(cfg).lm_schema(cfg), gen,
                            "float32", dev)
    contracted_attention_init_(cfg, params)
    for blk in params.get("blocks", {}).values():
        for gate in ("gate_attn", "gate_mlp"):
            if gate in blk:
                blk[gate].copy_(0.5 + torch.rand(blk[gate].shape,
                                                 generator=gen, device=dev))
    params = steps._map(lambda t: t.to(pr.torch_dtype(dtype)), params)
    opt = steps.init_opt_state(cfg, ocfg, dev)
    T = steps.token_len(cfg, ShapeConfig("train", seq, batch, "train"))
    pipe = TokenPipeline(cfg.vocab_size, T, batch, seed=seed)
    specs = steps.extras_specs(cfg, batch)

    def chunk(start: int, K: int) -> dict:
        out = pipe.chunk(start, K)
        if specs is not None:
            g = torch.Generator(device=dev).manual_seed(seed + 1 + start)
            out["extras"] = {
                k: torch.randn((K,) + tuple(v.shape), generator=g,
                               device=dev).to(pr.torch_dtype(dtype))
                for k, v in specs.items()}
        return out
    return cfg, par, ocfg, params, opt, chunk


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH, choices=list(registry.ARCHS))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    ap.add_argument("--experts", type=int, default=0,
                    help="cut an MoE config to this many experts (0: all)")
    ap.add_argument("--pattern", default="",
                    help="comma-separated block pattern for --layers, "
                         "e.g. attn,cross")
    args = ap.parse_args(argv)
    cfg, par, ocfg, params, opt, chunk = train_setup(
        args.arch, layers=args.layers, experts=args.experts,
        pattern=[k for k in args.pattern.split(",") if k])
    params, opt, _ = steps.train_chunk(cfg, par, ocfg, params, opt,
                                       chunk(0, 1))
    torch.cuda.synchronize()
    card = torch.cuda.get_device_name(0)
    rows = []
    for i in range(1, STEPS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = steps.train_chunk(cfg, par, ocfg, params, opt,
                                               chunk(i, 1))
            loss = m["loss"].item()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, by_name = _kernel_stats(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        row = {"phase": f"train step {i}", "arch": args.arch,
               "layers": cfg.num_layers, "loss": loss,
               "experts": cfg.moe.num_experts if cfg.moe else None,
               "moments": f"{ocfg.moment_dtype}/{ocfg.second_moment}",
               "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
               "device_idle_share": 1.0 - busy_us / wall_us,
               "kernels": len([e for e in prof.events() if e.device_type
                               == torch.autograd.DeviceType.CUDA]),
               "top_kernels_ms": [(k[:60], v / 1e3) for k, v in top],
               "card": card}
        for key, pats in GROUPS.items():
            row[key] = sum(v for k, v in by_name.items()
                           if any(p in k for p in pats)) / 1e3
        print(f"== train step {i}")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=25))
        rows.append(row)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
