"""Where training time goes on the card: a few full-width phi4 steps.

    python -m repro_torch.launch.profile_train

Builds full-width ``phi4-mini-3.8b`` training (bf16 params, f32 moments,
random weights from ``SEED`` as ``chip_smoke.py`` draws them, remat on), takes one untimed step (kernel
build, cuBLAS set-up), then runs ``STEPS`` optimizer steps of ``BATCH`` x
``SEQ`` tokens, each under ``torch.profiler``.  For each step it prints the
profiler's table and then one JSON line: host wall time, device busy time
(the union of kernel intervals), the device's idle share, the time in the
port's xent and AdamW kernels and in matrix products, the kernel count,
and the top kernels by device time.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.grad_check import contracted_attention_init_
from repro_torch.launch.profile_serve import _kernel_stats
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm
from repro_torch.runtime import steps

ARCH = "phi4-mini-3.8b"
BATCH, SEQ, STEPS, SEED = 2, 1024, 2, 0
GROUPS = {"xent_ms": ("xent_fwd", "xent_bwd"), "adamw_ms": ("adamw",),
          "matmul_ms": ("gemm", "nvjet", "cutlass", "sm90_xmma")}


def main() -> None:
    cfg = registry.get_config(ARCH)
    par = registry.get_parallel(ARCH)
    ocfg = OptimizerConfig(warmup_steps=2)
    # the weights chip_smoke.py trains from
    params = pr.init_params(tfm.lm_schema(cfg),
                            torch.Generator(device="cuda").manual_seed(SEED),
                            "float32", "cuda")
    contracted_attention_init_(cfg, params)
    params = steps._map(lambda t: t.to(torch.bfloat16), params)
    opt = steps.init_opt_state(cfg, ocfg, "cuda")
    pipe = TokenPipeline(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    params, opt, _ = steps.train_step(cfg, par, ocfg, params, opt,
                                      pipe.batch(0))
    torch.cuda.synchronize()
    card = torch.cuda.get_device_name(0)
    rows = []
    for i in range(1, STEPS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = steps.train_step(cfg, par, ocfg, params, opt,
                                              pipe.batch(i))
            loss = m["loss"].item()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, by_name = _kernel_stats(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        row = {"phase": f"train step {i}", "loss": loss,
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
