"""Where serving time goes on the card: one prefill and a few decode steps.

    python -m repro_torch.launch.profile_serve [--arch granite-moe-1b-a400m]
    python -m repro_torch.launch.profile_serve --arch llama-3.2-vision-90b \
        --layers 5

Builds the full-width serving engine of ``--arch`` (default
``phi4-mini-3.8b``; bf16, random weights from ``SEED``, ``SLOTS`` slots:
the paged pool where the cache pages, the slotted cache for the
recurrent-state, encoder-decoder and VLM families; ``--layers`` cuts the
depth, which the 100-layer VLM needs to fit one card), runs one untimed
prefill and decode step, then times one B=1 prefill of ``PROMPT`` tokens
(whisper's engine pads it to ``decoder_len - GEN``) and ``STEPS`` fused
decode steps, first ``REPEATS`` times each without the profiler (the wall
a user feels; the profiler adds its own host time), then once under
``torch.profiler``.  For each phase it prints one JSON line: the
unprofiled walls and their median, the profiled host wall time, device
busy time (the union of kernel intervals), the device's idle share of the
window, the kernel count, the time of each of the port's own kernels
(flash, SSD, WKV6, gmm) and their share of busy time, and the top kernels
by device time, after the profiler's table for the phase.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.runtime import steps as steps_mod
from repro_torch.serving.engine import ServingEngine

PROMPT, GEN, SLOTS, STEPS, SEED, BLOCK = 512, 64, 4, 8, 0, 16
REPEATS = 10          # unprofiled runs of each phase
# the port's kernels, by a part of their CUDA functions' names: flash_fwd
# matches flash_fwd_wgmma (f16/bf16) and flash_fwd (f32); gmm_ matches
# gmm_wgmma and gmm_fwd_gemv (f16/bf16, C above 8 and up to 8) and gmm_fwd
# (f32), and an older tree's gmm_fwd_mma
OWN_KERNELS = {"flash": "flash_fwd", "ssd": "ssd_fwd", "wkv6": "wkv_fwd",
               "gmm": "gmm_"}


def _kernel_stats(prof) -> tuple[float, dict]:
    """(busy_us, {kernel name: total us}) over the device events."""
    spans, by_name = [], defaultdict(float)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        by_name[evt.name] += end - start
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy, by_name


def _walls(fn) -> list[float]:
    """Wall ms of ``REPEATS`` unprofiled runs of fn, each synchronized."""
    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return runs


def _phase(name: str, fn) -> dict:
    walls = _walls(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name = _kernel_stats(prof)
    own = {k: sum(v for n, v in by_name.items() if fn in n) / 1e3
           for k, fn in OWN_KERNELS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"phase": name, "unprofiled_wall_ms": statistics.median(walls),
           "unprofiled_walls_ms": walls, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "kernels": len([e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA]),
           **{f"{k}_ms": v for k, v in own.items()},
           "own_kernels_share_of_busy": sum(own.values()) * 1e3 / busy_us,
           "top_kernels_ms": [(k[:60], v / 1e3) for k, v in top]}
    print(f"== {name}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=registry.ARCHS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    args = ap.parse_args(argv)
    cfg = registry.get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    paged = steps_mod.paged_compatible(cfg, PROMPT + GEN, BLOCK)
    engine = ServingEngine(cfg, device="cuda", num_slots=SLOTS,
                           prompt_len=PROMPT, max_new_tokens=GEN, seed=SEED,
                           paged=paged, block_size=BLOCK, prefix_cache=False)
    if paged:
        nb = PROMPT // BLOCK
        for s in range(SLOTS):      # every slot holds a prompt's blocks
            engine._tables[s, :nb + 1] = 1 + s * (nb + 1) + np.arange(nb + 1)
    prompt = torch.randint(1, cfg.vocab_size, (PROMPT,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    at = engine.prompt_pad
    engine.prefill_into(0, prompt)
    engine.decode_step([1] * SLOTS, [at] * SLOTS)
    rows = [_phase("prefill", lambda: engine.prefill_into(0, prompt))]

    # each slot decodes its own token (the prompt's first ones), so the
    # MoE families route them as a batch of distinct requests does
    tokens = prompt[:SLOTS]

    def decode():
        for i in range(STEPS):
            engine.decode_step(tokens, [at + i] * SLOTS)
    rows.append(_phase(f"decode x{STEPS}", decode))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    for row in rows:
        print(json.dumps(dict(row, arch=args.arch, layers=cfg.num_layers,
                              paged=paged, card=card)))


if __name__ == "__main__":
    main()
