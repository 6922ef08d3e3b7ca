"""Where serving time goes on the card: one prefill and a few decode steps.

    python -m repro_torch.launch.profile_serve

Builds the full-width ``phi4-mini-3.8b`` serving engine (bf16, random
weights from ``SEED``, paged pool of ``SLOTS`` slots), runs one untimed
prefill and decode step, then times one B=1 prefill of ``PROMPT`` tokens
and ``STEPS`` fused decode steps under ``torch.profiler``.  For each
phase it prints one JSON line: host wall time, device busy time (the
union of kernel intervals), the device's idle share of the window, the
flash kernel's share, and the top kernels by device time, after the
profiler's table for the phase.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.serving.engine import ServingEngine

ARCH = "phi4-mini-3.8b"
PROMPT, GEN, SLOTS, STEPS, SEED = 512, 64, 4, 8, 0


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


def _phase(name: str, fn) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name = _kernel_stats(prof)
    flash_us = sum(v for k, v in by_name.items() if "flash_fwd" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"phase": name, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "flash_ms": flash_us / 1e3,
           "kernels": len([e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA]),
           "top_kernels_ms": [(k[:60], v / 1e3) for k, v in top]}
    print(f"== {name}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    return row


def main() -> None:
    cfg = registry.get_config(ARCH)
    engine = ServingEngine(cfg, device="cuda", num_slots=SLOTS,
                           prompt_len=PROMPT, max_new_tokens=GEN, seed=SEED,
                           paged=True, block_size=16, prefix_cache=False)
    nb = PROMPT // 16
    for s in range(SLOTS):      # every slot holds a prompt's blocks
        engine._tables[s, :nb + 1] = 1 + s * (nb + 1) + np.arange(nb + 1)
    prompt = torch.randint(1, cfg.vocab_size, (PROMPT,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    engine.prefill_into(0, prompt)
    engine.decode_step([1] * SLOTS, [PROMPT] * SLOTS)
    rows = [_phase("prefill", lambda: engine.prefill_into(0, prompt))]

    def decode():
        for i in range(STEPS):
            engine.decode_step([1] * SLOTS, [PROMPT + i] * SLOTS)
    rows.append(_phase(f"decode x{STEPS}", decode))
    card = torch.cuda.get_device_name(0)
    for row in rows:
        print(json.dumps(dict(row, card=card)))


if __name__ == "__main__":
    main()
