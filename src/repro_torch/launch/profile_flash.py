"""The flash wrapper's host time a call, at the serving shapes.

    python -m repro_torch.launch.profile_flash

At 512 tokens a prefill is host-bound (the card idles most of its wall),
so what each attention layer costs the wall is the host work around its
launch: the argument checks, the output buffer, the ctypes call and, in
f16/bf16, the encoding of the kernel's tensor maps.  For each shape
(phi4-mini's heads, and gemma2's with its window and softcap, both bf16
transposes of (B, S, heads, dh) projections as the models pass them) it
prints one JSON line: the median over ``REPEATS`` runs of the mean host
microseconds a call of ``CALLS`` back-to-back calls, each run, the
wrapper's file and the card's name and power limit.  To compare two trees
on one card, run it in each (copied into a tree that lacks it) in one
session, in turns.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import flash_attention as fa

CALLS, REPEATS, SEED = 200, 7, 0
# (B, H, KV, Sq, Sk, dh), the wrapper's keywords
SHAPES = {
    "phi4": ((1, 24, 8, 512, 512, 128), {"causal": True}),
    "gemma2_local": ((1, 16, 8, 512, 512, 256),
                     {"causal": True, "window": 4096, "softcap": 50.0}),
}


def _views(B, H, KV, Sq, Sk, dh, gen):
    def one(n, S):
        x = torch.randn(B, S, n, dh, generator=gen, device="cuda")
        return x.to(torch.bfloat16).transpose(1, 2)
    return one(H, Sq), one(KV, Sk), one(KV, Sk)


def host_us(fn) -> tuple[float, list[float]]:
    """(median, runs) of the mean host microseconds a call of fn."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs), runs


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, (shape, kw) in SHAPES.items():
        q, k, v = _views(*shape, gen)
        med, runs = host_us(lambda: fa.flash_attention(q, k, v, **kw))
        print(json.dumps({"shape": name, "dims": shape, **kw,
                          "host_us": med, "runs_us": runs,
                          "wrapper": fa.__file__, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
