"""Serving driver for the port: the continuous batcher over a WorkQueue.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --requests 8 --prompt-len 32 --gen 16 --slots 4 [--spread]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --smoke --device cpu

It builds a ``repro_torch.serving.ServingEngine`` on the card (or on the
CPU with ``--device cpu``), serves a synthetic request stream to
exhaustion, and prints the per-metric CSV and the Table-I-style row like
``repro.launch.serve``.  Declaring the job as a manifest through a
``Session`` waits for the port's API slice.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import registry
from repro_torch.core.metrics import table_one
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.report import request_queue, serving_report


def serve(arch: str, *, smoke: bool, n_requests: int, prompt_len: int,
          gen: int, slots: int = 4, seed: int = 0, device="cuda",
          gen_lens: Optional[Sequence[int]] = None):
    """Serve ``n_requests`` synthetic requests after one warmup prefill and
    decode step (kernel build, CUDA context) off the clock; returns
    (results, metrics)."""
    cfg = registry.get_smoke(arch) if smoke else registry.get_config(arch)
    engine = ServingEngine(cfg, device=device, num_slots=slots,
                           prompt_len=prompt_len, max_new_tokens=gen,
                           seed=seed)
    engine.warmup()
    queue = request_queue(None, cfg, n_requests=n_requests,
                          prompt_len=prompt_len, gen=gen, seed=seed,
                          gen_lens=gen_lens, lease_timeout=30.0)
    return engine.run(queue)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny same-family config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--spread", action="store_true",
                    help="heterogeneous stop lengths (gen halved 4x, cycled)")
    args = ap.parse_args(argv)
    gen_lens = None
    if args.spread:
        gen_lens = [max(1, args.gen // (2 ** i)) for i in range(4)]
    results, metrics = serve(
        args.arch, smoke=args.smoke, n_requests=args.requests,
        prompt_len=args.prompt_len, gen=args.gen, slots=args.slots,
        seed=args.seed, device=args.device, gen_lens=gen_lens)
    print(f"[serve:continuous] completed {len(results)} requests")
    print(metrics.to_csv())
    print()
    print(table_one([serving_report(metrics, step="serve (continuous)")]))


if __name__ == "__main__":
    main()
