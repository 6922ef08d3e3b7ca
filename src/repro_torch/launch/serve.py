"""Serving driver for the port: the continuous batcher over a WorkQueue.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --requests 8 --prompt-len 32 --gen 16 --slots 4 [--spread] [--static]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --smoke --device cpu

It builds a ``repro_torch.serving.ServingEngine`` on the card (or on the
CPU with ``--device cpu``), serves a synthetic request stream to
exhaustion, and prints the per-metric CSV and the Table-I-style row like
``repro.launch.serve``.  Declaring the job as a manifest through a
``Session`` waits for the port's API slice.

``--static`` (``serve_static``) runs the drain-then-refill baseline of the
JAX package instead: lease a batch, prefill its rows together, decode
until the LONGEST request in the batch finishes, truncate each request at
its stop length, ack, repeat.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.metrics import Registry, table_one
from repro_torch.device import resolve_device
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm
from repro_torch.runtime import steps as steps_mod
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.report import (GAUGES, record_serving_totals,
                                        request_queue, serving_report)


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


@torch.inference_mode()
def serve_static(arch: str, *, smoke: bool, n_requests: int, prompt_len: int,
                 gen: int, batch: int = 4, seed: int = 0,
                 gen_lens: Optional[Sequence[int]] = None,
                 lease_timeout: float = 30.0, warmup: bool = False,
                 requests: Optional[Sequence[dict]] = None,
                 cfg_override=None, params=None, device="cuda"):
    """The drain-then-refill batcher (the serving benchmark's baseline).

    Each leased batch of up to ``batch`` requests is prefilled as one
    (batch, prompt_len) block (rows padded with token 1, empty rows too),
    its prompt-length cache spliced into the front of a full-length one,
    and decoded until its longest request's stop length; every member is
    then truncated to its own stop length and acked, and the next batch
    forms.  ``params`` defaults to a draw from ``seed``; ``cfg_override``
    replaces the arch's config.  Returns ``(results, metrics)``.
    """
    dev = resolve_device(device)
    cfg = cfg_override if cfg_override is not None else (
        registry.get_smoke(arch) if smoke else registry.get_config(arch))
    if params is None:
        params = pr.init_params(
            tfm.lm_schema(cfg), torch.Generator(device=dev).manual_seed(seed),
            cfg.param_dtype, dev)
    S = prompt_len + gen
    T = prompt_len
    metrics = Registry()

    def prefill(prompts):
        last, small = steps_mod.prefill_step(
            cfg, params, torch.as_tensor(prompts, device=dev))
        caches = steps_mod.cache_prefix_insert(
            steps_mod.init_cache(cfg, batch, S, dev), small)
        return last.argmax(dim=-1).to(torch.int32)[:, None], caches

    def decode(caches, tok, pos):
        return steps_mod.slot_decode_step(
            cfg, params, caches, tok,
            torch.full((batch,), pos, dtype=torch.int64, device=dev))

    results: Dict[int, list] = {}
    t_start = time.perf_counter()
    decode_s = 0.0
    if warmup:
        tok, caches = prefill(np.ones((batch, T), np.int64))
        decode(caches, tok, T)
        t_start = time.perf_counter()
    # requests enqueue after warmup so TTFT (enqueue -> first token, the
    # continuous engine's accounting) excludes it
    queue = request_queue(requests, cfg, n_requests=n_requests,
                          prompt_len=prompt_len, gen=gen, seed=seed,
                          gen_lens=gen_lens, lease_timeout=lease_timeout)
    while not queue.drained():
        leased = []
        while len(leased) < batch:
            got = queue.lease("server")
            if got is None:
                break
            leased.append(got)
        if not leased:
            time.sleep(0.001)
            continue
        prompts = np.ones((batch, T), np.int64)
        want = [gen] * len(leased)
        for row, (_, req) in enumerate(leased):
            prompts[row, :len(req["prompt"][:T])] = req["prompt"][:T]
            want[row] = min(int(req.get("max_new_tokens", gen)), gen)

        t0 = time.perf_counter()
        tok, caches = prefill(prompts)
        out_tokens = [tok.cpu().numpy()]          # the first tokens' sync
        metrics.gauge(GAUGES.PREFILL_S, time.perf_counter() - t0)
        now = time.monotonic()                    # the queue's clock
        for tid, _ in leased:
            metrics.gauge(GAUGES.TTFT_S, now - queue.enqueued_at(tid))

        t1 = time.perf_counter()
        for g in range(max(want) - 1):
            tok, caches = decode(caches, tok, T + g)
            out_tokens.append(tok.cpu().numpy())
        decode_s += time.perf_counter() - t1

        gen_tok = np.concatenate(out_tokens, axis=1)
        now = time.monotonic()
        for row, (tid, req) in enumerate(leased):
            results[req["id"]] = gen_tok[row, :want[row]].tolist()
            queue.ack(tid, "server")
            metrics.inc(GAUGES.COMPLETED)
            metrics.inc(GAUGES.TOKENS, want[row])
            metrics.gauge(GAUGES.LATENCY_S, now - queue.enqueued_at(tid))
    wall = time.perf_counter() - t_start
    record_serving_totals(metrics, sum(len(v) for v in results.values()),
                          wall, decode_s)
    return results, metrics


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
    ap.add_argument("--static", action="store_true",
                    help="drain-then-refill batcher (the baseline)")
    args = ap.parse_args(argv)
    gen_lens = None
    if args.spread:
        gen_lens = [max(1, args.gen // (2 ** i)) for i in range(4)]
    run = serve_static if args.static else serve
    kw = {"batch" if args.static else "slots": args.slots}
    results, metrics = run(
        args.arch, smoke=args.smoke, n_requests=args.requests,
        prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
        device=args.device, gen_lens=gen_lens, **kw)
    mode = "static" if args.static else "continuous"
    print(f"[serve:{mode}] completed {len(results)} requests")
    print(metrics.to_csv())
    print()
    print(table_one([serving_report(metrics, step=f"serve ({mode})")]))


if __name__ == "__main__":
    main()
