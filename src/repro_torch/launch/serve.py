"""Serving driver for the port — a thin manifest CLI over the workload API.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --requests 8 --prompt-len 32 --gen 16 --slots 4 [--spread] [--static]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --manifest examples/manifests/serve_smoke.json

Both forms declare the SAME ``repro_torch.api.ServeJob`` the JAX CLI
(``repro.launch.serve``) declares and apply it through a ``Session`` on a
one-device ``Cluster`` (the card, or the CPU with ``--device cpu``):
requests ride a WorkQueue into the continuous batcher
(``repro_torch.serving.ServingEngine``), or with ``max_replicas > 1``
into replicas behind the router.  It prints the per-metric CSV and the
Table-I-style row like ``repro.launch.serve``.

``--static`` (``serve_static``) runs the drain-then-refill baseline of the
JAX package instead: lease a batch, prefill its rows together, decode
until the LONGEST request in the batch finishes, truncate each request at
its stop length, ack, repeat.  It is the serving benchmark's baseline,
not a workload kind, so it takes no ``--manifest``.

Every arch of the port's registry serves here; the encoder-decoder and
the VLM get their zero stubs (``steps.zero_extras``), and whisper's
static prompts are ``decoder_len`` tokens long, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import ServeJob, Session
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.metrics import Registry, table_one
from repro_torch.core.orchestrator import Cluster
from repro_torch.device import resolve_device
from repro_torch.launch import cli
from repro_torch.models import params as pr
from repro_torch.runtime import steps as steps_mod
from repro_torch.serving.report import (GAUGES, record_serving_totals,
                                        request_queue, serving_report)


def serve_job(arch: str, *, smoke: bool, n_requests: int, prompt_len: int,
              gen: int, batch: int = 4, seed: int = 0,
              gen_lens: Optional[Sequence[int]] = None) -> ServeJob:
    """The ServeJob resource the flag surface declares."""
    return ServeJob(
        name=f"serve-{arch}", arch=arch, smoke=smoke,
        n_requests=n_requests, prompt_len=prompt_len, max_new_tokens=gen,
        slots=batch, seed=seed,
        gen_lens=tuple(gen_lens) if gen_lens is not None else None)


def apply_serve(spec: ServeJob, *, device="cuda"):
    """Run one ServeJob on a fresh one-device cluster Session."""
    session = Session(cluster=Cluster(devices=[resolve_device(device)],
                                      metrics=Registry()))
    return session.apply(spec).wait(cli.APPLY_TIMEOUT_S)


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
    and decoded until its longest request's stop length, every row at one
    position (a scalar, as the reference's whole-batch decode: a write
    past the cache clamps onto its last row); every member is then
    truncated to its own stop length and acked, and the next batch forms.
    ``params`` defaults to a draw from ``seed``; ``cfg_override`` replaces
    the arch's config.  Returns ``(results, metrics)``.
    """
    dev = resolve_device(device)
    cfg = cfg_override if cfg_override is not None else (
        registry.get_smoke(arch) if smoke else registry.get_config(arch))
    S = prompt_len + gen
    shape = ShapeConfig("serve", S, batch, "prefill")
    cfg = steps_mod.resolve_cfg(cfg, shape)
    if params is None:
        params = pr.init_params(
            steps_mod._model_module(cfg).lm_schema(cfg),
            torch.Generator(device=dev).manual_seed(seed), cfg.param_dtype,
            dev)
    T = steps_mod.token_len(cfg, shape) if cfg.family == "audio" \
        else prompt_len
    extras = steps_mod.zero_extras(cfg, batch, dev)
    metrics = Registry()

    def prefill(prompts):
        last, small = steps_mod.prefill_step(
            cfg, params, torch.as_tensor(prompts, device=dev), extras=extras)
        caches = steps_mod.cache_prefix_insert(
            steps_mod.init_cache(cfg, batch, S, dev), small)
        return last.argmax(dim=-1).to(torch.int32)[:, None], caches

    def decode(caches, tok, pos):
        return steps_mod.slot_decode_step(
            cfg, params, caches, tok,
            torch.tensor(pos, dtype=torch.int64, device=dev))

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
    cli.add_manifest(ap)
    cli.add_arch(ap)
    cli.add_smoke(ap)
    cli.add_seed(ap)
    cli.add_device(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--spread", action="store_true",
                    help="heterogeneous stop lengths (gen halved 4x, cycled)")
    ap.add_argument("--static", action="store_true",
                    help="drain-then-refill batcher (the baseline)")
    args = ap.parse_args(argv)
    gen_lens = None
    if args.spread:
        gen_lens = [max(1, args.gen // (2 ** i)) for i in range(4)]
    if args.static:
        if args.manifest:
            raise SystemExit("--static is the benchmark baseline, not an "
                             "API workload: it cannot run a --manifest "
                             "declaration")
        results, metrics = serve_static(
            args.arch, smoke=args.smoke, n_requests=args.requests,
            prompt_len=args.prompt_len, gen=args.gen, batch=args.slots,
            seed=args.seed, gen_lens=gen_lens, device=args.device)
        mode = "static"
    else:
        spec = cli.manifest_spec(args, ServeJob.KIND)
        if spec is None:
            spec = serve_job(args.arch, smoke=args.smoke,
                             n_requests=args.requests,
                             prompt_len=args.prompt_len, gen=args.gen,
                             batch=args.slots, seed=args.seed,
                             gen_lens=gen_lens)
        out = apply_serve(spec, device=args.device)
        results, metrics = out["results"], out["metrics"]
        mode = "continuous"
    print(f"[serve:{mode}] completed {len(results)} requests")
    print(metrics.to_csv())
    print()
    print(table_one([serving_report(metrics, step=f"serve ({mode})")]))


if __name__ == "__main__":
    main()
