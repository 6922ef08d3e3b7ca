"""Serving metric names, synthetic request streams and the Table-I row.

One place resolves the ``serve/*`` gauge names: the engine, the
scheduler, the static-batcher baseline and the report below all import
``GAUGES`` instead of re-spelling the strings (the old launcher had
three private copies that had already started to drift).  The report is
total-tolerant: a run that never recorded a stat (e.g. a smoke serve
with zero completed requests) still renders a row of zeros instead of
raising.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.metrics import Registry, StepReport


class GAUGES:
    """The serving metric namespace (see docs/serving.md for semantics)."""
    ADMITTED = "serve/admitted"
    COMPLETED = "serve/completed"
    TOKENS = "serve/tokens_generated"
    DECODE_STEPS = "serve/decode_steps"
    SLOT_OCCUPANCY = "serve/slot_occupancy"
    TTFT_S = "serve/ttft_s"
    SERVICE_TTFT_S = "serve/service_ttft_s"
    LATENCY_S = "serve/request_latency_s"
    QUEUE_DEPTH = "serve/queue_depth"
    LEASE_RENEWALS = "serve/lease_renewals"
    LEASE_LOST = "serve/lease_lost"
    STALE_ACK = "serve/stale_ack"
    STALE_TOKENS = "serve/stale_tokens"
    PREFILL_S = "serve/prefill_s"
    PREEMPTED = "serve/preempted"
    WALL_S = "serve/wall_s"
    TOK_S = "serve/tok_s"
    DECODE_TOK_S = "serve/decode_tok_s"
    PREFIX_HITS = "serve/prefix_hits"
    PREFIX_MISSES = "serve/prefix_misses"
    PREFIX_BYTES_SAVED = "serve/prefix_bytes_saved"
    BLOCKS_IN_USE = "serve/blocks_in_use"
    REPLICAS = "serve/replicas"
    SCALE_EVENTS = "serve/scale_events"


def make_requests(n_requests: int, prompt_len: int, gen: int, *,
                  vocab_size: int, seed: int = 0,
                  gen_lens: Optional[Sequence[int]] = None) -> List[dict]:
    """Synthetic request stream: random prompts, per-request stop lengths.
    ``gen_lens`` (cycled) gives a heterogeneous workload; default is the
    uniform ``gen`` every request."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_requests):
        g = gen if gen_lens is None else int(gen_lens[i % len(gen_lens)])
        out.append({"id": i,
                    "prompt": rng.randint(1, vocab_size, prompt_len).tolist(),
                    "max_new_tokens": g})
    return out


def request_queue(requests, cfg, *, n_requests, prompt_len, gen, seed,
                  gen_lens, lease_timeout):
    """A WorkQueue over explicit ``requests``, or a synthetic stream."""
    from repro_torch.core.queue import WorkQueue
    if requests is None:
        requests = make_requests(n_requests, prompt_len, gen,
                                 vocab_size=cfg.vocab_size, seed=seed,
                                 gen_lens=gen_lens)
    return WorkQueue(requests, lease_timeout=lease_timeout)


def record_serving_totals(registry: Registry, useful_tokens: int,
                          wall_s: float, decode_s: float) -> None:
    """End-of-run serving gauges, shared by every serving driver so the
    continuous-vs-static benchmark always compares identical accounting:
    wall time, useful tokens/s overall, and decode-only tokens/s (omitted
    when the run never decoded, e.g. stop-length-1 workloads)."""
    registry.gauge(GAUGES.WALL_S, wall_s)
    registry.gauge(GAUGES.TOK_S, useful_tokens / max(wall_s, 1e-9))
    if decode_s > 0:
        registry.gauge(GAUGES.DECODE_TOK_S, useful_tokens / decode_s)


def serving_summary(metrics: Registry) -> Dict[str, Dict[str, float]]:
    """Per-gauge stats with every ``GAUGES`` name present — missing
    (never-recorded) series summarize as all-zero stats, so reports and
    dashboards never KeyError on an idle run."""
    s = metrics.summary()
    zero = {"count": 0, "last": 0.0, "mean": 0.0, "max": 0.0,
            "total": 0.0, "p50": 0.0, "p99": 0.0}
    return {name: s.get(name, dict(zero))
            for attr, name in vars(GAUGES).items()
            if not attr.startswith("_") and isinstance(name, str)}


def serving_report(metrics: Registry, *, step: str = "serve",
                   devices: int = 1) -> StepReport:
    """Fold serve metrics into a paper-Table-I-style report column.

    Tolerates never-recorded stats: a 0-request run reports zeros."""
    s = serving_summary(metrics)

    def g(name, stat="last"):
        return s.get(name, {}).get(stat, 0.0)

    hits = g(GAUGES.PREFIX_HITS, "total")
    misses = g(GAUGES.PREFIX_MISSES, "total")
    return StepReport(
        step=step, pods=1, devices=devices,
        total_time_s=g(GAUGES.WALL_S),
        extra={
            "requests": g(GAUGES.COMPLETED, "total"),
            "tokens": g(GAUGES.TOKENS, "total"),
            "stale tokens": g(GAUGES.STALE_TOKENS, "total"),
            "tokens/s": g(GAUGES.TOK_S),
            "decode tokens/s": g(GAUGES.DECODE_TOK_S),
            "mean slot occupancy": g(GAUGES.SLOT_OCCUPANCY, "mean"),
            "p50 latency (s)": g(GAUGES.LATENCY_S, "p50"),
            "p99 latency (s)": g(GAUGES.LATENCY_S, "p99"),
            "p50 ttft (s)": g(GAUGES.TTFT_S, "p50"),
            "p50 service ttft (s)": g(GAUGES.SERVICE_TTFT_S, "p50"),
            "prefix hit rate": hits / max(hits + misses, 1.0),
        })
