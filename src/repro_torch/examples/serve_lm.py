"""Continuous-batching LM serving through the work queue, on the port.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        [--arch gemma2-9b] [--device cpu]

The twin of ``examples/serve_lm.py``: a ``ServeJob`` declares the stream
(requests with different stop lengths, so slots evict early and refill
from the queue mid-flight) and the Session routes it to the continuous
batcher of the arch's reduced config, on the card unless ``--device
cpu``.  Checks that every request is served.
"""
import argparse

from repro_torch.api import ServeJob, Session
from repro_torch.configs import registry
from repro_torch.core.metrics import table_one
from repro_torch.core.orchestrator import Cluster
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    job = ServeJob(name=f"serve-{args.arch}", arch=args.arch,
                   n_requests=args.requests, prompt_len=24,
                   max_new_tokens=12, slots=4, gen_lens=(12, 3, 6, 3))
    session = Session(cluster=Cluster(devices=[resolve_device(args.device)]))
    out = session.apply(job).wait()
    results = out["results"]
    print(f"served {len(results)} requests on {args.arch} (reduced config)")
    for rid in sorted(results)[:3]:
        print(f"  request {rid}: generated {results[rid]}")
    print(out["metrics"].to_csv())
    print()
    print(table_one([out["report"]]))
    assert len(results) == args.requests
    return out


if __name__ == "__main__":
    main()
