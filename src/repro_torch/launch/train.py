"""Training CLI for the port: elastic training on synthetic tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --steps 6 --batch 2 --seq 1024 --device-steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --ckpt-dir /tmp/run1 --ckpt-every 2 --fail-at 5

A thin CLI over ``repro_torch.elastic.ElasticTrainer`` on a one-device
``Cluster`` (the card, or the CPU with ``--device cpu``), as
``repro.launch.train`` is over the JAX trainer, with the JAX TrainJob's
defaults and recipe: params from ``--seed`` (the reference init),
batches from data seed 17, lr 1e-3 with warmup steps/20 and cosine decay
over the run, the newest 2 checkpoints kept.  ``--steps`` optimizer steps
run in chunks of ``--device-steps`` (``runtime.steps.train_chunk``; the
host syncs once a chunk at most).  ``--ckpt-dir`` keeps the checkpoints
(a temporary directory otherwise) and ``--ckpt-every`` sets their cadence;
``--fail-at N`` injects one crash before step N and the supervisor
restores the latest checkpoint within the same invocation.  It prints
``[train] loss first -> last`` on stdout; the trainer's ``[elastic]``
lines go to stderr.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import registry
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.orchestrator import Cluster
from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device
from repro_torch.elastic import ElasticTrainer, ElasticTrainSpec


def train(arch: str, *, steps: int, seq: int, batch: int, smoke: bool,
          ckpt_dir: str = "", ckpt_every: int = 0, fail_at: int = -1,
          log_every: int = 10, seed: int = 0, device_steps: int = 1,
          device="cuda"):
    """Run ``steps`` optimizer steps through the elastic trainer; returns
    {"losses", "params", "report"}."""
    dev = resolve_device(device)
    cfg = registry.get_smoke(arch) if smoke else registry.get_config(arch)
    # the JAX TrainJob's recipe (api/runners.py); the ported arch keeps
    # the default f32 moments
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=max(steps // 20, 1),
                           decay_steps=steps)
    spec = ElasticTrainSpec(
        cfg, registry.get_parallel(arch), ocfg, steps=steps, seq_len=seq,
        global_batch=batch, base_shape=(1, 1), max_data=1,
        name=f"train-{arch}", ckpt_every=ckpt_every, keep=2,
        log_every=log_every, device_steps=device_steps, seed=seed,
        data_seed=17, fail_at=fail_at, device=dev)
    store = ObjectStore(ckpt_dir) if ckpt_dir else None
    out = ElasticTrainer(Cluster(devices=[dev]), spec, store=store).run()
    return {"losses": out["losses"], "params": out["params"],
            "report": out["report"]}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny same-family config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject one crash at this step; the elastic "
                         "supervisor restores and finishes the run")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device-steps", type=int, default=1,
                    help="optimizer steps per chunk (one host sync each); "
                         "ckpt/log cadences snap up to multiples of this")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, seq=args.seq, batch=args.batch,
                smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                log_every=args.log_every, seed=args.seed,
                device_steps=args.device_steps, device=args.device)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
