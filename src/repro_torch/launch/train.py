"""Training CLI for the port — a thin manifest CLI over the workload API.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --steps 6 --batch 2 --seq 1024 --device-steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --ckpt-dir /tmp/run1 --ckpt-every 2 --fail-at 5
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --manifest examples/manifests/train_smoke.json

Both forms declare the SAME ``repro_torch.api.TrainJob`` the JAX CLI
(``repro.launch.train``) declares and apply it through a ``Session`` on a
one-device ``Cluster`` (the card, or the CPU with ``--device cpu``); the
Session runs it through ``repro_torch.elastic.ElasticTrainer``.  The
TrainJob's recipe: params from ``--seed`` (the reference init), batches
from data seed 17, lr 1e-3 with warmup steps/20 and cosine decay over the
run, the newest 2 checkpoints kept.  ``--steps`` optimizer steps run in
chunks of ``--device-steps`` (``runtime.steps.train_chunk``; the host
syncs once a chunk at most).  ``--ckpt-dir`` keeps the checkpoints (a
temporary directory otherwise) and ``--ckpt-every`` sets their cadence;
``--fail-at N`` injects one crash before step N and the supervisor
restores the latest checkpoint within the same invocation.  It prints
``[train] loss first -> last`` on stdout; the trainer's ``[elastic]``
lines go to stderr.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.api import Session, TrainJob
from repro_torch.core.metrics import Registry
from repro_torch.core.orchestrator import Cluster
from repro_torch.device import resolve_device
from repro_torch.launch import cli


def train_job(arch: str, *, steps: int, seq: int, batch: int, smoke: bool,
              ckpt_dir: str = "", ckpt_every: int = 0, fail_at: int = -1,
              log_every: int = 10, seed: int = 0,
              device_steps: int = 1) -> TrainJob:
    """The TrainJob resource the flag surface declares (the JAX CLI's,
    without its production mesh)."""
    return TrainJob(
        name=f"train-{arch}", steps=steps, arch=arch, smoke=smoke,
        seq_len=seq, global_batch=batch, base_shape=(1, 1), max_data=1,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, keep=2,
        log_every=log_every, fail_at=fail_at, seed=seed,
        device_steps=device_steps)


def apply_train(spec: TrainJob, *, device="cuda"):
    """Run one TrainJob on a fresh one-device cluster Session."""
    metrics = Registry()
    session = Session(cluster=Cluster(devices=[resolve_device(device)],
                                      metrics=metrics))
    out = session.apply(spec).wait(cli.APPLY_TIMEOUT_S)
    out["metrics"] = metrics
    return out


def train(arch: str, *, steps: int, seq: int, batch: int, smoke: bool,
          ckpt_dir: str = "", ckpt_every: int = 0, fail_at: int = -1,
          log_every: int = 10, seed: int = 0, device_steps: int = 1,
          device="cuda"):
    """Run ``steps`` optimizer steps through the Session; returns
    {"losses", "params", "metrics", "report"}."""
    out = apply_train(train_job(
        arch, steps=steps, seq=seq, batch=batch, smoke=smoke,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, fail_at=fail_at,
        log_every=log_every, seed=seed, device_steps=device_steps),
        device=device)
    return {"losses": out["losses"], "params": out["params"],
            "metrics": out["metrics"], "report": out["report"]}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli.add_manifest(ap)
    cli.add_arch(ap)
    cli.add_smoke(ap)
    cli.add_seed(ap)
    cli.add_device(ap)
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
    spec = cli.manifest_spec(args, TrainJob.KIND)
    if spec is None:
        spec = train_job(args.arch, steps=args.steps, seq=args.seq,
                         batch=args.batch, smoke=args.smoke,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         fail_at=args.fail_at, log_every=args.log_every,
                         seed=args.seed, device_steps=args.device_steps)
    out = apply_train(spec, device=args.device)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
