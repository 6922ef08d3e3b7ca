"""End-to-end LM training on the port: a decoder LM declared inside a
``TrainJob`` manifest, on the synthetic token pipeline, with checkpoints
and auto-resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --hundred-m
    PYTHONPATH=src python -m repro_torch.examples.train_lm --resume-demo

The twin of ``examples/train_lm.py``: ``config`` holds the ModelConfig
kwargs, so the whole run (model, schedule, checkpoint cadence, the
injected crash) is one declarative resource applied through the Session,
on the card unless ``--device cpu``.  The default is a ~20M model of the
~100M config's shape; ``--hundred-m`` is the ~110M one.  With
``--resume-demo`` one crash is injected mid-run and the elastic
supervisor restores the latest checkpoint and finishes within the same
apply.  Checks that the last loss is below the first.  The checkpoints
go to a temporary directory, removed at exit.
"""
import argparse
import tempfile

from repro_torch.api import Session, TrainJob
from repro_torch.core.orchestrator import Cluster
from repro_torch.device import resolve_device


def lm_config(hundred_m: bool) -> dict:
    if hundred_m:
        # ~110M params: 12L, d=768, ff=2048, vocab=32768
        return dict(name="lm-100m", family="dense", num_layers=12,
                    d_model=768, num_heads=12, num_kv_heads=4,
                    d_ff=2048, vocab_size=32_768, head_dim=64)
    return dict(name="lm-20m", family="dense", num_layers=6,
                d_model=320, num_heads=8, num_kv_heads=4,
                d_ff=896, vocab_size=16_384, head_dim=40)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--resume-demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = lm_config(args.hundred_m)
    steps = args.steps or (300 if not args.hundred_m else 200)
    with tempfile.TemporaryDirectory(prefix="lm-ckpt-") as ckpt_dir:
        return _run(args, config, steps, ckpt_dir)


def _run(args, config, steps: int, ckpt_dir: str):
    job = TrainJob(name=config["name"], steps=steps, seq_len=64,
                   global_batch=4, smoke=False, config=config,
                   ckpt_dir=ckpt_dir, ckpt_every=25,
                   # one injected crash mid-run: the elastic supervisor
                   # restores from the latest checkpoint and finishes
                   # WITHIN this same apply
                   fail_at=min(45, steps // 2) if args.resume_demo else -1)
    if args.resume_demo:
        print("[demo] training with an injected crash: the supervisor "
              "auto-resumes from the latest checkpoint")
    session = Session(cluster=Cluster(devices=[resolve_device(args.device)]))
    out = session.apply(job).wait(timeout=3600)
    losses = out["losses"]
    print(f"final: first-loss {losses[0]:.3f} last-loss {losses[-1]:.3f}")
    assert losses[-1] < losses[0]
    return out


if __name__ == "__main__":
    main()
