"""RL driver for the port: actors, replay, learner and policy store.

    PYTHONPATH=src python -m repro_torch.launch.rl --smoke --device cpu \\
        --learner-steps 6 --actors 2 --fail-at 2
    PYTHONPATH=src python -m repro_torch.launch.rl --device cpu \\
        --manifest examples/manifests/rl_smoke.json

The flags and defaults of ``repro.launch.rl`` plus ``--device`` (``cuda``
by default, which raises without a card).  Both forms declare an
``RLJob`` (``repro_torch.api.resources``) and run it through
``repro_torch.api.runners.run_rl_fleet``: N continuous-batching rollout
actors over a shared ticket queue, the policy-gradient learner, versioned
weight broadcast through the policy store.  ``--fail-at`` injects ONE
hard learner crash; the crash loop restores from the latest periodic
checkpoint within the same invocation (``steps_lost <= ckpt_every``).
Checkpoints and policies go to ``--ckpt-dir``, or to a temporary
directory that is removed at exit.  It prints the JAX CLI's report line.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

from repro_torch.api.resources import RLJob
from repro_torch.api.runners import run_rl_fleet
from repro_torch.configs import registry
from repro_torch.core.metrics import Registry
from repro_torch.data.objectstore import ObjectStore
from repro_torch.device import resolve_device


def rl_job(arch: str, *, learner_steps: int, actors: int = 2,
           rollouts_per_step: int = 2, prompt_len: int = 8,
           max_new_tokens: int = 8, seq_len: int = 24, slots: int = 2,
           max_policy_lag: int = 2, broadcast_every: int = 2,
           ckpt_every: int = 2, device_steps: int = 1, smoke: bool = True,
           fail_at: int = -1, ckpt_dir: str = "", seed: int = 0) -> RLJob:
    """The RLJob the flag surface declares."""
    return RLJob(
        name=f"rl-{arch}", learner_steps=learner_steps, arch=arch,
        smoke=smoke, actors=actors, rollouts_per_step=rollouts_per_step,
        prompt_len=prompt_len, max_new_tokens=max_new_tokens,
        seq_len=seq_len, slots=slots, max_policy_lag=max_policy_lag,
        broadcast_every=broadcast_every, ckpt_every=ckpt_every,
        device_steps=device_steps, fail_at=fail_at, ckpt_dir=ckpt_dir,
        seed=seed)


def apply_rl(spec: RLJob, *, device="cuda"):
    """Run one RLJob on ``device``; its store is ``spec.ckpt_dir`` or a
    temporary directory removed afterwards."""
    dev = resolve_device(device)
    if spec.ckpt_dir:
        return run_rl_fleet(None, spec, learner_store=ObjectStore(
            spec.ckpt_dir), metrics=Registry(), device=dev)
    with tempfile.TemporaryDirectory(prefix="rl-ckpt-") as root:
        return run_rl_fleet(None, spec, learner_store=ObjectStore(root),
                            metrics=Registry(), device=dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--manifest", default="",
                    help="an RLJob manifest (JSON); when given, the other "
                         "workload flags are ignored")
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny same-family config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--learner-steps", type=int, default=6)
    ap.add_argument("--actors", type=int, default=2)
    ap.add_argument("--rollouts-per-step", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=24)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-policy-lag", type=int, default=2)
    ap.add_argument("--broadcast-every", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--device-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject one hard learner crash after this step; "
                         "the crash loop restores from the latest "
                         "checkpoint and finishes the run")
    args = ap.parse_args(argv)
    if args.manifest:
        spec = RLJob.from_manifest(args.manifest)
    else:
        spec = rl_job(args.arch, learner_steps=args.learner_steps,
                      actors=args.actors,
                      rollouts_per_step=args.rollouts_per_step,
                      prompt_len=args.prompt_len,
                      max_new_tokens=args.max_new_tokens,
                      seq_len=args.seq_len, slots=args.slots,
                      max_policy_lag=args.max_policy_lag,
                      broadcast_every=args.broadcast_every,
                      ckpt_every=args.ckpt_every,
                      device_steps=args.device_steps, smoke=args.smoke,
                      fail_at=args.fail_at, ckpt_dir=args.ckpt_dir,
                      seed=args.seed)
    out = apply_rl(spec, device=args.device)
    print(f"[rl] steps {out['steps_done']}/{spec.learner_steps} "
          f"version {out['final_version']} "
          f"trained {out['trained']} stale {out['stale_dropped']} "
          f"max_lag {out['max_lag_trained']} "
          f"lost {out['steps_lost']} recoveries {out['recoveries']} "
          f"actor_syncs>={out['min_actor_syncs']}")


if __name__ == "__main__":
    main()
