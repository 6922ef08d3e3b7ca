"""Training CLI for the port: optimizer steps on synthetic tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --steps 6 --batch 2 --seq 1024 --device-steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

It makes the arch's params from ``--seed`` on the card (or on the CPU
with ``--device cpu``), zero AdamW state, and runs ``--steps`` optimizer
steps on ``TokenPipeline`` batches in chunks of ``--device-steps``
(``runtime.steps.train_chunk``: one host sync per chunk), with the JAX
CLI's optimizer recipe (lr 1e-3, warmup steps/20, cosine decay over the
run).  It prints ``[train] loss first -> last`` like ``repro.launch.train``.
Elastic recovery, checkpoints and ``--fail-at`` come with the port's
training runtime (ROADMAP queue A, item 5).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm
from repro_torch.runtime import steps as steps_mod


def train(arch: str, *, steps: int, seq: int, batch: int, smoke: bool,
          seed: int = 0, device_steps: int = 1, device="cuda"):
    """Run ``steps`` optimizer steps; returns {"losses", "grad_norms",
    "params"}."""
    dev = resolve_device(device)
    cfg = registry.get_smoke(arch) if smoke else registry.get_config(arch)
    par = registry.get_parallel(arch)
    # the JAX CLI's recipe (api/runners.py); the ported arch keeps the
    # default f32 moments
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=max(steps // 20, 1),
                           decay_steps=steps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = pr.init_params(tfm.lm_schema(cfg), gen, cfg.param_dtype, dev)
    opt = steps_mod.init_opt_state(cfg, ocfg, dev)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=seed)
    K = max(device_steps, 1)
    losses, norms = [], []
    for start in range(0, steps, K):
        params, opt, ms = steps_mod.train_chunk(
            cfg, par, ocfg, params, opt,
            pipe.chunk(start, min(K, steps - start)), device=dev)
        losses.extend(ms["loss"].tolist())          # one sync a chunk
        norms.extend(ms["grad_norm"].tolist())
    return {"losses": losses, "grad_norms": norms, "params": params}


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
    ap.add_argument("--device-steps", type=int, default=1,
                    help="optimizer steps per chunk (one host sync each)")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, seq=args.seq, batch=args.batch,
                smoke=args.smoke, seed=args.seed,
                device_steps=args.device_steps, device=args.device)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
