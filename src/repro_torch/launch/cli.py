"""Shared launcher flags + manifest loading — one place, no drift.

The JAX package's ``launch/cli.py`` plus ``add_device``: ``--arch``,
``--smoke``, ``--seed`` and ``--manifest`` are declared here once for the
port's train, serve and RL CLIs.  ``--manifest job.json`` short-circuits
the flag surface entirely: the file IS the workload declaration
(``repro_torch.api.resources``), exactly like ``kubectl apply -f``.
``--device`` picks the card (the default, which raises without one) or
the CPU.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.api.resources import WorkloadSpec, load_manifest

DEFAULT_ARCH = "phi4-mini-3.8b"
APPLY_TIMEOUT_S = 3600.0    # how long a CLI waits on its one workload


def add_arch(ap: argparse.ArgumentParser, *,
             default: str = DEFAULT_ARCH) -> None:
    """``--arch <id>`` from the port's config registry."""
    from repro_torch.configs import registry
    ap.add_argument("--arch", default=default, choices=list(registry.ARCHS))


def add_smoke(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-shape config (CPU-sized)")


def add_seed(ap: argparse.ArgumentParser, *, default: int = 0) -> None:
    ap.add_argument("--seed", type=int, default=default)


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")


def add_manifest(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--manifest", default="",
                    help="workload manifest (JSON); when given, the other "
                         "workload flags are ignored — the file is the "
                         "declaration")


def manifest_spec(args, expect_kind: str) -> Optional[WorkloadSpec]:
    """The manifest's spec (validated to ``expect_kind``), or None when
    ``--manifest`` was not passed."""
    path = getattr(args, "manifest", "")
    if not path:
        return None
    spec = load_manifest(path)
    if spec.KIND != expect_kind:
        raise SystemExit(
            f"--manifest {path}: kind {spec.KIND!r} cannot be launched "
            f"by this driver (expects {expect_kind!r})")
    return spec
