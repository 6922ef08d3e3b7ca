"""Versioned policy weight broadcast through the object store.

A copy of the JAX package's ``rl/weights.py`` over the port's
``Checkpointer``, whose files are the JAX layout byte for byte: a policy
published by either stack is fetched by the other.

The learner *publishes* — it never talks to an actor.  Each publish is
one committed version under ``<prefix>/policy``; actors *poll* the
latest version between rollout waves and pull-on-bump.  Both halves are
a thin veneer over ``Checkpointer`` (version == step), which already
provides what a weight broadcast needs:

  * **atomic commit** — per-leaf shards first, manifest last, so a
    reader never observes a half-published version;
  * **GC** — ``keep`` bounds live versions; a reader that loses the GC
    race retries on whatever is newest (``restore_latest`` semantics).

Version numbers are dense ints starting at 0 (the actors' initial
weights, seeded identically from the job seed, count as version 0 and
are never published).
"""
from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.checkpoint import Checkpointer


class PolicyStore:
    """Publish/fetch versioned policy params over an ObjectStore."""

    def __init__(self, store, *, prefix: str = "policy", keep: int = 3,
                 registry=None):
        self.ckpt = Checkpointer(store, prefix=prefix, keep=keep)
        self.metrics = registry

    # --------------------------------------------------------------- learner
    def publish(self, version: int, params: Any, *, step: int = 0) -> None:
        """Commit one new weight version (atomic: manifest lands last)."""
        # NB: restore_latest merges ``extra`` over {"step": version}, so
        # the learner step rides under its own key
        self.ckpt.save(version, {"params": params},
                       extra={"learner_step": step})
        if self.metrics is not None:
            self.metrics.inc("rl/weights_published")
            self.metrics.gauge("rl/policy_version", version)

    # ---------------------------------------------------------------- actors
    def latest_version(self) -> int:
        """Newest committed version, or -1 when nothing was published."""
        v = self.ckpt.latest_step()
        return -1 if v is None else v

    def fetch(self, abstract_params: Any, device="cuda"):
        """Pull the newest committed version onto ``device`` ->
        (params, version), each leaf cast to ``abstract_params``' dtype
        (tensors or ``meta`` tensors).  (None, -1) when nothing was
        published yet."""
        restored, meta = self.ckpt.restore_latest(
            {"params": abstract_params}, device)
        if restored is None:
            return None, -1
        if self.metrics is not None:
            self.metrics.inc("rl/weight_syncs")
        return restored["params"], int(meta["step"])
