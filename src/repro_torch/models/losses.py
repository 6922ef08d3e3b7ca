"""The LM loss from final hidden states, in PyTorch.

A port of the JAX package's ``models/losses.py`` for one device:

  * ``chunked_cross_entropy`` — mean token NLL over sequence chunks; each
    chunk's logits go through the port's fused softmax-xent
    (``repro_torch.kernels.xent.softmax_xent``: the CUDA kernels on the
    card, their plain versions on the CPU);
  * ``weighted_cross_entropy`` — the same with per-token weights (the RL
    form);
  * ``sharded_cross_entropy`` — plain math (``ref.softmax_xent_ref``);
    without a mesh there is nothing to shard, so it is the one-block loss;
  * ``sequence_parallel_cross_entropy`` — across ranks under sequence
    parallelism, each rank's sequence slice through the chunked loss (the
    xent kernel, the head whole on the rank), averaged over the ``model``
    group: where the reference takes either loss above on
    sequence-sharded rows, both compute this mean over the whole vocab.

A chunk's logits are ``x_c @ head.T`` in the compute dtype and only then
``.float()``, as the reference's einsum rounds to the compute dtype before
its ``astype(float32)``.  The chunk rule is the reference's: ``chunk`` if
it divides S, else one chunk of S.  The reference checkpoints each chunk;
here each chunk's f32 logits stay saved for the xent backward instead
(R x V x 4 bytes: 0.8 GB for 2 x 512 tokens of phi4), so the forward
kernel runs once per chunk and not again in backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import softmax_xent_ref
from repro_torch.kernels.xent import softmax_xent
from repro_torch.sharding import collectives


def _chunks(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    return chunk if S % chunk == 0 else S


def _chunk_nll(xc: torch.Tensor, lc: torch.Tensor, head: torch.Tensor,
               softcap: Optional[float]) -> torch.Tensor:
    """(B,c,D) hidden, (B,c) labels -> (B*c,) NLL in f32."""
    logits = (xc @ head.t()).float()
    return softmax_xent(logits.reshape(-1, head.shape[0]), lc.reshape(-1),
                        softcap=softcap)


def sharded_cross_entropy(x: torch.Tensor, labels: torch.Tensor,
                          head: torch.Tensor, *,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Mean token NLL from one block of logits: x (B,S,D), labels (B,S),
    head (V,D)."""
    logits = (x @ head.t()).float()
    return softmax_xent_ref(logits.reshape(-1, head.shape[0]),
                            labels.reshape(-1), softcap=softcap).mean()


def weighted_cross_entropy(x: torch.Tensor, labels: torch.Tensor,
                           head: torch.Tensor, weights: torch.Tensor, *,
                           denom=None, softcap: Optional[float] = None,
                           chunk: int = 512) -> torch.Tensor:
    """sum(weights * NLL) / denom (default B*S): x (B,S,D), labels and
    weights (B,S), head (V,D).  A zero weight gives its token no loss and
    no gradient."""
    B, S, _ = x.shape
    weights = weights.float()
    c = _chunks(S, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, c):
        nll = _chunk_nll(x[:, i:i + c], labels[:, i:i + c], head, softcap)
        total = total + (nll * weights[:, i:i + c].reshape(-1)).sum()
    return total / (B * S if denom is None else denom)


def chunked_cross_entropy(x: torch.Tensor, labels: torch.Tensor,
                          head: torch.Tensor, *,
                          softcap: Optional[float] = None,
                          chunk: int = 512) -> torch.Tensor:
    """Mean token NLL: x (B,S,D) final hidden states, labels (B,S),
    head (V,D), over sequence chunks of ``chunk``."""
    B, S, _ = x.shape
    c = _chunks(S, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, c):
        total = total + _chunk_nll(x[:, i:i + c], labels[:, i:i + c], head,
                                   softcap).sum()
    return total / (B * S)


def sequence_parallel_cross_entropy(x: torch.Tensor, labels: torch.Tensor,
                                    head: torch.Tensor, group, *,
                                    softcap: Optional[float] = None,
                                    chunk: int = 512) -> torch.Tensor:
    """Mean token NLL over the rows of ``group``'s ranks: x (B,s,D) this
    rank's sequence slice of the final hidden states, labels (B,s) its
    labels, head (V,D) whole.  Every rank's slice holds as many rows, so
    the mean of the ranks' means (``collectives.group_mean``) is the mean
    over all of them, and every rank of ``group`` holds it."""
    return collectives.group_mean(
        chunked_cross_entropy(x, labels, head, softcap=softcap, chunk=chunk),
        group)
