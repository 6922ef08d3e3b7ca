"""Every collective of the port, each with the reference's gradient.

The reference's train step runs under GSPMD, which derives each
collective's transpose itself; here each one a rank calls is an
``autograd.Function`` whose backward is that transpose, under one
convention: every rank seeds its own copy of the loss with 1, the data
ranks' gradients are averaged afterwards (``runtime.steps``), and a value
that every rank of a ``model`` group computes alike (the dense part of a
layer, replicated over ``model`` as the reference replicates it) must get
the same gradient on each of them.

  * ``zero_gather``  ZeRO-3 over ``data``, or under pure FSDP over the
                     world group (a dimension split over ``("data",
                     "model")``, whose blocks are in rank order):
                     all-gather forward, reduce-scatter (sum) backward;
  * ``seq_split``    a rank's sequence slice over ``model``: slice
                     forward, all-gather of the slices' gradients
                     backward;
  * ``seq_gather``   the slices back together: all-gather forward, this
                     rank's slice of the gradient backward (every
                     ``model`` rank holds the same upstream gradient, so a
                     summing backward would multiply it by the group size);
                     ``seq_split`` and ``seq_gather`` serve the layout
                     without tensor parallelism, where the dense part is
                     replicated over ``model``;
  * ``sp_gather``    Megatron sequence parallelism: the ``model`` ranks'
                     sequence slices gathered before a block's
                     column-parallel products, all-gather forward,
                     reduce-scatter (sum) backward (each rank's heads or
                     ff columns give a different partial gradient of the
                     gathered input, and the slice's gradient is their
                     sum); the same Function as ``zero_gather``, which
                     also gathers, over ``model``, a leaf whose split the
                     compute cannot use (a head_dim split, the vocab);
  * ``sp_scatter``   a row-parallel product's partial sums reduce-scattered
                     (sum) onto this rank's sequence slice forward,
                     all-gather of the slices' gradients backward;
  * ``all_to_all``   equal splits along dim 0 forward, the inverse
                     exchange (the same call) backward;
  * ``group_mean``   a mean across a group, whose backward is the mean of
                     the upstream gradients (each rank's loss holds the
                     mean, and the data ranks' gradients are averaged
                     afterwards): the MoE aux loss's global ``f`` and
                     ``pbar``, and under sequence parallelism the loss over
                     the ``model`` ranks' slices;
  * ``all_reduce_``  a plain in-place sum (no gradient): the grads of
                     leaves no rank splits over ``data``, the loss
                     metric, the global grad norm.

Data moves as bytes (``all_gather`` and ``all_to_all`` hand the backend a
``uint8`` view), so no backend needs to know bf16; reductions run in the
tensor's own dtype, as the reference's ``psum`` does.  gloo on CUDA
tensors takes each collective used here (``all_gather``,
``reduce_scatter``, ``all_to_all_single``, ``all_reduce``; its list
``all_to_all`` it refuses, and nothing here calls it), so no collective
goes through host memory: NCCL and gloo run the same calls.

Under sequence parallelism and under pure FSDP (every rank its own rows,
every leaf gathered whole from its blocks) every Function above is the
exact transpose of its forward, so each rank's gradient is that of the
sum of every rank's copy of the loss: ``runtime.steps`` then sums each
leaf over the axes that do not split it and divides by the number of
ranks.

``bytes_sent`` counts, per collective, the bytes this rank handed the
backend since ``reset_counts()`` (an all-gather's shard, a
reduce-scatter's whole input, an all-to-all's send buffer, an
all-reduce's tensor), forward and backward alike: ``sp_gather`` sends an
all-gather forward and a reduce-scatter backward, ``sp_scatter`` the
reverse.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

bytes_sent = {"all_gather": 0, "reduce_scatter": 0, "all_to_all": 0,
              "all_reduce": 0}


def reset_counts() -> None:
    for k in bytes_sent:
        bytes_sent[k] = 0


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat ``uint8`` view."""
    return t.reshape(-1).view(torch.uint8)


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather([_bytes(p) for p in parts], _bytes(src), group=group)
    bytes_sent["all_gather"] += src.numel() * src.element_size()
    return torch.cat(parts, 0).movedim(0, dim).contiguous()


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    out = torch.empty_like(src[:src.shape[0] // n])
    dist.reduce_scatter(out, list(src.chunk(n, 0)), group=group)
    bytes_sent["reduce_scatter"] += src.numel() * src.element_size()
    return out.movedim(0, dim).contiguous()


def _slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    return t.chunk(n, dim)[r].contiguous()


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if t.shape[0] != n:
        raise ValueError(f"all_to_all sends dim 0 of {tuple(t.shape)} to "
                         f"{n} ranks: it must be {n}")
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(_bytes(out), _bytes(src), group=group)
    bytes_sent["all_to_all"] += src.numel() * src.element_size()
    return out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no gradient); returns ``t``."""
    dist.all_reduce(t, group=group)
    bytes_sent["all_reduce"] += t.numel() * t.element_size()
    return t


class _ZeroGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _SpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _GroupMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        n = dist.get_world_size(group)
        return all_reduce_(t.detach().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return all_reduce_(g.contiguous().clone(), ctx.group) / n, None


def zero_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole of a leaf split along ``dim`` over ``group`` (ZeRO-3)."""
    return _ZeroGather.apply(t, dim, group)


def seq_split(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim``, of ``group``'s size."""
    return _SeqSplit.apply(t, dim, group)


def seq_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``group``'s slices along ``dim`` put back together, in rank order."""
    return _SeqGather.apply(t, dim, group)


def sp_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ``group`` ranks' sequence slices along ``dim`` put together;
    the gradient of the whole is summed back onto each slice."""
    return _ZeroGather.apply(t, dim, group)


def sp_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's ``t`` (a row-parallel
    product's partial sums), of which this rank keeps its slice along
    ``dim``."""
    return _SpScatter.apply(t, dim, group)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) -> (n, ...): row j goes to rank j, which files it as row
    r, r this rank (equal splits, ``tiled=False`` in the reference)."""
    return _AllToAll.apply(t, group)


def group_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over ``group``, on every rank of it."""
    return _GroupMean.apply(t, group)


def zero_gather_tree(tree, plans):
    """A nested dict of shards -> the same of whole leaves: each leaf is
    gathered along each (dim, group) of its entry in ``plans`` (the same
    structure, a list each) in turn, skipping a group of this rank
    alone."""
    if isinstance(tree, dict):
        return {k: zero_gather_tree(v, plans[k]) for k, v in tree.items()}
    for dim, group in plans:
        if dist.get_world_size(group) > 1:
            tree = zero_gather(tree, dim, group)
    return tree
