"""Carry params and caches between the JAX package and the port.

Both sides keep the same tree: nested dicts with identical leaf paths and
the JAX layout of every leaf (``blocks/0_attn/wq`` is (G, D, H, dh)), so a
conversion only changes the container, never a shape.  The JAX side hands
over ``np.asarray`` of its arrays; nothing here imports JAX.

bf16: ``np.asarray`` of a bf16 JAX array has the ``ml_dtypes`` dtype
``bfloat16``, which ``torch.from_numpy`` rejects.  Such a leaf travels as its 16-bit
pattern and is viewed as ``torch.bfloat16`` — bit exact both ways.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf_to_torch(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor, like) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        out = t.view(torch.int16).numpy().view(np.uint16).copy()
        return out.view(like.dtype) if like is not None else out
    return t.numpy().copy()


def to_torch(tree: Any, device="cuda") -> Any:
    """Nested dict of array-likes -> the same dict of torch tensors on
    ``device`` (raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf_to_torch(node, dev)
    return walk(tree)


def to_numpy(tree: Any, like: Optional[Any] = None) -> Any:
    """Nested dict of tensors -> the same dict of numpy arrays.

    A bf16 leaf comes back as its ``uint16`` bit pattern, or, when ``like``
    (a tree of arrays with the same paths) is given, viewed as the dtype of
    the matching ``like`` leaf — e.g. the JAX-side ``ml_dtypes.bfloat16``.
    """
    if isinstance(tree, dict):
        return {k: to_numpy(v, None if like is None else like[k])
                for k, v in tree.items()}
    return _leaf_to_numpy(tree, None if like is None else np.asarray(like))
