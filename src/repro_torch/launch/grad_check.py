"""Gradients of one training batch in f32 and in bf16, leaf by leaf.

    PYTHONPATH=src python -m repro_torch.launch.grad_check --init reference
    PYTHONPATH=src python -m repro_torch.launch.grad_check --init contracted
    PYTHONPATH=src python -m repro_torch.launch.grad_check --smoke --device cpu

It draws the arch's params in f32 from seed 0, takes the grads of the
training loss (``runtime.steps``, remat and the chunked xent as in a train
step) on one ``TokenPipeline`` batch of 2 x 1024 tokens (the batch
``chip_smoke.py`` trains on first), then rounds the same params to bf16
and takes them again.  It prints, for each leaf, the grad norm in both and
their relative gap, and per layer for the stacked ``wq``, ``wo`` and
``wo_mlp``.

``--init reference`` keeps the reference's init, std 1/sqrt(shape[-2]) for
every normal leaf, which gives the attention projections wq/wk/wv
(G, D, N, dh) a fan-in of N and wo (G, H, dh, D) one of dh.
``--init contracted`` rescales those four to 1/sqrt(their contracted
width), D and H*dh (``contracted_attention_init_``).  With the reference's
init the grads grow by orders of magnitude per layer backward, in f32 as in
bf16 and in the JAX model as in the port (ROADMAP queue C).
"""
from __future__ import annotations

import argparse
import gc
import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import params as pr
from repro_torch.models import transformer as tfm
from repro_torch.runtime import steps

LAYERED = ("wq", "wo", "wo_mlp")


def _attention_dicts(tree):
    """Every dict of ``tree`` that holds attention projections."""
    if isinstance(tree, dict):
        if "wq" in tree or "xwq" in tree:
            yield tree
        for v in tree.values():
            yield from _attention_dicts(v)


def contracted_attention_init_(cfg: ModelConfig, params) -> None:
    """Rescale wq/wk/wv/wo in place from the reference's std
    1/sqrt(shape[-2]) to 1/sqrt(contracted width): the input width for
    wq/wk/wv (D, or the VLM cross block's vision width for its wk/wv),
    H*dh for wo.  Every attention of the params is rescaled: the stacked
    blocks', zamba2's shared block, and whisper's encoder, decoder and
    cross attention (``xw*``); the widths are read from the leaves."""
    with torch.no_grad():
        for blk in _attention_dicts(params):
            for pre in ("", "x"):
                if pre + "wq" not in blk:
                    continue
                for name in ("wq", "wk", "wv"):
                    w = blk[pre + name]            # (..., in, heads, dh)
                    w.mul_(math.sqrt(w.shape[-2] / w.shape[-3]))
                w = blk[pre + "wo"]                # (..., H, dh, D)
                w.mul_(math.sqrt(1.0 / w.shape[-3]))


def grad_norms(cfg: ModelConfig, par: ParallelConfig, params,
               batch) -> Dict[str, object]:
    """{"loss", "leaves": {path: norm}, "layers": {name: [norm per layer]}}
    of one batch's grads, norms in f64 on the host."""
    loss, grads = steps._value_and_grad(cfg, steps.train_par(par), params,
                                        steps._batch_on(
                                            cfg, batch,
                                            params["embed"].device))
    leaves = {path: torch.linalg.vector_norm(_leaf(grads, path).double())
              .item() for path, _ in pr.leaves(tfm.lm_schema(cfg))}
    layers = {f"{key}/{name}": torch.linalg.vector_norm(
                  g[name].double().flatten(1), dim=1).tolist()
              for key, g in grads["blocks"].items() for name in LAYERED}
    out = {"loss": loss.item(), "leaves": leaves, "layers": layers}
    del loss, grads
    # the non-reentrant checkpoint leaves this backward's frames in
    # reference cycles, which hold ``params``: free them now, since the
    # caller drops these params (15 GB in f32 at full width) next
    gc.collect()
    return out


def _leaf(tree, path: str) -> torch.Tensor:
    for k in path.split("/"):
        tree = tree[k]
    return tree


def compare(arch: str, *, init: str, smoke: bool = False, seq: int = 1024,
            batch: int = 2, seed: int = 0, device="cuda"):
    """Grad norms of one batch with f32 params and with the same params in
    bf16 -> {"float32": ..., "bfloat16": ..., "rel_gap": {path: gap}}."""
    dev = resolve_device(device)
    base = registry.get_smoke(arch) if smoke else registry.get_config(arch)
    cfg32 = base.replace(param_dtype="float32", compute_dtype="float32")
    cfg16 = base.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = pr.init_params(tfm.lm_schema(cfg32),
                            torch.Generator(device=dev).manual_seed(seed),
                            "float32", dev)
    if init == "contracted":
        contracted_attention_init_(cfg32, params)
    elif init != "reference":
        raise ValueError(f"init {init!r}: reference or contracted")
    par = registry.get_parallel(arch)
    data = TokenPipeline(base.vocab_size, seq, batch, seed=seed).batch(0)
    out = {"float32": grad_norms(cfg32, par, params, data)}
    params = steps._map(lambda t: t.to(torch.bfloat16), params)
    out["bfloat16"] = grad_norms(cfg16, par, params, data)
    a, b = out["float32"]["leaves"], out["bfloat16"]["leaves"]
    out["rel_gap"] = {p: abs(b[p] - a[p]) / a[p] if a[p] > 0 else
                      float(b[p] != a[p]) for p in a}
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=registry.ARCHS)
    ap.add_argument("--init", default="reference",
                    choices=("reference", "contracted"))
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny same-family config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = compare(args.arch, init=args.init, smoke=args.smoke,
                  device=args.device)
    f32, b16 = out["float32"], out["bfloat16"]
    print(f"[grad_check] {args.arch} init {args.init}: loss f32 "
          f"{f32['loss']:.6f}, bf16 {b16['loss']:.6f}")
    for path, gap in out["rel_gap"].items():
        print(f"  {path:24s} f32 {f32['leaves'][path]:.4g}  bf16 "
              f"{b16['leaves'][path]:.4g}  rel gap {gap:.3g}")
    for name, norms in f32["layers"].items():
        print(f"  {name} per layer f32 ",
              " ".join(f"{x:.3g}" for x in norms))
        print(f"  {name} per layer bf16",
              " ".join(f"{x:.3g}" for x in b16["layers"][name]))


if __name__ == "__main__":
    main()
