"""Roofline table per (arch x shape) cell from the dry run, on H100 peaks.

    compute term    = step_FLOPs / (chips * 989e12)   [bf16 dense]
    memory term     = HBM bytes  / (chips * 3.35e12)

The peaks are NVIDIA's published figures for the H100 SXM (80 GB HBM3)
at 700 W, from its data sheet: 989 TFLOP/s of dense bf16 tensor-core
work and 3.35 TB/s of HBM bandwidth.  FLOPs and bytes come from the
analytic accounting (``roofline.flops``, equal to the JAX package's);
the dry-run record adds its per-device bytes and the meta trace's
counted/analytic ratio.  There is no collective term: the reference
counts collective bytes in XLA's compiled HLO, and the port has no
partitioner whose collectives it could count (one card; the lowering
onto 256 or 512 chips needs more than one device).  ``collective_s`` is
None and the table prints "—"; ``dominant`` is chosen from compute and
memory.  Also per cell: MODEL_FLOPS = 6·N_active·D, the useful/step
ratio, and what would move the dominant term.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.roofline.report \
        --dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.roofline import flops as flops_mod

PEAK_FLOPS = 989e12       # bf16 dense / card (H100 SXM, 700 W)
HBM_BW = 3.35e12          # bytes/s / card (H100 SXM HBM3)
NO_COLLECTIVES = ("no collective term: the port has no partitioner whose "
                  "collectives it could count (one card)")


def cell_roofline(arch: str, shape_name: str, rec: Optional[dict],
                  chips: int = 256) -> Dict:
    cfg = registry.get_config(arch)
    ocfg = registry.get_optimizer(arch)
    shape = SHAPES[shape_name]
    acc = flops_mod.accounting(cfg, shape, chips, ocfg)

    flops_chip = acc.step_flops_global / chips
    bytes_chip = acc.act_bytes_global / chips
    compute_t = flops_chip / PEAK_FLOPS
    memory_t = bytes_chip / HBM_BW
    terms = {"compute": compute_t, "memory": memory_t}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful_t = (acc.model_flops / chips) / PEAK_FLOPS
    out = {
        "arch": arch, "shape": shape_name, "chips": chips,
        "params": acc.params, "active_params": acc.active_params,
        "step_flops": acc.step_flops_global,
        "model_flops": acc.model_flops,
        "hbm_bytes": acc.act_bytes_global,
        "useful_ratio": acc.model_flops / max(acc.step_flops_global, 1),
        "compute_s": compute_t, "memory_s": memory_t, "collective_s": None,
        "dominant": dominant,
        "roofline_fraction": useful_t / max(bound, 1e-30),
        "mfu_upper_bound": useful_t / max(sum(terms.values()), 1e-30),
    }
    if rec:
        out["argument_bytes"] = rec.get("argument_bytes")
        out["per_device_bytes"] = rec.get("per_device_bytes")
        out["counted_over_analytic"] = rec.get("counted_over_analytic")
    return out


def _advice(row: Dict) -> str:
    if row["dominant"] == "compute":
        if row["useful_ratio"] < 0.4:
            return ("compute-bound with low useful ratio: cut remat "
                    "recompute / masked-attention waste / MoE padding")
        return "compute-bound near-useful: increase per-chip batch or accept"
    return ("HBM-bound: fuse/avoid activation round-trips; decode -> "
            "bigger batch amortizes weight reads")


def build_table(dry_dir: str, chips: int = 256) -> List[Dict]:
    d = Path(dry_dir)
    rows = []
    for arch, shape, skipped in registry.cells(include_skipped=True):
        if skipped:
            rows.append({"arch": arch, "shape": shape.name,
                         "skipped": "long_500k needs sub-quadratic attention"
                                    " (pure full-attention arch)"})
            continue
        path = d / f"{arch}__{shape.name}__16x16.json"
        rec = json.loads(path.read_text()) if path.exists() else None
        row = cell_roofline(arch, shape.name, rec, chips)
        row["advice"] = _advice(row)
        rows.append(row)
    return rows


def to_markdown(rows: List[Dict]) -> str:
    head = ("| arch | shape | compute s | memory s | collective s¹ | dominant "
            "| MODEL/step | roofline frac | next lever |")
    sep = "|" + "---|" * 9
    lines = [head, sep]
    for r in rows:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                         f"| — | SKIP: {r['skipped']} |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} "
            f"| {r['memory_s']:.3e} | — "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2f} | {r['advice']} |")
    lines.append("")
    lines.append(f"¹ {NO_COLLECTIVES}.")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--json-out", default="experiments/roofline_torch.json")
    args = ap.parse_args(argv)
    rows = build_table(args.dir)
    Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(to_markdown(rows))


if __name__ == "__main__":
    main()
