"""The port's FLOP and byte accounting (``repro_torch.roofline``) against
the JAX package's.

``accounting(...).as_dict()`` equals the reference's exactly for every
dry-run cell (the skipped long_500k ones too), every optimizer recipe and
both production meshes' chip counts; ``cell_roofline``'s params, FLOPs,
bytes and useful ratio equal the reference's, and each time term times
its peak (H100's here, v5e's there) equals the reference's to float
rounding (1e-12 relative: the two divide by different peaks).  The
reference's own roofline tests run on the port: the model-FLOPs
definition, every arch accounted, and the analytic count of a tiny
unrolled dense train step (forward and backward) within 2x of what
``torch.utils.flop_counter.FlopCounterMode`` counts in the port's
``train_step`` on the CPU, as the reference holds it against XLA.
"""
import json

import pytest

torch = pytest.importorskip("torch")
from torch.utils.flop_counter import FlopCounterMode           # noqa: E402

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.roofline import flops as jflops                      # noqa: E402
from repro.roofline import report as jreport                    # noqa: E402

from repro_torch.configs import registry                        # noqa: E402
from repro_torch.configs.base import (SHAPES, ModelConfig,       # noqa: E402
                                      OptimizerConfig, ParallelConfig,
                                      ShapeConfig)
from repro_torch.models import params as pr                     # noqa: E402
from repro_torch.roofline import flops as flops_mod             # noqa: E402
from repro_torch.roofline import report                         # noqa: E402
from repro_torch.runtime import steps                           # noqa: E402

RECIPES = [(m, s) for m in ("float32", "bfloat16", "int8")
           for s in ("full", "factored")]


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_accounting_equals_the_reference(arch):
    cells = [(a, s) for a, s, _ in registry.cells(include_skipped=True)
             if a == arch]
    assert len(cells) == len(SHAPES)
    for _arch, shape in cells:
        for chips in (256, 512):
            for recipe in RECIPES + [None]:
                jo = to = None
                if recipe:
                    jo = JOpt(moment_dtype=recipe[0], second_moment=recipe[1])
                    to = OptimizerConfig(moment_dtype=recipe[0],
                                         second_moment=recipe[1])
                want = jflops.accounting(jreg.get_config(arch), shape, chips,
                                         jo).as_dict()
                got = flops_mod.accounting(registry.get_config(arch), shape,
                                           chips, to).as_dict()
                assert got == want, (arch, shape.name, chips, recipe)


def test_cells_equal_the_reference():
    def names(cells):
        return sorted((a, s.name, sk) for a, s, sk in cells)
    assert names(registry.cells()) == names(jreg.cells())
    assert names(registry.cells(include_skipped=True)) == \
        names(jreg.cells(include_skipped=True))
    assert len(registry.cells()) == 32


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_cell_roofline_equals_the_reference(shape_name):
    for arch in registry.ARCHS:
        want = jreport.cell_roofline(arch, shape_name, None)
        got = report.cell_roofline(arch, shape_name, None)
        for key in ("params", "active_params", "step_flops", "model_flops",
                    "useful_ratio", "chips"):
            assert got[key] == want[key], (arch, shape_name, key)
        for term, peak, jpeak in (
                ("compute_s", report.PEAK_FLOPS, jreport.PEAK_FLOPS),
                ("memory_s", report.HBM_BW, jreport.HBM_BW)):
            assert got[term] * peak == pytest.approx(want[term] * jpeak,
                                                     rel=1e-12), (arch, term)
        assert got["collective_s"] is None
        terms = {"compute": got["compute_s"], "memory": got["memory_s"]}
        assert got["dominant"] == max(terms, key=terms.get)


def test_report_table_marks_the_missing_collective_term(tmp_path):
    rec = {"argument_bytes": 1, "per_device_bytes": 2,
           "counted_over_analytic": 1.0}
    (tmp_path / "phi4-mini-3.8b__train_4k__16x16.json").write_text(
        json.dumps(rec))
    rows = report.build_table(str(tmp_path))
    assert len(rows) == len(registry.cells(include_skipped=True))
    phi = next(r for r in rows if r["arch"] == "phi4-mini-3.8b"
               and r["shape"] == "train_4k")
    assert phi["per_device_bytes"] == 2 and phi["advice"]
    assert sum("skipped" in r for r in rows) == 8
    md = report.to_markdown(rows)
    body = [ln for ln in md.splitlines()
            if ln.startswith("| phi4-mini-3.8b | train_4k")]
    assert body and body[0].split("|")[5].strip() == "—"
    assert md.rstrip().endswith(f"¹ {report.NO_COLLECTIVES}.")
    out = tmp_path / "roofline.json"
    report.main(["--dir", str(tmp_path), "--json-out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))


def test_model_flops_definition():
    cfg = registry.get_config("kimi-k2-1t-a32b")
    shape = ShapeConfig("t", 4096, 256, "train")
    acc = flops_mod.accounting(cfg, shape, 256)
    # ~1T total params, ~32B active
    assert 0.9e12 < acc.params < 1.3e12
    assert 25e9 < acc.active_params < 45e9
    assert acc.model_flops == pytest.approx(
        6.0 * acc.active_params * 256 * 4096)


def test_accounting_covers_all_archs():
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
            acc = flops_mod.accounting(cfg, SHAPES[shape_name], 256,
                                       registry.get_optimizer(arch))
            assert acc.step_flops_global > 0, (arch, shape_name)
            assert acc.model_flops > 0
            assert acc.params > 1e8


def test_analytic_flops_vs_counted_small_dense():
    """Unrolled tiny dense model: analytic fwd+bwd flops within 2x of what
    FlopCounterMode counts in the port's train step (it counts matmuls;
    the analytic count leaves out elementwise work)."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
                      head_dim=16)
    par = ParallelConfig(scan_layers=False, remat=False)
    ocfg = OptimizerConfig()
    shape = ShapeConfig("t", 64, 2, "train")
    schema = steps._model_module(cfg).lm_schema(cfg)
    params = pr.init_params(schema, torch.Generator().manual_seed(0),
                            cfg.param_dtype, "cpu")
    opt = steps.init_opt_state(cfg, ocfg, "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as counter:
        steps.train_step(cfg, par, ocfg, params, opt, batch, device="cpu")
    counted = counter.get_total_flops()
    # fwd * (1 fwd + 2 bwd) -- no remat here
    ours = flops_mod.forward_flops(cfg, shape, 1) * 3.0
    assert counted > 0
    assert 0.5 < ours / counted < 2.0, (ours, counted)
