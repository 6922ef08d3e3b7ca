"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's step builders.

Bytes: for every dry-run cell (the skipped long_500k ones too) on both
production meshes, every argument and output leaf of the port's step has
the shape and dtype of the reference's ``build_step`` and the shard shape
``NamedSharding.shard_shape`` gives it, exactly (JAX's shardings on a
mesh over repeated host devices: only their arithmetic is read).  One
subprocess compiles phi4's smoke train and decode steps with the
reference's ``build_step`` on 8 forced host devices in a (4, 2) mesh:
XLA's ``argument_size_in_bytes`` equals the port's ``argument_bytes``.

FLOPs: the meta trace runs phi4 ``train_4k``, kimi ``decode_32k`` and
zamba2 ``long_500k``; their counted/analytic ratios lie within the bounds
PERF.md states (dense attention counts exactly the analytic formulas;
kimi's MoE capacity is the global one, the formulas' the per-chip one;
zamba2's scans count their plain form's einsums).

Also: each kernel wrapper takes its plain version on a ``meta`` tensor
and still raises on any device but cpu, cuda and meta; a decode step
with a 0-d tensor position equals one with an int (no host read); the
CLI writes one record and skips it as cached; ``train_job`` declares the
reference CLI's TrainJob, and the reference's production-layout manifest
loads unchanged.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from jax.sharding import Mesh as JMesh                          # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode        # noqa: E402

from repro.configs import registry as jreg                      # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402

from repro_torch.configs import registry                        # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig        # noqa: E402
from repro_torch.kernels import adamw_update as au              # noqa: E402
from repro_torch.kernels import flash_attention as fa           # noqa: E402
from repro_torch.kernels import moe_gmm, ssm_scan, wkv6, xent   # noqa: E402
from repro_torch.launch import dryrun                           # noqa: E402
from repro_torch.launch import mesh as tmesh                    # noqa: E402
from repro_torch.models import params as pr                     # noqa: E402
from repro_torch.runtime import steps                           # noqa: E402
from repro_torch.sharding import specs as sh                    # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# counted/analytic bounds of the meta trace, as PERF.md §6 states them
TRACE_BOUNDS = {("phi4-mini-3.8b", "train_4k"): (1 - 1e-9, 1 + 1e-9),
                ("kimi-k2-1t-a32b", "decode_32k"): (0.85, 0.87),
                ("zamba2-2.7b", "long_500k"): (0.99, 1.0)}


def fake_mesh(shape, axes):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


MESHES = ((tmesh.make_production_mesh(), fake_mesh((16, 16),
                                                   ("data", "model"))),
          (tmesh.make_production_mesh(multi_pod=True),
           fake_mesh((2, 16, 16), ("pod", "data", "model"))))


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _block(t, ax, mesh, rules):
    return sh.shard_shape(t.shape, sh.spec_for(t.shape, ax, mesh, rules),
                          mesh)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_bytes_equal_jax_shard_shapes(arch):
    for _arch, shape, _skipped in registry.cells(include_skipped=True):
        if _arch != arch:
            continue
        for tm, jm in MESHES:
            bundle = jsteps.build_step(
                jreg.get_config(arch), jreg.get_parallel(arch),
                jreg.get_optimizer(arch), jm, shape)
            io = dryrun.step_io(registry.get_config(arch),
                                registry.get_parallel(arch),
                                registry.get_optimizer(arch), tm, shape)
            assert len(io.args) == len(bundle.abstract_args)
            total = 0
            for name, jabs, jshd in zip(io.args, bundle.abstract_args,
                                        bundle.in_shardings):
                tree, axes = io.args[name]
                jabs, jshd = _jax_leaves(jabs), _jax_leaves(jshd)
                port = {p: (t, ax) for p, t, ax in dryrun.leaves(tree, axes)}
                assert sorted(port) == sorted(jabs), (shape.name, name)
                for path, (t, ax) in port.items():
                    a = jabs[path]
                    assert tuple(t.shape) == a.shape, (name, path)
                    assert str(t.dtype).split(".")[-1] == a.dtype.name
                    block = _block(t, ax, tm, io.rules)
                    assert block == jshd[path].shard_shape(a.shape), \
                        (arch, shape.name, tm.tag, name, path)
                    total += int(np.prod(block)) * a.dtype.itemsize
            nbytes = dryrun.io_bytes(io, tm)
            assert nbytes["argument_bytes"] == total
            assert sum(nbytes["bytes"].values()) - (
                nbytes["bytes"]["cache"] if shape.kind == "prefill" else 0
            ) == total
            outs = bundle.out_shardings
            assert len(io.outputs) == len(outs)
            for name, jshd in zip(io.outputs, outs):
                tree, axes = io.outputs[name]
                jshd = _jax_leaves(jshd)
                for path, t, ax in dryrun.leaves(tree, axes):
                    assert _block(t, ax, tm, io.rules) == \
                        jshd[path].shard_shape(tuple(t.shape)), (name, path)


def test_rule_selection_follows_build_step():
    """pure_fsdp_train switches a train step to pure FSDP only where the
    global batch divides the chips (256 of 256, not of 512)."""
    arch, shape = "phi4-mini-3.8b", SHAPES["train_4k"]
    par, ocfg = registry.get_parallel(arch), registry.get_optimizer(arch)
    assert par.pure_fsdp_train and not par.pure_fsdp
    one, two = (tm for tm, _ in MESHES)
    cfg = registry.get_config(arch)
    assert dryrun.step_io(cfg, par, ocfg, one, shape).par.pure_fsdp
    assert not dryrun.step_io(cfg, par, ocfg, two, shape).par.pure_fsdp
    assert not dryrun.step_io(cfg, par, ocfg, one,
                              SHAPES["decode_32k"]).par.pure_fsdp


_XLA_SCRIPT = r"""
import json
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.runtime import steps
arch = "phi4-mini-3.8b"
cfg = registry.get_smoke(arch)
# as repro.core.elastic builds its meshes (jax.make_mesh's explicit axes
# refuse the models' sharding constraints)
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
out = {}
for shape in (ShapeConfig("t", 32, 8, "train"),
              ShapeConfig("d", 64, 8, "decode")):
    bundle = steps.build_step(cfg, registry.get_parallel(arch),
                              registry.get_optimizer(arch), mesh, shape)
    with mesh:
        compiled = bundle.lower().compile()
    out[shape.kind] = int(compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


def test_argument_bytes_equal_xla_memory_analysis():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    run = subprocess.run([sys.executable, "-c", _XLA_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    xla = json.loads(run.stdout.strip().splitlines()[-1])
    arch = "phi4-mini-3.8b"
    mesh = tmesh.make_mesh((4, 2), ("data", "model"))
    for shape in (ShapeConfig("t", 32, 8, "train"),
                  ShapeConfig("d", 64, 8, "decode")):
        io = dryrun.step_io(registry.get_smoke(arch),
                            registry.get_parallel(arch),
                            registry.get_optimizer(arch), mesh, shape)
        assert dryrun.io_bytes(io, mesh)["argument_bytes"] == \
            xla[shape.kind], shape


@pytest.mark.parametrize("arch,shape_name", sorted(TRACE_BOUNDS))
def test_meta_trace_ratio_within_bounds(arch, shape_name):
    rec = dryrun.run_cell(arch, shape_name, verbose=False)
    lo, hi = TRACE_BOUNDS[(arch, shape_name)]
    assert lo <= rec["counted_over_analytic"] <= hi, rec
    assert rec["counted_flops"] > 0 and rec["temp_bytes"] is None
    assert rec["trace_layers"] == len(
        registry.get_config(arch).block_pattern)
    assert rec["state_fits_one_card"]
    assert rec["per_device_bytes"] == (rec["argument_bytes"]
                                       + rec["output_bytes"]
                                       - rec["alias_bytes"])


def _wrapper_cases(device):
    """(name, call) of each kernel wrapper on small inputs on ``device``
    (an ``xpu`` one made empty, under ``FakeTensorMode``)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        if device == "xpu":
            return torch.empty(shape, device=device)
        return torch.randn(shape, generator=g).to(device)

    def pos(*shape):
        if device == "xpu":
            return torch.empty(shape, device=device)
        return (torch.rand(shape, generator=g) + 0.1).to(device)
    labels = (torch.empty(3, dtype=torch.int32, device=device)
              if device == "xpu" else
              torch.tensor([1, 3, 0], dtype=torch.int32).to(device))
    scalars = r(3) if device == "xpu" else \
        torch.tensor([1e-3, 0.1, 0.05]).to(device)
    return [
        ("flash_attention", lambda: fa.flash_attention(
            r(1, 2, 8, 16), r(1, 1, 8, 16), r(1, 1, 8, 16))),
        ("gmm", lambda: moe_gmm.gmm(r(2, 3, 4), r(2, 4, 5))),
        ("gmm_train", lambda: moe_gmm.gmm_train(r(2, 3, 4), r(2, 4, 5))),
        ("ssd_scan", lambda: ssm_scan.ssd_scan(
            r(1, 8, 2, 4), pos(1, 8, 2), -pos(2), r(1, 8, 3), r(1, 8, 3),
            chunk=4)),
        ("ssd_scan_train", lambda: ssm_scan.ssd_scan_train(
            r(1, 8, 2, 4), pos(1, 8, 2), -pos(2), r(1, 8, 3), r(1, 8, 3),
            chunk=4)),
        ("wkv6", lambda: wkv6.wkv6(r(1, 8, 2, 4), r(1, 8, 2, 4),
                                   r(1, 8, 2, 4), -pos(1, 8, 2, 4),
                                   r(2, 4), chunk=4)),
        ("wkv6_train", lambda: wkv6.wkv6_train(
            r(1, 8, 2, 4), r(1, 8, 2, 4), r(1, 8, 2, 4), -pos(1, 8, 2, 4),
            r(2, 4), chunk=4)),
        ("softmax_xent", lambda: xent.softmax_xent(r(3, 7), labels)),
        ("xent_fwd", lambda: xent.xent_fwd(r(3, 7), labels)),
        ("xent_bwd", lambda: xent.xent_bwd(r(3, 7), labels, r(3), r(3))),
        ("adamw_update", lambda: au.adamw_update(
            r(4, 5), r(4, 5), r(4, 5), pos(4, 5), scalars, b1=0.9, b2=0.95,
            eps=1e-8, weight_decay=0.1)),
    ]


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def test_wrappers_take_the_plain_version_on_meta():
    for (name, cpu_call), (_n, meta_call) in zip(_wrapper_cases("cpu"),
                                                  _wrapper_cases("meta")):
        want, got = _flat(cpu_call()), _flat(meta_call())
        assert len(got) == len(want), name
        for w, t in zip(want, got):
            assert t.device.type == "meta", name
            assert (t.shape, t.dtype) == (w.shape, w.dtype), name


def test_wrappers_raise_on_any_other_device():
    """A fake ``xpu`` tensor stands in for a device that is neither cpu,
    cuda nor meta: every wrapper refuses it."""
    with FakeTensorMode():
        cases = _wrapper_cases("xpu")
        for name, call in cases:
            with pytest.raises(ValueError, match="cuda or cpu"):
                call()


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "whisper-small"])
def test_decode_at_a_tensor_position_equals_an_int(arch):
    """A 0-d tensor ``pos`` writes the cache and reads whisper's position
    table through tensor indices (no host read), with the int's result."""
    cfg = registry.get_smoke(arch).replace(param_dtype="float32",
                                           compute_dtype="float32")
    cfg = steps.resolve_cfg(cfg, ShapeConfig("d", 16, 2, "decode"))
    mod = steps._model_module(cfg)
    params = pr.init_params(mod.lm_schema(cfg),
                            torch.Generator().manual_seed(0), "float32",
                            "cpu")
    outs = []
    for pos in (5, torch.tensor(5, dtype=torch.int32)):
        cache = steps.init_cache(cfg, 2, 16, "cpu")
        steps._map(lambda t: t.normal_(generator=torch.Generator()
                                       .manual_seed(1)), cache)
        tok = torch.tensor([[3], [7]], dtype=torch.int32)
        nxt, cache = steps.slot_decode_step(cfg, params, cache, tok, pos)
        outs.append((nxt, steps.tree_leaves(cache)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_cli_writes_one_record_and_skips_it_as_cached(tmp_path, capsys):
    argv = ["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
            "--out", str(tmp_path)]
    dryrun.main(argv)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["phi4-mini-3.8b__decode_32k__16x16.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["bytes"]["cache"] > 0 and rec["counted_flops"] > 0
    dryrun.main(argv)
    out = capsys.readouterr().out
    assert "skip cached phi4-mini-3.8b__decode_32k__16x16" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == files


@pytest.mark.parametrize("declared_by", ["flags", "manifest"])
def test_train_job_matches_the_reference(declared_by, tmp_path):
    """The flags declare the reference CLI's TrainJob; the manifest of the
    reference's production-layout job loads in the port unchanged."""
    from repro.launch.train import train_job as j_train_job
    from repro_torch.api.resources import load_manifest
    from repro_torch.launch.train import train_job
    kw = dict(steps=4, seq=16, batch=2, smoke=True, ckpt_every=2,
              fail_at=3, seed=1, device_steps=2)
    if declared_by == "flags":
        got, want = train_job("phi4-mini-3.8b", **kw), \
            j_train_job("phi4-mini-3.8b", **kw)
        layout = ((1, 1), 1)
    else:
        want = j_train_job("phi4-mini-3.8b", production_mesh=True, **kw)
        path = tmp_path / "train.json"
        path.write_text(json.dumps(want.to_manifest()))
        got = load_manifest(str(path))
        layout = ((16, 16), None)
    assert got.to_manifest() == want.to_manifest()
    assert (tuple(got.base_shape), got.max_data) == layout
