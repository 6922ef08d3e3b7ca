"""Tensor and sequence parallelism across ranks (``launch.ranks``, gloo on
the CPU) against the JAX package on the same meshes.

The reference's default layout, ``ParallelConfig()``: heads, KV heads,
ff columns and the vocab split over ``model`` as ``sharding.specs`` lays
them out, the stream between layers sequence-sharded on ``model``, ZeRO-3
on ``data`` and the experts on ``model``.  The reference runs once, in a
subprocess on four forced host devices (``python
tests/test_torch_ranks_tp.py DIR CASE...``, three of them, each with a
third of the cases), while the ranks run: ``build_train``
in f32 for every case of ``CASES`` (granite-moe and phi4-mini smoke with
their own 4 heads, 2 KV heads of 16 dims, which split wq/wo on head_dim
and at (1, 4) repeat K/V; the same at 16 heads, 4 KV heads of 8 dims,
which split on heads; granite at 2 layers; granite at its own 49,155-word
vocab, which replicates the embedding over ``model`` and takes the
chunked loss), two steps of a 4 x 32 batch from ``np.random.RandomState
(0)``, granite's capacity factor 4.0, Adam eps 1e-5.  Initial params are
the port's ``launch.ranks.seeded_params`` (contracted attention init),
written as npz files the subprocess reads; the meshes are built as
``jax.sharding.Mesh`` of ``jax.devices()[:n]``.

Held, in f32: every rank's losses and grad norms within 1e-5 relative of
the reference's, every param leaf put back together from the ranks'
blocks within 1e-4 (the replicas of a block equal bit for bit), and each
rank's param and moment blocks' shapes against the reference's
``NamedSharding.shard_shape``.  Two mutants fail those checks: an
``sp_gather`` whose backward slices (``collectives.seq_gather``) instead of
summing, and the leaves replicated over ``model`` left unsummed.  The
collectives ``sp_gather`` and ``sp_scatter``, forward and backward and
their ``bytes_sent``, are held against one process's sums and slices.
Each rank runs one torch thread; at most three ``run_ranks`` calls run at
once.
"""
import dataclasses
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,           # noqa: E402
                                      ParallelConfig)
from repro_torch.launch import ranks                            # noqa: E402
from repro_torch.launch.mesh import make_mesh                   # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer                      # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.sharding import specs                          # noqa: E402

GRANITE, PHI4 = "granite-moe-1b-a400m", "phi4-mini-3.8b"
B, S, STEPS = 4, 32, 2
GRANITE_CF = 4.0
H16 = dict(num_heads=16, num_kv_heads=4, head_dim=8)
# name -> (arch, overrides of the smoke config, mesh)
CASES = {
    "granite_1x2": (GRANITE, {}, (1, 2)),
    "granite_2x2": (GRANITE, {}, (2, 2)),
    "granite_1x4": (GRANITE, {}, (1, 4)),
    "phi4_1x2": (PHI4, {}, (1, 2)),
    "phi4_2x2": (PHI4, {}, (2, 2)),
    "phi4_1x4": (PHI4, {}, (1, 4)),
    "granite_h16_1x2": (GRANITE, H16, (1, 2)),
    "granite_h16_1x4": (GRANITE, H16, (1, 4)),
    "phi4_h16_1x2": (PHI4, H16, (1, 2)),
    "phi4_h16_1x4": (PHI4, H16, (1, 4)),
    "granite_2layers_1x2": (GRANITE, dict(num_layers=2), (1, 2)),
    "granite_vocab49155_1x2": (GRANITE, dict(vocab_size=49_155), (1, 2)),
}
MUTANTS = ("sp_gather_slices", "replicated_not_summed")
MUTANT_CASE = "granite_1x2"
COLLECTIVE_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
OPT = dict(warmup_steps=1, decay_steps=100, eps=1e-5)
LOSS_RTOL = 1e-5
# the reference's step sums the squares in f32 in order on the CPU
# (``optim/adamw.py`` ``global_norm``'s einsum): its norm lands up to
# 2.8e-5 off the f64 sum of its own grads' squares at these sizes, and
# differs by 1.9e-5 between meshes.  The ranks' norm (f64 sums on the
# CPU) is held within LOSS_RTOL of that f64 sum of the reference's grads
# on the same mesh (``jax.grad`` of its ``loss_fn`` at the step's params),
# and within STEP_NORM_RTOL of the norm its step reports.
STEP_NORM_RTOL = 1e-4
PARAM_TOL = dict(rtol=0, atol=1e-4)
SRC = Path(__file__).resolve().parents[1] / "src"
REF_PROCS = 3


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: np.asarray(tree)}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _prefixed(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _overrides(extra):
    return dict(param_dtype="float32", compute_dtype="float32", **extra)


def _cfg(name):
    arch, extra, _ = CASES[name]
    cfg = treg.get_smoke(arch).replace(**_overrides(extra))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=GRANITE_CF))
    return cfg


def _reference(out_dir: str, names) -> None:
    """The JAX runs of the cases ``names``, from ``init_<case>.npz`` and
    ``batches_<case>.npz`` in ``out_dir``, written there as
    ``train_<case>.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import registry as jreg
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.base import ParallelConfig as JPar
    from repro.configs.base import ShapeConfig
    from repro.models import params as jpr
    from repro.models import transformer as jtfm
    from repro.models.layers import ModelCtx
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    out = Path(out_dir)
    ocfg = JOpt(**OPT)
    for name in names:
        arch, extra, shape = CASES[name]
        cfg = jreg.get_smoke(arch).replace(**_overrides(extra))
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=GRANITE_CF))
        with np.load(out / f"init_{name}.npz") as z:
            params = jax.tree.map(jnp.asarray, _nest(dict(z)))
        with np.load(out / f"batches_{name}.npz") as z:
            batches = {k: z[k] for k in z.files}
        schema = jtfm.lm_schema(cfg)
        opt = jpr.init_params(jadamw.opt_state_schema(schema, ocfg),
                              jax.random.key(1), "float32")
        mesh = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                    ("data", "model"))
        bundle = jsteps.build_train(cfg, JPar(), ocfg, mesh,
                                    ShapeConfig("t", S, B, "train"))
        p = jax.device_put(params, bundle.in_shardings[0])
        o = jax.device_put(opt, bundle.in_shardings[1])
        step = bundle.jit()
        ctx = ModelCtx(cfg, JPar(), mesh)
        grad = jax.jit(jax.grad(lambda pp, bb: jtfm.loss_fn(ctx, pp, bb)),
                       in_shardings=bundle.in_shardings[::2])
        losses, norms, exact = [], [], []
        for j in range(STEPS):
            batch = {k: jnp.asarray(v[j]) for k, v in batches.items()}
            exact.append(math.sqrt(sum(
                float(np.sum(np.square(np.asarray(g, np.float64))))
                for g in jax.tree.leaves(grad(p, batch)))))
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        blocks = {}
        for key, tree, shd in (("params", params, bundle.in_shardings[0]),
                               ("m", opt["m"], bundle.in_shardings[1]["m"]),
                               ("v", opt["v"], bundle.in_shardings[1]["v"])):
            shapes = jax.tree.map(lambda a, s: np.array(s.shard_shape(
                a.shape)), tree, shd)
            blocks.update({f"{key}:{k}": v
                           for k, v in _flat(shapes).items()})
        np.savez(out / f"train_{name}.npz", losses=np.array(losses),
                 norms=np.array(norms), exact_norms=np.array(exact),
                 **{f"final:{k}": v for k, v in
                    _flat(jax.tree.map(np.asarray, p)).items()},
                 **{f"shape:{k}": v for k, v in blocks.items()})


# ---------------------------------------------------------------------------
# what a rank runs besides ``ranks.train_ranks`` (spawned ranks import this
# module by name)
# ---------------------------------------------------------------------------

def _mutant_ranks(rm, mutant, *args, **kwargs):
    """``train_ranks`` with one rule broken in this rank's process."""
    from repro_torch.sharding import collectives
    if mutant == "sp_gather_slices":
        collectives.sp_gather = collectives.seq_gather
    elif mutant == "replicated_not_summed":
        def no_model_sum(cfg, par, grads, mesh):
            n = mesh.size("data") * mesh.size("model")
            assert mesh.size("data") == 1
            return tsteps._map(lambda g: g.div_(n), grads)
        tsteps._reduce_grads = no_model_sum
    else:
        raise ValueError(mutant)
    return ranks.train_ranks(rm, *args, **kwargs)


def _collective_ranks(rm, x, y, gx, gy):
    """``sp_gather`` of this rank's slice of ``x`` (B, S, D) and
    ``sp_scatter`` of its row ``y[r]`` (B, S, D), each differentiated
    against the rank's upstream ``gx[r]`` (B, S, D) and ``gy[r]`` (B, S /
    tp, D), r its ``model`` coordinate.  -> outputs, input grads and the
    bytes each handed the backend, forward and backward."""
    from repro_torch.sharding import collectives
    group, tp, r = rm.groups["model"], rm.size("model"), rm.coords["model"]
    n = x.shape[1] // tp
    xs = torch.tensor(x[:, r * n:(r + 1) * n], requires_grad=True)
    ys = torch.tensor(y[r], requires_grad=True)
    out = {}
    for key, fn, arg, up in (("gather", collectives.sp_gather, xs, gx[r]),
                             ("scatter", collectives.sp_scatter, ys, gy[r])):
        collectives.reset_counts()
        with torch.enable_grad():
            res = fn(arg, 1, group)
            fwd = dict(collectives.bytes_sent)
            collectives.reset_counts()
            (grad,) = torch.autograd.grad(res, arg, torch.tensor(up))
        out[key] = {"out": res.detach().numpy(), "grad": grad.numpy(),
                    "fwd_bytes": fwd, "bwd_bytes": dict(collectives.bytes_sent)}
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _batches(cfg):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (STEPS, B, S + 1)).astype(
        np.int32)
    return {"tokens": tokens[..., :S], "labels": tokens[..., 1:]}


def _collective_inputs(tp):
    rng = np.random.RandomState(7)
    D = 8
    x = rng.standard_normal((2, 4 * tp, D)).astype(np.float32)
    y = rng.standard_normal((tp, 2, 4 * tp, D)).astype(np.float32)
    gx = rng.standard_normal((tp, 2, 4 * tp, D)).astype(np.float32)
    gy = rng.standard_normal((tp, 2, 4, D)).astype(np.float32)
    return x, y, gx, gy


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks, the mutants' and the collectives', three
    ``run_ranks`` calls at a time, while the reference runs in its
    subprocess; -> {("train" | "mutant" | "collectives", name): result},
    and ("ref", case): the reference's npz."""
    out = tmp_path_factory.mktemp("ranks_tp_reference")
    inputs = {}
    for name in CASES:
        cfg = _cfg(name)
        init = bridge.to_numpy(ranks.seeded_params(cfg, 0))
        batches = _batches(cfg)
        np.savez(out / f"init_{name}.npz", **_flat(init))
        np.savez(out / f"batches_{name}.npz", **batches)
        inputs[name] = (cfg, init, batches)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=("--xla_force_host_platform_device_count=4 "
                          # one XLA thread: the suite runs beside timing
                          # tests (the fair-share makespan bound)
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1"),
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    # the reference's cases in REF_PROCS subprocesses (its time is mostly
    # XLA compiles, one thread each)
    names = list(CASES)
    refs = [subprocess.Popen(
        [sys.executable, __file__, str(out), *names[i::REF_PROCS]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(REF_PROCS)]
    par, ocfg = ParallelConfig(), OptimizerConfig(**OPT)

    def train(name, fn=ranks.train_ranks, extra=()):
        cfg, init, batches = inputs[name]
        return ranks.run_ranks(
            fn, CASES[name][2],
            args=(*extra, cfg, par, ocfg, batches),
            kwargs={"params": init, "keep": True}, device="cpu", threads=1)

    def collectives_run(name):
        return ranks.run_ranks(
            _collective_ranks, COLLECTIVE_MESHES[name],
            args=_collective_inputs(COLLECTIVE_MESHES[name][1]),
            device="cpu", threads=1)

    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            futures = {("train", n): pool.submit(train, n) for n in CASES}
            futures.update({("mutant", m): pool.submit(
                train, MUTANT_CASE, _mutant_ranks, (m,)) for m in MUTANTS})
            futures.update({("collectives", n): pool.submit(
                collectives_run, n) for n in COLLECTIVE_MESHES})
            done = {key: f.result(timeout=900) for key, f in futures.items()}
        errs = [ref.communicate(timeout=900)[1] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-4000:]
    for name in CASES:
        with np.load(out / f"train_{name}.npz") as z:
            done["ref", name] = {k: z[k] for k in z.files}
    return done


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _specs(cfg, mesh):
    rules = specs.logical_rules(ParallelConfig())
    schema = tsteps._model_module(cfg).lm_schema(cfg)
    return {path: specs.spec_for(p.shape, p.axes, mesh, rules)
            for path, p in tpr.leaves(schema)}


def _check_train(name, z, results):
    """The ranks' losses, grad norms and final blocks against the
    reference's run ``z`` of case ``name``."""
    shape = CASES[name][2]
    assert len(results) == math.prod(shape)
    for res in results:
        np.testing.assert_allclose([row["loss"] for row in res["steps"]],
                                   z["losses"], rtol=LOSS_RTOL, atol=0)
        got = [row["grad_norm"] for row in res["steps"]]
        np.testing.assert_allclose(got, z["exact_norms"], rtol=LOSS_RTOL,
                                   atol=0)
        np.testing.assert_allclose(got, z["norms"], rtol=STEP_NORM_RTOL,
                                   atol=0)
    final = _prefixed(z, "final:")
    mesh = make_mesh(shape, ("data", "model"))
    leaf_specs = _specs(_cfg(name), mesh)
    blocks = [_flat(res["params"]) for res in results]
    assert all(set(b) == set(final) for b in blocks)
    for path, want in final.items():
        whole = specs.assemble(
            {tuple(res["coords"][a] for a in mesh.axis_names):
             torch.as_tensor(b[path]) for res, b in zip(results, blocks)},
            want.shape, leaf_specs[path], mesh)
        np.testing.assert_allclose(whole.numpy(), want, err_msg=path,
                                   **PARAM_TOL)
        # the replicas of a block agree bit for bit
        for res, b in zip(results, blocks):
            np.testing.assert_array_equal(specs.local_shard(
                whole, leaf_specs[path], mesh, res["coords"]).numpy(),
                b[path], err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax_on_the_same_mesh(runs, name):
    z, results = runs["ref", name], runs["train", name]
    _check_train(name, z, results)
    # the step moved the params, and the layout is sequence-parallel:
    # each layer reduce-scatters its row-parallel outputs
    init = _flat(bridge.to_numpy(ranks.seeded_params(_cfg(name), 0)))
    final = _prefixed(z, "final:")
    assert any(np.abs(final[k] - init[k]).max() > 1e-4 for k in final)
    for res in results:
        assert res["steps"][0]["bytes"]["reduce_scatter"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_are_the_dry_runs_shard_shapes(runs, name):
    z, results = runs["ref", name], runs["train", name]
    want = {k: tuple(int(n) for n in v)
            for k, v in _prefixed(z, "shape:").items()}
    cfg = _cfg(name)
    mesh = make_mesh(CASES[name][2], ("data", "model"))
    rules = specs.logical_rules(ParallelConfig())
    for res in results:
        for key in ("params", "m", "v"):
            for path, shape in res["shapes"][key].items():
                assert shape == want[f"{key}:{path}"], (key, path)
        for path, p in tpr.leaves(tsteps._model_module(cfg).lm_schema(cfg)):
            assert res["shapes"]["params"][path] == specs.shard_shape(
                p.shape, specs.spec_for(p.shape, p.axes, mesh, rules), mesh)


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutants_fail_the_match(runs, mutant):
    """A slicing ``sp_gather`` backward, or leaves replicated over
    ``model`` left unsummed, miss the reference: the checks above see
    both."""
    with pytest.raises(AssertionError):
        _check_train(MUTANT_CASE, runs["ref", MUTANT_CASE],
                     runs["mutant", mutant])


@pytest.mark.parametrize("name", list(COLLECTIVE_MESHES))
def test_sp_collectives_match_one_process(runs, name):
    tp = COLLECTIVE_MESHES[name][1]
    x, y, gx, gy = _collective_inputs(tp)
    n = x.shape[1] // tp
    item = 4
    for rank, res in enumerate(runs["collectives", name]):
        m = rank % tp             # row-major: model is the minor axis
        g, sc = res["gather"], res["scatter"]
        # sp_gather: the whole sequence forward; backward, the sum of
        # every rank's upstream gradient on this rank's slice
        np.testing.assert_array_equal(g["out"], x)
        np.testing.assert_allclose(g["grad"],
                                   gx.sum(0)[:, m * n:(m + 1) * n],
                                   rtol=1e-6, atol=1e-6)
        # sp_scatter: this rank's slice of the sum forward; backward, the
        # ranks' upstream slices put together
        np.testing.assert_allclose(sc["out"],
                                   y.sum(0)[:, m * n:(m + 1) * n],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(sc["grad"], np.concatenate(gy, 1))
        # bytes: an all-gather sends the rank's slice, a reduce-scatter
        # its whole input
        whole, part = x.size * item, x.size // tp * item
        zero = {"all_gather": 0, "reduce_scatter": 0, "all_to_all": 0,
                "all_reduce": 0}
        assert g["fwd_bytes"] == {**zero, "all_gather": part}
        assert g["bwd_bytes"] == {**zero, "reduce_scatter": whole}
        assert sc["fwd_bytes"] == {**zero, "reduce_scatter": whole}
        assert sc["bwd_bytes"] == {**zero, "all_gather": part}


@pytest.mark.parametrize("arch,extra,par,shape,match", [
    (PHI4, {}, ParallelConfig(sequence_parallel=False), (1, 2),
     "tensor_parallel=True, sequence_parallel=False"),
    (PHI4, {}, ParallelConfig(tensor_parallel=False), (2, 2),
     "sequence_parallel=True, tensor_parallel=False"),
    (PHI4, dict(num_heads=12, num_kv_heads=3), ParallelConfig(), (1, 2),
     "3 KV heads"),
    (PHI4, dict(d_ff=130), ParallelConfig(), (1, 4), "d_ff 130"),
    (GRANITE, {}, ParallelConfig(pure_fsdp=True), (1, 2), "pure_fsdp"),
    (GRANITE, {}, ParallelConfig(expert_parallel=False), (1, 2),
     "expert_parallel"),
])
def test_tp_layouts_the_port_does_not_run_raise(arch, extra, par, shape,
                                                match):
    cfg = treg.get_smoke(arch).replace(**extra)
    with pytest.raises(NotImplementedError, match=match):
        tsteps.check_layout(cfg, par, OptimizerConfig(),
                            make_mesh(shape, ("data", "model")), seq=S)


@pytest.mark.parametrize("H,KV,tp,want", [
    # query heads, and the KV heads they read (h // (H / KV))
    (4, 2, 2, [((0, 2), (0, 1)), ((2, 4), (1, 2))]),
    (4, 2, 4, [((0, 1), (0, 1)), ((1, 2), (0, 1)), ((2, 3), (1, 2)),
               ((3, 4), (1, 2))]),
    (16, 4, 4, [((4 * r, 4 * r + 4), (r, r + 1)) for r in range(4)]),
    (8, 1, 2, [((0, 4), (0, 1)), ((4, 8), (0, 1))]),
])
def test_tp_range_gives_each_rank_its_heads_and_their_kv_heads(H, KV, tp,
                                                               want):
    cfg = treg.get_smoke(PHI4).replace(num_heads=H, num_kv_heads=KV)
    got = [(transformer.tp_range(cfg, "heads", tp, r),
            transformer.tp_range(cfg, "kv_heads", tp, r)) for r in range(tp)]
    assert got == want
    # every query head reads its own KV head: h // (H / KV)
    for (h0, h1), (k0, k1) in got:
        assert {h // (H // KV) for h in range(h0, h1)} == set(range(k0, k1))
    F = cfg.d_ff
    assert [transformer.tp_range(cfg, "ff", tp, r) for r in range(tp)] == [
        (r * F // tp, (r + 1) * F // tp) for r in range(tp)]


def test_cli_takes_the_archs_own_layout_and_refuses_unported_ones():
    """``main`` trains under ``registry.get_parallel(arch)``: granite's is
    ``ParallelConfig()``, which ``check_layout`` admits on (1, 2); phi4's
    turns pure FSDP on where ``--batch`` divides the mesh, and its ranks
    on (1, 2) take the losses and grad norms of one device's
    ``train_step``, moving only the bytes the leaf shapes give.  MoE
    under pure FSDP (``--layout fsdp``) it refuses before any rank
    starts."""
    from repro_torch.data.tokens import TokenPipeline
    assert treg.get_parallel(GRANITE) == ParallelConfig()
    tsteps.check_layout(treg.get_smoke(GRANITE), ParallelConfig(),
                        OptimizerConfig(), make_mesh((1, 2), ("data", "model")),
                        seq=S)
    batch = 2
    results = ranks.main(["--arch", PHI4, "--smoke", "--mesh", "1,2",
                          "--seq", str(S), "--batch", str(batch),
                          "--steps", str(STEPS), "--device", "cpu",
                          "--threads", "1"])
    cfg = treg.get_smoke(PHI4).replace(param_dtype="float32",
                                       compute_dtype="float32")
    ocfg = OptimizerConfig(warmup_steps=2)
    own = treg.get_parallel(PHI4)
    par = tsteps.train_par(own, global_batch=batch, chips=2)
    assert par.pure_fsdp
    batches = TokenPipeline(cfg.vocab_size, S, batch, seed=0).chunk(0, STEPS)
    params = ranks.seeded_params(cfg, 0)
    opt = tsteps.init_opt_state(cfg, ocfg, "cpu")
    want = []
    for j in range(STEPS):
        params, opt, m = tsteps.train_step(
            cfg, own, ocfg, params, opt,
            {k: v[j] for k, v in batches.items()}, device="cpu")
        want.append((float(m["loss"]), float(m["grad_norm"])))
    assert len(results) == 2
    for res in results:
        got = [(row["loss"], row["grad_norm"]) for row in res["steps"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
        for row in res["steps"]:
            assert row["bytes"] == ranks.fsdp_step_bytes(cfg, par, (1, 2))
    with pytest.raises(NotImplementedError, match="pure_fsdp"):
        ranks.main(["--arch", GRANITE, "--layout", "fsdp", "--smoke",
                    "--mesh", "1,2", "--seq", str(S), "--batch", str(B),
                    "--device", "cpu"])


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2:])
