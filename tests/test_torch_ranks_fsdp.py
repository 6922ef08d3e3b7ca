"""Pure-FSDP training across ranks (``launch.ranks``, gloo on the CPU)
against the JAX package on the same meshes.

The train layout of phi4, gemma2, codeqwen and deepseek: their
``ParallelConfig(pure_fsdp_train=True)`` turns ``pure_fsdp`` on wherever
the global batch divides the ranks (``steps.train_par``, the reference's
``_train_pieces``), and then the batch splits over ``("data",
"model")``, every leaf's ``fsdp`` axis over both (over ``model`` alone
where that does not divide, replicated where neither does), and nothing
but the weights' gathers and their gradients' reductions moves.  The
reference runs in subprocesses on four forced host devices (``python
tests/test_torch_ranks_fsdp.py DIR CASE...``, each with one XLA thread),
while the ranks run: ``build_train`` in f32 under each arch's own
``registry.get_parallel`` for every case of ``CASES`` (phi4-mini and
gemma2-9b smoke on (1, 2), (2, 2) and (1, 4), gemma2's window cut to 8
so its ``local`` layers mask; phi4 at ``accum_steps=2``; phi4 at d_model
66, which splits over ``model`` alone on (2, 2), and 65, which
replicates; gemma2 on a batch of 6, which does not divide the four ranks
and falls to tensor and sequence parallelism as the reference does), two
steps of a (B, 32) batch from ``np.random.RandomState(0)``, Adam eps 1e-5.
Initial params are the port's ``launch.ranks.seeded_params``, written as
npz files the subprocesses read; the meshes are ``jax.sharding.Mesh`` of
``jax.devices()[:n]``.

Held, in f32: every rank's losses and grad norms within 1e-5 relative of
the reference's, every param leaf put back together from the ranks'
blocks within 1e-4 (the replicas of a block equal bit for bit), each
rank's param and moment blocks' shapes against the reference's
``NamedSharding.shard_shape``, and each rank's collective bytes against
``ranks.fsdp_step_bytes``.  Three mutants fail the match: a dimension
split over ``("data", "model")`` gathered over ``data`` and then over
``model`` (its blocks interleaved wrongly), the norms' grads left
unsummed over ``model``, and the loss metric averaged over ``data``
alone.  Each rank runs one torch thread, at most four ranks a call and
two calls at a time.
"""
import contextlib
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
from repro_torch.launch.mesh import RankMesh, make_mesh         # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer                      # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.sharding import specs                          # noqa: E402

PHI4, GEMMA2, GRANITE = "phi4-mini-3.8b", "gemma2-9b", "granite-moe-1b-a400m"
S, STEPS = 32, 2
GEMMA2_WINDOW = 8
# name -> (arch, overrides of the smoke config, mesh, global batch, accum)
CASES = {
    "phi4_1x2": (PHI4, {}, (1, 2), 4, 1),
    "phi4_2x2": (PHI4, {}, (2, 2), 4, 1),
    "phi4_1x4": (PHI4, {}, (1, 4), 4, 1),
    "gemma2_1x2": (GEMMA2, {}, (1, 2), 4, 1),
    "gemma2_2x2": (GEMMA2, {}, (2, 2), 4, 1),
    "gemma2_1x4": (GEMMA2, {}, (1, 4), 4, 1),
    # two microbatches of 4 rows, one row of each a rank
    "phi4_accum2_2x2": (PHI4, {}, (2, 2), 8, 2),
    "phi4_d66_2x2": (PHI4, dict(d_model=66), (2, 2), 4, 1),
    "phi4_d65_2x2": (PHI4, dict(d_model=65), (2, 2), 4, 1),
    "gemma2_b6_2x2": (GEMMA2, {}, (2, 2), 6, 1),
}
MUTANTS = ("gather_data_then_model", "norms_not_summed_over_model",
           "loss_over_data_only")
MUTANT_CASE = "phi4_2x2"
OPT = dict(warmup_steps=1, decay_steps=100, eps=1e-5)
LOSS_RTOL = 1e-5
# as in tests/test_torch_ranks_tp.py: the ranks' norm (f64 sums on the
# CPU) is held within LOSS_RTOL of the f64 norm of the reference's grads
# at the step's params, and within STEP_NORM_RTOL of the f32 norm its
# step reports
STEP_NORM_RTOL = 1e-4
PARAM_TOL = dict(rtol=0, atol=1e-4)
SRC = Path(__file__).resolve().parents[1] / "src"
REF_PROCS = 3
RANK_CALLS = 2
# one XLA thread a reference process: the suite runs beside timing tests
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
                 "--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1")


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


def _smoke(cfg, arch, extra):
    """``cfg`` (either stack's smoke config of ``arch``) in f32 with the
    case's overrides, gemma2's window cut so it masks."""
    cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                      **extra)
    if arch == GEMMA2:
        cfg = cfg.replace(attn=dataclasses.replace(cfg.attn,
                                                   window=GEMMA2_WINDOW))
    return cfg


def _cfg(name):
    arch, extra, *_ = CASES[name]
    return _smoke(treg.get_smoke(arch), arch, extra)


def _ocfg(name):
    return OptimizerConfig(**OPT, accum_steps=CASES[name][4])


def _par(name):
    """The layout a step of case ``name`` runs: the arch's own, switched
    to pure FSDP where the batch divides the ranks."""
    arch, _, shape, B, _ = CASES[name]
    return tsteps.train_par(treg.get_parallel(arch), global_batch=B,
                            chips=math.prod(shape))


def _reference(out_dir: str, names) -> None:
    """The JAX runs of the cases ``names``, from ``init_<case>.npz`` and
    ``batches_<case>.npz`` in ``out_dir``, written there as
    ``train_<case>.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import registry as jreg
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.base import ShapeConfig
    from repro.models import params as jpr
    from repro.models import transformer as jtfm
    from repro.models.layers import ModelCtx
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    out = Path(out_dir)
    for name in names:
        arch, extra, shape, B, accum = CASES[name]
        cfg = _smoke(jreg.get_smoke(arch), arch, extra)
        ocfg = JOpt(**OPT, accum_steps=accum)
        jpar = jreg.get_parallel(arch)
        with np.load(out / f"init_{name}.npz") as z:
            params = jax.tree.map(jnp.asarray, _nest(dict(z)))
        with np.load(out / f"batches_{name}.npz") as z:
            batches = {k: z[k] for k in z.files}
        schema = jtfm.lm_schema(cfg)
        opt = jpr.init_params(jadamw.opt_state_schema(schema, ocfg),
                              jax.random.key(1), "float32")
        mesh = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                    ("data", "model"))
        bundle = jsteps.build_train(cfg, jpar, ocfg, mesh,
                                    ShapeConfig("t", S, B, "train"))
        p = jax.device_put(params, bundle.in_shardings[0])
        o = jax.device_put(opt, bundle.in_shardings[1])
        step = bundle.jit()
        # the grads at the step's layout: build_train's own switch
        if jpar.pure_fsdp_train and B % math.prod(shape) == 0:
            jpar = dataclasses.replace(jpar, pure_fsdp=True)
        ctx = ModelCtx(cfg, jpar, mesh)
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

@contextlib.contextmanager
def _mutated(mutant):
    """One rule broken in this process while the block runs (None: none)."""
    from repro_torch.sharding import collectives
    saved = {(mod, attr): getattr(mod, attr) for mod, attr in (
        (transformer, "_gathers"), (tsteps, "_reduce_grads"),
        (tsteps, "_loss_metric"))}
    if mutant == "gather_data_then_model":
        gathers = transformer._gathers

        def split(cfg, par, mesh, axes):
            def fix(node):
                if isinstance(node, dict):
                    return {k: fix(v) for k, v in node.items()}
                return [step for d, g in node for step in (
                    ((d, mesh.groups["data"]), (d, mesh.groups["model"]))
                    if g is mesh.world else ((d, g),))]
            return fix(gathers(cfg, par, mesh, axes))
        transformer._gathers = split
    elif mutant == "norms_not_summed_over_model":
        def data_sum_only(cfg, par, grads, mesh):
            dp, tp = mesh.size("data"), mesh.size("model")
            spec_tree = specs.leaf_specs(
                tsteps._model_module(cfg).lm_schema(cfg), mesh.mesh,
                specs.logical_rules(par))

            def mean(g, spec):
                if dp > 1 and specs.axis_dim(spec, "data") is None:
                    collectives.all_reduce_(g, mesh.groups["data"])
                return g.div_(dp * tp)
            return tsteps._map(mean, grads, spec_tree)
        tsteps._reduce_grads = data_sum_only
    elif mutant == "loss_over_data_only":
        def data_mean(value, mesh, par):
            return collectives.all_reduce_(
                value.to(torch.float32).clone(), mesh.groups["data"]) / \
                mesh.size("data")
        tsteps._loss_metric = data_mean
    elif mutant is not None:
        raise ValueError(mutant)
    try:
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def _cases_ranks(rm, jobs):
    """``train_ranks`` for each (mutant or None, cfg, par, ocfg, batches,
    whole params) of ``jobs`` in turn on this rank (one spawn for all of a
    mesh's cases) -> their results in order."""
    out = []
    for mutant, cfg, par, ocfg, batches, init in jobs:
        with _mutated(mutant):
            out.append(ranks.train_ranks(rm, cfg, par, ocfg, batches,
                                         params=init, keep=True))
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _batches(cfg, B):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (STEPS, B, S + 1)).astype(
        np.int32)
    return {"tokens": tokens[..., :S], "labels": tokens[..., 1:]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks and the mutants', one ``run_ranks`` call a mesh
    (the mutants one of their own), ``RANK_CALLS`` at a time, while the
    reference runs in its subprocesses; -> {("train" | "mutant", name):
    result}, and ("ref", case): the reference's npz."""
    out = tmp_path_factory.mktemp("ranks_fsdp_reference")
    inputs = {}
    for name in CASES:
        arch, _, _, B, _ = CASES[name]
        cfg = _cfg(name)
        init = bridge.to_numpy(ranks.seeded_params(cfg, 0))
        batches = _batches(cfg, B)
        np.savez(out / f"init_{name}.npz", **_flat(init))
        np.savez(out / f"batches_{name}.npz", **batches)
        inputs[name] = (cfg, treg.get_parallel(arch), _ocfg(name), batches,
                        init)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=REF_XLA_FLAGS,
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    names = list(CASES)
    refs = [subprocess.Popen(
        [sys.executable, __file__, str(out), *names[i::REF_PROCS]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(REF_PROCS)]
    calls = {}
    for name in CASES:
        calls.setdefault(CASES[name][2], []).append(
            (("train", name), None, name))
    calls["mutants"] = [(("mutant", m), m, MUTANT_CASE) for m in MUTANTS]

    def call(key):
        shape = CASES[MUTANT_CASE][2] if key == "mutants" else key
        res = ranks.run_ranks(
            _cases_ranks, shape,
            args=([(m, *inputs[name]) for _, m, name in calls[key]],),
            device="cpu", threads=1)
        return {tag: [r[i] for r in res]
                for i, (tag, _, _) in enumerate(calls[key])}

    try:
        with ThreadPoolExecutor(max_workers=RANK_CALLS) as pool:
            futures = [pool.submit(call, key) for key in sorted(
                calls, key=lambda k: -len(calls[k]))]
            done = {}
            for f in futures:
                done.update(f.result(timeout=900))
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

def _specs(cfg, par, mesh):
    rules = specs.logical_rules(par)
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
    leaf_specs = _specs(_cfg(name), _par(name), mesh)
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
    init = _flat(bridge.to_numpy(ranks.seeded_params(_cfg(name), 0)))
    final = _prefixed(z, "final:")
    assert any(np.abs(final[k] - init[k]).max() > 1e-4 for k in final)
    par = _par(name)
    for res in results:
        for row in res["steps"]:
            if par.pure_fsdp:
                # weights' gathers and their grads' reductions, nothing
                # else: the bytes the leaf shapes give
                assert row["bytes"] == ranks.fsdp_step_bytes(
                    _cfg(name), par, CASES[name][2], CASES[name][4])
            else:
                # tensor and sequence parallelism moves activations
                assert row["bytes"]["reduce_scatter"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_are_the_reference_shard_shapes(runs, name):
    z, results = runs["ref", name], runs["train", name]
    want = {k: tuple(int(n) for n in v)
            for k, v in _prefixed(z, "shape:").items()}
    cfg, par = _cfg(name), _par(name)
    mesh = make_mesh(CASES[name][2], ("data", "model"))
    rules = specs.logical_rules(par)
    for res in results:
        for key in ("params", "m", "v"):
            for path, shape in res["shapes"][key].items():
                assert shape == want[f"{key}:{path}"], (key, path)
        for path, p in tpr.leaves(tsteps._model_module(cfg).lm_schema(cfg)):
            assert res["shapes"]["params"][path] == specs.shard_shape(
                p.shape, specs.spec_for(p.shape, p.axes, mesh, rules), mesh)


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutants_fail_the_match(runs, mutant):
    """A tuple-split dimension gathered over ``data`` then ``model``, the
    norms' grads unsummed over ``model``, or the loss metric averaged over
    ``data`` alone miss the reference: the checks above see each."""
    with pytest.raises(AssertionError):
        _check_train(MUTANT_CASE, runs["ref", MUTANT_CASE],
                     runs["mutant", mutant])


# ---------------------------------------------------------------------------
# the layout's pieces, with no process group
# ---------------------------------------------------------------------------

def _fake_rank_mesh(shape, coords):
    """A ``RankMesh`` whose groups are labels: what ``_gathers`` and
    ``_rank_rows`` read of it, without a process group."""
    return RankMesh(mesh=make_mesh(shape, ("data", "model")), rank=0,
                    coords=dict(zip(("data", "model"), coords)),
                    device=torch.device("cpu"), world="world",
                    groups={"data": "data", "model": "model"})


@pytest.mark.parametrize("name,want", [
    # every matrix and the embedding over both axes, once over the world;
    # the norms replicated
    ("phi4_2x2", {"embed": [(1, "world")], "final_norm": [],
                  "blocks/0_attn/wq": [(1, "world")],
                  "blocks/0_attn/wo": [(3, "world")],
                  "blocks/0_attn/wo_mlp": [(2, "world")],
                  "blocks/0_attn/ln1": []}),
    # 66 divides 2, not 4: over model alone
    ("phi4_d66_2x2", {"embed": [(1, "model")],
                      "blocks/0_attn/wq": [(1, "model")],
                      "blocks/0_attn/ln2": []}),
    # 65 divides neither: replicated, never gathered
    ("phi4_d65_2x2", {"embed": [], "blocks/0_attn/wg": []}),
    ("gemma2_1x4", {"embed": [(1, "world")],
                    "blocks/0_local/ln1_post": [],
                    "blocks/1_global/wk": [(1, "world")]}),
])
def test_gathers_follow_each_leafs_spec(name, want):
    cfg, par = _cfg(name), _par(name)
    assert par.pure_fsdp
    rm = _fake_rank_mesh(CASES[name][2], (0, 0))
    plans = _flat_plans(transformer._gathers(
        cfg, par, rm, transformer._zero_axes(par, rm)))
    for path, plan in want.items():
        assert plans[path] == plan, path


def _flat_plans(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_plans(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def test_gathers_under_tensor_parallelism_stay_on_data():
    """The reference's default layout gathers a layer over ``data``
    alone: its ``model`` splits are the heads and ff columns a rank
    computes with (``_tp_blocks``)."""
    cfg = treg.get_smoke(PHI4).replace(num_heads=16, num_kv_heads=4,
                                       head_dim=8)
    par, rm = ParallelConfig(), _fake_rank_mesh((2, 2), (1, 0))
    plans = _flat_plans(transformer._gathers(
        cfg, par, rm, transformer._zero_axes(par, rm)))
    assert plans["blocks/0_attn/wq"] == [(1, "data")]
    assert plans["blocks/0_attn/wo_mlp"] == [(2, "data")]
    assert plans["embed"] == [(1, "data")]


@pytest.mark.parametrize("shape,B,accum", [
    ((2, 2), 4, 1), ((1, 4), 4, 1), ((2, 2), 8, 2), ((4, 1), 8, 2),
    ((1, 2), 12, 3)])
def test_rank_rows_are_the_reference_split_of_each_microbatch(shape, B,
                                                              accum):
    """Under pure FSDP microbatch i is rows i*mb .. (i+1)*mb, split over
    ``("data", "model")`` in rank order; the ranks' rows cover the batch
    once."""
    par = ParallelConfig(pure_fsdp=True)
    batch = {"tokens": torch.arange(B)[:, None].repeat(1, 3)}
    n, mb = math.prod(shape), B // accum
    seen = []
    for k in range(n):
        coords = (k // shape[1], k % shape[1])
        rows = tsteps._rank_rows(batch, _fake_rank_mesh(shape, coords),
                                 accum, par)["tokens"][:, 0].tolist()
        r = mb // n
        assert rows == [i * mb + k * r + j for i in range(accum)
                        for j in range(r)]
        seen += rows
    assert sorted(seen) == list(range(B))


def test_a_microbatch_that_does_not_split_over_the_ranks_raises():
    """The port splits each microbatch over the ranks by rows: 2 rows on
    4 ranks do not split (the reference reshards them under GSPMD)."""
    batch = {"tokens": torch.zeros((4, 3), dtype=torch.int32)}
    with pytest.raises(ValueError, match="2 microbatches over the 4 ranks"):
        tsteps._rank_rows(batch, _fake_rank_mesh((2, 2), (0, 1)), 2,
                          ParallelConfig(pure_fsdp=True))


@pytest.mark.parametrize("arch,shape,B,pure", [
    (PHI4, (1, 2), 4, True), (PHI4, (2, 2), 4, True),
    (GEMMA2, (1, 4), 4, True), (GEMMA2, (2, 2), 6, False),
    ("codeqwen1.5-7b", (2, 2), 8, True), ("deepseek-7b", (1, 4), 2, False)])
def test_check_layout_admits_pure_fsdp_on_a_model_axis(arch, shape, B,
                                                       pure):
    """The arch's own layout on a mesh with ``model`` > 1: pure FSDP
    where the batch divides the ranks, else its tensor- and
    sequence-parallel defaults; both run."""
    par = tsteps.train_par(treg.get_parallel(arch), global_batch=B,
                           chips=math.prod(shape))
    assert par.pure_fsdp == pure
    tsteps.check_layout(treg.get_smoke(arch), par, OptimizerConfig(),
                        make_mesh(shape, ("data", "model")), seq=S)


@pytest.mark.parametrize("arch,ocfg,axes,shape,match", [
    (GRANITE, OptimizerConfig(), ("data", "model"), (1, 2), "pure_fsdp"),
    (GRANITE, OptimizerConfig(), ("data", "model"), (2, 2), "pure_fsdp"),
    ("llama-3.2-vision-90b", OptimizerConfig(), ("data", "model"), (1, 2),
     "dense and MoE"),
    ("whisper-small", OptimizerConfig(), ("data", "model"), (2, 2),
     "dense and MoE"),
    ("whisper-small", OptimizerConfig(), ("data", "model"), (1, 2),
     "dense and MoE"),
    (PHI4, OptimizerConfig(moment_dtype="int8"), ("data", "model"), (1, 2),
     "int8"),
    (PHI4, OptimizerConfig(second_moment="factored"), ("data", "model"),
     (2, 2), "factored"),
    (PHI4, OptimizerConfig(), ("pod", "data", "model"), (2, 1, 2), "pod"),
])
def test_pure_fsdp_layouts_the_port_does_not_run_raise(arch, ocfg, axes,
                                                       shape, match):
    with pytest.raises(NotImplementedError, match=match):
        tsteps.check_layout(treg.get_smoke(arch),
                            ParallelConfig(pure_fsdp=True), ocfg,
                            make_mesh(shape, axes), seq=S)


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2:])
