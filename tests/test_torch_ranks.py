"""Training across ranks (``launch.ranks``, gloo on the CPU) against the JAX
package on the same meshes.

The reference runs once, in a subprocess on four forced host devices
(``python tests/test_torch_ranks.py OUT``): ``build_train`` for
granite-moe smoke (1 layer, 4 experts top 2, d 64) in f32 under
``ParallelConfig(tensor_parallel=False, sequence_parallel=False)`` on the
(2, 2), (1, 4) and (4, 1) meshes, two steps of a 4 x 32 batch from a
numpy seed, and ``moe_mlp`` under (1, 2) and (1, 4) meshes inside
``jax.jit`` with its gradients; the meshes are built as
``repro.core.elastic.make_elastic_mesh`` builds them (``make_mesh`` gives
Explicit axes, which the reference's ``constrain`` refuses).  Initial
params come from the JAX ``init_params`` and reach the ranks through
``repro_torch.bridge``; each rank takes its blocks by
``steps.shard_params``.

Held, in f32:

  * the EP MoE output, its aux loss and the gradients of x, the router
    and each rank's experts against the JAX ``shard_map`` run on the same
    mesh, within 1e-5, at the config's capacity factor on inputs where no
    destination segment and no bucket fills (asserted from the JAX run's
    routing: the reference's scatter collision, ROADMAP queue C, would
    otherwise take a kept entry away);
  * two train steps' losses and grad norms and every param leaf after
    them against ``build_train`` on the same mesh, within 1e-4, at
    capacity factor 4.0 (no bucket can fill: besides the collision, on a
    model axis of 1 the reference computes the capacities over the global
    batch and the port over each rank's rows), with Adam eps 1e-5 (see
    tests/test_torch_train_families.py: an element whose grad lies within
    f32 rounding of 0 moves by +-lr under eps 1e-8);
  * the same at ``router_aux_weight`` 1.0 on (2, 2), where an aux loss or
    a sequence gather whose backward is off by a factor of tp or dp
    shows;
  * every rank's param and moment blocks' shapes against the reference's
    ``NamedSharding.shard_shape``: the bytes the dry run counts.

Also: a mesh larger than the cards raises without ``devices=``, the
layouts and recipes the port does not run raise ``NotImplementedError``
(tensor and sequence parallelism, which it runs, are held in
tests/test_torch_ranks_tp.py),
and two ``run_ranks`` calls at once do not collide.  Each rank runs one
torch thread.
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

from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,           # noqa: E402
                                      ParallelConfig)
from repro_torch.launch import ranks                            # noqa: E402
from repro_torch.launch.mesh import make_mesh                   # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models.moe import capacities                   # noqa: E402
from repro_torch.optim import adamw as tadamw                   # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.sharding import specs                          # noqa: E402

ARCH = "granite-moe-1b-a400m"
B, S, STEPS = 4, 32, 2
TRAIN_CF = 4.0
MOE_SEED = 2
# name -> (mesh, router_aux_weight)
TRAIN = {"2x2": ((2, 2), 0.01), "2x2_aux1": ((2, 2), 1.0),
         "1x4": ((1, 4), 0.01), "4x1": ((4, 1), 0.01)}
MOE = {"1x2": (1, 2), "1x4": (1, 4)}
OPT = dict(warmup_steps=1, decay_steps=100, eps=1e-5)
PAR = dict(tensor_parallel=False, sequence_parallel=False)
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=0, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
SRC = Path(__file__).resolve().parents[1] / "src"


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


def _reference(out_dir: str) -> None:
    """The JAX runs, written as npz files into ``out_dir``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import registry as jreg
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.base import ParallelConfig as JPar
    from repro.configs.base import ShapeConfig
    from repro.models import moe as jmoe
    from repro.models import params as jpr
    from repro.models import transformer as jtfm
    from repro.models.layers import ModelCtx
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    out = Path(out_dir)
    par = JPar(**PAR)
    ocfg = JOpt(**OPT)

    def mesh_of(shape):
        devs = jax.devices()[:math.prod(shape)]
        return Mesh(np.array(devs).reshape(shape), ("data", "model"))

    def cfg_of(cf, aux):
        cfg = jreg.get_smoke(ARCH).replace(param_dtype="float32",
                                           compute_dtype="float32")
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf, router_aux_weight=aux))

    rng = np.random.RandomState(0)
    cfg0 = cfg_of(TRAIN_CF, 0.01)
    V = cfg0.vocab_size
    tokens = rng.randint(0, V, (STEPS, B, S + 1)).astype(np.int32)
    batches = {"tokens": tokens[..., :S], "labels": tokens[..., 1:]}
    np.savez(out / "batches.npz", **batches)
    for name, (shape, aux) in TRAIN.items():
        cfg = cfg_of(TRAIN_CF, aux)
        schema = jtfm.lm_schema(cfg)
        params = jpr.init_params(schema, jax.random.key(0), "float32")
        opt = jpr.init_params(jadamw.opt_state_schema(schema, ocfg),
                              jax.random.key(1), "float32")
        bundle = jsteps.build_train(cfg, par, ocfg, mesh_of(shape),
                                    ShapeConfig("t", S, B, "train"))
        flat0 = _flat(jax.tree.map(np.asarray, params))
        p = jax.device_put(params, bundle.in_shardings[0])
        o = jax.device_put(opt, bundle.in_shardings[1])
        step = bundle.jit()
        losses, norms = [], []
        for j in range(STEPS):
            p, o, m = step(p, o, {k: jnp.asarray(v[j])
                                  for k, v in batches.items()})
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
                 norms=np.array(norms),
                 **{f"init:{k}": v for k, v in flat0.items()},
                 **{f"final:{k}": v for k, v in
                    _flat(jax.tree.map(np.asarray, p)).items()},
                 **{f"shape:{k}": v for k, v in blocks.items()})

    cfg = cfg_of(jreg.get_smoke(ARCH).moe.capacity_factor, 0.01)
    layer = jax.tree.map(lambda a: np.asarray(a[0]), jpr.init_params(
        jmoe.moe_schema(cfg, 1), jax.random.key(2), "float32"))
    rng = np.random.RandomState(MOE_SEED)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    for name, shape in MOE.items():
        ctx = ModelCtx(cfg, par, mesh_of(shape))

        def f(x_, p_):
            o_, aux_ = jmoe.moe_mlp(ctx, p_, x_)
            return jnp.sum(o_ * dy) + aux_, (o_, aux_)
        (_, (o_, aux_)), (gx, gp) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), layer)
        logits = jnp.einsum("bsd,de->bse", x, layer["router"])
        top_idx = jax.lax.top_k(jax.nn.softmax(logits, -1),
                                cfg.moe.top_k)[1]
        np.savez(out / f"moe_{name}.npz", x=x, dy=dy, out=np.asarray(o_),
                 aux=np.asarray(aux_), gx=np.asarray(gx),
                 top_idx=np.asarray(top_idx),
                 **{f"p:{k}": v for k, v in layer.items()},
                 **{f"g:{k}": np.asarray(v) for k, v in gp.items()})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=("--xla_force_host_platform_device_count=4 "
                          # one XLA thread: the suite runs beside timing
                          # tests (the fair-share makespan bound)
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1"),
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return out


def _load(ref, name):
    with np.load(ref / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def _cfg(cf, aux):
    cfg = treg.get_smoke(ARCH).replace(param_dtype="float32",
                                       compute_dtype="float32")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, router_aux_weight=aux))


def _prefixed(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(ref):
    """Every TRAIN and MOE case's ranks over gloo, one ``run_ranks`` a
    case, three calls at a time from three threads: calls at once must
    not collide (each has its own store)."""
    batches = _load(ref, "batches")
    moe_cfg = _cfg(treg.get_smoke(ARCH).moe.capacity_factor, 0.01)

    def train(name):
        shape, aux = TRAIN[name]
        z = _load(ref, f"train_{name}")
        return z, ranks.run_ranks(
            ranks.train_ranks, shape,
            args=(_cfg(TRAIN_CF, aux), ParallelConfig(**PAR),
                  OptimizerConfig(**OPT), batches),
            kwargs={"params": _nest(_prefixed(z, "init:")), "keep": True},
            device="cpu", threads=1)

    def moe(name):
        z = _load(ref, f"moe_{name}")
        return z, ranks.run_ranks(
            ranks.moe_ranks, MOE[name],
            args=(moe_cfg, _prefixed(z, "p:"), z["x"], z["dy"]),
            device="cpu", threads=1)

    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = {("train", n): pool.submit(train, n) for n in TRAIN}
        futures.update({("moe", n): pool.submit(moe, n) for n in MOE})
        return {key: f.result(timeout=600) for key, f in futures.items()}


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_jax_on_the_same_mesh(runs, name):
    z, results = runs["train", name]
    shape = TRAIN[name][0]
    assert len(results) == math.prod(shape)
    final = _prefixed(z, "final:")
    cfg = _cfg(TRAIN_CF, TRAIN[name][1])
    mesh = make_mesh(shape, ("data", "model"))
    schema_specs = _flat_specs(cfg, mesh)
    for res in results:
        got = [row["loss"] for row in res["steps"]]
        np.testing.assert_allclose(got, z["losses"], rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose([row["grad_norm"] for row in res["steps"]],
                                   z["norms"], rtol=1e-4, atol=0)
    # every leaf put back together from the ranks' blocks
    blocks = [_flat(res["params"]) for res in results]
    assert all(set(b) == set(final) for b in blocks)
    for path, want in final.items():
        whole = specs.assemble(
            {tuple(res["coords"][a] for a in mesh.axis_names):
             torch.as_tensor(b[path]) for res, b in zip(results, blocks)},
            want.shape, schema_specs[path], mesh)
        np.testing.assert_allclose(whole.numpy(), want, err_msg=path,
                                   **PARAM_TOL)
        # the replicas of a block agree bit for bit
        for res, b in zip(results, blocks):
            np.testing.assert_array_equal(specs.local_shard(
                whole, schema_specs[path], mesh, res["coords"]).numpy(),
                b[path], err_msg=path)
    # the step moved the params
    init = _prefixed(z, "init:")
    assert any(np.abs(final[k] - init[k]).max() > 1e-4 for k in final)


def _flat_specs(cfg, mesh):
    rules = specs.logical_rules(ParallelConfig(**PAR))
    schema = tsteps._model_module(cfg).lm_schema(cfg)
    return {path: specs.spec_for(p.shape, p.axes, mesh, rules)
            for path, p in tpr.leaves(schema)}


@pytest.mark.parametrize("name", list(TRAIN))
def test_rank_blocks_are_the_dry_runs_shard_shapes(runs, name):
    z, results = runs["train", name]
    want = {k: tuple(int(n) for n in v)
            for k, v in _prefixed(z, "shape:").items()}
    cfg = _cfg(TRAIN_CF, TRAIN[name][1])
    mesh = make_mesh(TRAIN[name][0], ("data", "model"))
    rules = specs.logical_rules(ParallelConfig(**PAR))
    for res in results:
        for key in ("params", "m", "v"):
            got = res["shapes"][key]
            for path, shape in got.items():
                assert shape == want[f"{key}:{path}"], (key, path)
        # the dry run's count: shard_shape of spec_for, leaf by leaf
        for path, p in tpr.leaves(tsteps._model_module(cfg).lm_schema(cfg)):
            assert res["shapes"]["params"][path] == specs.shard_shape(
                p.shape, specs.spec_for(p.shape, p.axes, mesh, rules), mesh)


def test_aux_weight_moves_the_losses(runs):
    """At aux weight 1.0 the aux loss is a visible share of the loss, so
    the (2, 2) match above holds its gradient's factors."""
    small = runs["train", "2x2"][0]["losses"]
    big = runs["train", "2x2_aux1"][0]["losses"]
    assert np.all(big - small > 0.5)


@pytest.mark.parametrize("name", list(MOE))
def test_ep_moe_matches_jax_shard_map(runs, name):
    z, results = runs["moe", name]
    dp, tp = MOE[name]
    cfg = _cfg(treg.get_smoke(ARCH).moe.capacity_factor, 0.01)
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    # no destination segment and no bucket fills on any rank
    T = (B // dp) * (S // tp)
    cap, cap_e = capacities(T, K, E, cfg.moe.capacity_factor, tp)
    E_local = E // tp
    per_rank = z["top_idx"].reshape(B, tp, S // tp, K).transpose(1, 0, 2, 3)
    for m in range(tp):
        dst = np.bincount(per_rank[m].ravel() // E_local, minlength=tp)
        assert dst.max() < cap, (m, dst, cap)
    counts = np.bincount(z["top_idx"].ravel(), minlength=E)
    assert counts.max() < cap_e
    for m, res in enumerate(results):
        np.testing.assert_allclose(res["out"], z["out"], **MOE_TOL)
        np.testing.assert_allclose(res["aux"], z["aux"], **MOE_TOL)
        np.testing.assert_allclose(res["grads"]["x"], z["gx"], **MOE_TOL)
        np.testing.assert_allclose(res["grads"]["router"], z["g:router"],
                                   **MOE_TOL)
        for k in ("moe_wg", "moe_wu", "moe_wo"):
            np.testing.assert_allclose(
                res["grads"][k],
                z[f"g:{k}"][m * E_local:(m + 1) * E_local], err_msg=k,
                **MOE_TOL)


def test_more_ranks_than_cards_raise_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        ranks.run_ranks(ranks.train_ranks, (1, 2))
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        ranks.run_ranks(ranks.train_ranks, (1, 2),
                        devices=["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.run_ranks(ranks.train_ranks, (1, 1))


@pytest.mark.parametrize("par,ocfg,shape,match", [
    (ParallelConfig(sequence_parallel=False), OptimizerConfig(), (1, 2),
     "tensor_parallel"),
    (ParallelConfig(tensor_parallel=False), OptimizerConfig(), (2, 2),
     "sequence_parallel"),
    (ParallelConfig(pure_fsdp=True, **PAR), OptimizerConfig(), (1, 2),
     "pure_fsdp"),
    (ParallelConfig(expert_parallel=False, **PAR), OptimizerConfig(),
     (1, 2), "expert_parallel"),
    (ParallelConfig(**PAR), OptimizerConfig(moment_dtype="int8"), (2, 1),
     "int8"),
    (ParallelConfig(**PAR), OptimizerConfig(second_moment="factored"),
     (1, 2), "factored"),
    # tensor and sequence parallelism: 4 heads on 8 ranks take the
    # reference's "seq" strategy; 32 tokens do not split over 3
    (ParallelConfig(), OptimizerConfig(), (1, 8), "'seq' attention strategy"),
    (ParallelConfig(), OptimizerConfig(), (1, 3), "a sequence of 32"),
])
def test_unported_layouts_and_recipes_raise(par, ocfg, shape, match):
    cfg = _cfg(TRAIN_CF, 0.01)
    with pytest.raises(NotImplementedError, match=match):
        tsteps.check_layout(cfg, par, ocfg, make_mesh(shape,
                                                      ("data", "model")),
                            seq=S)


def test_ported_layouts_pass_and_other_kinds_raise():
    cfg = _cfg(TRAIN_CF, 0.01)
    for shape in ((1, 1), (2, 1), (1, 2), (2, 2)):
        tsteps.check_layout(cfg, ParallelConfig(**PAR), OptimizerConfig(),
                            make_mesh(shape, ("data", "model")))
    # tensor parallelism on a model axis of 1 lays nothing out on it;
    # with sequence parallelism on one larger (the reference's default)
    # it runs (tests/test_torch_ranks_tp.py)
    for shape in ((2, 1), (1, 2), (2, 2), (1, 4)):
        tsteps.check_layout(cfg, ParallelConfig(), OptimizerConfig(),
                            make_mesh(shape, ("data", "model")), seq=S)
    # one rank keeps every recipe
    tsteps.check_layout(cfg, ParallelConfig(**PAR),
                        OptimizerConfig(moment_dtype="int8"),
                        make_mesh((1, 1), ("data", "model")))
    # the recurrent kinds on a model axis of 1 (tests/test_torch_ranks_scan.py
    # trains them under pure FSDP)
    tsteps.check_layout(treg.get_smoke("zamba2-2.7b"), ParallelConfig(**PAR),
                        OptimizerConfig(),
                        make_mesh((2, 1), ("data", "model")))
    for arch in ("llama-3.2-vision-90b", "whisper-small"):
        with pytest.raises(NotImplementedError, match="dense and MoE"):
            tsteps.check_layout(treg.get_smoke(arch), ParallelConfig(**PAR),
                                OptimizerConfig(),
                                make_mesh((2, 1), ("data", "model")))


def test_global_norm_on_the_cpu_is_accurate_at_any_thread_count():
    """The CPU's f32 ``vector_norm`` accumulates in order: on a leaf of
    2**24 elements it lands 6.5e-4 low, and the norm across ranks on the
    CPU missed the card's by 2.3e-4.  ``global_norm`` holds f32 rounding
    against float64 and gives the same bits on 1 and 4 threads."""
    g = torch.randn(1 << 24, generator=torch.Generator().manual_seed(0))
    want = float(torch.linalg.vector_norm(g.double()))
    got = []
    before = torch.get_num_threads()
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            got.append(tadamw.global_norm({"w": g, "b": g[:100] * 0}))
    finally:
        torch.set_num_threads(before)
    assert torch.equal(got[0], got[1])
    assert abs(float(got[0]) - want) <= 1e-7 * want


if __name__ == "__main__":
    _reference(sys.argv[1])
