"""The port's codeqwen1.5-7b and deepseek-7b configs against the JAX package.

Both are dense ``attn`` models: codeqwen with a qkv bias, both with an
untied ``lm_head``, which no other ported config has.  Smoke size, f32,
two layers, params made by the JAX ``init_params`` and carried over by
``repro_torch.bridge``; the port on the CPU (its plain paths), the JAX
side as its own tests run it.

Tolerances, all f32:
  * the loss, 1e-5 relative; the train-mode hidden states and the prefill
    logits, 1e-5 relative by the norm of the difference over the norm of
    the JAX value (single elements of the hidden states move by up to
    2e-5 of the largest: the frameworks sum the same products in other
    orders);
  * every grad leaf, 2e-4 relative by norm.  Over init seeds 0-7 the
    farthest leaf of each config and seed lies 1.5e-5 to 7.3e-5 from
    JAX's (the worst: deepseek-7b, a config with no bias, seed 1,
    ``embed``).  That is f32 rounding, not a wrong gradient: against the
    same grads in f64 (the port's plain path at float64) JAX's own f32
    leaves lie up to 5.5e-5 away and the port's up to 6.0e-5.  The tests
    run seeds 0 and 1; ``python tests/test_torch_configs.py`` prints the
    readings for seeds 0-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import ShapeConfig                      # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe            # noqa: E402
from repro.launch.mesh import single_device_mesh                # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.models.layers import ModelCtx                        # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402

ARCHS = ["codeqwen1.5-7b", "deepseek-7b"]
F32 = dict(param_dtype="float32", compute_dtype="float32", num_layers=2)
RTOL = 1e-5
GRAD_RTOL = 2e-4


def _cfgs(arch):
    return (jreg.get_smoke(arch).replace(**F32),
            treg.get_smoke(arch).replace(**F32))


def _rel(want, got, path):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert want.shape == got.shape, path
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= RTOL, (path, err)


def _walk(want, got, path=""):
    """Leaf-wise: ||got - want|| <= GRAD_RTOL * ||want||."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _walk(want[k], got[k], f"{path}/{k}")
        return
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= GRAD_RTOL, (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    assert arch in treg.ARCHS
    assert dataclasses.asdict(treg.get_config(arch)) == dataclasses.asdict(
        jreg.get_config(arch))
    assert dataclasses.asdict(treg.get_smoke(arch)) == dataclasses.asdict(
        jreg.get_smoke(arch))
    assert treg.get_parallel(arch) == dataclasses.replace(
        treg.get_parallel(arch), **dataclasses.asdict(
            jreg.get_parallel(arch)))
    assert dataclasses.asdict(treg.get_optimizer(arch)) == \
        dataclasses.asdict(jreg.get_optimizer(arch))
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    assert tpr.param_count(ttfm.lm_schema(tcfg)) == jpr.param_count(
        jtfm.lm_schema(jcfg))
    assert not tcfg.tie_embeddings
    assert "lm_head" in ttfm.lm_schema(tcfg)


def test_registry_optimizer_defaults_like_jax():
    """Every arch takes the default recipe but kimi-k2, whose own is int8
    + factored moments, as in the JAX registry."""
    for arch in treg.ARCHS:
        want = OptimizerConfig(moment_dtype="int8", second_moment="factored") \
            if arch == "kimi-k2-1t-a32b" else OptimizerConfig()
        assert treg.get_optimizer(arch) == want, arch
        assert dataclasses.asdict(treg.get_optimizer(arch)) == \
            dataclasses.asdict(jreg.get_optimizer(arch)), arch


def _train_both(arch, seed):
    """Both stacks' train-mode forward and grads from init seed ``seed``
    (with the qkv biases drawn where the config has them)."""
    jcfg, tcfg = _cfgs(arch)
    par_j, par_t = jreg.get_parallel(arch), treg.get_parallel(arch)
    p = jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(seed),
                        "float32")
    if jcfg.attn.qkv_bias:       # the init's biases are zero: make them bite
        rng = np.random.RandomState(7)
        for blk in p["blocks"].values():
            for name in ("bq", "bk", "bv"):
                blk[name] = jnp.asarray(
                    0.1 * rng.standard_normal(blk[name].shape), jnp.float32)
    batch = JPipe(jcfg.vocab_size, 32, 2, seed=3)._host_batch(0)
    ctx = ModelCtx(jcfg, par_j, None)
    jx, _, _ = jtfm.forward(ctx, p, jnp.asarray(batch["tokens"]),
                            mode="train")
    jl, jg = jax.value_and_grad(lambda q: jtfm.loss_fn(
        ctx, q, {k: jnp.asarray(v) for k, v in batch.items()}))(p)
    tp = bridge.to_torch(jax.tree.map(np.asarray, p), device="cpu")
    tx, _ = ttfm.forward(tcfg, tp, torch.as_tensor(batch["tokens"]),
                         mode="train", par=tsteps.train_par(par_t))
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tg = tsteps._value_and_grad(tcfg, tsteps.train_par(par_t), tp,
                                    tbatch)
    return dict(jcfg=jcfg, tcfg=tcfg, par=tsteps.train_par(par_t), p=p,
                batch=tbatch, jx=jx, tx=tx, jl=jl, tl=tl, jg=jg, tg=tg)


def _check_train(arch, seed):
    """Train-mode hidden states, the loss and every grad leaf (the qkv
    bias and the untied head included) from init seed ``seed``."""
    r = _train_both(arch, seed)
    jcfg, jl, tl, jg, tg = r["jcfg"], r["jl"], r["tl"], r["jg"], r["tg"]
    _rel(r["jx"], r["tx"], "hidden")
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert "lm_head" in tg
    if jcfg.attn.qkv_bias:
        assert "bq" in next(iter(tg["blocks"].values()))
    _walk(jg, tg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_loss_and_grads_match_jax(arch):
    _check_train(arch, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_jax_from_a_second_seed(arch):
    """Seed 1: the seed whose deepseek-7b leaves differ most (7.3e-5)."""
    _check_train(arch, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    S = 24
    jp = jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(1), "float32")
    toks = np.random.RandomState(2).randint(1, jcfg.vocab_size, (1, S))
    fn = jsteps.build_prefill(jcfg, jreg.get_parallel(arch),
                              single_device_mesh(),
                              ShapeConfig("serve", S, 1, "prefill")).fn
    j_last, _ = jax.jit(fn)(jp, jnp.asarray(toks, jnp.int32))
    t_last, _ = tsteps.prefill_step(
        tcfg, bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"),
        torch.as_tensor(toks))
    _rel(j_last, t_last, "logits")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _norm_rel(got, want):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float64)
    want = np.asarray(want.detach() if hasattr(want, "detach") else want,
                      np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def grad_readings(seeds=range(8)):
    """Per config and init seed, the grad leaf farthest apart between the
    stacks (norm-relative), and each stack's farthest leaf from the same
    grads in f64 (the port's plain path at float64)."""
    for arch in ARCHS:
        for seed in seeds:
            r = _train_both(arch, seed)
            cfg64 = r["tcfg"].replace(param_dtype="float64",
                                      compute_dtype="float64")
            p64 = jax.tree.map(lambda a: torch.as_tensor(
                np.asarray(a, np.float64)), r["p"])
            _, g64 = tsteps._value_and_grad(cfg64, r["par"], p64,
                                            r["batch"])
            g64 = dict(_leaves(g64))
            tg = dict(_leaves(r["tg"]))
            rows = [(path, _norm_rel(tg[path], jv), _norm_rel(jv, g64[path]),
                     _norm_rel(tg[path], g64[path]))
                    for path, jv in _leaves(r["jg"])]
            worst = max(rows, key=lambda row: row[1])
            print(f"{arch} seed {seed}: port vs JAX {worst[1]:.2e} "
                  f"({worst[0]}); JAX vs f64 {max(x[2] for x in rows):.2e}; "
                  f"port vs f64 {max(x[3] for x in rows):.2e}")


if __name__ == "__main__":
    torch.set_num_threads(2)
    grad_readings()
