"""The port's AdamW (kernel wrapper, schedule, tree update) against JAX.

On the CPU the port's ``adamw_update`` runs its plain version (the oracle)
and writes into p, m and v in place; the JAX kernel runs in interpret
mode, as tests/test_kernels.py runs it, over the same dtype, weight-decay
and tail cases.  The tree update ``apply_updates`` is held against the JAX
``apply_updates(fused=False)``, the path every JAX CPU run takes, on a
phi4 smoke tree with two stacked layers, which pins the weight-decay rule
on stacked norms (ROADMAP queue C).  Inputs come from numpy seeds.

Tolerances: tests/test_kernels.py's (1e-6 relative, 1e-7 absolute on the
moments; 1e-6 on params), since the two sides round the same f32 steps
apart from XLA's fused multiply-adds.  The global norm gets 5e-6
relative: JAX's f32 sum of squares over a smoke tree lands about 1e-6 from
the float64 value, the port's within 1e-7, and a clipped step carries
that difference into the moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.kernels.adamw_update import adamw_update as jadamw    # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.optim import adamw as jopt                           # noqa: E402
from repro.optim.schedule import learning_rate as jlr           # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.kernels import adamw_update as tk              # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.optim import adamw as topt                     # noqa: E402
from repro_torch.optim.schedule import learning_rate as tlr     # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402

ARCH = "phi4-mini-3.8b"
MOM = dict(rtol=1e-6, atol=1e-7)
PAR = dict(rtol=1e-6, atol=1e-6)
NORM = dict(rtol=5e-6, atol=0)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _leaf(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (0.1 * rng.standard_normal(shape)).astype(np.float32),
            np.abs(rng.standard_normal(shape)).astype(np.float32))


def _f32(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x)
                      else np.asarray(x, np.float32))


@pytest.mark.parametrize("shape", [(256, 128), (3, 100, 37), (5,)])
@pytest.mark.parametrize("pdtype,gdtype", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_update_matches_jax_kernel(shape, pdtype, gdtype, weight_decay):
    p, g, m, v = _leaf(shape, seed=len(shape) + int(weight_decay * 10))
    (jp, tp), (jg, tg) = DT[pdtype], DT[gdtype]
    lr, bc1, bc2 = 3e-4, 0.271, 0.0297
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=weight_decay)
    want = jadamw(jnp.asarray(p, jp), jnp.asarray(g, jg), jnp.asarray(m),
                  jnp.asarray(v), jnp.float32(lr), jnp.float32(bc1),
                  jnp.float32(bc2), block_rows=64, interpret=True, **hp)
    tpp, tm, tv = (torch.as_tensor(p).to(tp), torch.as_tensor(m),
                   torch.as_tensor(v))
    out = tk.adamw_update(tpp, torch.as_tensor(g).to(tg), tm, tv,
                          torch.tensor([lr, bc1, bc2]), **hp)
    assert out[0] is tpp and out[1] is tm and out[2] is tv   # in place
    assert tpp.dtype == tp and tm.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(want[1]), **MOM)
    np.testing.assert_allclose(tv.numpy(), np.asarray(want[2]), **MOM)
    np.testing.assert_allclose(_f32(tpp), _f32(want[0]), **PAR)


def test_bf16_params_update_in_f32():
    """A tiny lr*update that a pure-bf16 subtract would lose must match the
    f32-accumulated oracle exactly."""
    p = torch.full((128,), 1.0, dtype=torch.bfloat16)
    g = torch.full((128,), 1e-3)
    m, v = torch.zeros(128), torch.zeros(128)
    hp = dict(b1=0.9, b2=0.95, eps=1e-8)
    want = jadamw(jnp.full((128,), 1.0, jnp.bfloat16),
                  jnp.full((128,), 1e-3, jnp.float32),
                  jnp.zeros((128,), jnp.float32),
                  jnp.zeros((128,), jnp.float32), jnp.float32(1e-5),
                  jnp.float32(0.1), jnp.float32(0.05), block_rows=8,
                  interpret=True, **hp)
    tk.adamw_update(p, g, m, v, torch.tensor([1e-5, 0.1, 0.05]), **hp)
    np.testing.assert_array_equal(_f32(p), _f32(want[0]))


def test_wrapper_rejects_bad_inputs():
    z = torch.zeros(4)
    sc = torch.tensor([1e-3, 0.1, 0.05])
    with pytest.raises(TypeError, match="moments"):
        tk.adamw_update(z.clone(), z, z.to(torch.bfloat16), z.clone(), sc,
                        b1=0.9, b2=0.95, eps=1e-8)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(4, 2).t()
        tk.adamw_update(t, t, torch.zeros(2, 4), torch.zeros(2, 4), sc,
                        b1=0.9, b2=0.95, eps=1e-8)
    # meta takes the plain version (shapes only); any device but cpu,
    # cuda and meta raises: a fake xpu tensor stands in for one
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), pytest.raises(ValueError, match="cuda or cpu"):
        xz = torch.zeros(4, device="xpu")
        tk.adamw_update(xz, xz, xz, xz, torch.zeros(3, device="xpu"),
                        b1=0.9, b2=0.95, eps=1e-8)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=3, decay_steps=20, schedule=schedule)
    for step in [0, 1, 2, 3, 4, 10, 19, 20, 25]:
        want = jlr(JOpt(**kw), jnp.int32(step))
        got = tlr(OptimizerConfig(**kw), torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)


def _tree(cfg_j, seed):
    """(params, grads) numpy trees of the JAX schema, random normal."""
    rng = np.random.RandomState(seed)
    schema = jtfm.lm_schema(cfg_j)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return rng.standard_normal(node.shape).astype(np.float32)
    return rec(schema), rec(schema)


def _run_jax(cfg_j, params, grads, steps, ocfg, fused):
    schema = jtfm.lm_schema(cfg_j)
    jp = jax.tree.map(jnp.asarray, params)
    zeros = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), params)
    state = {"m": zeros, "v": zeros, "count": jnp.zeros((), jnp.int32)}
    for _ in range(steps):
        jp, state, stats = jopt.apply_updates(
            schema, jp, jax.tree.map(jnp.asarray, grads), state, ocfg,
            fused=fused)
    return jp, state, stats


def _cfgs():
    return (jreg.get_smoke(ARCH).replace(num_layers=2),
            treg.get_smoke(ARCH).replace(num_layers=2))


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_apply_updates_matches_jax_unfused(grad_clip):
    """Two steps on a phi4 smoke tree with G = 2 stacked layers: params,
    moments, count, grad_norm and lr against the JAX unfused path."""
    cfg_j, cfg_t = _cfgs()
    kw = dict(lr=1.0, weight_decay=0.1, warmup_steps=1, decay_steps=10,
              grad_clip=grad_clip)
    params, grads = _tree(cfg_j, seed=4)
    jp, jstate, jstats = _run_jax(cfg_j, params, grads, 2, JOpt(**kw), False)
    tp = bridge.to_torch(params, device="cpu")
    tstate = {"m": bridge.to_torch(jax.tree.map(np.zeros_like, params),
                                   device="cpu"),
              "v": bridge.to_torch(jax.tree.map(np.zeros_like, params),
                                   device="cpu"),
              "count": torch.zeros((), dtype=torch.int32)}
    schema = ttfm.lm_schema(cfg_t)
    for _ in range(2):
        tg = bridge.to_torch(grads, device="cpu")
        tp, tstate, tstats = topt.apply_updates(schema, tp, tg, tstate,
                                                OptimizerConfig(**kw))
    assert int(tstate["count"]) == int(jstate["count"]) == 2
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), **NORM)
    mom = NORM if grad_clip else MOM
    np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                               rtol=1e-6)
    for (path, _), got_p, got_m, got_v in zip(
            tpr.leaves(schema), _leaves(tp), _leaves(tstate["m"]),
            _leaves(tstate["v"])):
        want_p, want_m, want_v = (_get(t, path) for t in
                                  (jp, jstate["m"], jstate["v"]))
        np.testing.assert_allclose(got_m.numpy(), want_m, **mom, err_msg=path)
        np.testing.assert_allclose(got_v.numpy(), want_v, **mom, err_msg=path)
        np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-5,
                                   atol=1e-5, err_msg=path)


def test_jax_fused_path_decays_stacked_norms_and_the_port_does_not():
    """ROADMAP queue C: with G = 2 the JAX fused path weight-decays the
    stacked (G, D) norm scales and its unfused path does not.  The port
    takes the unfused rule; the two JAX paths differ on ln1/ln2 only."""
    cfg_j, cfg_t = _cfgs()
    ocfg = JOpt(lr=1.0, weight_decay=0.1, warmup_steps=1, decay_steps=10)
    params, grads = _tree(cfg_j, seed=5)
    params = jax.tree.map(lambda x: np.full_like(x, 0.5), params)
    unfused, _, _ = _run_jax(cfg_j, params, grads, 1, ocfg, False)
    fused, _, _ = _run_jax(cfg_j, params, grads, 1, ocfg, True)
    gaps = {path: float(np.max(np.abs(_get(fused, path) - _get(unfused, path))))
            for path, _ in tpr.leaves(ttfm.lm_schema(cfg_t))}
    differ = sorted(p for p, gap in gaps.items() if gap > 1e-5)
    assert differ == ["blocks/0_attn/ln1", "blocks/0_attn/ln2"], gaps
    # lr 1 * wd 0.1 * p 0.5 = 0.05 apart
    np.testing.assert_allclose(gaps["blocks/0_attn/ln1"], 0.05, rtol=1e-3)
    rule = {p: topt.decays(s) for p, s in tpr.leaves(ttfm.lm_schema(cfg_t))}
    assert not rule["blocks/0_attn/ln1"] and not rule["final_norm"]
    assert rule["blocks/0_attn/wq"] and rule["embed"]


def test_global_norm_and_clip_match_jax():
    cfg_j, _ = _cfgs()
    _, grads = _tree(cfg_j, seed=6)
    want, want_norm = jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), 1.0)
    flat = dict(topt._flat(bridge.to_torch(grads, device="cpu")))
    got, got_norm = topt.clip_by_global_norm(flat, 1.0)
    np.testing.assert_allclose(float(got_norm), float(want_norm), **NORM)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), _get(want, path), **NORM)


RECIPES = {"bf16": dict(moment_dtype="bfloat16"),
           "int8": dict(moment_dtype="int8"),
           "factored": dict(second_moment="factored"),
           "int8+factored": dict(moment_dtype="int8",
                                 second_moment="factored")}


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], f"{path}/{k}" if path else k)
        return out
    return [(path, tree)]


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_quantized_and_factored_moments_train(recipe):
    """A phi4 smoke model (vocab 2048: a factored embedding) trains under
    each recipe through ``runtime.steps``: the loss falls and the state
    keeps its schema's dtypes."""
    cfg = treg.get_smoke("phi4-mini-3.8b").replace(
        num_layers=2, vocab_size=2048, param_dtype="float32",
        compute_dtype="float32")
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=1, decay_steps=20,
                           **RECIPES[recipe])
    schema = ttfm.lm_schema(cfg)
    params = tpr.init_params(schema, torch.Generator().manual_seed(0),
                             "float32", "cpu")
    opt = tsteps.init_opt_state(cfg, ocfg, "cpu")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (4, 17)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    par = treg.get_parallel("phi4-mini-3.8b")
    losses = []
    for _ in range(6):
        params, opt, m = tsteps.train_step(cfg, par, ocfg, params, opt,
                                           batch, device="cpu")
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.2, losses
    want = {k: str(p.dtype or 'float32') for k, p in
            _leaves_with_paths(topt.opt_state_schema(schema, ocfg))}
    for key, t in _leaves_with_paths(opt):
        assert str(t.dtype).removeprefix("torch.") == want[key], key


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _leaves(tree):
    """Leaves in sorted-path order (``params.leaves`` order)."""
    flat = topt._flat(tree)
    return [flat[k] for k in sorted(flat)]


def test_global_norm_reads_inf_past_f32_range_like_jax():
    """The norm sums unscaled f32 squares, as the reference does: grads
    whose squares pass f32's range read inf on both sides."""
    big = {"a": np.array([3e20, -4e20], np.float32),
           "b": np.ones((3,), np.float32)}
    assert np.isinf(float(jopt.global_norm(jax.tree.map(jnp.asarray, big))))
    assert np.isinf(float(topt.global_norm(bridge.to_torch(big,
                                                           device="cpu"))))
