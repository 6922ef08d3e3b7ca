"""The port's quantized and factored optimizer state against JAX.

``optim.quant`` bit for bit against ``repro.optim.quant`` on
tests/test_substrates.py's shapes and scales; ``opt_state_schema`` equal
in keys, shapes and dtypes under every recipe for phi4 and kimi smoke;
three ``apply_updates`` steps against JAX's ``apply_updates(fused=False)``
(the path every JAX CPU run takes) on a tree that holds every leaf kind
the recipes tell apart: stacked over G = 2 layers (factored or not), a
2-D leaf with and without 128-blocks, a 1-D leaf, and a leaf of 2**16
elements; the blocked walk of ``apply_updates`` against its unblocked
one.  (A model trains under each recipe in tests/test_torch_adamw.py.)

Tolerances.  Quantization is exact (the same f32 steps, ``round`` half to
even on both sides).  The update: every f32 state leaf within 1e-6 of its
largest value of JAX's (the two sides sum the factored means in other
orders), 2e-5 after a clip (JAX's f32 global norm over this tree lies
6.6e-6 from float64, the port's 3.8e-7, and the clip scale carries that
into every moment); bf16 moments also within two bf16 steps of the
leaf's largest value (XLA fuses multiply-adds, so an f32 step apart can
round a bf16 moment one step apart, and later updates carry that step
into values that cancel to near 0);
the int8 ``q`` equal but for +-1 flips of values within f32 rounding of a
.5 boundary, counted and under 1 in 10,000 (21 of 806,368 here); params
within 1e-5 but for at most 1 in 200 (the values whose moments rounded a
bf16 or int8 step apart: 2.2e-3 of them under bf16 moments after a
clip), and every one within lr / 20 (0.019 lr at most here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.models.params import PSpec as JPSpec                 # noqa: E402
from repro.optim import adamw as jopt                           # noqa: E402
from repro.optim import quant as jquant                         # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.optim import adamw as topt                     # noqa: E402
from repro_torch.optim import quant as tquant                   # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402

RECIPES = {"bf16": dict(moment_dtype="bfloat16"),
           "int8": dict(moment_dtype="int8"),
           "factored": dict(second_moment="factored"),
           "int8+factored": dict(moment_dtype="int8",
                                 second_moment="factored")}
SHAPES = [(8,), (4, 128), (3, 5, 256), (2, 7)]
SCALES = [1e-3, 0.37, 1.0, 41.5, 1e3]
FLIP_SHARE = 1e-4
STATE_TOL = {True: 2e-5, False: 1e-6}     # after a clip / without one
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads a team: several test workers share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("shape", SHAPES + [()])
@pytest.mark.parametrize("scale", SCALES)
def test_quantize_and_dequantize_are_jax_bit_for_bit(shape, scale):
    x = np.asarray(np.random.RandomState(0).randn(*shape) * scale,
                   np.float32)
    want = jquant.quantize(jnp.asarray(x))
    got = tquant.quantize(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_bits(got["s"].numpy()), _bits(want["s"]))
    np.testing.assert_array_equal(
        _bits(tquant.dequantize(got).numpy()),
        _bits(jquant.dequantize(want)))


def test_quant_edges_zeros_halves_and_shapes():
    """All zeros take the 1e-12 floor; exact halves round to even as
    ``jnp.round`` does; ``quantized_shapes`` and ``block_size`` agree."""
    for x in (np.zeros((2, 256), np.float32),
              np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5]],
                       np.float32)):
        want = jquant.quantize(jnp.asarray(x))
        got = tquant.quantize(torch.from_numpy(x))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(_bits(got["s"].numpy()),
                                      _bits(want["s"]))
    for shape in SHAPES + [(), (7, 384), (1, 129)]:
        assert tquant.quantized_shapes(shape) == \
            jquant.quantized_shapes(shape)
    assert [tquant.block_size(n) for n in (128, 256, 7, 200)] == \
        [jquant.block_size(n) for n in (128, 256, 7, 200)] == \
        [128, 128, 7, 200]


def _flat_specs(tree, path=""):
    if isinstance(tree, (tpr.PSpec, JPSpec)):
        return {path: (tuple(tree.shape), tuple(tree.axes),
                       tree.dtype or "float32")}
    out = {}
    for k, v in tree.items():
        out.update(_flat_specs(v, f"{path}/{k}" if path else k))
    return out


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("recipe", ["float32", *RECIPES])
def test_opt_state_schema_matches_jax(arch, recipe):
    kw = RECIPES.get(recipe, {})
    cfg_j = jreg.get_smoke(arch).replace(num_layers=2)
    cfg_t = treg.get_smoke(arch).replace(num_layers=2)
    want = jopt.opt_state_schema(jtfm.lm_schema(cfg_j), JOpt(**kw))
    got = topt.opt_state_schema(ttfm.lm_schema(cfg_t), OptimizerConfig(**kw))
    assert _flat_specs(got) == _flat_specs(want)


def test_kimi_recipe_is_its_own_and_refuses_unknown_names():
    assert treg.get_optimizer("kimi-k2-1t-a32b") == OptimizerConfig(
        moment_dtype="int8", second_moment="factored")
    with pytest.raises(ValueError, match="moment_dtype"):
        topt.opt_state_schema({}, OptimizerConfig(moment_dtype="fp8"))
    with pytest.raises(ValueError, match="second_moment"):
        topt.opt_state_schema({}, OptimizerConfig(second_moment="low_rank"))


# ------------------------------------------------------------- the update

# (shape, axes): every leaf kind the recipes tell apart
LEAVES = {
    "stacked": ((2, 4, 64, 256), ("layers", "expert", "fsdp", None)),
    "stacked_small": ((2, 384, 96), ("layers", "fsdp", None)),
    "norms": ((2, 96), ("layers", None)),
    "embed": ((520, 128), ("vocab", "fsdp")),
    "odd": ((300, 220), ("fsdp", None)),
    "big_1d": ((1 << 16,), (None,)),
    "bias": ((96,), (None,)),
}


def _schemas():
    jt = {k: JPSpec(s, a) for k, (s, a) in LEAVES.items()}
    tt = {k: tpr.PSpec(s, a) for k, (s, a) in LEAVES.items()}
    return jt, tt


def _np_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, (s, _a) in LEAVES.items()}


def _okw(kw, clip):
    return dict(lr=LR, weight_decay=0.1, warmup_steps=1, decay_steps=10,
                grad_clip=clip, **kw)


def _grads(i):
    return _np_tree(10 + i, scale=0.3 + i)


def _jax_steps(kw, steps=3, clip=1.0):
    """(params, state, stats) of JAX's unfused path after ``steps``
    updates of ``_np_tree(1)`` by ``_grads(0..)``."""
    jsch, _ = _schemas()
    ocfg = JOpt(**_okw(kw, clip))
    jp = jax.tree.map(jnp.asarray, _np_tree(1))
    state = jax.tree.map(
        lambda p: jnp.zeros(p.shape, jnp.dtype(p.dtype or "float32")),
        jopt.opt_state_schema(jsch, ocfg),
        is_leaf=lambda x: isinstance(x, JPSpec))
    for i in range(steps):
        jp, state, stats = jopt.apply_updates(
            jsch, jp, jax.tree.map(jnp.asarray, _grads(i)), state, ocfg,
            fused=False)
    return jp, state, stats


def _torch_steps(kw, steps=3, clip=1.0):
    """The port's (params, state, stats) of the same updates."""
    _, tsch = _schemas()
    ocfg = OptimizerConfig(**_okw(kw, clip))
    tp = bridge.to_torch(_np_tree(1), device="cpu")
    state = tsteps._zeros(topt.opt_state_schema(tsch, ocfg), "float32", "cpu")
    for i in range(steps):
        tp, state, stats = topt.apply_updates(
            tsch, tp, bridge.to_torch(_grads(i), device="cpu"), state, ocfg)
    return tp, state, stats


def _compare_state(jstate, tstate, tol):
    """Every state leaf against JAX's, to ``tol`` of the leaf's largest
    value (bf16 leaves also two bf16 steps of it) -> (int8 flips,
    int8 values)."""
    flips = total = 0
    for key, got in _leaves_with_paths(tstate):
        want = np.asarray(_get(jstate, key)).astype(np.float32)
        got = got.float().numpy()
        assert got.shape == want.shape, key
        if key.endswith("/q"):
            diff = np.abs(got - want)
            assert diff.max() <= 1, key
            flips += int((diff > 0).sum())
            total += diff.size
            continue
        bound = tol * np.abs(want).max()
        if _get(tstate, key).dtype == torch.bfloat16:
            bound = bound + 2 ** -6 * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all(), \
            (key, float(np.max(np.abs(got - want) / np.abs(want).max())))
    return flips, total


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], f"{path}/{k}" if path else k)
        return out
    return [(path, tree)]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_three_updates_match_jax_unfused(recipe, clip):
    jp, jstate, jstats = _jax_steps(RECIPES[recipe], clip=clip)
    tp, tstate, tstats = _torch_steps(RECIPES[recipe], clip=clip)
    assert int(tstate["count"]) == int(jstate["count"]) == 3
    grads = _grads(2)
    exact = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                        for g in grads.values()))
    np.testing.assert_allclose(float(tstats["grad_norm"]), exact, rtol=1e-6)
    np.testing.assert_allclose(float(jstats["grad_norm"]), exact, rtol=1e-5)
    flips, total = _compare_state({"m": jstate["m"], "v": jstate["v"]},
                                  {"m": tstate["m"], "v": tstate["v"]},
                                  tol=STATE_TOL[bool(clip)])
    assert flips <= FLIP_SHARE * max(total, 1), (flips, total)
    far = total = 0
    for key, got in _leaves_with_paths(tp):
        diff = np.abs(got.numpy() - np.asarray(_get(jp, key)))
        assert diff.max() <= LR / 20, key
        far += int((diff > 1e-5).sum())
        total += diff.size
    assert far <= 5e-3 * total, (far, total)


def test_factored_leaves_are_the_ones_jax_factors():
    _, tstate, _ = _torch_steps(RECIPES["int8+factored"], steps=1)
    kinds = {k: sorted(v) if isinstance(v, dict) else str(v.dtype)
             for k, v in tstate["v"].items()}
    assert kinds == {"stacked": ["vc", "vr"], "stacked_small": ["vc", "vr"],
                     "norms": ["q", "s"], "embed": ["vc", "vr"],
                     "odd": ["vc", "vr"], "big_1d": ["q", "s"],
                     "bias": ["q", "s"]}


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("block", [1 << 15, 200])
def test_blocked_walk_equals_one_block(recipe, block, monkeypatch):
    """Blocks of whole matrices (the stacked leaf's slice is 4 matrices of
    64 x 256: 2 a block at 2**15, 1 at 200; every larger matrix is a block
    of its own) give the update of one block bit for bit: quant blocks run
    along the last axis and the factored means are per matrix."""
    wp, whole, _ = _torch_steps(RECIPES[recipe])
    monkeypatch.setattr(topt, "BLOCK_ELEMS", block)
    bp, blocked, _ = _torch_steps(RECIPES[recipe])
    for (key, a), (_, b) in zip(_leaves_with_paths(
            {"p": wp, "m": whole["m"], "v": whole["v"]}),
            _leaves_with_paths({"p": bp, "m": blocked["m"],
                                "v": blocked["v"]})):
        assert torch.equal(a, b), key
