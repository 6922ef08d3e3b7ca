"""Parity of the port's gemma2-9b with the JAX package.

gemma2 smoke config (local + global layers, logit softcaps 50 and 30,
post-norms, the sqrt(d_model) embed scale, head dim 16), params made by
the JAX ``init_params`` and carried over by ``repro_torch.bridge``.  The
window is shrunk from 4096 to 8 so that at S = 24 the local layers really
mask; the port runs on the CPU (its plain paths), the JAX side as its own
tests run it.  Tolerances are tests/test_torch_model.py's: f32 1e-4 on
logits and caches with equal greedy tokens (the frameworks sum the same
f32 products in different orders), bf16 5e-2 on logits (8 mantissa bits,
rounded at other places); grads 2e-4 of each leaf's norm, as
tests/test_torch_configs.py holds codeqwen's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import ShapeConfig                      # noqa: E402
from repro.core.queue import WorkQueue as JQueue                # noqa: E402
from repro.launch.mesh import single_device_mesh                # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.models.layers import ModelCtx                        # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402
from repro.serving.engine import ServingEngine as JEngine        # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.core.queue import WorkQueue as TQueue          # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

ARCH = "gemma2-9b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 8
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Smoke-size tensors gain nothing from an OpenMP team of every core,
    and the suite runs several workers on one machine, where such teams
    spin against each other and against the timing-bound tests in other
    workers.  Two threads a team, as the threaded test files pin it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    j, t = jreg.get_smoke(ARCH), treg.get_smoke(ARCH)
    return (j.replace(attn=dataclasses.replace(j.attn, window=WINDOW), **kw),
            t.replace(attn=dataclasses.replace(t.attn, window=WINDOW), **kw))


def _jax_params(jcfg, seed=0):
    return jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(seed),
                           jcfg.param_dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_cpu(tree):
    return bridge.to_torch(tree, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size, (B, S))


def _filled_cache(jcfg, B, S, seed=2):
    rng = np.random.RandomState(seed)
    return jpr.tree_map_schema(
        lambda _p, p: rng.standard_normal(p.shape).astype(np.float32),
        jtfm.cache_schema(jcfg, B, S))


def test_config_copy_matches_reference():
    assert ARCH in treg.ARCHS
    assert dataclasses.asdict(treg.get_config(ARCH)) == dataclasses.asdict(
        jreg.get_config(ARCH))
    assert dataclasses.asdict(treg.get_smoke(ARCH)) == dataclasses.asdict(
        jreg.get_smoke(ARCH))
    assert dataclasses.asdict(treg.get_parallel(ARCH)) == \
        dataclasses.asdict(jreg.get_parallel(ARCH))
    jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    n = tpr.param_count(ttfm.lm_schema(tcfg))
    assert n == jpr.param_count(jtfm.lm_schema(jcfg))
    assert 9.2e9 < n < 9.3e9                       # 9.24 B, 18.5 GB in bf16
    want = dict(jpr._leaves(jtfm.cache_schema(jcfg, 2, 64)))
    got = dict(tpr.leaves(ttfm.cache_schema(tcfg, 2, 64)))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    jcfg, _ = _cfgs(param_dtype=dtype, compute_dtype=dtype)
    jp = _np(_jax_params(jcfg))
    back = bridge.to_numpy(_to_cpu(jp), like=jp)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                 jax.tree_util.tree_leaves_with_path(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    assert "ln1_post" in jp["blocks"]["0_local"]


def _jax_prefill(jcfg, S):
    fn = jsteps.build_prefill(jcfg, jreg.get_parallel(ARCH),
                              single_device_mesh(),
                              ShapeConfig("serve", S, 1, "prefill")).fn
    return jax.jit(fn)


def test_prefill_logits_and_caches_match_f32_with_the_window_masking():
    jcfg, tcfg = _cfgs(**F32)
    S = 24                                 # three windows of 8
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg, 1, S)
    j_last, j_caches = _jax_prefill(jcfg, S)(jp, jnp.asarray(toks, jnp.int32))
    t_last, t_caches = tsteps.prefill_step(tcfg, _to_cpu(_np(jp)),
                                           torch.as_tensor(toks))
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    assert np.abs(np.asarray(j_last)).max() <= 30.0     # the final softcap
    for key in ("0_local", "1_global"):
        for kind in ("k", "v"):
            np.testing.assert_allclose(t_caches[key][kind].numpy(),
                                       np.asarray(j_caches[key][kind]), **TOL)
    # the window is live: 4096 (the config's) gives other logits
    wide = tcfg.replace(attn=dataclasses.replace(tcfg.attn, window=4096))
    other, _ = tsteps.prefill_step(wide, _to_cpu(_np(jp)),
                                   torch.as_tensor(toks))
    assert (other - t_last).abs().max().item() > 1e-3


def test_prefill_logits_match_bf16():
    jcfg, tcfg = _cfgs()
    S = 24
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg, 1, S, seed=1)
    j_last, _ = _jax_prefill(jcfg, S)(jp, jnp.asarray(toks, jnp.int32))
    t_last, _ = tsteps.prefill_step(tcfg, _to_cpu(_np(jp)),
                                    torch.as_tensor(toks))
    assert t_last.dtype == torch.bfloat16
    np.testing.assert_allclose(t_last.float().numpy(),
                               np.asarray(j_last, np.float32), atol=5e-2,
                               rtol=0)


def test_slot_decode_step_matches_f32():
    """Positions past the window (15, 21) mask the cache's head."""
    jcfg, tcfg = _cfgs(**F32)
    B, S = 3, 24
    jp = _jax_params(jcfg)
    cache = _filled_cache(jcfg, B, S)
    tok = _tokens(jcfg, B, 1, seed=3)
    pos = np.array([5, 15, 21])
    bundle = jsteps.build_slot_decode(jcfg, jreg.get_parallel(ARCH),
                                      single_device_mesh(),
                                      ShapeConfig("serve", S, B, "decode"))
    j_next, j_cache = jax.jit(bundle.fn)(
        jp, jax.tree.map(jnp.asarray, cache), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    t_next, t_cache = tsteps.slot_decode_step(
        tcfg, _to_cpu(_np(jp)), _to_cpu(cache), torch.as_tensor(tok),
        torch.as_tensor(pos))
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
    for key in ("0_local", "1_global"):
        for kind in ("k", "v"):
            np.testing.assert_allclose(t_cache[key][kind].numpy(),
                                       np.asarray(j_cache[key][kind]), **TOL)


def test_paged_decode_step_matches_f32():
    jcfg, tcfg = _cfgs(**F32)
    B, S, bs = 2, 24, 4
    nb = S // bs
    num_blocks = 1 + B * nb
    jp = _jax_params(jcfg)
    pool = _filled_cache(jcfg, num_blocks, bs, seed=4)
    tables = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 0, 0]])
    tok = _tokens(jcfg, B, 1, seed=5)
    pos = np.array([22, 13])
    bundle = jsteps.build_paged_decode(
        jcfg, jreg.get_parallel(ARCH), single_device_mesh(),
        ShapeConfig("serve", S, B, "decode"), block_size=bs,
        num_blocks=num_blocks)
    j_next, j_pool = jax.jit(bundle.fn)(
        jp, jax.tree.map(jnp.asarray, pool), jnp.asarray(tables, jnp.int32),
        jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32))
    t_next, t_pool = tsteps.paged_decode_step(
        tcfg, _to_cpu(_np(jp)), _to_cpu(pool), torch.as_tensor(tables),
        torch.as_tensor(tok), torch.as_tensor(pos))
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
    for key in ("0_local", "1_global"):
        for kind in ("k", "v"):
            np.testing.assert_allclose(t_pool[key][kind].numpy(),
                                       np.asarray(j_pool[key][kind]), **TOL)


def _walk(want, got, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _walk(want[k], got[k], f"{path}/{k}")
        return
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= GRAD_RTOL, (path, err)


def test_loss_and_grads_match_jax_f32():
    """The train path (plain ``train_attention`` with the window and the
    softcap, the xent with the final softcap) against JAX ``loss_fn``."""
    jcfg, tcfg = _cfgs(num_layers=4, **F32)
    par_j, par_t = jreg.get_parallel(ARCH), treg.get_parallel(ARCH)
    jp = _jax_params(jcfg, seed=1)
    rng = np.random.RandomState(6)
    batch = {"tokens": rng.randint(1, jcfg.vocab_size, (2, 24)),
             "labels": rng.randint(1, jcfg.vocab_size, (2, 24))}
    ctx = ModelCtx(jcfg, par_j, None)
    jl, jg = jax.value_and_grad(lambda q: jtfm.loss_fn(
        ctx, q, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}))(jp)
    tl, tg = tsteps._value_and_grad(
        tcfg, tsteps.train_par(par_t), _to_cpu(_np(jp)),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(tl.item() - float(jl)) <= 1e-4 * abs(float(jl))
    _walk(_np(jg), tg)


def test_engine_tokens_equal_jax_engine():
    """Paged and slotted CPU engines against the JAX engine: prompts of 16
    with 8 new tokens pass the window of 8."""
    jcfg, tcfg = _cfgs(**F32)
    jp = _jax_params(jcfg)
    tp = _to_cpu(_np(jp))
    rng = np.random.RandomState(7)
    reqs = [{"id": i, "prompt": rng.randint(1, jcfg.vocab_size, 16).tolist(),
             "max_new_tokens": g} for i, g in enumerate([8, 3, 6])]
    kw = dict(num_slots=2, prompt_len=16, max_new_tokens=8, block_size=4)
    want, _ = JEngine(jcfg, jreg.get_parallel(ARCH), single_device_mesh(),
                      params=jp, **kw).run(JQueue([dict(r) for r in reqs]))
    for paged in (True, False):
        eng = TEngine(tcfg, device="cpu", params=tp, paged=paged, **kw)
        assert eng.paged == paged
        got, _ = eng.run(TQueue([dict(r) for r in reqs]))
        assert got == want, paged
