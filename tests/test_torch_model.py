"""Parity of the port's phi4 model and serving steps with the JAX package.

phi4-mini smoke config, params made by the JAX ``init_params`` and carried
over by ``repro_torch.bridge``; the port runs on the CPU (its plain
paths), the JAX side as its own tests run it.  Tolerances:

  * f32: 1e-4 absolute/relative on logits and caches — the two frameworks
    sum the same f32 products in different orders (matmul blocking,
    online vs. one-pass softmax), which moves the last few bits;
  * bf16: 5e-2 absolute on logits of unit scale — bf16 keeps 8 bits of
    mantissa and the frameworks round intermediates at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import ShapeConfig                      # noqa: E402
from repro.launch.mesh import single_device_mesh                # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    return jreg.get_smoke(ARCH).replace(**kw), treg.get_smoke(ARCH).replace(**kw)


def _jax_params(jcfg, seed=0):
    return jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(seed),
                           jcfg.param_dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_cpu(tree):
    return bridge.to_torch(tree, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size, (B, S))


def test_config_copy_matches_reference():
    assert dataclasses.asdict(treg.get_config(ARCH)) == dataclasses.asdict(
        jreg.get_config(ARCH))
    assert dataclasses.asdict(treg.get_smoke(ARCH)) == dataclasses.asdict(
        jreg.get_smoke(ARCH))
    jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    assert tpr.param_count(ttfm.lm_schema(tcfg)) == jpr.param_count(
        jtfm.lm_schema(jcfg))
    assert tpr.param_bytes(ttfm.lm_schema(tcfg), "bfloat16") == \
        jpr.param_bytes(jtfm.lm_schema(jcfg), "bfloat16")


def test_schema_paths_and_shapes_match():
    jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    for jschema, tschema in [
            (jtfm.lm_schema(jcfg), ttfm.lm_schema(tcfg)),
            (jtfm.cache_schema(jcfg, 4, 576), ttfm.cache_schema(tcfg, 4, 576))]:
        want = dict(jpr._leaves(jschema))
        got = dict(tpr.leaves(tschema))
        assert sorted(got) == sorted(want)
        for path, p in got.items():
            assert (p.shape, p.axes, p.init, p.scale) == (
                want[path].shape, want[path].axes, want[path].init,
                want[path].scale), path


def test_init_params_follows_reference_rules():
    tcfg = treg.get_smoke(ARCH)
    gen = torch.Generator().manual_seed(0)
    params = tpr.init_params(ttfm.lm_schema(tcfg), gen, "float32", "cpu")
    blk = params["blocks"]["0_attn"]
    assert torch.all(blk["ln1"] == 0) and torch.all(params["final_norm"] == 0)
    D = tcfg.d_model
    # normal leaves: std = 1/sqrt(fan_in), fan_in = shape[-2]
    assert abs(blk["wg"].std().item() - D ** -0.5) < 0.2 * D ** -0.5
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    again = tpr.init_params(ttfm.lm_schema(tcfg),
                            torch.Generator().manual_seed(0), "float32", "cpu")
    assert torch.equal(again["embed"], params["embed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    jcfg, _ = _cfgs(param_dtype=dtype, compute_dtype=dtype)
    jp = _np(_jax_params(jcfg))
    tp = _to_cpu(jp)
    assert tp["blocks"]["0_attn"]["wq"].shape == jp["blocks"]["0_attn"]["wq"].shape
    assert tp["embed"].dtype == getattr(torch, dtype)
    back = bridge.to_numpy(tp, like=jp)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jp),
            jax.tree_util.tree_leaves_with_path(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def _jax_prefill(jcfg, S):
    par = jreg.get_parallel(ARCH)
    mesh = single_device_mesh()
    fn = jsteps.build_prefill(jcfg, par, mesh,
                              ShapeConfig("serve", S, 1, "prefill")).fn
    return jax.jit(fn)


def test_prefill_logits_and_caches_match_f32():
    jcfg, tcfg = _cfgs(**F32)
    S = 24                      # not a multiple of the kernel's 64-row tile
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg, 1, S)
    j_last, j_caches = _jax_prefill(jcfg, S)(jp, jnp.asarray(toks, jnp.int32))
    t_last, t_caches = tsteps.prefill_step(tcfg, _to_cpu(_np(jp)),
                                           torch.as_tensor(toks))
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    for kind in ("k", "v"):
        np.testing.assert_allclose(t_caches["0_attn"][kind].numpy(),
                                   np.asarray(j_caches["0_attn"][kind]), **TOL)


def test_prefill_logits_match_bf16():
    jcfg, tcfg = _cfgs()        # the smoke config keeps bf16
    S = 16
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg, 1, S, seed=1)
    j_last, _ = _jax_prefill(jcfg, S)(jp, jnp.asarray(toks, jnp.int32))
    t_last, _ = tsteps.prefill_step(tcfg, _to_cpu(_np(jp)),
                                    torch.as_tensor(toks))
    assert t_last.dtype == torch.bfloat16
    np.testing.assert_allclose(t_last.float().numpy(),
                               np.asarray(j_last, np.float32), atol=5e-2,
                               rtol=0)


def _filled_cache(jcfg, B, S, seed=2):
    """A random (not all-zero) slotted cache, so decode attends to history."""
    rng = np.random.RandomState(seed)
    schema = jtfm.cache_schema(jcfg, B, S)
    return jpr.tree_map_schema(
        lambda _p, p: rng.standard_normal(p.shape).astype(np.float32), schema)


def test_slot_decode_step_matches_f32():
    jcfg, tcfg = _cfgs(**F32)
    B, S = 3, 16
    jp = _jax_params(jcfg)
    cache = _filled_cache(jcfg, B, S)
    tok = _tokens(jcfg, B, 1, seed=3)
    pos = np.array([5, 15, 16])             # 16 >= S: that slot writes nothing
    bundle = jsteps.build_slot_decode(jcfg, jreg.get_parallel(ARCH),
                                      single_device_mesh(),
                                      ShapeConfig("serve", S, B, "decode"))
    j_next, j_cache = jax.jit(bundle.fn)(
        jp, jax.tree.map(jnp.asarray, cache), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    t_cache = _to_cpu(cache)
    t_next, t_cache = tsteps.slot_decode_step(
        tcfg, _to_cpu(_np(jp)), t_cache, torch.as_tensor(tok),
        torch.as_tensor(pos))
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
    for kind in ("k", "v"):
        np.testing.assert_allclose(t_cache["0_attn"][kind].numpy(),
                                   np.asarray(j_cache["0_attn"][kind]), **TOL)


def test_paged_decode_step_matches_f32():
    jcfg, tcfg = _cfgs(**F32)
    B, S, bs = 2, 16, 4
    nb = S // bs
    num_blocks = 1 + B * nb
    jp = _jax_params(jcfg)
    pool = _filled_cache(jcfg, num_blocks, bs, seed=4)
    # slot 0 owns blocks 1..4; slot 1 owns 5, 6 and the null tail
    tables = np.array([[1, 2, 3, 4], [5, 6, 0, 0]])
    tok = _tokens(jcfg, B, 1, seed=5)
    pos = np.array([13, 6])
    bundle = jsteps.build_paged_decode(
        jcfg, jreg.get_parallel(ARCH), single_device_mesh(),
        ShapeConfig("serve", S, B, "decode"), block_size=bs,
        num_blocks=num_blocks)
    j_next, j_pool = jax.jit(bundle.fn)(
        jp, jax.tree.map(jnp.asarray, pool), jnp.asarray(tables, jnp.int32),
        jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32))
    t_next, t_pool = tsteps.paged_decode_step(
        tcfg, _to_cpu(_np(jp)), _to_cpu(pool),
        torch.as_tensor(tables), torch.as_tensor(tok), torch.as_tensor(pos))
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
    for kind in ("k", "v"):
        np.testing.assert_allclose(t_pool["0_attn"][kind].numpy(),
                                   np.asarray(j_pool["0_attn"][kind]), **TOL)


def test_paged_view_scatter_and_prompt_insert_match_reference():
    jcfg, tcfg = _cfgs(**F32)
    bs, num_blocks = 4, 7
    pool = _filled_cache(jcfg, num_blocks, bs, seed=6)
    src = _filled_cache(jcfg, 1, 8, seed=7)
    blocks = np.array([3, 5])
    tables = np.array([[3, 5, 0, 0], [1, 2, 4, 6]])
    pos = np.array([9, 16])                 # 16 >= S lands on the null block

    j_pool = jsteps.paged_prompt_insert(jax.tree.map(jnp.asarray, pool),
                                        jax.tree.map(jnp.asarray, src),
                                        jnp.asarray(blocks))
    t_pool = tsteps.paged_prompt_insert(_to_cpu(pool),
                                        _to_cpu(src),
                                        torch.as_tensor(blocks))
    j_view = jsteps.paged_cache_view(j_pool, jnp.asarray(tables))
    t_view = tsteps.paged_cache_view(t_pool, torch.as_tensor(tables))
    for kind in ("k", "v"):
        np.testing.assert_array_equal(t_view["0_attn"][kind].numpy(),
                                      np.asarray(j_view["0_attn"][kind]))
    j_pool = jsteps.paged_cache_scatter(j_pool, j_view, jnp.asarray(tables),
                                        jnp.asarray(pos))
    t_pool = tsteps.paged_cache_scatter(t_pool, t_view, torch.as_tensor(tables),
                                        torch.as_tensor(pos))
    for kind in ("k", "v"):
        np.testing.assert_array_equal(t_pool["0_attn"][kind][:, 1:].numpy(),
                                      np.asarray(j_pool["0_attn"][kind])[:, 1:])


def test_cache_insert_and_evict_match_reference():
    jcfg, tcfg = _cfgs(**F32)
    dst = _filled_cache(jcfg, 3, 12, seed=8)
    src = _filled_cache(jcfg, 1, 8, seed=9)
    j = jsteps.cache_batch_insert(jax.tree.map(jnp.asarray, dst),
                                  jax.tree.map(jnp.asarray, src), 1)
    t = tsteps.cache_batch_insert(_to_cpu(dst), _to_cpu(src), 1)
    np.testing.assert_array_equal(t["0_attn"]["k"].numpy(),
                                  np.asarray(j["0_attn"]["k"]))
    j = jsteps.cache_batch_evict(j, 2)
    t = tsteps.cache_batch_evict(t, 2)
    np.testing.assert_array_equal(t["0_attn"]["v"].numpy(),
                                  np.asarray(j["0_attn"]["v"]))
    assert tsteps.paged_compatible(tcfg, 24, 8) == jsteps.paged_compatible(
        jcfg, 24, 8)
    assert tsteps.paged_compatible(tcfg, 24, 5) is False


@pytest.mark.parametrize("pos", [3, 99, [1, 20, 11]])
def test_insert_kv_matches_reference(pos):
    """Scalar pos clamps like dynamic_update_slice; a vector entry >= the
    cache length writes nothing."""
    rng = np.random.RandomState(10)
    B, S, KV, dh = 3, 12, 2, 4
    cache = {n: rng.standard_normal((B, S, KV, dh)).astype(np.float32)
             for n in ("k", "v")}
    k, v = (rng.standard_normal((B, 1, KV, dh)).astype(np.float32)
            for _ in range(2))
    want = jtfm.insert_kv(jax.tree.map(jnp.asarray, cache), jnp.asarray(k),
                          jnp.asarray(v), jnp.asarray(pos))
    got = _to_cpu(cache)
    tpos = torch.as_tensor(pos) if isinstance(pos, list) else pos
    ttfm.insert_kv(got, torch.as_tensor(k), torch.as_tensor(v), tpos)
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want[1]))
