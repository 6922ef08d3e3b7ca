"""Parity of the port's whisper-small encoder-decoder with the JAX package.

whisper smoke config (2 encoder layers, 1 decoder layer, no RoPE, the
decoder's 16 learned positions), params made by the JAX ``init_params``
and carried over by ``repro_torch.bridge``, and seeded frames (B, T_enc,
d_model) for the stubbed frontend.  The port runs on the CPU (its plain
paths: the encoder's self-attention and the cross attention unmasked
with Sq != Sk), the JAX side as its own tests run it.  Tolerances are
tests/test_torch_model.py's: f32 1e-4 with equal greedy tokens, bf16 5e-2
on logits; grads 2e-4 of each leaf's norm.
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
from repro.launch.serve import serve_static as j_serve_static   # noqa: E402
from repro.models import encdec as jenc                         # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models.layers import ModelCtx                        # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402
from repro.serving.engine import ServingEngine as JEngine        # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.core.queue import WorkQueue as TQueue          # noqa: E402
from repro_torch.launch import serve as tserve                  # noqa: E402
from repro_torch.models import encdec as tenc                   # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

ARCH = "whisper-small"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 2e-4
T_ENC = 20                  # encoder frames: not the decoder's 16


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
    return (jreg.get_smoke(ARCH).replace(encoder_frames=T_ENC, **kw),
            treg.get_smoke(ARCH).replace(encoder_frames=T_ENC, **kw))


def _jax_params(jcfg, seed=0):
    return jpr.init_params(jenc.lm_schema(jcfg), jax.random.key(seed),
                           jcfg.param_dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_cpu(tree):
    return bridge.to_torch(tree, device="cpu")


def _frames(cfg, B, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (B, T_ENC, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size, (B, S))


def test_config_copy_and_schemas_match_reference():
    assert ARCH in treg.ARCHS
    assert dataclasses.asdict(treg.get_config(ARCH)) == dataclasses.asdict(
        jreg.get_config(ARCH))
    assert dataclasses.asdict(treg.get_smoke(ARCH)) == dataclasses.asdict(
        jreg.get_smoke(ARCH))
    jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    for jschema, tschema in [(jenc.lm_schema(jcfg), tenc.lm_schema(tcfg)),
                             (jenc.cache_schema(jcfg, 4, 576),
                              tenc.cache_schema(tcfg, 4, 576))]:
        want = dict(jpr._leaves(jschema))
        got = dict(tpr.leaves(tschema))
        assert sorted(got) == sorted(want)
        for path, p in got.items():
            assert (p.shape, p.axes, p.init, p.scale) == (
                want[path].shape, want[path].axes, want[path].init,
                want[path].scale), path
    assert tpr.param_count(tenc.lm_schema(tcfg)) == jpr.param_count(
        jenc.lm_schema(jcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    jcfg, _ = _cfgs(param_dtype=dtype, compute_dtype=dtype)
    jp = _np(_jax_params(jcfg))
    assert {"enc_blocks", "dec_blocks", "pos_dec"} <= set(jp)
    back = bridge.to_numpy(_to_cpu(jp), like=jp)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                 jax.tree_util.tree_leaves_with_path(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_sinusoid_matches_reference():
    want = np.asarray(jenc._sinusoid(T_ENC, 64, jnp.float32))
    got = tenc._sinusoid(T_ENC, 64, torch.float32, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_prefill(jcfg):
    fn = jsteps.build_prefill(jcfg, jreg.get_parallel(ARCH),
                              single_device_mesh(),
                              ShapeConfig("serve", T_ENC, 1, "prefill")).fn
    return jax.jit(fn)


def _prefill_both(jcfg, tcfg, Td, seed):
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg, 1, Td, seed=seed)
    frames = _frames(jcfg, 1, seed=seed)
    j_last, j_caches = _jax_prefill(jcfg)(
        jp, jnp.asarray(toks, jnp.int32),
        {"frames": jnp.asarray(frames, jcfg.param_dtype)})
    t_last, t_caches = tsteps.prefill_step(
        tcfg, _to_cpu(_np(jp)), torch.as_tensor(toks),
        extras={"frames": torch.as_tensor(frames).to(
            getattr(torch, tcfg.param_dtype))})
    return j_last, j_caches, t_last, t_caches


def test_prefill_logits_and_caches_match_f32():
    jcfg, tcfg = _cfgs(**F32)
    j_last, j_caches, t_last, t_caches = _prefill_both(jcfg, tcfg, 12, 0)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    for part, kinds in (("self", ("k", "v")), ("cross", ("ck", "cv"))):
        for kind in kinds:
            np.testing.assert_allclose(t_caches[part][kind].numpy(),
                                       np.asarray(j_caches[part][kind]),
                                       **TOL)
    assert t_caches["cross"]["ck"].shape[2] == T_ENC


def test_prefill_logits_match_bf16():
    jcfg, tcfg = _cfgs()
    j_last, _, t_last, _ = _prefill_both(jcfg, tcfg, 12, 1)
    assert t_last.dtype == torch.bfloat16
    np.testing.assert_allclose(t_last.float().numpy(),
                               np.asarray(j_last, np.float32), atol=5e-2,
                               rtol=0)


def test_slot_decode_step_matches_f32():
    jcfg, tcfg = _cfgs(**F32)
    B = 3
    jp = _jax_params(jcfg)
    rng = np.random.RandomState(2)
    cache = jpr.tree_map_schema(
        lambda _p, p: rng.standard_normal(p.shape).astype(np.float32),
        jenc.cache_schema(jcfg, B, T_ENC))
    tok = _tokens(jcfg, B, 1, seed=3)
    pos = np.array([3, 10, 15])
    bundle = jsteps.build_slot_decode(jcfg, jreg.get_parallel(ARCH),
                                      single_device_mesh(),
                                      ShapeConfig("serve", T_ENC, B, "decode"))
    j_next, j_cache = jax.jit(bundle.fn)(
        jp, jax.tree.map(jnp.asarray, cache), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    t_next, t_cache = tsteps.slot_decode_step(
        tcfg, _to_cpu(_np(jp)), _to_cpu(cache), torch.as_tensor(tok),
        torch.as_tensor(pos))
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
    for part, kinds in (("self", ("k", "v")), ("cross", ("ck", "cv"))):
        for kind in kinds:
            np.testing.assert_allclose(t_cache[part][kind].numpy(),
                                       np.asarray(j_cache[part][kind]),
                                       **TOL)


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
    jcfg, tcfg = _cfgs(**F32)
    par = jreg.get_parallel(ARCH)
    jp = _jax_params(jcfg, seed=1)
    rng = np.random.RandomState(6)
    toks = rng.randint(1, jcfg.vocab_size, (2, jcfg.decoder_len))
    labels = rng.randint(1, jcfg.vocab_size, (2, jcfg.decoder_len))
    frames = _frames(jcfg, 2, seed=6)
    ctx = ModelCtx(jcfg, par, None)
    jl, jg = jax.value_and_grad(lambda q: jenc.loss_fn(ctx, q, {
        "tokens": jnp.asarray(toks, jnp.int32),
        "labels": jnp.asarray(labels, jnp.int32),
        "extras": {"frames": jnp.asarray(frames)}}))(jp)
    tbatch = {"tokens": torch.as_tensor(toks),
              "labels": torch.as_tensor(labels),
              "extras": {"frames": torch.as_tensor(frames)}}
    tl, tg = tsteps._value_and_grad(tcfg, treg.get_parallel(ARCH),
                                    _to_cpu(_np(jp)), tbatch,
                                    loss=tenc.loss_fn)
    assert abs(tl.item() - float(jl)) <= 1e-4 * abs(float(jl))
    _walk(_np(jg), tg)


def test_engine_follows_the_audio_rule_and_jax_tokens():
    """prompt_len 16 with 6 new tokens in a decoder of 16 positions: the
    prompt pads to 10 and the cache holds 16, as in the JAX engine; the
    frames are zeros on both sides."""
    jcfg, tcfg = jreg.get_smoke(ARCH).replace(**F32), \
        treg.get_smoke(ARCH).replace(**F32)
    jp = _jax_params(jcfg)
    rng = np.random.RandomState(7)
    reqs = [{"id": i, "prompt": rng.randint(1, jcfg.vocab_size, 12).tolist(),
             "max_new_tokens": g} for i, g in enumerate([6, 2, 5])]
    kw = dict(num_slots=2, prompt_len=16, max_new_tokens=6)
    jeng = JEngine(jcfg, jreg.get_parallel(ARCH), single_device_mesh(),
                   params=jp, **kw)
    teng = TEngine(tcfg, device="cpu", params=_to_cpu(_np(jp)), **kw)
    assert (teng.prompt_pad, teng.cache_len) == (jeng.prompt_pad,
                                                 jeng.cache_len) == (10, 16)
    assert teng.cfg.encoder_frames == 22 and not teng.paged
    want, _ = jeng.run(JQueue([dict(r) for r in reqs]))
    got, _ = teng.run(TQueue([dict(r) for r in reqs]))
    assert got == want
    with pytest.raises(ValueError, match="audio cache cannot be paged"):
        TEngine(tcfg, device="cpu", paged=True, block_size=2, **kw)


def test_static_batcher_matches_jax():
    """The CLI's drain-then-refill path: prompts of decoder_len tokens and
    zero frames, as the JAX CLI builds them."""
    jcfg, tcfg = jreg.get_smoke(ARCH).replace(**F32), \
        treg.get_smoke(ARCH).replace(**F32)
    jp = _jax_params(jcfg)
    rng = np.random.RandomState(8)
    reqs = [{"id": i, "prompt": rng.randint(1, jcfg.vocab_size, 8).tolist(),
             "max_new_tokens": g} for i, g in enumerate([4, 2, 3])]
    kw = dict(smoke=True, n_requests=len(reqs), prompt_len=8, gen=4,
              batch=2)
    want, _ = j_serve_static(ARCH, requests=[dict(r) for r in reqs],
                             cfg_override=jcfg, **kw)
    got, _ = tserve.serve_static(ARCH, requests=[dict(r) for r in reqs],
                                 cfg_override=tcfg, params=_to_cpu(_np(jp)),
                                 device="cpu", **kw)
    assert got == want
