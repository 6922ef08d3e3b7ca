"""Parity of the port's training slice with the JAX package.

phi4-mini smoke config in f32 with two stacked layers, params made by the
JAX ``init_params`` and carried over by ``repro_torch.bridge``, batches
from the same ``TokenPipeline`` seed.  The port runs on the CPU, through
the plain versions of its xent and AdamW kernels; the JAX side runs as its
own tests run it (the Pallas xent in interpret mode where a test asks for
the fused loss).

Tolerances, all f32:
  * losses and attention: 1e-5 — the two frameworks sum the same products
    in other orders; final hidden states: 1e-4, as for the serving
    forward in tests/test_torch_model.py;
  * gradients of the loss head: 1e-5 relative; of the whole model, 1e-4
    relative — a random-init model's grads move by up to 7e-5 relative
    between f32 orders (both sides stay within 1e-4 of a float64 run);
  * params after 3 Adam steps: 2e-4 absolute at lr 3e-4 — Adam divides
    by sqrt(v), so where |g| is near eps a grad rounding flips a step of
    size lr; moments 1e-3 relative + 2e-5 / 1e-6 absolute.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.configs.base import ShapeConfig                      # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe            # noqa: E402
from repro.launch.mesh import single_device_mesh                # noqa: E402
from repro.models import attention as jattn                     # noqa: E402
from repro.models import losses as jlosses                      # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.models.layers import ModelCtx                        # noqa: E402
from repro.optim import adamw as jadamw                         # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.data.tokens import TokenPipeline               # noqa: E402
from repro_torch.launch import grad_check                       # noqa: E402
from repro_torch.models import attention as tattn               # noqa: E402
from repro_torch.models import losses as tlosses                # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402

ARCH = "phi4-mini-3.8b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN = dict(rtol=1e-4, atol=1e-4)
HEAD_GRAD = dict(rtol=1e-5, atol=1e-7)
NORM = dict(rtol=1e-4, atol=0)
PARAMS = dict(rtol=0, atol=2e-4)
M_TOL = dict(rtol=1e-3, atol=2e-5)
V_TOL = dict(rtol=1e-3, atol=1e-6)


def _cfgs(**kw):
    kw = dict(F32, num_layers=2, **kw)
    return jreg.get_smoke(ARCH).replace(**kw), treg.get_smoke(ARCH).replace(**kw)


def _walk(a, b, check, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _walk(a[k], b[k], check, f"{path}/{k}")
        return
    check(np.asarray(a, np.float32), b.detach().float().numpy(), path)


def _close(tol):
    def check(want, got, path):
        np.testing.assert_allclose(got, want, err_msg=path, **tol)
    return check


def _rel(tol):
    """Leaf-wise: |got - want| <= rtol * max|want| (grads of mixed scale)."""
    def check(want, got, path):
        assert np.abs(got - want).max() <= tol["rtol"] * np.abs(want).max(), path
    return check


def _loss_inputs(B=2, S=32, D=64, V=512, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            rng.randint(0, V, (B, S)).astype(np.int32),
            (0.05 * rng.standard_normal((V, D))).astype(np.float32),
            rng.uniform(0, 2, (B, S)).astype(np.float32))


@pytest.mark.parametrize("kind", ["chunked", "weighted"])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_losses_match_jax_fused_kernel(kind, softcap):
    """chunk 8 < S 32: four chunks, each through the xent kernel (JAX:
    Pallas in interpret mode; the port: its plain versions); values and
    grads w.r.t. the hidden states and the head."""
    x, lab, head, w = _loss_inputs()

    def jloss(xx, hh):
        if kind == "chunked":
            return jlosses.chunked_cross_entropy(
                xx, jnp.asarray(lab), hh, softcap=softcap, chunk=8,
                fused=True)
        return jlosses.weighted_cross_entropy(
            xx, jnp.asarray(lab), hh, jnp.asarray(w), denom=50.0,
            softcap=softcap, chunk=8, fused=True)

    want, (gx, gh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.as_tensor(x).requires_grad_()
    th = torch.as_tensor(head).requires_grad_()
    if kind == "chunked":
        got = tlosses.chunked_cross_entropy(tx, torch.as_tensor(lab), th,
                                            softcap=softcap, chunk=8)
    else:
        got = tlosses.weighted_cross_entropy(
            tx, torch.as_tensor(lab), th, torch.as_tensor(w), denom=50.0,
            softcap=softcap, chunk=8)
    tgx, tgh = torch.autograd.grad(got, (tx, th))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    _rel(HEAD_GRAD)(np.asarray(gx), tgx.numpy(), "x")
    _rel(HEAD_GRAD)(np.asarray(gh), tgh.numpy(), "head")


def test_weighted_zero_weights_give_no_gradient():
    x, lab, head, w = _loss_inputs()
    w[:, :16] = 0.0
    tx = torch.as_tensor(x).requires_grad_()
    loss = tlosses.weighted_cross_entropy(tx, torch.as_tensor(lab),
                                          torch.as_tensor(head),
                                          torch.as_tensor(w), chunk=8)
    (g,) = torch.autograd.grad(loss, tx)
    assert torch.count_nonzero(g[:, :16]) == 0
    assert torch.count_nonzero(g[:, 16:]) > 0


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_sharded_loss_matches_jax(softcap):
    x, lab, head, _ = _loss_inputs()
    ctx = ModelCtx(jreg.get_smoke(ARCH), jreg.get_parallel(ARCH), None)
    want = jlosses.sharded_cross_entropy(ctx, jnp.asarray(x),
                                         jnp.asarray(lab), jnp.asarray(head),
                                         softcap=softcap)
    got = tlosses.sharded_cross_entropy(torch.as_tensor(x),
                                        torch.as_tensor(lab),
                                        torch.as_tensor(head), softcap=softcap)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("window,cap", [(None, None), (8, 20.0)])
def test_train_attention_matches_qchunk_attention(window, cap):
    """Values and grads of q, k, v against the reference's ``_qchunk_attention``
    (reached through ``causal_attention`` in train mode, chunk 16 < S 48)."""
    rng = np.random.RandomState(1)
    B, S, H, KV, dh = 2, 48, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)])
    w = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    ctx = ModelCtx(jreg.get_smoke(ARCH), jreg.get_parallel(ARCH), None)

    def jf(q_, k_, v_):
        out = jattn.causal_attention(ctx, q_, k_, v_, window=window,
                                     logit_softcap=cap, strategy="heads",
                                     mode="train", chunk=16)
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    got = tattn.train_attention(tq, tk, tv, window=window,
                                logit_softcap=cap, chunk=16)
    tgrads = torch.autograd.grad((got * torch.as_tensor(w)).sum(),
                                 (tq, tk, tv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, a, b in zip("qkv", grads, tgrads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [True, False])
def test_train_forward_and_loss_grads_match_jax(remat):
    jcfg, tcfg = _cfgs()
    par_j = dataclasses.replace(jreg.get_parallel(ARCH), pure_fsdp=True,
                                remat=remat)
    par_t = dataclasses.replace(treg.get_parallel(ARCH), pure_fsdp=True,
                                remat=remat)
    p = jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(0), "float32")
    batch = JPipe(jcfg.vocab_size, 32, 2, seed=3)._host_batch(0)
    ctx = ModelCtx(jcfg, par_j, None)
    jx, _, _ = jtfm.forward(ctx, p, jnp.asarray(batch["tokens"]),
                            mode="train")
    jl, jg = jax.value_and_grad(lambda q: jtfm.loss_fn(
        ctx, q, {k: jnp.asarray(v) for k, v in batch.items()}))(p)
    tp = bridge.to_torch(jax.tree.map(np.asarray, p), device="cpu")
    tx, caches = ttfm.forward(tcfg, tp, torch.as_tensor(batch["tokens"]),
                              mode="train", par=par_t)
    assert caches is None
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), **HIDDEN)
    tl, tg = tsteps._value_and_grad(
        tcfg, par_t, tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _walk(jg, tg, _rel(NORM))


def _jax_trajectory(jcfg, ocfg, steps, B=4, S=32, seed=11):
    par = jreg.get_parallel(ARCH)
    mesh = single_device_mesh()
    schema = jtfm.lm_schema(jcfg)
    fn = jsteps.build_train(jcfg, par, ocfg, mesh,
                            ShapeConfig("t", S, B, "train")).jit()
    pipe = JPipe(jcfg.vocab_size, S, B, seed=seed)
    with mesh:
        p = jpr.init_params(schema, jax.random.key(0), "float32")
        o = jpr.init_params(jadamw.opt_state_schema(schema, ocfg),
                            jax.random.key(1), "float32")
        start = jax.tree.map(np.asarray, p)        # before donation
        ms = []
        for i in range(steps):
            p, o, m = fn(p, o, pipe.batch(i))
            ms.append({k: float(v) for k, v in m.items()})
    return start, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o), ms


@pytest.mark.parametrize("accum", [1, 2])
def test_three_step_trajectory_matches_build_train(accum):
    """3 steps of ``steps.train_step`` against the JAX ``build_train`` on a
    one-device mesh (phi4's pure-FSDP layout, so the chunked loss): loss,
    grad_norm and lr per step, then params, moments and count."""
    jcfg, tcfg = _cfgs()
    kw = dict(warmup_steps=1, decay_steps=100, accum_steps=accum)
    start, jp, jo, jms = _jax_trajectory(jcfg, JOpt(**kw), 3)
    ocfg = OptimizerConfig(**kw)
    par = treg.get_parallel(ARCH)
    params = bridge.to_torch(start, device="cpu")
    opt = tsteps.init_opt_state(tcfg, ocfg, device="cpu")
    pipe = TokenPipeline(tcfg.vocab_size, 32, 4, seed=11)
    for i, want in enumerate(jms):
        params, opt, got = tsteps.train_step(tcfg, par, ocfg, params, opt,
                                             pipe.batch(i), device="cpu")
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   want["grad_norm"], **NORM)
        np.testing.assert_allclose(float(got["lr"]), want["lr"], rtol=1e-6)
    _walk(jp, params, _close(PARAMS))
    _walk(jo["m"], opt["m"], _close(M_TOL))
    _walk(jo["v"], opt["v"], _close(V_TOL))
    assert int(opt["count"]) == int(jo["count"]) == 3


def test_token_pipeline_copy_gives_the_same_batches():
    for i in (0, 5):
        want = JPipe(512, 32, 4, seed=11)._host_batch(i)
        got = TokenPipeline(512, 32, 4, seed=11).batch(i)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        TokenPipeline(512, 32, 4, seed=11).chunk(2, 3)["tokens"],
        JPipe(512, 32, 4, seed=11).chunk_host(2, 3)["tokens"])


def test_train_chunk_equals_per_step_train_step():
    """Two K=3 chunks against six per-step calls, accum 2: every loss and
    every param bit."""
    _, tcfg = _cfgs()
    par = treg.get_parallel(ARCH)
    ocfg = OptimizerConfig(warmup_steps=2, decay_steps=100, accum_steps=2)
    pipe = TokenPipeline(tcfg.vocab_size, 16, 4, seed=5)
    runs = []
    for chunked in (False, True):
        params = tpr.init_params(ttfm.lm_schema(tcfg),
                                 torch.Generator().manual_seed(0), "float32",
                                 "cpu")
        opt = tsteps.init_opt_state(tcfg, ocfg, device="cpu")
        losses = []
        if chunked:
            for start in (0, 3):
                params, opt, ms = tsteps.train_chunk(
                    tcfg, par, ocfg, params, opt, pipe.chunk(start, 3),
                    device="cpu")
                assert ms["loss"].shape == (3,)
                losses.extend(ms["loss"].tolist())
        else:
            for i in range(6):
                params, opt, m = tsteps.train_step(
                    tcfg, par, ocfg, params, opt, pipe.batch(i), device="cpu")
                losses.append(float(m["loss"]))
        runs.append((losses, params))
    assert runs[0][0] == runs[1][0]
    _walk(bridge.to_numpy(runs[0][1]), runs[1][1],
          lambda want, got, path: np.testing.assert_array_equal(got, want,
                                                                err_msg=path))


def test_accum_must_divide_the_batch():
    _, tcfg = _cfgs()
    ocfg = OptimizerConfig(accum_steps=3)
    params = tpr.init_params(ttfm.lm_schema(tcfg),
                             torch.Generator().manual_seed(0), "float32",
                             "cpu")
    opt = tsteps.init_opt_state(tcfg, ocfg, device="cpu")
    with pytest.raises(ValueError, match="accum_steps=3"):
        tsteps.train_step(tcfg, treg.get_parallel(ARCH), ocfg, params, opt,
                          TokenPipeline(tcfg.vocab_size, 16, 4).batch(0),
                          device="cpu")


def test_cli_trains_on_the_cpu(capsys):
    from repro_torch.launch import train
    train.main(["--smoke", "--device", "cpu", "--steps", "4", "--seq", "16",
                "--batch", "2", "--device-steps", "2"])
    out = capsys.readouterr().out
    assert out.startswith("[train] loss ") and "->" in out


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-90b"])
def test_train_steps_carry_extras_and_the_cli_refuses(arch):
    """Whisper's encoder and the VLM's image embeddings reach their losses
    through ``batch["extras"]``, which the train steps carry: a step on a
    batch with them gives finite metrics.  The CLI's trainer feeds
    ``TokenPipeline`` batches, which have none, and refuses the family
    (tests/test_torch_elastic.py pins it beside the JAX trainer)."""
    from repro_torch.launch import train
    cfg, ocfg = treg.get_smoke(arch), OptimizerConfig()
    if cfg.family == "audio":
        cfg = cfg.replace(encoder_frames=16)
    T = tsteps.token_len(cfg, ShapeConfig("t", 16, 2, "train"))
    batch = TokenPipeline(cfg.vocab_size, T, 2).batch(0)
    rng = np.random.RandomState(0)
    batch["extras"] = {k: rng.standard_normal(tuple(v.shape)).astype(
        np.float32) for k, v in tsteps.extras_specs(cfg, 2).items()}
    params = tpr.init_params(tsteps._model_module(cfg).lm_schema(cfg),
                             torch.Generator().manual_seed(0),
                             cfg.param_dtype, "cpu")
    _, _, m = tsteps.train_step(cfg, treg.get_parallel(arch), ocfg, params,
                                tsteps.init_opt_state(cfg, ocfg, "cpu"),
                                batch, device="cpu")
    assert all(torch.isfinite(v).all() for v in m.values())
    with pytest.raises(RuntimeError, match=f"{cfg.family}' family"):
        train.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "2", "--seq", "16", "--batch", "2"])


# 32 layers at width 256, with phi4's head width of 128: deep enough for
# the reference init's growth to show, small enough for the CPU
DEEP = dict(num_layers=32, d_model=256, num_heads=2, num_kv_heads=1,
            head_dim=128, d_ff=512, vocab_size=1024)


@functools.lru_cache(maxsize=None)
def _deep_grads(init, dtype):
    """Per-layer wq grad norms and the embed grad norm of one batch, JAX
    and port, on the same JAX-made weights ("contracted": wq/wk/wv/wo
    rescaled by the port's ``contracted_attention_init_``) in ``dtype``."""
    cj = jreg.get_config(ARCH).replace(**DEEP, param_dtype=dtype,
                                       compute_dtype=dtype)
    ct = treg.get_config(ARCH).replace(**DEEP, param_dtype=dtype,
                                       compute_dtype=dtype)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jpr.init_params(
        jtfm.lm_schema(cj), jax.random.key(0), "float32")), device="cpu")
    if init == "contracted":
        grad_check.contracted_attention_init_(ct, tp)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                      tsteps._map(lambda t: t.numpy(), tp))
    tp = tsteps._map(lambda t: t.to(getattr(torch, dtype)), tp)
    batch = JPipe(DEEP["vocab_size"], 64, 2, seed=11)._host_batch(0)
    par = dataclasses.replace(jreg.get_parallel(ARCH), pure_fsdp=True)
    ctx = ModelCtx(cj, par, None)
    _, gj = jax.jit(jax.value_and_grad(lambda q: jtfm.loss_fn(
        ctx, q, {k: jnp.asarray(v) for k, v in batch.items()})))(jp)
    _, gt = tsteps._value_and_grad(
        ct, tsteps.train_par(treg.get_parallel(ARCH)), tp,
        {k: torch.as_tensor(v) for k, v in batch.items()})

    def norms(wq, embed):
        wq, embed = np.asarray(wq, np.float64), np.asarray(embed, np.float64)
        return (np.sqrt((wq.reshape(len(wq), -1) ** 2).sum(1)),
                np.sqrt((embed ** 2).sum()))
    return {"jax": norms(gj["blocks"]["0_attn"]["wq"].astype(jnp.float32),
                         gj["embed"].astype(jnp.float32)),
            "port": norms(gt["blocks"]["0_attn"]["wq"].float().numpy(),
                          gt["embed"].float().numpy())}


def test_reference_init_grads_grow_with_depth_in_jax_and_port():
    """ROADMAP queue C: under the reference's fan_in = shape[-2] the
    attention projections start 8-16x too wide here, and in f32 the grads
    grow more than 1e6-fold from the last layer back to the first, in the
    JAX model as in the port; so the blowup is the init's, not bf16's."""
    for side, (wq, embed) in _deep_grads("reference", "float32").items():
        assert wq[0] / wq[-1] > 1e6 and embed > 1e6, (side, wq, embed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deep_grads_match_jax_at_contracted_init(dtype):
    """At 32 layers with the attention projections at their contracted
    fan-in, the port's grads match JAX's layer by layer, in f32 (1e-5
    relative) and in bf16 (3e-2; 1.2e-2 seen), and the port's bf16 grads
    match its f32 grads (3e-2): no bf16 backward fault."""
    rtol = 1e-5 if dtype == "float32" else 3e-2
    got = _deep_grads("contracted", dtype)
    (jwq, jembed), (twq, tembed) = got["jax"], got["port"]
    np.testing.assert_allclose(twq, jwq, rtol=rtol)
    np.testing.assert_allclose(tembed, jembed, rtol=rtol)
    wq32, embed32 = _deep_grads("contracted", "float32")["port"]
    np.testing.assert_allclose(twq, wq32, rtol=3e-2)
    np.testing.assert_allclose(tembed, embed32, rtol=3e-2)
    assert wq32[0] / wq32[-1] < 1e3


def test_grad_check_bf16_matches_f32_on_the_cpu():
    """What chip_smoke.py asserts at full width on the card, at smoke size:
    each leaf's bf16 grad norm within 3e-2 of its f32 norm (7e-3 seen)."""
    out = grad_check.compare(ARCH, init="contracted", smoke=True, seq=32,
                             batch=2, device="cpu")
    assert set(out["rel_gap"]) == {p for p, _ in
                                   tpr.leaves(ttfm.lm_schema(
                                       treg.get_smoke(ARCH)))}
    assert max(out["rel_gap"].values()) <= 3e-2, out["rel_gap"]
