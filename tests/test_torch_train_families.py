"""Training the families the port used to serve only, against the JAX package.

granite-moe-1b-a400m (top-k MoE, two layers), zamba2-2.7b (one Mamba2
layer and one with the shared attention block), rwkv6-1.6b, whisper-small
(frames) and llama-3.2-vision-90b (one self- and one cross-attention
layer, image embeddings), each at its smoke widths in f32.
Params are made by the JAX ``init_params`` and carried over by
``repro_torch.bridge`` (the VLM's cross gates seeded nonzero, as in
tests/test_torch_vlm.py: the reference init zeroes them).  The port runs
on the CPU through the plain versions of its kernels and of their train
Functions (``moe_gmm.gmm_train``, ``ssm_scan.ssd_scan_train``,
``wkv6.wkv6_train``); the JAX side as its own tests run it.

Tolerances, all f32: the loss 1e-5 (the same products summed in other
orders); each grad leaf 1e-4 of its norm, as tests/test_torch_train.py
holds phi4's whole model (the farthest leaves here: 4.8e-5, whisper's
decoder ``wo_mlp``; 2.6e-5, zamba2).  zamba2 and the VLM are cut to two
layers: at the 6 and 5 layers of their smoke configs, under the
reference init, f32 rounding alone moves JAX's own leaves up to 3.2e-4
and 1.7e-4 of their norms from the same grads in float64 (the port's
plain path at float64; the port's lie up to 2.2e-4 and 1.1e-4 away), so
no f32 pair could be held at 1e-4 there.  Params after one step 2e-4
absolute and the moments 1e-3 relative + 2e-5 / 1e-6 absolute, as in
tests/test_torch_train.py.  The train
Functions against autograd of their plain versions: 1e-6, since both run
the same plain arithmetic on the CPU.
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
from repro.launch.mesh import single_device_mesh                # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import ssm as jssm                            # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.models.layers import ModelCtx                        # noqa: E402
from repro.optim import adamw as jadamw                         # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.kernels import moe_gmm, ssm_scan, wkv6         # noqa: E402
from repro_torch.kernels.ref import gmm_ref                     # noqa: E402
from repro_torch.models import moe as tmoe                      # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402

GRANITE, ZAMBA, RWKV = "granite-moe-1b-a400m", "zamba2-2.7b", "rwkv6-1.6b"
WHISPER, VLM = "whisper-small", "llama-3.2-vision-90b"
FAMILIES = [GRANITE, ZAMBA, RWKV, WHISPER, VLM]
F32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, T_ENC = 2, 16, 20       # whisper's decoder is its smoke length, 16
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
PARAMS = dict(rtol=0, atol=2e-4)
M_TOL = dict(rtol=1e-3, atol=2e-5)
V_TOL = dict(rtol=1e-3, atol=1e-6)
SCHEDULE = dict(warmup_steps=1, decay_steps=100)
# Adam's first step moves each element by lr g / (|g| + eps): with the
# default eps 1e-8 an element whose grad lies within f32 rounding of 0
# steps by +-lr either way, so one step is held with an eps that keeps the
# update a smooth function of the grad there
STEP_EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Smoke-size tensors gain nothing from an OpenMP team of every core,
    and the suite runs several workers on one machine.  Two threads a
    team, as the threaded test files pin it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(arch):
    kw = dict(F32)
    if arch == GRANITE:
        kw["num_layers"] = 2          # the aux loss summed across groups
    if arch == ZAMBA:                 # one mamba layer and the shared block
        kw.update(num_layers=2, block_pattern=("mamba", "mamba_attn"))
    if arch == VLM:                   # one self- and one cross-attention
        kw.update(num_layers=2, block_pattern=("attn", "cross"))
    if arch == WHISPER:
        kw["encoder_frames"] = T_ENC
    return jreg.get_smoke(arch).replace(**kw), \
        treg.get_smoke(arch).replace(**kw)


def _pars(arch):
    """The train steps' layout on one device (the pure-FSDP switch)."""
    tpar = tsteps.train_par(treg.get_parallel(arch))
    return dataclasses.replace(jreg.get_parallel(arch),
                               pure_fsdp=tpar.pure_fsdp), tpar


def _jax_params(arch, jcfg, seed=0):
    """The reference init; the VLM's cross gates set nonzero, or its cross
    layer adds nothing and gets no gradient but the gates'."""
    schema = jsteps._model_module(jcfg).lm_schema(jcfg)
    p = jax.jit(lambda k: jpr.init_params(schema, k, "float32"))(
        jax.random.key(seed))
    if arch == VLM:
        rng = np.random.RandomState(100 + seed)
        for gate in ("gate_attn", "gate_mlp"):
            leaf = p["blocks"]["1_cross"][gate]
            p["blocks"]["1_cross"][gate] = jnp.asarray(
                rng.uniform(0.5, 1.5, leaf.shape), leaf.dtype)
    return jax.tree.map(np.asarray, p)


def _batch(cfg, seed=0, lead=()):
    """tokens/labels (*lead, B, T) and the family's extras, from numpy."""
    rng = np.random.RandomState(seed)
    T = cfg.decoder_len if cfg.family == "audio" else S
    out = {k: rng.randint(1, cfg.vocab_size, lead + (B, T)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "audio":
        out["extras"] = {"frames": rng.standard_normal(
            lead + (B, T_ENC, cfg.d_model)).astype(np.float32)}
    elif cfg.family == "vlm":
        out["extras"] = {"image_embeds": rng.standard_normal(
            lead + (B, cfg.num_patches, cfg.vision_dim)).astype(np.float32)}
    return out


def _pairs(want, got, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            yield from _pairs(want[k], got[k], f"{path}/{k}")
        return
    yield path, np.asarray(want, np.float32), got.detach().float().numpy()


def _rel(got, want):
    return np.linalg.norm(np.asarray(got, np.float64) - want) / \
        np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _jax_reference(arch):
    """JAX's side, in one compiled call: ``value_and_grad`` of the family's
    ``loss_fn`` on the train steps' layout, and one step of its
    ``build_train`` on a one-device mesh, from the same weights and
    batch.  -> (params, batch, loss, grads, (params, opt, metrics) after
    the step), all numpy."""
    jcfg, _ = _cfgs(arch)
    jpar, _ = _pars(arch)
    params, batch = _jax_params(arch, jcfg), _batch(jcfg, seed=3)
    ctx = ModelCtx(jcfg, jpar, None)
    loss = jsteps._model_module(jcfg).loss_fn
    mesh = single_device_mesh()
    ocfg = JOpt(eps=STEP_EPS, **SCHEDULE)
    step = jsteps.build_train(
        jcfg, jreg.get_parallel(arch), ocfg, mesh,
        ShapeConfig("t", T_ENC if jcfg.family == "audio" else S, B,
                    "train")).fn
    schema = jsteps._model_module(jcfg).lm_schema(jcfg)

    def both(p, o, b):
        return jax.value_and_grad(lambda q: loss(ctx, q, b))(p), \
            step(p, o, b)
    with mesh:
        opt = jax.jit(lambda: jpr.init_params(
            jadamw.opt_state_schema(schema, ocfg), jax.random.key(1),
            "float32"))()
        (jl, jg), out = jax.jit(both)(jax.tree.map(jnp.asarray, params), opt,
                                      jax.tree.map(jnp.asarray, batch))
    return params, batch, float(jl), *jax.tree.map(np.asarray, (jg, out))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """The train steps' loss (the family's ``loss_fn``, the MoE aux loss
    included) and every grad leaf against ``jax.value_and_grad`` of the
    JAX family's ``loss_fn`` on the same weights and batch."""
    _, tcfg = _cfgs(arch)
    params, batch, jl, jg, _ = _jax_reference(arch)
    tl, tg = tsteps._value_and_grad(
        tcfg, _pars(arch)[1], bridge.to_torch(params, device="cpu"),
        jax.tree.map(torch.as_tensor, batch))
    np.testing.assert_allclose(float(tl), jl, rtol=LOSS_RTOL)
    for path, want, got in _pairs(jg, tg):
        assert _rel(got, want) <= LEAF_RTOL, path


def test_moe_routes_as_jax_and_adds_the_aux_loss(monkeypatch):
    """Both stacks pick the same top-k in each layer of the train forward,
    expert 0 never fills its bucket (where it does, the JAX bucket
    scatter drops its last kept token's term: tests/test_torch_moe.py
    pins that divergence), and the aux loss the port adds to the NLL is
    JAX's, summed over the two layers."""
    jcfg, tcfg = _cfgs(GRANITE)
    jpar, tpar = _pars(GRANITE)
    jpar = dataclasses.replace(jpar, remat=False, scan_layers=False)
    tpar = dataclasses.replace(tpar, remat=False)
    params = _jax_params(GRANITE, jcfg)
    tokens = _batch(jcfg, seed=3)["tokens"]
    picked = {"jax": [], "port": []}
    top_k = jax.lax.top_k

    def jax_top_k(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: picked["jax"].append(np.asarray(i)),
                           idx, ordered=True)
        return vals, idx
    routed = tmoe._routed

    def port_routed(cfg, p, x, train=False):
        out = routed(cfg, p, x, train)
        picked["port"].append(out[2].numpy())
        return out
    monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
    monkeypatch.setattr(tmoe, "_routed", port_routed)
    _, _, jaux = jax.jit(lambda p, t: jtfm.forward(
        ModelCtx(jcfg, jpar, None), p, t, mode="train"))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    jax.effects_barrier()
    with torch.no_grad():
        _, taux = ttfm._train_forward(
            tcfg, tpar, bridge.to_torch(params, device="cpu"),
            torch.as_tensor(tokens))
    assert len(picked["jax"]) == len(picked["port"]) == jcfg.num_layers
    _, cap_e = tmoe.capacities(B * S, jcfg.moe.top_k, jcfg.moe.num_experts,
                               jcfg.moe.capacity_factor)
    for want, got in zip(picked["jax"], picked["port"]):
        np.testing.assert_array_equal(got, want)
        assert (got == 0).sum() < cap_e
    assert float(jaux) > 1e-3
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_matches_build_train(arch):
    """One ``steps.train_step`` against one step of the JAX
    ``build_train`` on a one-device mesh: loss, grad norm, lr, params,
    moments and count."""
    _, tcfg = _cfgs(arch)
    params, batch, _, _, (jp, jo, jm) = _jax_reference(arch)
    ocfg = OptimizerConfig(eps=STEP_EPS, **SCHEDULE)
    tp, to, tm = tsteps.train_step(
        tcfg, treg.get_parallel(arch), ocfg,
        bridge.to_torch(params, device="cpu"),
        tsteps.init_opt_state(tcfg, ocfg, device="cpu"), batch,
        device="cpu")
    np.testing.assert_allclose(float(tm["loss"]), jm["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"],
                               rtol=LEAF_RTOL)
    np.testing.assert_allclose(float(tm["lr"]), jm["lr"], rtol=1e-6)
    for tol, want, got in ((PARAMS, jp, tp), (M_TOL, jo["m"], to["m"]),
                           (V_TOL, jo["v"], to["v"])):
        for path, w, g in _pairs(want, got):
            np.testing.assert_allclose(g, w, err_msg=path, **tol)
    assert int(to["count"]) == int(jo["count"]) == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_chunk_equals_its_steps(arch):
    """A K=2 chunk, extras stacked (K, B, ...), against two
    ``train_step`` calls with accum 2: every loss and every param bit."""
    _, tcfg = _cfgs(arch)
    par = treg.get_parallel(arch)
    ocfg = OptimizerConfig(accum_steps=2, **SCHEDULE)
    params = bridge.to_torch(_jax_params(arch, _cfgs(arch)[0]), device="cpu")
    chunk = _batch(tcfg, seed=5, lead=(2,))
    runs = []
    for chunked in (False, True):
        p = jax.tree.map(torch.clone, params)
        opt = tsteps.init_opt_state(tcfg, ocfg, device="cpu")
        if chunked:
            p, opt, ms = tsteps.train_chunk(tcfg, par, ocfg, p, opt, chunk,
                                            device="cpu")
            losses = ms["loss"].tolist()
        else:
            losses = []
            for j in range(2):
                p, opt, m = tsteps.train_step(
                    tcfg, par, ocfg, p, opt,
                    jax.tree.map(lambda a: a[j], chunk), device="cpu")
                losses.append(float(m["loss"]))
        assert all(np.isfinite(losses))
        runs.append((losses, p))
    assert runs[0][0] == runs[1][0]
    for path, a, b in _pairs(bridge.to_numpy(runs[0][1]), runs[1][1]):
        np.testing.assert_array_equal(b, a, err_msg=path)


def test_a_batch_without_the_familys_extras_is_refused():
    _, tcfg = _cfgs(VLM)
    ocfg = OptimizerConfig()
    batch = _batch(tcfg)
    del batch["extras"]
    with pytest.raises(ValueError, match=r"with \['image_embeds'\]"):
        tsteps.train_step(tcfg, treg.get_parallel(VLM), ocfg, {}, {},
                          batch, device="cpu")


def test_rl_chunk_trains_moe_and_refuses_whisper_as_jax():
    """granite's policy-gradient chunk (aux included) against the JAX
    ``build_rl_train_chunk``; whisper's encoder-decoder has no
    ``rl_loss_fn`` in either stack, and both refuse it alike."""
    jcfg, tcfg = _cfgs(GRANITE)
    params = _jax_params(GRANITE, jcfg)
    rng = np.random.RandomState(7)
    batches = _batch(jcfg, seed=7, lead=(2,))
    batches["mask"] = (rng.uniform(size=(2, B, S)) < 0.6).astype(np.float32)
    batches["advantages"] = rng.standard_normal((2, B)).astype(np.float32)
    mesh = single_device_mesh()
    fn = jsteps.build_rl_train_chunk(
        jcfg, jreg.get_parallel(GRANITE), JOpt(**SCHEDULE), mesh,
        ShapeConfig("rl", S, B, "train"), 2).jit()
    schema = jtfm.lm_schema(jcfg)
    ocfg = OptimizerConfig(**SCHEDULE)
    with mesh:
        opt = jax.jit(lambda: jpr.init_params(
            jadamw.opt_state_schema(schema, JOpt()), jax.random.key(1),
            "float32"))()
        jp, _, jms = fn(jax.tree.map(jnp.asarray, params), opt,
                        jax.tree.map(jnp.asarray, batches))
    tp, _, tms = tsteps.rl_train_chunk(
        tcfg, treg.get_parallel(GRANITE), ocfg,
        bridge.to_torch(params, device="cpu"),
        tsteps.init_opt_state(tcfg, ocfg, device="cpu"), batches,
        device="cpu")
    np.testing.assert_allclose(tms["loss"].numpy(), np.asarray(jms["loss"]),
                               rtol=LOSS_RTOL)
    for path, w, g in _pairs(jax.tree.map(np.asarray, jp), tp):
        np.testing.assert_allclose(g, w, err_msg=path, **PARAMS)
    jw, tw = _cfgs(WHISPER)
    with pytest.raises(ValueError, match="does not define 'rl_loss_fn'"):
        jsteps.build_rl_train_chunk(jw, jreg.get_parallel(WHISPER), JOpt(),
                                    mesh, ShapeConfig("rl", T_ENC, B,
                                                      "train"), 1)
    with pytest.raises(ValueError, match="does not define 'rl_loss_fn'"):
        tsteps.rl_train_chunk(tw, treg.get_parallel(WHISPER), ocfg, {}, {},
                              _batch(tw, lead=(1,)), device="cpu")


# --- the train Functions against autograd of their plain versions ---------

def _grads(fn, inputs, dy):
    ins = [t.clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    return out.detach(), torch.autograd.grad(out, ins, dy)


def test_gmm_train_matches_plain_autograd():
    """A ragged bucket (C 37, D 24, F 40): the Function's output, dx and dw
    against autograd of the plain einsum; with ``rows`` (an empty expert,
    a partial one, a full one) against autograd of ``gmm_plain`` with the
    same rows; nothing launches on the CPU."""
    rng = np.random.RandomState(8)
    x, w, dy = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                for s in [(3, 37, 24), (3, 24, 40), (3, 37, 40)])
    before = moe_gmm.launches
    got, (gx, gw) = _grads(moe_gmm.gmm_train, (x, w), dy)
    want, (wx, ww) = _grads(gmm_ref, (x, w), dy)
    for a, b in ((got, want), (gx, wx), (gw, ww)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    rows = torch.tensor([0, 20, 37], dtype=torch.int32)
    got, (gx, gw) = _grads(
        lambda a, b: moe_gmm.gmm_train(a, b, rows), (x, w), dy)
    want, (wx, ww) = _grads(
        lambda a, b: moe_gmm.gmm_plain(a, b, rows), (x, w), dy)
    assert moe_gmm.launches == before
    for a, b in ((got, want), (gx, wx), (gw, ww)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert not got[0].any() and not gx[0].any() and not gw[0].any()
    assert not got[1, 20:].any() and not gx[1, 20:].any()


@pytest.mark.parametrize("name", ["ssd", "wkv6"])
def test_scan_train_functions_match_plain_autograd(name):
    """Every input's gradient through the train Function (forward by the
    wrapper, backward by recomputing the plain chunked form) against
    autograd straight through the plain version, over two chunks."""
    rng = np.random.RandomState(9)
    Bz, T, H, hd = 2, 16, 3, 8

    def t(*shape, lo=None, hi=None):
        a = rng.standard_normal(shape) if lo is None else \
            rng.uniform(lo, hi, shape)
        return torch.as_tensor(a.astype(np.float32))
    if name == "ssd":
        N = 6
        inputs = (t(Bz, T, H, hd), t(Bz, T, H, lo=0.05, hi=0.5),
                  t(H, lo=-1.0, hi=-0.1), t(Bz, T, N), t(Bz, T, N))

        def train(*a):
            return ssm_scan.ssd_scan_train(*a, chunk=8)

        def plain(*a):
            return ssm_scan.ssd_scan_plain(*a, chunk=8)[0]
    else:
        inputs = (t(Bz, T, H, hd), t(Bz, T, H, hd), t(Bz, T, H, hd),
                  t(Bz, T, H, hd, lo=-2.0, hi=-0.01), t(H, hd))

        def train(*a):
            return wkv6.wkv6_train(*a, chunk=8)

        def plain(*a):
            return wkv6.wkv6_plain(*a, chunk=8)[0]
    dy = t(Bz, T, H, hd)
    got, ggot = _grads(train, inputs, dy)
    want, gwant = _grads(plain, inputs, dy)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    for i, (a, b) in enumerate(zip(ggot, gwant)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"input {i}")


def _ssd_f64(x, dt, a, B_, C):
    """The SSD recurrence step by step, in the inputs' dtype."""
    h = x.new_zeros(x.shape[0], x.shape[2], x.shape[3], B_.shape[-1])
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t] * a)[..., None, None] * h + torch.einsum(
            "bh,bn,bhd->bhdn", dt[:, t], B_[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhdn->bhd", C[:, t], h))
    return torch.stack(ys, 1)


def _wkv6_f64(r, k, v, logw, u):
    """The WKV6 recurrence step by step, in the inputs' dtype."""
    s = r.new_zeros(r.shape[0], r.shape[2], r.shape[3], r.shape[3])
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(ys, 1)


@pytest.mark.parametrize("name", ["ssd", "wkv6"])
def test_scan_grads_stay_finite_where_the_masked_exp_overflows(name):
    """One chunk of 128 rows (SSD: dt 1, a -1) or 64 (WKV6: log-decay -2),
    so the pairwise log-decay above the diagonal reaches 127 and 126 and
    exp overflows f32 there.  The values agree; JAX masks after the exp,
    and its gradient there is 0 * inf = NaN; the port masks before it,
    and its gradient is finite and within 1e-4 of the recurrence's,
    stepped in float64 (the gradient of the SSD's a sums the chunk's 8,256
    pairs in f32: 2.2e-5 off) (ROADMAP queue C)."""
    rng = np.random.RandomState(10)

    def a32(*shape, fill=None):
        a = np.full(shape, fill) if fill is not None else \
            rng.standard_normal(shape)
        return a.astype(np.float32)
    if name == "ssd":
        S, H, hd, N = 128, 2, 4, 4
        inputs = (a32(1, S, H, hd), a32(1, S, H, fill=1.0),
                  a32(H, fill=-1.0), a32(1, S, N), a32(1, S, N))

        def jax_y(*a):
            return jssm._ssd_chunked(*a, jnp.zeros((1, H, hd, N)), S)[0]

        def port_y(*a):
            return ssm_scan.ssd_scan_train(*a, chunk=S)
        truth = _ssd_f64
    else:
        S, H, hd = 64, 2, 4
        inputs = (a32(1, S, H, hd), a32(1, S, H, hd), a32(1, S, H, hd),
                  a32(1, S, H, hd, fill=-2.0), a32(H, hd))

        def jax_y(*a):
            return jssm._wkv_chunked(*a, jnp.zeros((1, H, hd, hd)), S)[0]

        def port_y(*a):
            return wkv6.wkv6_train(*a, chunk=S)
        truth = _wkv6_f64
    dy = rng.standard_normal((1, S, H, hd)).astype(np.float32)
    jy, jgrad = jax.vjp(jax_y, *map(jnp.asarray, inputs))
    assert any(np.isnan(np.asarray(g)).any() for g in jgrad(jnp.asarray(dy)))
    y, grads = _grads(port_y, [torch.as_tensor(a) for a in inputs],
                      torch.as_tensor(dy))
    _, want = _grads(truth, [torch.as_tensor(a, dtype=torch.float64)
                             for a in inputs],
                     torch.as_tensor(dy, dtype=torch.float64))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert np.isfinite(g.numpy()).all(), i
        assert _rel(g.numpy(), w.numpy()) <= 1e-4, i
