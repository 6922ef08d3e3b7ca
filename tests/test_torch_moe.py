"""The port's MoE family (granite-moe-1b-a400m) against the JAX package.

Grouped matmul: the port's ``gmm`` wrapper takes its plain version
(``ref.gmm_ref``, an f32 einsum) on CPU tensors; it is held against the
JAX Pallas kernel run with ``interpret=True`` at the shapes
tests/test_kernels.py runs it (2e-3 in f32, 5e-2 in bf16: its
tolerances), and at ragged shapes against it or, where it refuses them,
against the JAX ``ref.gmm_ref``.  Inputs come from numpy seeds.

MoE MLP and block: ``moe_mlp`` against the JAX ``moe_mlp`` with
``mesh=None`` (its single-rank capacity path) in f32, out and aux loss
within 1e-5 (the same f32 products; the combine sums each token's K terms
in another order).  The routing is set through the router weights, so
which experts fill is known: (a) no expert full, (b) cf 1.0 with experts
other than 0 over capacity, where entries drop in (token, k) order.

The JAX model loses a kept entry when expert 0 fills its bucket (its
dropped entries scatter zeros onto ``bucket[0, cap_e - 1]``, ROADMAP queue
C); ``test_jax_bucket_scatter_zeroes_expert0s_last_kept_token`` pins it
with the probe's routing, and the port follows a per-token Switch
reference there.  So the whole-model and engine tests run at capacity
factor 4.0, where ``cap_e >= T*K`` and no expert can fill: routing is
exact in both packages.  At the config's own 1.25 the port's paged tokens
must equal its slotted ones.

Whole model: granite smoke with two layers (G = 2) in f32, JAX params
carried over by ``bridge``: prefill and four decode steps against
``repro.models.transformer.forward`` within 1e-4, relative to each cache
leaf's scale.  The CUDA kernel runs only on a card
(tests/test_torch_gpu.py, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg                       # noqa: E402
from repro.core.queue import WorkQueue as JQueue                 # noqa: E402
from repro.kernels import ref as jref                            # noqa: E402
from repro.kernels.moe_gmm import gmm as jgmm                    # noqa: E402
from repro.launch.mesh import single_device_mesh                 # noqa: E402
from repro.models import moe as jmoe                             # noqa: E402
from repro.models import params as jpr                           # noqa: E402
from repro.models import transformer as jtfm                     # noqa: E402
from repro.models.layers import ModelCtx                         # noqa: E402
from repro.runtime import steps as jsteps                        # noqa: E402
from repro.serving.engine import ServingEngine as JEngine        # noqa: E402

from repro_torch import bridge                                   # noqa: E402
from repro_torch.configs import registry as treg                 # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.core.queue import WorkQueue as TQueue           # noqa: E402
from repro_torch.kernels import moe_gmm                          # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402
from repro_torch.models import moe as tmoe                       # noqa: E402
from repro_torch.models import params as tpr                     # noqa: E402
from repro_torch.models import transformer as ttfm               # noqa: E402
from repro_torch.runtime import steps as tsteps                  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.report import GAUGES                    # noqa: E402

ARCH = "granite-moe-1b-a400m"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x,
                                                                   np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _scaled(tol, want):
    """tol with atol scaled to the largest |value|."""
    return dict(rtol=tol, atol=tol * max(1.0, float(np.abs(_np(want)).max())))


def _cfgs(cf=None, **kw):
    """(JAX, port) granite smoke configs in f32, at capacity factor cf."""
    out = []
    for reg in (jreg, treg):
        cfg = reg.get_smoke(ARCH).replace(**F32, **kw)
        if cf is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=cf))
        out.append(cfg)
    return out


def _to_port(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

GMM_SHAPES = [(2, 128, 64, 128, 128, 128, 64),
              (4, 256, 128, 256, 128, 128, 128),
              (1, 128, 256, 128, 64, 64, 128)]   # tests/test_kernels.py:84-88


def _gmm_inputs(E, C, D, F, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            rng.standard_normal((E, D, F)).astype(np.float32))


@pytest.mark.parametrize("E,C,D,F,bc,bf,bd", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_pallas_interpret(E, C, D, F, bc, bf, bd, dtype):
    x, w = _gmm_inputs(E, C, D, F)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jgmm(jnp.asarray(x, jd), jnp.asarray(w, jd), block_c=bc,
                block_f=bf, block_d=bd, interpret=True)
    got = moe_gmm.gmm(_t(x).to(td), _t(w).to(td))
    assert got.dtype == td and got.shape == (E, C, F)
    tol = 5e-2 if dtype == "bfloat16" else 2e-3
    _close(got, want, dict(rtol=tol, atol=tol))


@pytest.mark.parametrize("E,C,D,F", [(3, 5, 24, 40), (32, 2, 72, 40),
                                     (1, 1, 72, 40), (2, 200, 24, 8),
                                     (2, 3, 200, 130)])
def test_gmm_plain_matches_at_ragged_shapes(E, C, D, F):
    """Ragged shapes, as the model's bucket capacities are (200 rows a
    prefill, 2 a decode step).  The Pallas kernel shrinks a block to a
    dimension below 128 and refuses a larger one that 128 does not divide;
    there the plain version is held against the JAX ``ref.gmm_ref``."""
    x, w = _gmm_inputs(E, C, D, F, seed=E + C)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    if any(n > 128 and n % 128 for n in (C, D, F)):
        with pytest.raises(AssertionError):
            jgmm(jx, jw, interpret=True)
        want = jref.gmm_ref(jx, jw)
    else:
        want = jgmm(jx, jw, interpret=True)
    _close(moe_gmm.gmm(_t(x), _t(w)), want, dict(rtol=1e-5, atol=1e-5))


def test_gmm_wrapper_takes_the_plain_path_on_cpu_tensors():
    x, w = _gmm_inputs(3, 7, 72, 40, seed=4)
    stacked = np.random.RandomState(5).standard_normal(
        (3, 3, 72, 40)).astype(np.float32)
    before = moe_gmm.launches
    got = moe_gmm.gmm(_t(x), _t(w))
    assert torch.equal(got, tref.gmm_ref(_t(x), _t(w)))
    # a group's slice of stacked (G,E,D,F) weights, and a strided one
    for ws in (_t(stacked)[1], _t(stacked)[:, 1]):
        torch.testing.assert_close(
            moe_gmm.gmm(_t(x), ws),
            torch.einsum("ecd,edf->ecf", _t(x), ws.contiguous()),
            rtol=1e-5, atol=1e-5)
    bf = moe_gmm.gmm(_t(x).bfloat16(), _t(w).bfloat16())
    assert bf.dtype == torch.bfloat16
    assert moe_gmm.launches == before          # no kernel on the CPU
    with pytest.raises(ValueError, match="does not match"):
        moe_gmm.gmm(_t(x), _t(w)[:, :10])
    with pytest.raises(ValueError, match=r"x \(E,C,D\)"):
        moe_gmm.gmm(_t(x)[0], _t(w))
    assert moe_gmm.gmm(_t(x)[:, :0], _t(w)).shape == (3, 0, 40)
    # rows that do not start on 16 bytes: only the card's kernel needs them
    xb, wb = _t(x).bfloat16()[:, :, 1:], _t(w).bfloat16()[:, 1:]
    assert torch.equal(moe_gmm.gmm(xb, wb),
                       tref.gmm_ref(xb.contiguous(), wb))


# ---------------------------------------------------------------------------
# MoE MLP
# ---------------------------------------------------------------------------

def _routed_case(routing, cf, seed=11):
    """(JAX cfg, port cfg, JAX layer params, port copy, x (1,T,D)) where
    the router sends token t to ``routing[t]`` (first choice first): the
    router reads the first E features, which hold each token's scores."""
    jcfg, tcfg = _cfgs(cf)
    E, D = jcfg.moe.num_experts, jcfg.d_model
    jp = jpr.init_params(jmoe.moe_schema(jcfg, 1), jax.random.key(seed),
                         "float32")
    gp = jax.tree.map(lambda a: np.asarray(a[0]), jp)
    router = np.zeros((D, E), np.float32)
    router[np.arange(E), np.arange(E)] = 20.0
    gp["router"] = router
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((1, len(routing), D)).astype(np.float32)
    x[0, :, :E] = -0.5
    for t, pair in enumerate(routing):
        for rank, e in enumerate(pair):
            x[0, t, e] = 1.0 - 0.2 * rank
    return jcfg, tcfg, gp, bridge.to_torch(gp, device="cpu"), x


# (a) T=8, K=2, E=4, cf 1.25: cap 20, cap_e 6; four entries an expert
UNIFORM = [[0, 1], [2, 3], [1, 2], [3, 0], [0, 2], [1, 3], [2, 0], [3, 1]]
# (b) cf 1.0: cap 16 (no padding rows), cap_e 4; expert 1 gets 7 entries
# (tokens 4, 5, 6 drop it), expert 2 exactly 4, expert 0 only 2
OVER = [[1, 2], [1, 3], [1, 2], [1, 0], [1, 2], [1, 3], [1, 2], [0, 3]]


@pytest.mark.parametrize("routing,cf", [(UNIFORM, 1.25), (OVER, 1.0)],
                         ids=["no_expert_full", "cf1_drops_in_order"])
def test_moe_mlp_matches_jax_f32(routing, cf):
    jcfg, tcfg, jgp, tgp, x = _routed_case(routing, cf)
    ctx = ModelCtx(jcfg, jreg.get_parallel(ARCH), None)
    jout, jaux = jmoe.moe_mlp(ctx, jgp, jnp.asarray(x))
    tout, taux = tmoe.moe_mlp(tcfg, tgp, _t(x))
    _close(tout, jout, TOL)
    _close(taux, jaux, TOL)
    # the routing is the intended one, and (b) really drops
    _, probs, top_idx = tmoe._routed(tcfg, tgp, _t(x))
    assert top_idx[0].tolist() == routing
    cap, cap_e = tmoe.capacities(len(routing), 2, 4, cf)
    counts = np.bincount(np.ravel(routing), minlength=4)
    assert (counts.max() > cap_e) == (cf == 1.0)


def test_moe_mlp_matches_jax_random_router():
    """The smoke init's own router at capacity factor 4.0 (no expert can
    fill), over two rows of seven tokens."""
    jcfg, tcfg = _cfgs(4.0)
    jp = jpr.init_params(jmoe.moe_schema(jcfg, 1), jax.random.key(0),
                         "float32")
    gp = jax.tree.map(lambda a: a[0], jp)
    x = np.random.RandomState(0).standard_normal((2, 7, 64)).astype(
        np.float32)
    ctx = ModelCtx(jcfg, jreg.get_parallel(ARCH), None)
    jout, jaux = jmoe.moe_mlp(ctx, gp, jnp.asarray(x))
    tout, taux = tmoe.moe_mlp(tcfg, _to_port(gp), _t(x))
    _close(tout, jout, TOL)
    _close(taux, jaux, TOL)


def _switch_ref(x, top_idx, top_w, wg, wu, wo, cf):
    """Per-token Switch routing in numpy: entry i = t*K + k is kept when
    i < cap and fewer than cap_e earlier entries chose its expert."""
    T, K = top_idx.shape
    E = wg.shape[0]
    cap = int(T * K * cf)
    cap_e = int(-(-cap // E) * cf)
    out = np.zeros_like(x, dtype=np.float64)
    seen = np.zeros(E, int)
    for i in range(min(T * K, cap)):
        t, k = divmod(i, K)
        e = top_idx[t, k]
        seen[e] += 1
        if seen[e] > cap_e:
            continue
        g, u = x[t] @ wg[e], x[t] @ wu[e]
        h = g / (1.0 + np.exp(-g)) * u
        out[t] += top_w[t, k] * (h @ wo[e])
    return out


@pytest.mark.parametrize("expert", [0, 1])
def test_jax_bucket_scatter_zeroes_expert0s_last_kept_token(expert):
    """E 4, K 2, T 4, cf 1.25: cap 10 > T*K = 8 (two padding rows) and
    cap_e 3.  Three tokens choose ``expert``: exactly its capacity, so
    nothing drops.  The JAX bucket scatter writes the padding rows as
    zeros onto ``bucket[0, cap_e - 1]`` after the real row: with expert 0
    full, token 2 loses its expert-0 term; the same load on expert 1 is
    exact.  The port keeps every kept entry, as the Switch reference does."""
    other = 1 - expert
    routing = np.array([[expert, other], [expert, 2], [expert, 3],
                        [other, 2]])
    rng = np.random.RandomState(12)
    T, K, E, D, F = 4, 2, 4, 16, 24
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (T, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    wg, wu = (rng.standard_normal((E, D, F)).astype(np.float32) / 4
              for _ in range(2))
    wo = rng.standard_normal((E, F, D)).astype(np.float32) / 5
    want = _switch_ref(x.astype(np.float64), routing, w, wg, wu, wo, 1.25)
    jout = np.asarray(jmoe._dispatch_compute_combine(
        jnp.asarray(x), jnp.asarray(routing, jnp.int32), jnp.asarray(w),
        jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wo), E=E, tp=1,
        cf=1.25, compute_dtype=jnp.float32))
    tout = tmoe._dispatch_compute_combine(
        _t(x), _t(routing), _t(w), _t(wg), _t(wu), _t(wo), E=E, cf=1.25,
        compute_dtype=torch.float32)
    assert tmoe.capacities(T, K, E, 1.25) == (10, 3)
    _close(tout, want, TOL)
    jerr = np.abs(jout - want).max(axis=1)
    if expert == 0:
        assert jerr[2] > 0.1 and np.all(jerr[[0, 1, 3]] < 1e-5)
        # what JAX computes for token 2 is the Switch output without its
        # expert-0 term
        g, u = x[2] @ wg[0], x[2] @ wu[0]
        term = w[2, 0] * ((g / (1 + np.exp(-g)) * u) @ wo[0])
        _close(jout[2], want[2] - term, TOL)
    else:
        assert np.all(jerr < 1e-5)


def test_dispatch_matches_jax_where_no_expert_fills_in_bf16():
    """bf16 buckets and products (the serving dtype): port and JAX agree
    within bf16 rounding where no bucket fills."""
    rng = np.random.RandomState(13)
    T, K, E, D, F = 6, 2, 4, 32, 48
    routing = np.array([[0, 1], [2, 3], [1, 2], [3, 0], [0, 2], [1, 3]])
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = np.full((T, K), 0.5, np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) / 4
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    jout = jmoe._dispatch_compute_combine(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(routing, jnp.int32),
        jnp.asarray(w), *(jnp.asarray(a, jnp.bfloat16) for a in ws), E=E,
        tp=1, cf=1.25, compute_dtype=jnp.bfloat16)
    tout = tmoe._dispatch_compute_combine(
        _t(x).bfloat16(), _t(routing), _t(w), *(_t(a).bfloat16() for a in ws),
        E=E, cf=1.25, compute_dtype=torch.bfloat16)
    assert tout.dtype == torch.bfloat16
    _close(tout, jout, dict(rtol=3e-2, atol=3e-2))


# ---------------------------------------------------------------------------
# block, whole model, config
# ---------------------------------------------------------------------------

def _jax_params(jcfg, seed=0, dtype="float32"):
    return jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(seed), dtype)


def test_config_schema_and_bridge_match_reference():
    for get in ("get_config", "get_smoke", "get_parallel"):
        assert dataclasses.asdict(getattr(treg, get)(ARCH)) == \
            dataclasses.asdict(getattr(jreg, get)(ARCH))
    assert ARCH in treg.ARCHS
    jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    for jschema, tschema in [
            (jtfm.lm_schema(jcfg), ttfm.lm_schema(tcfg)),
            (jtfm.cache_schema(jcfg, 4, 576), ttfm.cache_schema(tcfg, 4, 576))]:
        want = {k: (v.shape, v.init, v.scale, v.dtype)
                for k, v in jpr._leaves(jschema)}
        got = {k: (v.shape, v.init, v.scale, v.dtype)
               for k, v in tpr.leaves(tschema)}
        assert got == want
    n = tpr.param_count(ttfm.lm_schema(tcfg))
    assert n == jpr.param_count(jtfm.lm_schema(jcfg))
    assert 1.32e9 < n < 1.34e9
    # the router and expert leaves cross bit for bit, bf16 included
    jp = _jax_params(jreg.get_smoke(ARCH), seed=2, dtype="bfloat16")
    blk = jp["blocks"]["0_moe"]
    tp = _to_port(jp)["blocks"]["0_moe"]
    for name, shape in (("router", (1, 64, 4)), ("moe_wg", (1, 4, 64, 128)),
                        ("moe_wu", (1, 4, 64, 128)),
                        ("moe_wo", (1, 4, 128, 64))):
        assert tp[name].dtype == torch.bfloat16 and tp[name].shape == shape
        np.testing.assert_array_equal(
            tp[name].view(torch.int16).numpy().view(np.uint16),
            np.asarray(blk[name]).view(np.uint16))
        back = bridge.to_numpy(tp[name], like=blk[name])
        np.testing.assert_array_equal(back.view(np.uint16),
                                      np.asarray(blk[name]).view(np.uint16))


def test_block_prefill_and_decode_match_f32():
    jcfg, tcfg = _cfgs(4.0)
    ctx = ModelCtx(jcfg, jreg.get_parallel(ARCH), None)
    jp = _jax_params(jcfg, seed=5)
    jgp = jax.tree.map(lambda a: a[0], jp["blocks"]["0_moe"])
    tgp = _to_port(jgp)
    B, S = 2, 13
    x = np.random.RandomState(6).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    positions = np.arange(S, dtype=np.int32)
    jx, jc, _ = jmoe.apply_moe_block(
        ctx, jgp, jnp.asarray(x), mode="prefill",
        positions=jnp.asarray(positions), cache=None, pos=None, shared=None,
        extras=None)
    tx, tc = tmoe.apply_moe_block(tcfg, tgp, _t(x), mode="prefill",
                                  positions=_t(positions), cache=None,
                                  pos=None, shared=None)
    _close(tx, jx, dict(rtol=1e-4, atol=1e-4))
    for name in ("k", "v"):
        _close(tc[name], jc[name], dict(rtol=1e-4, atol=1e-4))

    rng = np.random.RandomState(7)
    cache = {n: rng.standard_normal((B, 16, jcfg.num_kv_heads,
                                     jcfg.resolved_head_dim)).astype(
                                         np.float32) for n in ("k", "v")}
    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([5, 11], np.int32)
    jx, jc, _ = jmoe.apply_moe_block(
        ctx, jgp, jnp.asarray(x1), mode="decode",
        positions=jnp.asarray(pos)[:, None],
        cache=jax.tree.map(jnp.asarray, cache), pos=jnp.asarray(pos),
        shared=None, extras=None)
    tcache = bridge.to_torch(cache, device="cpu")
    tx, _ = tmoe.apply_moe_block(tcfg, tgp, _t(x1), mode="decode",
                                 positions=_t(pos)[:, None], cache=tcache,
                                 pos=_t(pos), shared=None)
    _close(tx, jx, dict(rtol=1e-4, atol=1e-4))
    for name in ("k", "v"):
        _close(tcache[name], jc[name], dict(rtol=1e-4, atol=1e-4))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_model_prefill_and_decode_match_f32():
    """Two layers (G = 2) at capacity factor 4.0: no bucket can fill, so
    the JAX bucket fault (see the pinning test) cannot fire."""
    jcfg, tcfg = _cfgs(4.0, num_layers=2)
    assert tcfg.num_groups == 2
    ctx = ModelCtx(jcfg, jreg.get_parallel(ARCH), None)
    jp = _jax_params(jcfg)
    tp = _to_port(jp)
    P, steps = 11, 4
    rng = np.random.RandomState(9)
    toks = rng.randint(1, jcfg.vocab_size, (1, P))
    jx, jcache, _ = jtfm.forward(ctx, jp, jnp.asarray(toks, jnp.int32),
                                 mode="prefill")
    tx, tcache = ttfm.forward(tcfg, tp, _t(toks), mode="prefill")
    _close(ttfm.lm_logits(tcfg, tp, tx[:, -1:]),
           jtfm.lm_logits(ctx, jp, jx[:, -1:]), _scaled(1e-4, jx))
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(map(str, tl)) == sorted(map(str, jl))
    for path, leaf in jl.items():
        _close(tl[path], leaf, _scaled(1e-4, leaf))

    jbig = jsteps.cache_batch_insert(jsteps.init_cache(jcfg, 1, P + steps),
                                     jcache, 0)
    tbig = tsteps.cache_batch_insert(tsteps.init_cache(tcfg, 1, P + steps,
                                                       "cpu"), tcache, 0)
    for i in range(steps):
        tok = rng.randint(1, jcfg.vocab_size, (1, 1))
        jx, jbig, _ = jtfm.forward(ctx, jp, jnp.asarray(tok, jnp.int32),
                                   mode="decode", caches=jbig,
                                   pos=jnp.int32(P + i))
        tx, tbig = ttfm.forward(tcfg, tp, _t(tok), mode="decode",
                                caches=tbig, pos=P + i)
        want = jtfm.lm_logits(ctx, jp, jx)
        _close(ttfm.lm_logits(tcfg, tp, tx), want, _scaled(1e-4, want))
    jl, tl = _leaves(jbig), _leaves(tbig)
    for path, leaf in jl.items():
        _close(tl[path], leaf, _scaled(1e-4, leaf))


# ---------------------------------------------------------------------------
# serving engine and rules
# ---------------------------------------------------------------------------

def _requests(cfg, gens, seed=10, shared_prefix=0):
    rng = np.random.RandomState(seed)
    head = rng.randint(1, cfg.vocab_size, shared_prefix).tolist()
    return [{"id": i, "prompt": head + rng.randint(
        1, cfg.vocab_size, 8 - shared_prefix).tolist(), "max_new_tokens": g}
        for i, g in enumerate(gens)]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_greedy_tokens_equal_jax_engine(paged):
    """Two layers at capacity factor 4.0 (no bucket can fill: the JAX
    bucket fault cannot fire, see
    ``test_jax_bucket_scatter_zeroes_expert0s_last_kept_token``), so the
    routing is exact in both engines; five requests on two slots, slotted
    and paged."""
    jcfg, tcfg = _cfgs(4.0, num_layers=2)
    jp = _jax_params(jcfg, seed=1)
    kw = dict(num_slots=2, prompt_len=8, max_new_tokens=8, paged=paged)
    if paged:
        kw.update(block_size=4, prefix_cache=False)
    j = JEngine(jcfg, jreg.get_parallel(ARCH), single_device_mesh(),
                params=jp, **kw)
    t = TEngine(tcfg, device="cpu", params=_to_port(jp), **kw)
    assert j.paged == t.paged == paged
    gens = [6, 2, 4, 5, 3]
    reqs = _requests(jcfg, gens)
    r_j, _ = j.run(JQueue(reqs))
    r_t, _ = t.run(TQueue(reqs))
    assert r_t == r_j
    assert [len(r_t[i]) for i in range(len(gens))] == gens


def test_prefix_cache_replay_equals_jax_engine():
    """A shared prefix through one paged slot: later requests replay their
    suffix through the decode step (routed as decode batches); capacity
    factor 4.0, as above."""
    jcfg, tcfg = _cfgs(4.0, num_layers=2)
    jp = _jax_params(jcfg, seed=3)
    kw = dict(num_slots=1, prompt_len=8, max_new_tokens=8, paged=True,
              block_size=4, prefix_cache=True)
    j = JEngine(jcfg, jreg.get_parallel(ARCH), single_device_mesh(),
                params=jp, **kw)
    t = TEngine(tcfg, device="cpu", params=_to_port(jp), **kw)
    reqs = _requests(jcfg, [4, 4, 4], seed=3, shared_prefix=4)
    r_j, m_j = j.run(JQueue(reqs))
    r_t, m_t = t.run(TQueue(reqs))
    assert r_t == r_j
    assert m_t.summary()[GAUGES.PREFIX_HITS]["total"] == 2


def test_paged_equals_slotted_at_the_configs_capacity_factor():
    """cf 1.25 (buckets do fill and drop): the paged and slotted engines
    route the same batches, so their tokens are equal."""
    _, tcfg = _cfgs(None, num_layers=2)
    assert tcfg.moe.capacity_factor == 1.25
    params = tpr.init_params(ttfm.lm_schema(tcfg),
                             torch.Generator().manual_seed(4), "float32",
                             "cpu")
    reqs = _requests(tcfg, [6, 2, 7, 4, 5], seed=5)
    out = {}
    for paged in (False, True):
        eng = TEngine(tcfg, device="cpu", params=params, num_slots=3,
                      prompt_len=8, max_new_tokens=8, paged=paged,
                      block_size=4, prefix_cache=False)
        assert eng.paged == paged
        out[paged] = eng.run(TQueue(reqs))[0]
    assert out[True] == out[False]


def test_training_moe_runs():
    """The train forward keeps no cache, and a train step through the
    gmm Function's plain path gives finite metrics and moves the expert
    weights (tests/test_torch_train_families.py holds the values)."""
    cfg = treg.get_smoke(ARCH)
    params = tpr.init_params(ttfm.lm_schema(cfg), torch.Generator(),
                             cfg.param_dtype, "cpu")
    toks = torch.ones((1, 8), dtype=torch.long)
    x, caches = ttfm.forward(cfg, params, toks, mode="train")
    assert caches is None and x.shape == (1, 8, cfg.d_model)
    ocfg = OptimizerConfig()
    before = params["blocks"]["0_moe"]["moe_wg"].clone()
    params, _, m = tsteps.train_step(
        cfg, treg.get_parallel(ARCH), ocfg, params,
        tsteps.init_opt_state(cfg, ocfg, "cpu"),
        {"tokens": toks, "labels": toks}, device="cpu")
    assert all(torch.isfinite(v).all() for v in m.values())
    assert not torch.equal(params["blocks"]["0_moe"]["moe_wg"], before)
