"""The port's recurrent-state families (Mamba2, zamba2, RWKV6) against JAX.

Kernel functions: the port's SSD and WKV6 wrappers take their plain
versions on CPU tensors (transcriptions of the JAX model's
``_ssd_chunked``/``_wkv_chunked``, with an initial state and the last state
returned); they are held against the JAX Pallas kernels run with
``interpret=True`` (zero initial state, y only, as tests/test_kernels.py
runs them) and against the step-by-step oracles of ``repro.kernels.ref``
(non-zero initial state, y and the last state).  Inputs come from numpy
seeds.  Tolerances are tests/test_kernels.py's: SSD 1e-4 and WKV6 2e-3 in
f32 (the chunked and the step-by-step forms sum the same terms in another
order, WKV6 through per-channel exps over a longer chain), 4e-2 / 5e-2 in
bf16 (inputs rounded to 8 bits of mantissa at different places); relative
to the values' scale where the state grows.

Blocks and whole models: smoke configs in f32 with JAX-made params carried
over by ``bridge``; prefill and decode against ``repro.models.ssm`` and
``repro.models.transformer.forward`` (``mesh=None``) within 1e-4 (f32 sums
in another order), relative to each cache leaf's scale in the whole
models: under the reference's init the shared attention's k/v reach
|20| at two groups, and the error grows with them.  The engine's greedy tokens must equal the JAX
engine's.  The CUDA kernels run only on a card (tests/test_torch_gpu.py,
``chip_smoke.py``).
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
from repro.kernels.ssm_scan import ssd_scan as jssd              # noqa: E402
from repro.kernels.wkv6 import wkv6 as jwkv                      # noqa: E402
from repro.launch.mesh import single_device_mesh                 # noqa: E402
from repro.models import params as jpr                           # noqa: E402
from repro.models import ssm as jssm                             # noqa: E402
from repro.models import transformer as jtfm                     # noqa: E402
from repro.models.layers import ModelCtx                         # noqa: E402
from repro.runtime import steps as jsteps                        # noqa: E402
from repro.serving.engine import ServingEngine as JEngine        # noqa: E402

from repro_torch import bridge                                   # noqa: E402
from repro_torch.configs import registry as treg                 # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.core.queue import WorkQueue as TQueue           # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402
from repro_torch.kernels import ssm_scan, wkv6                   # noqa: E402
from repro_torch.models import params as tpr                     # noqa: E402
from repro_torch.models import ssm as tssm                       # noqa: E402
from repro_torch.models import transformer as ttfm               # noqa: E402
from repro_torch.runtime import steps as tsteps                  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

ZAMBA, RWKV = "zamba2-2.7b", "rwkv6-1.6b"
ARCHS = (ZAMBA, RWKV)
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x,
                                                                   np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _scaled(tol, want):
    """tol with atol scaled to the largest |value| (states grow with S)."""
    return dict(rtol=tol, atol=tol * max(1.0, float(np.abs(_np(want)).max())))


# ---------------------------------------------------------------------------
# kernel functions
# ---------------------------------------------------------------------------

def _ssd_inputs(B, S, H, hd, N, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, hd, N)).astype(np.float32)
    return x, dt, a, Bm, Cm, h0


def _wkv_inputs(B, S, H, hd, seed=2):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.maximum(-np.exp(rng.standard_normal((B, S, H, hd))),
                      -8.0).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, s0


def _cast(arrs, dtype):
    """(JAX arrays, torch tensors) of ``arrs`` in ``dtype``."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.as_tensor(a).to(td) for a in arrs])


SSD_SHAPES = [(1, 64, 1, 16, 8, 16), (2, 128, 3, 32, 16, 32),
              (1, 256, 2, 64, 64, 128)]          # tests/test_kernels.py:41-59
WKV_SHAPES = [(1, 64, 1, 16, 16), (2, 128, 2, 32, 32),
              (1, 128, 4, 64, 64)]               # tests/test_kernels.py:62-81


@pytest.mark.parametrize("B,S,H,hd,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_interpret(B, S, H, hd, N, chunk, dtype):
    x, dt, a, Bm, Cm, _ = _ssd_inputs(B, S, H, hd, N)
    (jx, jB, jC), (tx, tB, tC) = _cast((x, Bm, Cm), dtype)
    want = jssd(jx, jnp.asarray(dt), jnp.asarray(a), jB, jC, chunk=chunk,
                interpret=True)
    _, h_want = jref.ssd_ref(jx, jnp.asarray(dt), jnp.asarray(a), jB, jC,
                             jnp.zeros((B, H, hd, N), jnp.float32))
    y, h = ssm_scan.ssd_scan(tx, _t(dt), _t(a), tB, tC, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    tol = 4e-2 if dtype == "bfloat16" else 1e-4
    _close(y, want, dict(rtol=tol, atol=tol))
    _close(h, h_want, _scaled(tol, h_want))


def test_jax_model_rounds_cb_to_bf16_and_the_port_does_not():
    """The JAX model's ``_ssd_chunked`` forms C.B in the compute dtype
    (``einsum(...).astype(f32)``), its Pallas kernel in f32.  In bf16 at
    N = 64 the model lands outside the kernel tolerance on some outputs;
    the port forms C.B in f32 like both kernels (ROADMAP queue C).  Both
    sides' y are compared after one rounding to bf16."""
    B, S, H, hd, N, chunk = SSD_SHAPES[-1]
    x, dt, a, Bm, Cm, _ = _ssd_inputs(B, S, H, hd, N)
    (jx, jB, jC), (tx, tB, tC) = _cast((x, Bm, Cm), "bfloat16")
    want = np.asarray(jssd(jx, jnp.asarray(dt), jnp.asarray(a), jB, jC,
                           chunk=chunk, interpret=True))
    y_model, _ = jssm._ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(a), jB,
                                   jC, jnp.zeros((B, H, hd, N)), chunk)
    y_port, _ = ssm_scan.ssd_scan(tx, _t(dt), _t(a), tB, tC, chunk=chunk)

    def outside(y):
        return int((np.abs(_np(y) - want) > 4e-2 + 4e-2 * np.abs(want)).sum())
    assert outside(y_model) > 0
    assert outside(y_port.to(torch.bfloat16)) == 0


@pytest.mark.parametrize("B,S,H,hd,N,chunk", SSD_SHAPES + [
    (2, 100, 3, 32, 16, 8),      # ragged: 8 does not divide 100
    (1, 5, 2, 16, 24, 8),        # S below one chunk, N != hd
])
def test_ssd_plain_matches_ref_with_initial_state(B, S, H, hd, N, chunk):
    x, dt, a, Bm, Cm, h0 = _ssd_inputs(B, S, H, hd, N, seed=3)
    y_want, h_want = jref.ssd_ref(*map(jnp.asarray, (x, dt, a, Bm, Cm, h0)))
    y, h = ssm_scan.ssd_scan(*map(_t, (x, dt, a, Bm, Cm, h0)), chunk=chunk)
    _close(y, y_want, _scaled(1e-4, y_want))
    _close(h, h_want, _scaled(1e-4, h_want))
    # the port's step-by-step oracle is the JAX one
    y_ref, h_ref = tref.ssd_ref(*map(_t, (x, dt, a, Bm, Cm, h0)))
    _close(y_ref, y_want, _scaled(1e-5, y_want))
    _close(h_ref, h_want, _scaled(1e-5, h_want))


@pytest.mark.parametrize("B,S,H,hd,chunk", WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plain_matches_pallas_interpret(B, S, H, hd, chunk, dtype):
    r, k, v, logw, u, _ = _wkv_inputs(B, S, H, hd)
    (jr, jk, jv), (tr, tk, tv) = _cast((r, k, v), dtype)
    want = jwkv(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u), chunk=chunk,
                interpret=True)
    _, s_want = jref.wkv6_ref(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u),
                              jnp.zeros((B, H, hd, hd), jnp.float32))
    y, s = wkv6.wkv6(tr, tk, tv, _t(logw), _t(u), chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    tol = 5e-2 if dtype == "bfloat16" else 2e-3
    _close(y, want, dict(rtol=tol, atol=tol))
    _close(s, s_want, _scaled(tol, s_want))


@pytest.mark.parametrize("B,S,H,hd,chunk", WKV_SHAPES + [
    (2, 100, 3, 16, 8),          # ragged: 8 does not divide 100
    (1, 5, 2, 16, 8),            # S below one chunk
])
@pytest.mark.parametrize("floor", [False, True])
def test_wkv6_plain_matches_ref_with_initial_state(B, S, H, hd, chunk, floor):
    r, k, v, logw, u, s0 = _wkv_inputs(B, S, H, hd, seed=4)
    if floor:                    # every decay at the model's -8 floor
        logw = np.full_like(logw, -8.0)
    y_want, s_want = jref.wkv6_ref(*map(jnp.asarray, (r, k, v, logw, u, s0)))
    y, s = wkv6.wkv6(*map(_t, (r, k, v, logw, u, s0)), chunk=chunk)
    _close(y, y_want, _scaled(2e-3, y_want))
    _close(s, s_want, _scaled(2e-3, s_want))
    y_ref, s_ref = tref.wkv6_ref(*map(_t, (r, k, v, logw, u, s0)))
    _close(y_ref, y_want, _scaled(1e-5, y_want))
    _close(s_ref, s_want, _scaled(1e-5, s_want))


def test_scan_wrappers_reject_what_the_kernels_do_not_take():
    x, dt, a, Bm, Cm, h0 = map(_t, _ssd_inputs(1, 8, 2, 16, 8))
    with pytest.raises(ValueError, match="h0"):
        ssm_scan.ssd_scan(x, dt, a, Bm, Cm, h0[:, :1])
    with pytest.raises(ValueError, match="do not match"):
        ssm_scan.ssd_scan(x, dt[:, :4], a, Bm, Cm)
    r, k, v, logw, u, s0 = map(_t, _wkv_inputs(1, 8, 2, 16))
    with pytest.raises(ValueError, match="u "):
        wkv6.wkv6(r, k, v, logw, u[:1])
    with pytest.raises(ValueError, match="differ"):
        wkv6.wkv6(r, k[:, :4], v, logw, u)


# ---------------------------------------------------------------------------
# the tensor-core scan kernels' arithmetic, in torch f32 on the CPU
# ---------------------------------------------------------------------------
# The bf16 tensor-core kernels' arithmetic.  csrc/ssm_scan.cu walks each
# (batch, head, slice of hd)'s 64-row chunks in one launch with the state in
# f32; csrc/wkv6.cu walks each (batch, head)'s 64-row chunks in one launch,
# its decays as products of w = exp(logw) factored about block and half
# boundaries, the state in f32.  Their products run on the tensor cores with
# f32 sums; every f32 operand goes in as a hi + lo pair of bf16.  The
# emulations below repeat that arithmetic (the split as roundings to bf16,
# the products as f32 matmuls) and are held against the plain versions at
# the kernels' tolerance, 1e-4 of the output's scale.  The kernels
# themselves run only on a card (tests/test_torch_gpu.py, chip_smoke.py).

TC_L, TC_SUB, TC_HALF = 64, 16, 8


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _parts(t, split):
    """t as the bf16 parts the kernel feeds the tensor cores: hi and lo
    ("hi+lo"), hi alone ("hi"), or t itself in f32 ("f32")."""
    if split == "f32":
        return [t]
    hi = _bf16(t)
    return [hi, _bf16(t - hi)] if split == "hi+lo" else [hi]


def _mm(eq, a, b, split_a, split_b):
    """einsum of a and b summed in f32 over the parts the kernel multiplies:
    against an exact operand every part, between two split ones all but
    lo lo."""
    pa, pb = _parts(a, split_a), _parts(b, split_b)
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(pa)
               for j, y in enumerate(pb) if i + j < 2)


def _pad_chunks(t, S):
    """(B, S, ...) zero-padded to whole 64-row chunks -> (B, nc, 64, ...)."""
    nc = -(-S // TC_L)
    pad = torch.zeros((t.shape[0], nc * TC_L - S) + t.shape[2:],
                      dtype=t.dtype)
    return torch.cat([t, pad], 1).reshape(t.shape[0], nc, TC_L, *t.shape[2:])


def _ssd_walk_emulated(x, dt, a, B_, C, h0, split="hi+lo", dsl=16):
    """ssd_fwd_walk's arithmetic: per slice of ``dsl`` columns of hd, the
    state H^T (N x dsl) carried in f32 through the 64-row chunks; per chunk
    S = C B^T (exact bf16 inputs), G = S exp(cum_t - cum_s) dt_s for s <= t
    (below the diagonal 16-row block as exp(cum_t - cum_r) exp(cum_r -
    cum_s) dt_s about r, the last row of s's block; on it masked before the
    exp), y = exp(cum_t) C H_in^T + G x, then H^T = exp(cum_end) H^T +
    B^T (w x) with w_s = exp(cum_end - cum_s) dt_s; G, H_in^T and w x are
    the operands split hi + lo."""
    Bsz, S, H, hd = x.shape
    xc, dtc, Bc, Cc = (_pad_chunks(t.float(), S) for t in (x, dt, B_, C))
    nc = xc.shape[1]
    cum = torch.cumsum(dtc * a, dim=2)                 # (B,nc,L,H)
    blk = torch.arange(TC_L) // TC_SUB
    below = (blk[:, None] > blk[None, :])[..., None]   # (t,s,1)
    diag = ((blk[:, None] == blk[None, :])
            & torch.ones(TC_L, TC_L, dtype=torch.bool).tril())[..., None]
    r = blk * TC_SUB + TC_SUB - 1                      # per column s
    h = (torch.zeros((Bsz, H, hd, B_.shape[-1])) if h0 is None
         else h0.float())
    ys, hs = [], []
    for d0 in range(0, hd, dsl):
        ht = h[:, :, d0:d0 + dsl].transpose(-1, -2)    # (B,H,N,dsl)
        y_slice = []
        for c in range(nc):
            cu, dtk = cum[:, c], dtc[:, c]             # (B,L,H)
            xs = xc[:, c, :, :, d0:d0 + dsl]           # (B,L,H,dsl)
            cb = torch.einsum("btn,bsn->bts", Cc[:, c], Bc[:, c])[..., None]
            cur = cu[:, r]                             # (B,s,H): cum_r
            u = torch.exp(torch.where(below, cu[:, :, None] - cur[:, None],
                                      float("-inf")))
            v = torch.exp(cur - cu) * dtk              # (B,s,H)
            on = torch.exp(torch.where(diag, cu[:, :, None] - cu[:, None],
                                       float("-inf"))) * dtk[:, None]
            G = cb * u * v[:, None] + cb * on          # (B,t,s,H)
            y = torch.exp(cu)[..., None] * _mm(
                "btn,bhnd->bthd", Cc[:, c], ht, "f32", split)
            y = y + _mm("btsh,bshd->bthd", G, xs, split, "f32")
            w = torch.exp(cu[:, -1:] - cu) * dtk
            ht = torch.exp(cu[:, -1])[..., None, None] * ht + _mm(
                "bsn,bshd->bhnd", Bc[:, c], w[..., None] * xs, "f32", split)
            y_slice.append(y)
        ys.append(torch.cat(y_slice, 1))
        hs.append(ht.transpose(-1, -2))
    return torch.cat(ys, -1)[:, :S], torch.cat(hs, 2)


def _wkv_walk_emulated(r, k, v, logw, u, s0, split="hi+lo", dsl=64):
    """wkv_fwd_walk's arithmetic: per slice of ``dsl`` columns of v, the
    state (hd_k x dsl) carried in f32 through the 64-row chunks; the decays
    as products of w = exp(logw), in 16-row blocks and their 8-row halves.
    att: the off-diagonal blocks (t in block i, s in an earlier block J) as
    (r P8 [WL] W_{J+1}..W_{i-1}) . (k Q), factored about the last row of
    s's block; the pairs across a block's halves as (r P8) . (k Q8) about
    the left half's last row; the pairs inside a half with the running
    product of w and the bonus r u k on the diagonal, exact in f32.  y =
    att v + q S_in, S_out = e_end S_in + kd^T v.  att, q, kd, the
    factored operands and S_in are split hi + lo as on the tensor cores."""
    B, S, H, hd = r.shape
    rc, kc, vc, wc = (_pad_chunks(t.float(), S) for t in (r, k, v, logw))
    nc = rc.shape[1]
    w = torch.exp(wc)                                  # (B,nc,L,H,hd)
    wh = w.reshape(B, nc, 8, TC_HALF, H, hd)           # the 8-row halves
    one = torch.ones_like(wh[:, :, :, :1])
    p8 = torch.cumprod(torch.cat([one, wh[:, :, :, :-1]], 3), 3)
    q8 = torch.cumprod(torch.cat([one, wh.flip(3)[:, :, :, :-1]], 3),
                       3).flip(3)
    Wh = torch.prod(wh, 3)                             # (B,nc,8,H,hd)
    Wb = Wh[:, :, 0::2] * Wh[:, :, 1::2]               # (B,nc,4,H,hd)
    p8, q8 = (t.reshape(B, nc, TC_L, H, hd) for t in (p8, q8))
    half = torch.arange(TC_L) // TC_HALF               # a row's half
    blk = torch.arange(TC_L) // TC_SUB
    right = (half % 2 == 1)[:, None, None]
    other = Wh[:, :, half ^ 1]                         # the block's other half
    one_r = torch.ones_like(other)
    pin = torch.where(right, other, one_r)             # P = WL P8 (right)
    qin = torch.where(right, one_r, other)             # Q = Q8 WR (left)
    apre = torch.stack([torch.prod(Wb[:, :, :b], 2) for b in range(4)], 2)
    asuf = torch.stack([torch.prod(Wb[:, :, b + 1:], 2) for b in range(4)], 2)
    rp8 = rc * p8
    q = rp8 * pin * apre[:, :, blk]
    kq = kc * q8 * qin                                 # k~ = k Q
    kd = kq * asuf[:, :, blk]
    eend = torch.prod(Wb, 2)                           # (B,nc,H,hd)
    att = torch.zeros(B, nc, TC_L, TC_L, H)
    for i in range(1, 4):                              # off the diagonal
        ti = slice(TC_SUB * i, TC_SUB * (i + 1))
        a_i = rp8[:, :, ti] * pin[:, :, ti]
        for J in range(i):
            g = torch.prod(Wb[:, :, J + 1:i], 2)[:, :, None]
            sj = slice(TC_SUB * J, TC_SUB * (J + 1))
            att[:, :, ti, sj] = _mm("bcthi,bcshi->bctsh", a_i * g,
                                    kq[:, :, sj], split, split)
    for b in range(4):                                 # across the halves
        tr = slice(TC_SUB * b + TC_HALF, TC_SUB * (b + 1))
        sl = slice(TC_SUB * b, TC_SUB * b + TC_HALF)
        att[:, :, tr, sl] = _mm("bcthi,bcshi->bctsh", rp8[:, :, tr],
                                kc[:, :, sl] * q8[:, :, sl], split, split)
    for hb in range(8):                                # inside a half
        base = TC_HALF * hb
        for t in range(TC_HALF):
            d = torch.ones_like(w[:, :, 0])
            for s in range(t - 1, -1, -1):
                att[:, :, base + t, base + s] = (
                    rc[:, :, base + t] * d * kc[:, :, base + s]).sum(-1)
                d = d * w[:, :, base + s]
            att[:, :, base + t, base + t] = (
                rc[:, :, base + t] * u.float() * kc[:, :, base + t]).sum(-1)
    state = torch.zeros((B, H, hd, hd)) if s0 is None else s0.float()
    ys, states = [], []
    for j0 in range(0, hd, dsl):
        st = state[..., j0:j0 + dsl]
        y_slice = []
        for c in range(nc):
            vs = vc[:, c, ..., j0:j0 + dsl]
            y = _mm("btsh,bshj->bthj", att[:, c], vs, split, "f32")
            y = y + _mm("bthi,bhij->bthj", q[:, c], st, split, split)
            st = eend[:, c][..., None] * st + _mm(
                "bshi,bshj->bhij", kd[:, c], vs, split, "f32")
            y_slice.append(y)
        ys.append(torch.cat(y_slice, 1))
        states.append(st)
    return torch.cat(ys, -1)[:, :S], torch.cat(states, -1)


def _within(got, want, rtol=1e-4):
    return float((got - want).abs().max()) <= rtol * max(
        1.0, float(want.abs().max()))


def _ssd_tc_case(B, S, H, hd, N, h0, seed=5):
    x, dt, a, Bm, Cm, s0 = _ssd_inputs(B, S, H, hd, N, seed=seed)
    (tx, tB, tC) = _cast((x, Bm, Cm), "bfloat16")[1]
    return tx, _t(dt), _t(a), tB, tC, _t(s0) if h0 else None


def _wkv_tc_case(B, S, H, hd, s0, floor, seed=6):
    r, k, v, logw, u, st = _wkv_inputs(B, S, H, hd, seed=seed)
    if floor:
        logw = np.full_like(logw, -8.0)
    tr, tk, tv = _cast((r, k, v), "bfloat16")[1]
    return tr, tk, tv, _t(logw), _t(u), _t(st) if s0 else None


SSD_TC_SHAPES = [
    (1, 128, 2, 16, 16, False),    # two whole chunks, zero state
    (2, 100, 3, 32, 16, True),     # ragged last chunk, N != hd, h0
    (1, 10, 2, 16, 32, True),      # S below one 16-row strip
    (1, 200, 2, 32, 48, True),     # S a multiple of neither 64 nor 16
]
WKV_TC_SHAPES = [
    (1, 128, 2, 16, False, False),
    (2, 100, 3, 16, True, False),  # ragged last chunk, s0
    (1, 10, 2, 32, True, False),   # S below one sub-chunk
    (1, 200, 2, 32, True, False),
    (1, 200, 2, 32, True, True),   # every decay at the model's -8 floor
    (1, 64, 1, 16, False, True),
]


SSD_WALK_CASES = [(shape, dsl) for shape in SSD_TC_SHAPES + [
    (1, 512, 2, 64, 64, True),     # zamba2's widths at two heads
    (1, 77, 2, 128, 128, True),    # the widest: two m64 tiles of the state
] for dsl in (16, 32) if shape[3] % dsl == 0]


@pytest.mark.parametrize("split", ["f32", "hi+lo"])
@pytest.mark.parametrize("shape,dsl", SSD_WALK_CASES)
def test_ssd_chunk_walk_matches_plain(shape, dsl, split):
    """csrc/ssm_scan.cu's walk over 64-row chunks, one slice of ``dsl``
    columns of hd at a time with the state in f32, its products exact
    ("f32") and with G, H_in^T and w x split hi + lo as on the tensor
    cores, is the plain version's scan within 1e-4 of scale."""
    args = _ssd_tc_case(*shape)
    want_y, want_h = ssm_scan.ssd_scan_plain(*args)
    y, h = _ssd_walk_emulated(*args, split=split, dsl=dsl)
    assert _within(y, want_y) and _within(h, want_h)


WKV_WALK_SHAPES = WKV_TC_SHAPES + [
    (1, 512, 2, 64, True, False),  # rwkv6's widths at two heads
    (1, 77, 2, 128, True, False),  # the widest: two 64-column slices
]


@pytest.mark.parametrize("split", ["f32", "hi+lo"])
@pytest.mark.parametrize("B,S,H,hd,s0,floor", WKV_WALK_SHAPES)
def test_wkv6_chunk_walk_matches_plain(B, S, H, hd, s0, floor, split):
    """csrc/wkv6.cu's walk over 64-row chunks, one 64-column slice of v at a
    time with the state in f32: the decays as products of w over 16-row
    blocks and 8-row halves, att off the diagonal blocks and across the
    halves as factored products, inside a half with the running product,
    its products exact ("f32") and with every f32 operand split hi + lo as
    on the tensor cores, is the plain version's scan within 1e-4 of scale;
    at the -8 floor the far products flush to 0 in f32 and it still
    holds."""
    args = _wkv_tc_case(B, S, H, hd, s0, floor)
    want_y, want_s = wkv6.wkv6_plain(*args)
    y, s = _wkv_walk_emulated(*args, split=split)
    assert _within(y, want_y) and _within(s, want_s)


def test_scan_f32_operands_need_the_hi_lo_split():
    """Why the kernels split their f32 operands: fed as one bf16 each (8
    bits of mantissa), G, w x, the decayed k and r, att, q, kd and the
    states move y past 1e-4 of its scale; hi + lo holds it (the tests
    above)."""
    args = _ssd_tc_case(1, 128, 2, 32, 32, True)
    want_y, _ = ssm_scan.ssd_scan_plain(*args)
    for dsl in (16, 32):
        assert not _within(_ssd_walk_emulated(*args, split="hi",
                                              dsl=dsl)[0], want_y)
        assert _within(_ssd_walk_emulated(*args, split="hi+lo",
                                          dsl=dsl)[0], want_y)
    args = _wkv_tc_case(1, 128, 2, 32, True, False)
    want_y, _ = wkv6.wkv6_plain(*args)
    assert not _within(_wkv_walk_emulated(*args, split="hi")[0], want_y)
    assert _within(_wkv_walk_emulated(*args, split="hi+lo")[0], want_y)


def test_scan_paths_follow_dtype_and_shape():
    """bf16 with widths that are multiples of 16 up to 128 takes the
    tensor-core kernels; f32, f16 and other widths the CUDA-core ones."""
    def ssd(dtype, hd, N):
        return ssm_scan.path(torch.zeros(1, 1, 1, hd, dtype=dtype),
                             torch.zeros(1, 1, N, dtype=dtype))

    assert ssd(torch.bfloat16, 64, 64) == "tensor-core"      # zamba2
    assert ssd(torch.bfloat16, 32, 16) == "tensor-core"
    assert ssd(torch.bfloat16, 128, 48) == "tensor-core"
    assert ssd(torch.bfloat16, 24, 48) == "cuda-core"
    assert ssd(torch.bfloat16, 64, 256) == "cuda-core"
    assert ssd(torch.float16, 64, 64) == "cuda-core"
    assert ssd(torch.float32, 64, 64) == "cuda-core"

    def wkv(dtype, hd):
        return wkv6.path(torch.zeros(1, 1, 1, hd, dtype=dtype))

    assert wkv(torch.bfloat16, 64) == "tensor-core"          # rwkv6
    assert wkv(torch.bfloat16, 16) == "tensor-core"
    assert wkv(torch.bfloat16, 128) == "tensor-core"
    assert wkv(torch.bfloat16, 40) == "cuda-core"
    assert wkv(torch.float16, 128) == "cuda-core"
    assert wkv(torch.float32, 64) == "cuda-core"


SMS = 132                 # an H100 SXM's SMs
BF = torch.bfloat16
# (B, S, H, hd, N) of the bf16 cases of chip_smoke.py's phase_ssd and of
# tests/test_torch_gpu.py's that take the Hopper path
WALK_SHAPES = [
    (1, 512, 80, 64, 64),      # zamba2's prefill
    (2, 1024, 80, 64, 64),     # its train forward
    (2, 100, 3, 32, 16), (1, 200, 4, 64, 64), (1, 10, 2, 64, 64),
    (2, 77, 3, 128, 128), (1, 130, 4, 16, 48), (2, 150, 4, 64, 32),
    (1, 1, 2, 64, 64), (1, 65, 2, 128, 16), (1, 64, 3, 16, 128),
    (1, 64, 80, 128, 128),     # hd and N 128 with an item for every SM
]


def _poisoned_views(B, S, H, hd, N, device="meta"):
    """x, B and C as the NaN-poisoned case cuts them: views into larger
    buffers (rows, heads and columns to spare on every side that the
    kernel must never read)."""
    xbuf = torch.empty((B, S + 3, H + 1, hd + 8), dtype=BF, device=device)
    bcbuf = torch.empty((B, S + 2, 3 * N + 8), dtype=BF, device=device)
    return (xbuf[:, 1:S + 1, 1:, :hd], bcbuf[:, 1:S + 1, 8:8 + N],
            bcbuf[:, 1:S + 1, 8 + 2 * N:8 + 3 * N])


@pytest.mark.parametrize("B,S,H,hd,N", WALK_SHAPES)
def test_ssd_walk_launch_geometry(B, S, H, hd, N):
    """The Hopper SSD kernel's launch as the wrapper computes it: a block
    per (column slice, head, batch), shared memory within a block's opt-in
    with two blocks an SM, tensor maps whose strides and box rows are
    16-byte multiples, on contiguous inputs and on the poisoned views."""
    x = torch.empty((B, S, H, hd), dtype=BF, device="meta")
    Bm = torch.empty((B, S, N), dtype=BF, device="meta")
    assert ssm_scan.path(x, Bm) == "tensor-core"
    geo = ssm_scan.walk_geometry(B, H, hd, N, SMS)
    dsl = geo["dsl"]
    assert dsl in (16, 32) and hd % dsl == 0
    assert geo["items"] == B * H * (hd // dsl)
    assert geo["grid"] == (min(geo["items"], 2 * SMS), 1, 1)
    assert geo["threads"] == ssm_scan.WALK_THREADS == 192
    assert geo["stages"] in (2, 3)
    assert geo["smem"] == ssm_scan.walk_smem_bytes(dsl, N, geo["stages"])
    assert geo["smem"] <= ssm_scan.BLOCK_SMEM_MAX == 232448
    assert 2 * (geo["smem"] + ssm_scan.BLOCK_SMEM_RESERVED) <= \
        ssm_scan.SM_SMEM
    for views in ((x, Bm, Bm), _poisoned_views(B, S, H, hd, N)):
        maps = ssm_scan.tma_geometry(*views, dsl)
        assert maps["x"][0] == (hd, H, S, B) and maps["B"][0] == (N, S, B)
        assert maps["x"][2] == (dsl, 1, 64, 1)
        assert maps["B"][2] == maps["C"][2] == (64, 64, 1)
        for dims, strides, box in maps.values():
            assert len(strides) == len(dims) - 1
            assert all(st > 0 and st % 16 == 0 for st in strides)
            assert box[0] * 2 in (32, 64, 128)


@pytest.mark.parametrize("B,H,hd,N,dsl,stages,blocks", [
    (1, 80, 64, 64, 32, 3, 160),    # zamba2's prefill: 160 items
    (2, 80, 64, 64, 32, 3, 264),    # its train forward: 320 items
    (1, 2, 64, 64, 16, 3, 8),       # too few items at 32: 16
    (1, 80, 128, 128, 16, 2, 264),  # N > 64: two m64 state tiles, 2 stages;
                                    # two blocks at 32 do not fit: 640 items
    (2, 3, 128, 128, 16, 2, 48),
    (1, 40, 48, 32, 16, 3, 120),    # hd 48: 32 does not divide it
])
def test_ssd_walk_geometry_rule(B, H, hd, N, dsl, stages, blocks):
    """The rule the source header states: dsl 32 where it divides hd,
    gives every SM an item and two such blocks fit an SM at two stages,
    else 16; three stages where two blocks fit an SM, else two; two blocks
    an SM, which take the items in turn."""
    geo = ssm_scan.walk_geometry(B, H, hd, N, SMS)
    assert (geo["dsl"], geo["stages"]) == (dsl, stages)
    assert geo["items"] == B * H * (hd // dsl)
    assert geo["grid"] == (blocks, 1, 1)


def test_ssd_walk_tma_geometry_names_the_stride_it_cannot_take():
    """A stride TMA cannot take is named (the wrapper asks once the C side
    has refused the launch); an axis of size 1 is never stepped, so its
    stride does not matter."""
    x = torch.empty((1, 8, 2, 68), dtype=BF, device="meta")[..., :64]
    Bm = torch.empty((1, 8, 16), dtype=BF, device="meta")
    with pytest.raises(ValueError, match=r"x\.stride\(2\) is 68"):
        ssm_scan.tma_geometry(x, Bm, Bm, 32)
    narrow = torch.empty((1, 8, 20), dtype=BF, device="meta")[..., :16]
    with pytest.raises(ValueError, match=r"C\.stride\(1\) is 20"):
        ssm_scan.tma_geometry(x[:, :, :, :64].contiguous(), Bm, narrow, 32)
    one_head = torch.empty((1, 8, 1, 72), dtype=BF, device="meta")[..., :64]
    maps = ssm_scan.tma_geometry(one_head, Bm, Bm, 32)
    assert maps["x"][1][:2] == (128, 144)   # heads: a packed 64-wide row


# clusters of n wkv_fwd_walk blocks (228,408 bytes of shared memory, one
# block an SM) that fit on an H100 80GB HBM3 at once, as
# cudaOccupancyMaxActiveClusters reports them on the card
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# (B, S, H, hd) of the bf16 cases of chip_smoke.py's phase_wkv and of
# tests/test_torch_gpu.py's that take the Hopper path
WKV_WALK_GEOMETRY = [
    (1, 512, 32, 64),      # rwkv6's prefill
    (2, 1024, 32, 64),     # its train forward
    (2, 100, 3, 16), (1, 200, 4, 64), (1, 10, 2, 64), (1, 77, 2, 128),
    (1, 100, 2, 128), (1, 1, 2, 64), (1, 63, 2, 64), (1, 64, 2, 64),
    (1, 65, 2, 64), (1, 150, 3, 32), (2, 300, 4, 128), (2, 150, 4, 64),
]


def _wkv_poisoned_views(B, S, H, hd, device="meta"):
    """r, k, v and logw as the NaN-poisoned case cuts them: views into
    larger buffers (rows, a head and columns to spare around them)."""
    bbuf = torch.empty((B, S + 3, H + 1, 3 * hd + 16), dtype=BF,
                       device=device)
    fbuf = torch.empty((B, S + 3, H + 1, hd + 16), device=device)
    return (bbuf[:, 1:S + 1, 1:, 8:8 + hd],
            bbuf[:, 1:S + 1, 1:, 8 + hd:8 + 2 * hd],
            bbuf[:, 1:S + 1, 1:, 8 + 2 * hd:8 + 3 * hd],
            fbuf[:, 1:S + 1, 1:, 4:4 + hd])


@pytest.mark.parametrize("B,S,H,hd", WKV_WALK_GEOMETRY)
def test_wkv6_walk_launch_geometry(B, S, H, hd):
    """The Hopper WKV6 kernel's launch as the wrapper computes it: a
    cluster of at most 8 blocks (and at most the chunks) a (batch, head)
    whose clusters all fit on the card at once, dividing the grid; shared
    memory within a block's opt-in; tensor maps whose strides and box rows
    are 16-byte multiples, on contiguous inputs and on poisoned views."""
    r = torch.empty((B, S, H, hd), dtype=BF, device="meta")
    logw = torch.empty((B, S, H, hd), device="meta")
    assert wkv6.path(r) == "tensor-core"
    geo = wkv6.walk_geometry(B, S, H, hd, H100_CLUSTERS.get)
    slices, cluster, items = -(-hd // 64), geo["cluster"], B * H
    assert geo["slices"] == slices and geo["dsl"] == 64
    assert 1 <= cluster <= min(8, -(-S // 64))
    assert cluster == 1 or H100_CLUSTERS[cluster] >= items
    assert geo["grid"] == (items * cluster, 1, 1)
    assert geo["grid"][0] % cluster == 0
    assert geo["threads"] == 384
    assert geo["stages"] == ((2, 2) if slices == 1 else (1, 1))
    assert geo["smem"] == wkv6.walk_smem_bytes(slices, *geo["stages"],
                                               cluster)
    assert geo["smem"] <= wkv6.BLOCK_SMEM_MAX == 232448
    for views in ((r, r, r, logw), _wkv_poisoned_views(B, S, H, hd)):
        maps = wkv6.tma_geometry(*views)
        for name, (dims, strides, box) in maps.items():
            item = 4 if name == "logw" else 2
            assert dims == (hd, H, S, B) and box == (64, 1, 64, 1)
            assert len(strides) == 3
            assert all(st > 0 and st % 16 == 0 for st in strides)
            assert box[0] * item % 16 == 0


@pytest.mark.parametrize("B,S,H,hd,cluster", [
    (1, 512, 32, 64, 3),    # rwkv6's prefill: 32 items, 30 fit at 4
    (2, 1024, 32, 64, 2),   # its train forward: 64 items, 66 fit at 2
    (1, 512, 2, 64, 8),     # few items: a block a chunk, 8 at most
    (1, 200, 2, 64, 4),     # at most the chunks
    (1, 10, 2, 64, 1),      # one chunk
    (1, 512, 2, 128, 1),    # two slices: one block walks every chunk
    (4, 512, 40, 64, 1),    # 160 items: no cluster size fits them all
])
def test_wkv6_walk_cluster_rule(B, S, H, hd, cluster):
    """The rule the source header states: the largest cluster, at most 8
    and at most the chunks, whose clusters all fit on the card at once; 1
    past hd 64."""
    geo = wkv6.walk_geometry(B, S, H, hd, H100_CLUSTERS.get)
    assert geo["cluster"] == cluster
    assert geo["grid"] == (B * H * cluster, 1, 1)


def test_wkv6_walk_tma_geometry_names_the_stride_it_cannot_take():
    """A stride TMA cannot take is named (the wrapper asks once the C side
    has refused the launch); an axis of size 1 is never stepped."""
    r = torch.empty((1, 8, 2, 68), dtype=BF, device="meta")[..., :64]
    logw = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match=r"r\.stride\(2\) is 68"):
        wkv6.tma_geometry(r, r, r, logw)
    ok = r.contiguous()
    odd = torch.empty((1, 8, 2, 66), device="meta")[..., :64]
    with pytest.raises(ValueError, match=r"logw\.stride\(2\) is 66"):
        wkv6.tma_geometry(ok, ok, ok, odd)
    one_head = torch.empty((1, 8, 1, 72), dtype=BF, device="meta")[..., :64]
    maps = wkv6.tma_geometry(one_head, one_head, one_head, logw[:, :, :1])
    assert maps["r"][1][:2] == (128, 144)   # heads: a packed 64-wide row


# ---------------------------------------------------------------------------
# configs, schemas, blocks
# ---------------------------------------------------------------------------

def _jax_params(jcfg, seed=0):
    return jpr.init_params(jtfm.lm_schema(jcfg), jax.random.key(seed),
                           jcfg.param_dtype)


def _to_port(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_schema_copies_match_reference(arch):
    assert dataclasses.asdict(treg.get_config(arch)) == dataclasses.asdict(
        jreg.get_config(arch))
    assert dataclasses.asdict(treg.get_smoke(arch)) == dataclasses.asdict(
        jreg.get_smoke(arch))
    assert dataclasses.asdict(treg.get_parallel(arch)) == dataclasses.asdict(
        jreg.get_parallel(arch))
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for jschema, tschema in [
            (jtfm.lm_schema(jcfg), ttfm.lm_schema(tcfg)),
            (jtfm.cache_schema(jcfg, 4, 576), ttfm.cache_schema(tcfg, 4, 576))]:
        want = {k: (v.shape, v.init, v.scale, v.dtype)
                for k, v in jpr._leaves(jschema)}
        got = {k: (v.shape, v.init, v.scale, v.dtype)
               for k, v in tpr.leaves(tschema)}
        assert got == want
    assert tpr.param_count(ttfm.lm_schema(tcfg)) == jpr.param_count(
        jtfm.lm_schema(jcfg))


def _block_setup(arch, key):
    """(jcfg, tcfg, JAX group-0 params of block ``key``, port copy, JAX
    shared params or None, port copy or None)."""
    jcfg = jreg.get_smoke(arch).replace(**F32)
    tcfg = treg.get_smoke(arch).replace(**F32)
    jp = _jax_params(jcfg, seed=5)
    gp = jax.tree.map(lambda a: a[0], jp["blocks"][key])
    shared = jp.get("shared_attn")
    return (jcfg, tcfg, gp, _to_port(gp), shared,
            None if shared is None else _to_port(shared))


def _random_cache(jcfg, key, B, S, seed):
    """Group 0 of a random (not all-zero) cache for block ``key``."""
    rng = np.random.RandomState(seed)
    schema = jtfm.cache_schema(jcfg, B, S)[key]
    return jpr.tree_map_schema(
        lambda _p, p: rng.standard_normal(p.shape[1:]).astype(np.float32),
        schema)


BLOCKS = [(ZAMBA, "0_mamba", jssm.apply_mamba, tssm.apply_mamba),
          (ZAMBA, "5_mamba_attn", jssm.apply_mamba_attn,
           tssm.apply_mamba_attn),
          (RWKV, "0_rwkv", jssm.apply_rwkv, tssm.apply_rwkv)]


@pytest.mark.parametrize("arch,key,japply,tapply", BLOCKS,
                         ids=[b[1] for b in BLOCKS])
def test_block_prefill_and_decode_match_f32(arch, key, japply, tapply):
    jcfg, tcfg, jgp, tgp, jsh, tsh = _block_setup(arch, key)
    ctx = ModelCtx(jcfg, jreg.get_parallel(arch), None)
    B, S = 2, 13                 # 13: not a multiple of the smoke chunk 8
    x = np.random.RandomState(6).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    positions = np.arange(S, dtype=np.int32)
    jx, jc, _ = japply(ctx, jgp, jnp.asarray(x), mode="prefill",
                       positions=jnp.asarray(positions), cache=None, pos=None,
                       shared=jsh, extras=None)
    tx, tc = tapply(tcfg, tgp, _t(x), mode="prefill",
                    positions=_t(positions), cache=None, pos=None, shared=tsh)
    _close(tx, jx, TOL)
    jleaves = dict(jax.tree_util.tree_leaves_with_path(jc))
    tleaves = dict(jax.tree_util.tree_leaves_with_path(tc))
    assert sorted(map(str, tleaves)) == sorted(map(str, jleaves))
    for path, leaf in jleaves.items():
        _close(tleaves[path], leaf, TOL)

    # decode one token against a random cache of 16 positions; slot 1 at
    # a later position than slot 0
    cache = _random_cache(jcfg, key, B, 16, seed=7)
    x1 = np.random.RandomState(8).standard_normal(
        (B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([5, 11], np.int32)
    jx, jc, _ = japply(ctx, jgp, jnp.asarray(x1), mode="decode",
                       positions=jnp.asarray(pos)[:, None],
                       cache=jax.tree.map(jnp.asarray, cache),
                       pos=jnp.asarray(pos), shared=jsh, extras=None)
    tcache = bridge.to_torch(cache, device="cpu")
    tx, tc = tapply(tcfg, tgp, _t(x1), mode="decode",
                    positions=_t(pos)[:, None], cache=tcache, pos=_t(pos),
                    shared=tsh)
    _close(tx, jx, TOL)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        got = dict(jax.tree_util.tree_leaves_with_path(tcache))[path]
        _close(got, leaf, TOL)       # written in place


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _model_cfgs(arch):
    kw = dict(F32)
    if arch == ZAMBA:
        kw["num_layers"] = 12    # two groups: the shared block runs twice
    return jreg.get_smoke(arch).replace(**kw), treg.get_smoke(arch).replace(
        **kw)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_and_decode_match_f32(arch):
    jcfg, tcfg = _model_cfgs(arch)
    ctx = ModelCtx(jcfg, jreg.get_parallel(arch), None)
    jp = _jax_params(jcfg)
    tp = _to_port(jp)
    P, steps = 11, 4
    rng = np.random.RandomState(9)
    toks = rng.randint(1, jcfg.vocab_size, (1, P))
    jx, jcache, _ = jtfm.forward(ctx, jp, jnp.asarray(toks, jnp.int32),
                                 mode="prefill")
    tx, tcache = ttfm.forward(tcfg, tp, _t(toks), mode="prefill")
    _close(ttfm.lm_logits(tcfg, tp, tx[:, -1:]),
           jtfm.lm_logits(ctx, jp, jx[:, -1:]), TOL)
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(map(str, tl)) == sorted(map(str, jl))
    for path, leaf in jl.items():
        _close(tl[path], leaf, _scaled(1e-4, leaf))

    # room for the decode steps, as the engine's slotted cache has
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
        _close(ttfm.lm_logits(tcfg, tp, tx), jtfm.lm_logits(ctx, jp, jx),
               TOL)
    jl, tl = _leaves(jbig), _leaves(tbig)
    for path, leaf in jl.items():
        _close(tl[path], leaf, _scaled(1e-4, leaf))


# ---------------------------------------------------------------------------
# serving engine and rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax_engine(arch):
    """3 requests with different stop lengths on 2 slots: one slot is
    reused, so a later prefill overwrites a whole state slot."""
    jcfg = jreg.get_smoke(arch).replace(**F32)
    tcfg = treg.get_smoke(arch).replace(**F32)
    jp = _jax_params(jcfg, seed=1)
    kw = dict(num_slots=2, prompt_len=8, max_new_tokens=6)
    j = JEngine(jcfg, jreg.get_parallel(arch), single_device_mesh(),
                params=jp, **kw)
    t = TEngine(tcfg, device="cpu", params=_to_port(jp), **kw)
    assert not j.paged and not t.paged
    rng = np.random.RandomState(10)
    gens = [6, 2, 4]
    reqs = [{"id": i, "prompt": rng.randint(1, jcfg.vocab_size, 8).tolist(),
             "max_new_tokens": g} for i, g in enumerate(gens)]
    r_j, _ = j.run(JQueue(reqs))
    r_t, _ = t.run(TQueue(reqs))
    assert r_t == r_j
    assert [len(r_t[i]) for i in range(len(gens))] == gens


@pytest.mark.parametrize("arch", ARCHS)
def test_state_caches_are_slotted_and_never_paged(arch):
    cfg = treg.get_smoke(arch)
    assert not tsteps.paged_compatible(cfg, 16, 8)
    assert jsteps.paged_compatible(jreg.get_smoke(arch), 16, 8) is False
    engine = TEngine(cfg, device="cpu", num_slots=2, prompt_len=8,
                     max_new_tokens=8)
    assert not engine.paged and engine.block_pool is None
    with pytest.raises(ValueError, match="cannot be paged"):
        TEngine(cfg, device="cpu", num_slots=2, prompt_len=8,
                max_new_tokens=8, paged=True)
    # state leaves stay f32 under bf16 params; an insert overwrites a slot
    caches = tsteps.init_cache(cfg, 2, 16, "cpu")
    states = {str(p): leaf for p, leaf in _leaves(caches).items()
              if "state" in str(p)}
    assert states and all(s.dtype == torch.float32 for s in states.values())
    src = jax.tree.map(lambda a: torch.ones_like(a[:, :1]), caches)
    tsteps.cache_batch_insert(caches, src, 1)
    for leaf in states.values():
        assert bool((leaf[:, 1] == 1).all()) and bool((leaf[:, 0] == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_training_these_kinds_runs(arch):
    """The train forward keeps no cache, and a train step through the scan
    Functions' plain paths gives finite metrics (zamba2's shared
    attention weights included among the leaves it moves;
    tests/test_torch_train_families.py holds the values)."""
    cfg = treg.get_smoke(arch)
    params = tpr.init_params(ttfm.lm_schema(cfg), torch.Generator(),
                             cfg.param_dtype, "cpu")
    toks = torch.ones((1, 8), dtype=torch.long)
    x, caches = ttfm.forward(cfg, params, toks, mode="train")
    assert caches is None and x.shape == (1, 8, cfg.d_model)
    ocfg = OptimizerConfig()
    before = {k: v.clone() for k, v in params.get("shared_attn", {}).items()}
    params, _, m = tsteps.train_step(
        cfg, treg.get_parallel(arch), ocfg, params,
        tsteps.init_opt_state(cfg, ocfg, "cpu"),
        {"tokens": toks, "labels": toks}, device="cpu")
    assert all(torch.isfinite(v).all() for v in m.values())
    assert all(not torch.equal(params["shared_attn"][k], v)
               for k, v in before.items() if k.startswith("w"))


def test_unported_kinds_still_raise():
    """Every block kind of the JAX package is ported (the VLM's "cross"
    last); a kind neither package has still raises, naming the kinds."""
    assert sorted(ttfm.KINDS) == sorted(jtfm.KINDS)
    tcfg = treg.get_smoke(ZAMBA).replace(block_pattern=("mamba", "conv"),
                                         num_layers=2)
    with pytest.raises(NotImplementedError, match="does not exist"):
        ttfm.lm_schema(tcfg)
