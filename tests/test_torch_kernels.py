"""The port's flash attention against the JAX Pallas kernel and the oracle.

On the CPU the port's wrapper runs its plain version (the JAX model's
attention with KV heads expanded: in f32 the oracle bit for bit; in bf16
it rounds the scores and P as the JAX model does); the JAX kernel runs in
interpret mode, as tests/test_kernels.py runs it, with KV heads repeated
(it has no GQA).  The window, the softcap and non-causal Sq != Sk are held
against the JAX model's own XLA functions (``_qchunk_attention``,
``_kchunk_flash``).  Inputs come from numpy seeds.  Tolerances are
tests/test_kernels.py's: 2e-5 for f32, 2e-2 for bf16.

The CUDA kernel itself runs only on a card: tests/test_torch_gpu.py holds
it against the plain version there, and so does ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref                            # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import flash_attention as fa            # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402
from repro_torch.models import attention as tattn                # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(B, H, KV, Sq, Sk, dh, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, H, Sq, dh)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, dh)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, dh)).astype(np.float32))


def _torch(x, dtype):
    return torch.as_tensor(x).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      np.asarray(x, np.float32))


@pytest.mark.parametrize("B,H,KV,S,dh", [
    (1, 2, 2, 128, 64),       # KV == H: exactly the Pallas kernel's case
    (2, 4, 2, 256, 32),       # GQA, groups of 2
    (1, 6, 2, 128, 128),      # phi4's head dim, groups of 3
    (1, 8, 1, 128, 112),      # kimi-k2's head dim, groups of 8
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_interpret(B, H, KV, S, dh, dtype, causal):
    q, k, v = _qkv(B, H, KV, S, S, dh)
    g = H // KV
    jd = getattr(jnp, dtype)
    want = jflash(jnp.asarray(q, jd), jnp.repeat(jnp.asarray(k, jd), g, 1),
                  jnp.repeat(jnp.asarray(v, jd), g, 1), causal=causal,
                  interpret=True)
    got = fa.flash_attention(_torch(q, dtype), _torch(k, dtype),
                             _torch(v, dtype), causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, S, dh)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("B,H,KV,Sq,Sk,dh,causal", [
    (1, 3, 1, 37, 37, 64, True),      # ragged: not a multiple of any tile
    (2, 4, 2, 100, 100, 16, False),
    (1, 4, 2, 48, 130, 32, True),     # Sq < Sk: bottom-right causal mask
    (1, 2, 2, 1, 77, 128, True),      # one query row against a history
    (1, 8, 1, 96, 130, 112, True),    # kimi-k2's head dim, ragged, Sq < Sk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_oracle_edge_shapes(B, H, KV, Sq, Sk, dh, causal, dtype):
    """Shapes the Pallas kernel refuses (ragged) or masks top-left
    (Sq < Sk): held against the oracle only."""
    q, k, v = _qkv(B, H, KV, Sq, Sk, dh, seed=1)
    g = H // KV
    jd = getattr(jnp, dtype)
    want = jref.attention_ref(jnp.asarray(q, jd),
                              jnp.repeat(jnp.asarray(k, jd), g, 1),
                              jnp.repeat(jnp.asarray(v, jd), g, 1),
                              causal=causal)
    got = fa.flash_attention(_torch(q, dtype), _torch(k, dtype),
                             _torch(v, dtype), causal=causal)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_torch_oracle_is_the_jax_oracle():
    q, k, v = _qkv(2, 3, 3, 40, 72, 32, seed=2)
    for causal in (True, False):
        want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
        got = tref.attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])


def test_gqa_head_h_reads_kv_head_h_div_groups():
    """Head h reads KV head h // (H // KV) — the JAX reshape of H into
    (KV, g) — not h % KV."""
    B, H, KV, S, dh = 1, 4, 2, 8, 16
    q, k, v = (torch.as_tensor(x) for x in _qkv(B, H, KV, S, S, dh, seed=3))
    out = fa.flash_attention(q, k, v, causal=True)
    for h in range(H):
        kvh = h // (H // KV)
        one = tref.attention_ref(q[:, h:h + 1], k[:, kvh:kvh + 1],
                                 v[:, kvh:kvh + 1], causal=True)
        torch.testing.assert_close(out[:, h:h + 1], one, rtol=0, atol=0)


def test_strided_model_layout_views():
    """The attention module passes (B,S,H,dh) tensors transposed: the
    wrapper takes the views as they are."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 4, 2, 24, 24, 32, seed=4))
    q_m, k_m, v_m = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = tattn.causal_attention(q_m, k_m, v_m)
    want = fa.attention_plain(q, k, v, causal=True).transpose(1, 2)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes_and_features():
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(q, k, v)
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="match"):
        fa.flash_attention(q, k[..., :8], v[..., :8])


def test_cpu_path_does_not_count_launches():
    before = fa.launches
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 2, 2, 8, 8, 16))
    fa.flash_attention(q, k, v)
    assert fa.launches == before


def _attention_p_rounded(q, k, v, dtype):
    """The oracle with the probabilities rounded to ``dtype`` before P V,
    as the tensor-core kernel (and the JAX model) rounds them."""
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1).float()
    v = v.repeat_interleave(g, dim=1).float()
    Sq, Sk, dh = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * dh ** -0.5
    mask = torch.ones((Sq, Sk), dtype=torch.bool).tril(diagonal=Sk - Sq)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_probability_rounding_stays_inside_the_card_tolerance(seed):
    """The oracle keeps P in f32.  At phi4's prefill shape (24/8 heads,
    S 512, dh 128, causal) rounding P to bf16 before P V moves the output
    by about one bf16 ulp of |2-4| outputs, inside the 2e-2 tolerance of
    the bf16 checks: the tensor-core kernel and its plain version may round
    P as the JAX model does."""
    q, k, v = (torch.as_tensor(x).bfloat16()
               for x in _qkv(1, 24, 8, 512, 512, 128, seed=seed))
    want = tref.attention_ref(q, k.repeat_interleave(3, dim=1),
                              v.repeat_interleave(3, dim=1), causal=True)
    got = _attention_p_rounded(q, k, v, torch.bfloat16)
    gap = (got.float() - want.float()).abs().max().item()
    assert 0 < gap <= 2e-2


@pytest.mark.parametrize("make,message", [
    (lambda: torch.zeros(4, 8, 72, dtype=torch.bfloat16), None),
    (lambda: torch.zeros(4, 8, 80, dtype=torch.bfloat16)[:, :, :72], None),
    (lambda: torch.zeros(1, 3, 36, dtype=torch.bfloat16)[:, :1], None),
    (lambda: torch.zeros(4, 8, 44, dtype=torch.bfloat16)[:, :, :40],
     r"t\.stride\(1\) is 44 elements \(88 bytes\)"),
    (lambda: torch.zeros(1, 3, 36, dtype=torch.float16),
     r"t\.stride\(1\) is 36 elements \(72 bytes\)"),
    (lambda: torch.zeros(3, 1, 36, dtype=torch.bfloat16),
     r"t\.stride\(0\) is 36 elements"),
    (lambda: torch.zeros(4, 8, 72, dtype=torch.bfloat16)[:, :, 1:],
     r"t's data pointer is 2 bytes past"),
    (lambda: torch.zeros(2, 6, 64, 68, dtype=torch.bfloat16)[..., :64],
     r"t\.stride\(2\) is 68"),
])
def test_require_aligned16_names_the_stride(make, message):
    """The f16/bf16 kernels' 16-byte copies need every row to start on 16
    bytes; the check skips axes of size 1, whose stride is never used."""
    from repro_torch.kernels import build
    t = make()
    if message is None:
        build.require_aligned16("t", t)
    else:
        with pytest.raises(ValueError, match=message):
            build.require_aligned16("t", t)


def test_cpu_path_takes_unaligned_bf16_views():
    """Only the card's kernel needs aligned rows: on the CPU the wrapper
    runs the plain version on any view."""
    q, k, v = (torch.as_tensor(x).bfloat16()
               for x in _qkv(1, 4, 2, 24, 24, 68, seed=6))
    got = fa.flash_attention(q[..., :64], k[..., :64], v[..., :64])
    want = fa.attention_plain(q[..., :64].contiguous(),
                              k[..., :64].contiguous(),
                              v[..., :64].contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _jax_model_attention(q, k, v, *, window, cap, causal, dtype, chunked):
    """The JAX model's XLA attention on (B,H,S,dh) / (B,KV,S,dh) inputs:
    ``_qchunk_attention`` (q chunks of 16) or ``_kchunk_flash`` (k chunks
    of 8), back in the kernel's layout."""
    from repro.models import attention as jattn
    B, H, Sq, dh = q.shape
    KV = k.shape[1]
    jd = getattr(jnp, dtype)
    qr = jnp.asarray(q, jd).transpose(0, 2, 1, 3).reshape(B, Sq, KV, H // KV,
                                                          dh)
    kk = jnp.asarray(k, jd).transpose(0, 2, 1, 3)
    vv = jnp.asarray(v, jd).transpose(0, 2, 1, 3)
    fn = jattn._qchunk_attention if chunked == "q" else jattn._kchunk_flash
    out = fn(qr, kk, vv, scale=dh ** -0.5, window=window, cap=cap,
             chunk=16 if chunked == "q" else 8, causal=causal)
    return np.asarray(out.reshape(B, Sq, H, dh).transpose(0, 2, 1, 3),
                      np.float32)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,dh,window,cap,causal", [
    (1, 4, 2, 48, 48, 16, 8, 2.0, True),       # gemma2 local, shrunk
    (2, 4, 2, 40, 40, 32, 8, None, True),      # window alone
    (1, 4, 4, 48, 48, 16, None, 2.0, True),    # softcap alone (global)
    (1, 6, 3, 64, 64, 32, 200, 2.0, True),     # window past the sequence
    (1, 4, 2, 24, 40, 16, None, None, False),  # cross: Sq < Sk, unmasked
    (2, 4, 4, 40, 16, 16, None, 2.0, False),   # Sq > Sk, unmasked, capped
    (1, 4, 2, 32, 32, 16, 8, None, False),     # a window without causal: none
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunked", ["q", "k"])
def test_window_softcap_and_cross_match_the_jax_model(
        B, H, KV, Sq, Sk, dh, window, cap, causal, dtype, chunked):
    """Where Sq == Sk or nothing is masked, the JAX model's top-left mask
    and the port's bottom-right one coincide.  Under a softcap q is scaled
    by 4 so that the cap of 2 bites (it bounds the scores, so the JAX
    model's rounding of q k^T to bf16 stays small against it)."""
    q, k, v = _qkv(B, H, KV, Sq, Sk, dh, seed=Sq + Sk)
    if cap is not None:
        q = 4.0 * q
    want = _jax_model_attention(q, k, v, window=window, cap=cap,
                                causal=causal, dtype=dtype, chunked=chunked)
    got = fa.flash_attention(_torch(q, dtype), _torch(k, dtype),
                             _torch(v, dtype), causal=causal, window=window,
                             softcap=cap)
    np.testing.assert_allclose(_f32(got), want, **TOL[dtype])
    model = tattn.causal_attention(
        _torch(q, dtype).transpose(1, 2), _torch(k, dtype).transpose(1, 2),
        _torch(v, dtype).transpose(1, 2), window=window, logit_softcap=cap,
        causal=causal).transpose(1, 2)
    torch.testing.assert_close(model, got, rtol=0, atol=0)


@pytest.mark.parametrize("Sq,Sk,window", [(5, 13, 4), (13, 5, 3), (9, 9, 1)])
def test_window_is_bottom_right_aligned(Sq, Sk, window):
    """Key j is visible to query i iff i + d - w < j <= i + d, d = Sk - Sq
    (a row with i + d < 0 sees nothing and averages v): the plain version
    against a row-by-row numpy softmax."""
    q, k, v = _qkv(1, 2, 2, Sq, Sk, 8, seed=9)
    got = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), window=window).numpy()
    d = Sk - Sq
    for h in range(2):
        for i in range(Sq):
            vis = [j for j in range(Sk) if i + d - window < j <= i + d]
            s = (k[0, h] @ q[0, h, i]) * 8 ** -0.5
            w = np.zeros(Sk)
            if vis:
                e = np.exp(s[vis] - s[vis].max())
                w[vis] = e / e.sum()
            else:
                w[:] = 1.0 / Sk
            np.testing.assert_allclose(got[0, h, i], w @ v[0, h], rtol=1e-5,
                                       atol=1e-5)


def test_window_and_softcap_are_checked():
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 2, 2, 8, 8, 16))
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="window"):
            fa.flash_attention(q, k, v, window=bad)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="softcap"):
            fa.flash_attention(q, k, v, softcap=bad)
    assert 256 in fa.HEAD_DIMS
