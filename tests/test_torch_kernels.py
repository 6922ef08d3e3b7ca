"""The port's flash attention against the JAX Pallas kernel and the oracle.

On the CPU the port's wrapper runs its plain version (the oracle with KV
heads expanded); the JAX kernel runs in interpret mode, as
tests/test_kernels.py runs it, with KV heads repeated (it has no GQA).
Inputs come from numpy seeds.  Tolerances are tests/test_kernels.py's:
2e-5 for f32, 2e-2 for bf16.

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
    with pytest.raises(NotImplementedError, match="gemma2"):
        tattn.causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), window=4)
    with pytest.raises(NotImplementedError, match="gemma2"):
        tattn.causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), logit_softcap=50.0)


def test_cpu_path_does_not_count_launches():
    before = fa.launches
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 2, 2, 8, 8, 16))
    fa.flash_attention(q, k, v)
    assert fa.launches == before
