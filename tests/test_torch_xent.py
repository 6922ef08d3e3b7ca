"""The port's fused softmax-xent against the JAX Pallas kernel and the oracle.

On the CPU the port's ``softmax_xent`` runs the plain transcriptions of
its two CUDA kernels (forward and the custom backward); the JAX kernel runs
in interpret mode, as tests/test_kernels.py runs it, over the same cases:
ragged rows and vocab, V smaller than a tile, softcap, logits of +-1000.
Inputs come from numpy seeds.  Tolerances are tests/test_kernels.py's:
2e-5 on NLL values (f32 sums over V in another order), 1e-4 relative /
1e-5 absolute on gradients.

The CUDA kernels run only on a card: tests/test_torch_gpu.py and
``chip_smoke.py`` hold them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref                            # noqa: E402
from repro.kernels.xent import softmax_xent as jxent             # noqa: E402

from repro_torch.kernels import ref as tref                      # noqa: E402
from repro_torch.kernels import xent                             # noqa: E402

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _inputs(R, V, seed, scale=4.0):
    rng = np.random.RandomState(seed)
    logits = (scale * rng.standard_normal((R, V))).astype(np.float32)
    labels = rng.randint(0, V, (R,)).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("R,V,br,bv", [
    (128, 512, 128, 512),      # single tile both ways
    (256, 1024, 128, 256),     # multi-tile vocab sweep
    (100, 777, 64, 256),       # ragged rows AND vocab
    (32, 50, 32, 128),         # vocab smaller than one tile
])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_values_match_jax_kernel(R, V, br, bv, softcap):
    logits, labels = _inputs(R, V, seed=R + V)
    want = jxent(jnp.asarray(logits), jnp.asarray(labels), softcap=softcap,
                 block_r=br, block_v=bv, interpret=True)
    got = xent.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels),
                            softcap=softcap)
    assert got.shape == (R,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    oracle = tref.softmax_xent_ref(torch.as_tensor(logits),
                                   torch.as_tensor(labels), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **VAL)


@pytest.mark.parametrize("R,V,br,bv", [(96, 300, 64, 128),
                                       (100, 777, 64, 256),
                                       (32, 50, 32, 128)])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_grads_match_jax_grad(R, V, br, bv, softcap):
    """jax.grad through the Pallas custom_vjp against torch.autograd.grad
    through the port's autograd.Function, with a non-uniform cotangent."""
    logits, labels = _inputs(R, V, seed=7 * R + V)
    w = np.random.RandomState(3).uniform(0.5, 1.5, (R,)).astype(np.float32)
    g_jax = jax.grad(lambda x: jnp.sum(jnp.asarray(w) * jxent(
        x, jnp.asarray(labels), softcap=softcap, block_r=br, block_v=bv,
        interpret=True)))(jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_()
    nll = xent.softmax_xent(x, torch.as_tensor(labels), softcap=softcap)
    (g_port,) = torch.autograd.grad((torch.as_tensor(w) * nll).sum(), x)
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax), **GRAD)


def test_extreme_logits_stay_finite_and_match():
    logits = np.array([[1000.0, 0.0, -1000.0, 500.0]] * 8, np.float32)
    labels = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    want = jxent(jnp.asarray(logits), jnp.asarray(labels), block_r=8,
                 block_v=128, interpret=True)
    x = torch.as_tensor(logits).requires_grad_()
    got = xent.softmax_xent(x, torch.as_tensor(labels))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jref.softmax_xent_ref(jnp.asarray(logits),
                                         jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(got.sum(), x)
    assert torch.isfinite(g).all()


def test_label_outside_vocab_has_gold_zero():
    """As in the Pallas kernel: the gold logit of an out-of-range label is
    0, so its NLL is the row's lse."""
    logits, _ = _inputs(4, 40, seed=1)
    labels = np.array([-1, 40, 3, 1000], np.int32)
    want = jxent(jnp.asarray(logits), jnp.asarray(labels), block_r=4,
                 block_v=128, interpret=True)
    nll, lse = xent.xent_fwd(torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(nll.numpy(), np.asarray(want), **VAL)
    np.testing.assert_allclose(nll.numpy()[[0, 1, 3]], lse.numpy()[[0, 1, 3]])


def test_backward_keeps_the_logits_dtype():
    logits, labels = _inputs(16, 100, seed=2)
    x = torch.as_tensor(logits).to(torch.bfloat16).requires_grad_()
    nll = xent.softmax_xent(x, torch.as_tensor(labels))
    (g,) = torch.autograd.grad(nll.sum(), x)
    assert nll.dtype == torch.float32 and g.dtype == torch.bfloat16
    want = xent.xent_bwd_plain(x.detach(), torch.as_tensor(labels),
                               xent.xent_fwd_plain(x.detach(),
                                                   torch.as_tensor(labels))[1],
                               torch.ones(16))
    torch.testing.assert_close(g, want)


def test_wrapper_rejects_other_devices_and_bad_shapes():
    # meta takes the plain version (shapes only); any device but cpu,
    # cuda and meta raises: a fake xpu tensor stands in for one
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), pytest.raises(ValueError, match="cuda or cpu"):
        xent.xent_fwd(torch.zeros(2, 3, device="xpu"),
                      torch.zeros(2, dtype=torch.int32, device="xpu"))
    with pytest.raises(ValueError, match=r"\(R, V\)"):
        xent.softmax_xent(torch.zeros(2, 3), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="softcap"):
        xent.xent_fwd(torch.zeros(2, 3), torch.zeros(2, dtype=torch.int32),
                      softcap=0.0)
