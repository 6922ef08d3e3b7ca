"""The grouped matmul's occupied rows (``rows``) on the CPU, against JAX.

The MoE dispatch hands each of its three grouped matmuls ``rows``, the
count of every expert's kept entries: the reference's
``min(bincount(flat_e[:cap]), cap_e)`` (``repro/models/moe.py:95-98``, one
rank), computed here with ``jnp`` on the same ``top_idx`` for a routing
that fills an expert, one that fills none and one that cuts the exchange
buffer (cap < T*K); it also equals each bucket's count of nonzero rows.

``gmm_plain(x, w, rows)`` masks x and the output past ``rows`` with
``torch.where``; it is held against the JAX Pallas kernel (interpret
mode) on x with those rows zeroed, at tests/test_kernels.py's shapes (2e-3
in f32, 5e-2 in bf16: that file's tolerances).  NaN past the rows and in
an empty expert's weights stays out of the output and of both gradients
through ``gmm_train``; ``rows=None`` is the unmasked product bit for bit;
on ``meta`` tensors the shapes come out and the dry run's counted FLOPs
are those of the unmasked einsums.  The CUDA kernel's handling of ``rows``
runs only on a card (tests/test_torch_gpu.py, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.moe_gmm import gmm as jgmm                    # noqa: E402
from repro_torch.configs import registry as treg                 # noqa: E402
from repro_torch.configs.base import ShapeConfig                 # noqa: E402
from repro_torch.kernels import moe_gmm                          # noqa: E402
from repro_torch.kernels.ref import gmm_ref                      # noqa: E402
from repro_torch.launch import dryrun                            # noqa: E402
from repro_torch.models import moe as tmoe                       # noqa: E402


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _reference_rows(top_idx: np.ndarray, E: int, cf: float) -> np.ndarray:
    """The JAX model's per-expert kept count with tp = 1: its exchange
    buffer takes the first cap entries, its buckets cap_e of each."""
    TK = top_idx.size
    cap = int(-(-TK // 1) * cf)
    cap_e = int(-(-cap // E) * cf)
    flat_e = jnp.asarray(top_idx.reshape(TK))
    counts = jnp.bincount(flat_e[:cap], length=E)
    return np.asarray(jnp.minimum(counts, cap_e))


def _routing(kind: str, T: int, K: int, E: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    top = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
    if kind == "fills":              # half the tokens put expert 0 first
        top[: T // 2, 0] = 0
        top[: T // 2, 1:] = (np.arange(1, K)[None] + np.arange(T // 2)[:, None]
                             ) % (E - 1) + 1
    return top.astype(np.int64)


@pytest.mark.parametrize("kind,cf", [("fills", 1.0), ("none", 4.0),
                                     ("cut", 0.5)])
def test_dispatch_rows_equal_the_references_rule(kind, cf):
    T, K, E, D = 24, 2, 6, 8
    top = _routing(kind, T, K, E, seed=len(kind))
    cap, cap_e = tmoe.capacities(T, K, E, cf)
    want = _reference_rows(top, E, cf)
    if kind == "fills":
        assert want.max() == cap_e and np.bincount(top.ravel())[0] > cap_e
    elif kind == "none":
        assert want.max() < cap_e
    else:
        assert cap < T * K
    x2d = torch.as_tensor(np.random.RandomState(1).standard_normal(
        (T, D)).astype(np.float32)) + 10.0          # no zero rows
    bucket, row, kept, rows = tmoe._dispatch(
        x2d, torch.as_tensor(top), E=E, cf=cf, compute_dtype=torch.float32)
    assert rows.dtype == torch.int32 and rows.shape == (E,)
    np.testing.assert_array_equal(rows.numpy(), want)
    assert int(kept.sum()) == int(want.sum())
    # the kept entries fill each bucket's first rows, the rest are zeros
    nonzero = bucket.abs().sum(-1) != 0
    np.testing.assert_array_equal(nonzero.sum(1).numpy(), want)
    live = torch.arange(cap_e)[None, :] < rows[:, None]
    assert torch.equal(nonzero, live)


GMM_SHAPES = [(2, 128, 64, 128, 128, 128, 64),
              (4, 256, 128, 256, 128, 128, 128),
              (1, 128, 256, 128, 64, 64, 128)]   # tests/test_kernels.py:84-88


@pytest.mark.parametrize("E,C,D,F,bc,bf,bd", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_rows_match_pallas_interpret_on_masked_x(E, C, D, F, bc,
                                                           bf, bd, dtype):
    rng = np.random.RandomState(E + C)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    rows = rng.randint(0, C + 1, size=E).astype(np.int32)
    rows[0] = C // 3
    masked = np.where(np.arange(C)[None, :, None] < rows[:, None, None], x,
                      0.0).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jgmm(jnp.asarray(masked, jd), jnp.asarray(w, jd), block_c=bc,
                block_f=bf, block_d=bd, interpret=True)
    got = moe_gmm.gmm_plain(_t(x).to(td), _t(w).to(td), _t(rows))
    assert got.dtype == td and got.shape == (E, C, F)
    tol = 5e-2 if dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    past = np.arange(C)[None, :] >= rows[:, None]
    assert not got[torch.as_tensor(past)].any()


def test_nan_past_rows_and_in_empty_experts_stays_out():
    """x NaN past rows[e], w NaN for the empty expert: zero output rows
    there, and finite dx and dw through ``gmm_train`` (dx zero past the
    rows, dw zero for the empty expert); nothing launches on the CPU."""
    rng = np.random.RandomState(6)
    E, C, D, F = 3, 9, 16, 24
    x = _t(rng.standard_normal((E, C, D)).astype(np.float32))
    w = _t(rng.standard_normal((E, D, F)).astype(np.float32))
    dy = _t(rng.standard_normal((E, C, F)).astype(np.float32))
    rows = torch.tensor([4, 0, 9], dtype=torch.int32)
    x[0, 4:] = float("nan")
    x[1] = float("nan")
    w[1] = float("nan")
    before = moe_gmm.launches
    for fn in (moe_gmm.gmm, moe_gmm.gmm_plain):
        y = fn(x, w, rows)
        assert torch.isfinite(y).all()
        assert not y[0, 4:].any() and not y[1].any()
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = moe_gmm.gmm_train(xk, wk, rows)
    y.backward(dy)
    assert moe_gmm.launches == before
    assert torch.isfinite(y).all()
    assert torch.isfinite(xk.grad).all() and torch.isfinite(wk.grad).all()
    assert not xk.grad[0, 4:].any() and not xk.grad[1].any()
    assert not wk.grad[1].any()
    # the live rows are the unmasked product's
    want = gmm_ref(x[2:], w[2:])
    assert torch.equal(y[2:].detach(), want)
    torch.testing.assert_close(y[0, :4].detach(),
                               gmm_ref(x[:1, :4], w[:1])[0])


def test_rows_none_and_full_rows_equal_the_unmasked_product():
    rng = np.random.RandomState(7)
    x = _t(rng.standard_normal((4, 11, 24)).astype(np.float32)).bfloat16()
    w = _t(rng.standard_normal((4, 24, 40)).astype(np.float32)).bfloat16()
    want = gmm_ref(x, w)
    assert torch.equal(moe_gmm.gmm(x, w), want)
    assert torch.equal(moe_gmm.gmm(x, w, None), want)
    assert torch.equal(moe_gmm.gmm_plain(x, w), want)
    full = torch.full((4,), 11, dtype=torch.int32)
    assert torch.equal(moe_gmm.gmm(x, w, full), want)
    # values past C clamp to C, negative ones to 0, as the kernel's
    over = torch.tensor([11, 50, -3, 0], dtype=torch.int32)
    got = moe_gmm.gmm(x, w, over)
    assert torch.equal(got[:2], want[:2]) and not got[2:].any()


def test_rows_are_checked():
    x, w = torch.zeros(3, 5, 8), torch.zeros(3, 8, 4)
    for bad in (torch.zeros(3, dtype=torch.int64),
                torch.zeros(4, dtype=torch.int32),
                torch.zeros(3, 1, dtype=torch.int32),
                torch.zeros(6, dtype=torch.int32)[::2],
                torch.zeros(3, dtype=torch.int32, device="meta")):
        for fn in (moe_gmm.gmm, moe_gmm.gmm_plain, moe_gmm.gmm_train):
            with pytest.raises(ValueError, match="rows must be"):
                fn(x, w, bad)


def test_meta_shapes_and_counted_flops_are_the_unmasked_einsums():
    """On ``meta`` the wrapper and the Function give the shapes, and the
    counter sees the einsums alone: 2 E C D F for the product, three
    times that with the backward.  The dry run's granite-moe and kimi
    cells count what they count with the products unmasked."""
    from torch.utils.flop_counter import FlopCounterMode
    E, C, D, F = 4, 6, 8, 12
    x = torch.empty(E, C, D, device="meta", dtype=torch.bfloat16)
    w = torch.empty(E, D, F, device="meta", dtype=torch.bfloat16)
    rows = torch.empty(E, device="meta", dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter:
        y = moe_gmm.gmm(x, w, rows)
    assert y.shape == (E, C, F) and y.dtype == torch.bfloat16
    assert y.device.type == "meta"
    assert counter.get_total_flops() == 2 * E * C * D * F
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    with counter:
        moe_gmm.gmm_train(xk, wk, rows).backward(torch.empty_like(y))
    assert counter.get_total_flops() == 3 * 2 * E * C * D * F
    assert xk.grad.shape == x.shape and wk.grad.shape == w.shape

    def unmasked(x, w, rows=None):
        return gmm_ref(x, w)

    for arch, shape in (("granite-moe-1b-a400m", ShapeConfig("p", 512, 1,
                                                             "prefill")),
                        ("kimi-k2-1t-a32b", ShapeConfig("d", 1024, 4,
                                                        "decode"))):
        cfg, par = treg.get_config(arch), treg.get_parallel(arch)
        got, _ = dryrun.traced_flops(cfg, par, shape)
        mp = pytest.MonkeyPatch()
        mp.setattr(tmoe, "gmm", unmasked)
        try:
            want, _ = dryrun.traced_flops(cfg, par, shape)
        finally:
            mp.undo()
        assert got == want > 0, arch
