"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device, so the CPU suite
counts none of them.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports nothing of JAX, so it runs where only PyTorch is
installed.  Tolerances: flash attention 2e-5 for f32 (the same products
summed in another order), 2e-2 for f16/bf16 (one rounding of the output);
xent 1e-4 on NLL (f32 sums over V in another order) and 1e-5 (f32) or
2^-7 (bf16) on dlogits; AdamW 1e-6 on f32 (each step rounded as the plain
version rounds it) and 2^-7 relative on a bf16 parameter; the SSD and
WKV6 scans 1e-4 of the output's scale on both paths (kernel and plain
version compute in f32 from the same inputs, chunked differently: the sums
run in another order; the bf16 tensor-core path feeds its f32 operands as
hi + lo pairs of bf16, about 2^-17 of each value); the grouped matmul 1e-5 of the output's scale in f32 (sums over D
in another order) and 2^-7 of it in f16/bf16 (one rounding of the output,
which a different f32 sum can push across a rounding boundary).  In
f16/bf16 the flash kernel also rounds P to the input type before P V, as
the JAX model does; tests/test_torch_kernels.py shows on the CPU that the
2e-2 tolerance covers that rounding at phi4's prefill shape.  The
training runtime: a crash-and-resume run on the card against a clean one,
1e-5 relative on the losses (f32; the embedding's grad may be summed in
another order), and checkpoints restored onto the card bit for bit.  The
router and RL slice: flash at the static batcher's B=4 prefill (2e-2, as
above), the xent backward with the RL learner's dy (zeros and negative
values; 1e-5 in f32, and exactly 0 on the rows whose dy is 0), and an RL
fleet on the card launching each kernel where its path says.  The workload
API: a smoke ServeJob (f32) through a Session on the card's ``Cluster()``
gives the greedy tokens of a CPU Session's, with flash in every prefill.
CONNECT: the FFN's forward and flood fill on the card within 1e-4 of the
output's scale of the CPU's (f32 with TF32 off), ``connect_label`` equal
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw_update as au               # noqa: E402
from repro_torch.kernels import flash_attention as fa            # noqa: E402
from repro_torch.kernels import moe_gmm, ssm_scan, wkv6, xent    # noqa: E402


def _qkv(B, H, KV, Sq, Sk, dh, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, H, Sq, dh)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, dh)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, dh)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dt = getattr(torch, dtype)
    for (B, H, KV, Sq, Sk, dh, causal) in [(1, 24, 8, 512, 512, 128, True),
                                           (1, 32, 32, 512, 512, 80, True),
                                           (2, 4, 2, 100, 100, 64, False),
                                           (1, 4, 4, 48, 130, 32, True)]:
        q, k, v = (torch.as_tensor(x).to("cuda", dt)
                   for x in _qkv(B, H, KV, Sq, Sk, dh, seed=5))
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        want = fa.attention_plain(q, k, v, causal=causal)
        tol = 2e-5 if dtype == "float32" else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal", [
    (1, 4, 2, 130, 130, True),     # ragged last q and k tile, GQA
    (2, 4, 2, 100, 100, False),    # full attention, two batches
    (1, 4, 4, 48, 130, True),      # Sq < Sk (bottom-right mask), KV == H
    (1, 4, 2, 130, 48, True),      # Sq > Sk: the first rows see no key
    (1, 6, 3, 1, 77, True),        # one query row
])
def test_flash_tensor_core_path_every_head_dim(B, H, KV, Sq, Sk, causal, dh,
                                               dtype):
    _card()
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(x).to("cuda", dt)
               for x in _qkv(B, H, KV, Sq, Sk, dh, seed=Sq + Sk + dh))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dt
    want = fa.attention_plain(q, k, v, causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_flash_at_the_static_batchers_b4_prefill():
    """phi4's heads at S 512 with B=4, bf16: the static batcher's prefill."""
    _card()
    q, k, v = (torch.as_tensor(x).to("cuda", torch.bfloat16)
               for x in _qkv(4, 24, 8, 512, 512, 128, seed=4))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.attention_plain(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_wrappers_raise_on_unaligned_16bit_views():
    """The f16/bf16 kernels copy 16-byte chunks: a view whose rows do not
    start on 16 bytes is refused, naming the stride, and launches
    nothing; the f32 kernels take it."""
    _card()
    bf = torch.bfloat16
    x = torch.randn(4, 8, 72, device="cuda").to(bf)
    w = torch.randn(4, 72, 44, device="cuda").to(bf)
    q = torch.randn(1, 4, 64, 68, device="cuda").to(bf)
    kv = torch.randn(1, 2, 64, 64, device="cuda").to(bf)
    before = (moe_gmm.launches, fa.launches)
    with pytest.raises(ValueError, match=r"w\.stride\(1\) is 44"):
        moe_gmm.gmm(x, w[:, :, :40])             # 88-byte rows
    with pytest.raises(ValueError, match="x's data pointer"):
        moe_gmm.gmm(x[:, :, 1:65], w[:, :64, :40].contiguous())
    with pytest.raises(ValueError, match=r"q\.stride\(2\) is 68"):
        fa.flash_attention(q[..., :64], kv, kv)   # 136-byte rows
    assert (moe_gmm.launches, fa.launches) == before
    got = moe_gmm.gmm(x.float(), w[:, :, :40].float())
    want = moe_gmm.gmm_plain(x.float(), w[:, :, :40].float())
    assert moe_gmm.launches == before[0] + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("R,V,softcap,dtype", [
    (1024, 200_064, None, "float32"),     # the train phase's loss chunk
    (100, 777, None, "float32"),          # ragged rows and vocab
    (32, 50, 30.0, "float32"),            # V below one block, softcap
    (64, 1000, None, "bfloat16"),
])
def test_xent_kernels_match_plain(R, V, softcap, dtype):
    _card()
    rng = np.random.RandomState(R + V)
    dt = getattr(torch, dtype)
    logits = torch.as_tensor(4 * rng.standard_normal((R, V)).astype(
        np.float32)).to("cuda", dt)
    labels = torch.as_tensor(rng.randint(0, V, (R,)).astype(np.int32),
                             device="cuda")
    dy = torch.as_tensor(rng.standard_normal(R).astype(np.float32),
                         device="cuda")
    before = (xent.fwd_launches, xent.bwd_launches)
    nll, lse = xent.xent_fwd(logits, labels, softcap)
    d = xent.xent_bwd(logits, labels, lse, dy, softcap)
    torch.cuda.synchronize()
    assert (xent.fwd_launches, xent.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    want_nll, want_lse = xent.xent_fwd_plain(logits, labels, softcap)
    want_d = xent.xent_bwd_plain(logits, labels, lse, dy, softcap)
    torch.testing.assert_close(nll, want_nll, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-4)
    assert d.dtype == dt
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(d.float(), want_d.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_xent_backward_with_the_rl_learners_dy():
    """8 rollouts of 256 positions: dy = mask * advantage / sum(mask), 0 on
    prompt rows and on a rollout whose advantage is 0, negative where the
    advantage is; against the plain version, zero rows exactly zero."""
    _card()
    R, V = 8 * 256, 200_064
    rng = np.random.RandomState(18)
    logits = torch.as_tensor(4 * rng.standard_normal((R, V)).astype(
        np.float32), device="cuda")
    labels = torch.as_tensor(rng.randint(0, V, (R,)).astype(np.int32),
                             device="cuda")
    mask = np.zeros((8, 256), np.float32)
    mask[:, 127:255] = 1.0
    adv = rng.standard_normal(8).astype(np.float32)
    adv[3] = 0.0
    dy = torch.as_tensor((mask * adv[:, None] / mask.sum()).reshape(-1),
                         device="cuda")
    _, lse = xent.xent_fwd(logits, labels)
    d = xent.xent_bwd(logits, labels, lse, dy)
    want = xent.xent_bwd_plain(logits, labels, lse, dy)
    assert bool((dy < 0).any()) and bool((dy == 0).any())
    assert not d[dy == 0].any()
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_rl_fleet_on_the_card_launches_each_kernel_on_its_path(tmp_path):
    """phi4 smoke through ``run_rl_fleet`` on the card: the learner's 2
    steps launch xent forward and backward once each a step and AdamW
    once a leaf; every actor prefill launches flash once a layer."""
    _card()
    from repro_torch.api.resources import RLJob
    from repro_torch.api.runners import rl_pieces, run_rl_fleet
    from repro_torch.core.metrics import Registry
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.serving.report import GAUGES
    job = RLJob(name="rl-card", learner_steps=2, rollouts_per_step=2,
                prompt_len=8, max_new_tokens=8, seq_len=16, slots=2,
                broadcast_every=1, ckpt_every=0)
    before = (xent.fwd_launches, xent.bwd_launches, au.launches,
              fa.launches)
    out = run_rl_fleet(None, job, learner_store=ObjectStore(str(tmp_path)),
                       metrics=Registry())
    assert out["done"] and out["min_actor_syncs"] >= 1
    prefills = sum(m.series(GAUGES.PREFILL_S).stats()["count"]
                   for m in out["actor_metrics"].values())
    ran = (xent.fwd_launches - before[0], xent.bwd_launches - before[1],
           au.launches - before[2], fa.launches - before[3])
    layers = rl_pieces(job)[0].num_layers
    assert ran == (2, 2, 2 * 11, layers * prefills)


@pytest.mark.gpu
@pytest.mark.parametrize("n,pdtype,gdtype,wd", [
    (1_000_003, "float32", "float32", 0.1),
    (1_000_003, "bfloat16", "bfloat16", 0.0),
    (4096, "bfloat16", "float32", 0.1),
    (5, "float32", "bfloat16", 0.1),
])
def test_adamw_kernel_matches_plain(n, pdtype, gdtype, wd):
    _card()
    rng = np.random.RandomState(n % 1000)
    p = torch.as_tensor(rng.standard_normal(n).astype(np.float32)).to(
        "cuda", getattr(torch, pdtype))
    g = torch.as_tensor(rng.standard_normal(n).astype(np.float32)).to(
        "cuda", getattr(torch, gdtype))
    m = torch.as_tensor(0.1 * rng.standard_normal(n).astype(np.float32),
                        device="cuda")
    v = torch.as_tensor(np.abs(rng.standard_normal(n)).astype(np.float32),
                        device="cuda")
    scalars = torch.tensor([3e-4, 0.271, 0.0297], device="cuda")
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd)
    want = au.adamw_update_plain(p, g, m, v, scalars, **hyper)
    before = au.launches
    got = au.adamw_update(p, g, m, v, scalars, **hyper)
    torch.cuda.synchronize()
    assert au.launches == before + 1 and got[0] is p
    torch.testing.assert_close(m, want[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(v, want[2], rtol=1e-6, atol=1e-7)
    tol = 1e-6 if pdtype == "float32" else 2 ** -7
    torch.testing.assert_close(p.float(), want[0].float(), rtol=tol, atol=tol)


def _scan_close(got, want):
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale


def _scan_path(dtype, *widths):
    """The path the wrappers' ``path`` should pick: bf16 with widths that
    are multiples of 16 up to 128 takes the tensor-core kernels."""
    tc = dtype == "bfloat16" and all(w % 16 == 0 and w <= 128
                                     for w in widths)
    return "tensor-core" if tc else "cuda-core"


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,N,dtype,h0", [
    (1, 512, 80, 64, 64, "bfloat16", False),   # zamba2's prefill
    (2, 100, 3, 32, 16, "float32", True),      # ragged last chunk, N != hd
    (1, 40, 2, 24, 48, "float32", True),       # S below one chunk, hd % 16
    (1, 130, 4, 64, 64, "float16", True),
    (1, 512, 80, 64, 64, "bfloat16", True),    # tensor-core path from here
    (2, 100, 3, 32, 16, "bfloat16", True),     # ragged last chunk
    (1, 200, 4, 64, 64, "bfloat16", True),     # S % 64 and S % 16 not 0
    (1, 10, 2, 64, 64, "bfloat16", True),      # S below one 16-row strip
    (2, 77, 3, 128, 128, "bfloat16", True),    # the widest it takes
    (1, 130, 4, 16, 48, "bfloat16", False),
    (1, 40, 2, 24, 48, "bfloat16", True),      # hd 24: the CUDA-core path
])
def test_ssd_kernel_matches_plain(B, S, H, hd, N, dtype, h0):
    _card()
    rng = np.random.RandomState(S + N)
    dt_ = getattr(torch, dtype)

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device="cuda")
    x, Bm, Cm = rnd(B, S, H, hd).to(dt_), rnd(B, S, N).to(dt_), \
        rnd(B, S, N).to(dt_)
    d = torch.nn.functional.softplus(rnd(B, S, H))
    a = -torch.exp(rnd(H))
    state = rnd(B, H, hd, N) if h0 else None
    assert ssm_scan.path(x, Bm) == _scan_path(dtype, hd, N)
    before = ssm_scan.launches
    y, h = ssm_scan.ssd_scan(x, d, a, Bm, Cm, state)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm_scan.ssd_scan_plain(x, d, a, Bm, Cm, state)
    _scan_close(y, want_y)
    _scan_close(h, want_h)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,dtype,s0,floor", [
    (1, 512, 32, 64, "bfloat16", False, False),   # rwkv6's prefill
    (2, 100, 3, 16, "float32", True, False),      # ragged last chunk
    (1, 20, 2, 40, "float32", True, True),        # S below one chunk, -8
    (1, 77, 2, 128, "float16", True, False),
    (1, 512, 32, 64, "bfloat16", True, True),     # tensor-core path from here
    (2, 100, 3, 16, "bfloat16", True, False),     # ragged last chunk
    (1, 200, 4, 64, "bfloat16", True, False),     # S % 64 and S % 16 not 0
    (1, 10, 2, 64, "bfloat16", True, False),      # S below one sub-chunk
    (1, 77, 2, 128, "bfloat16", True, False),     # the widest it takes
    (1, 100, 2, 128, "bfloat16", True, True),
    (2, 50, 3, 40, "bfloat16", True, False),      # hd 40: the CUDA-core path
])
def test_wkv6_kernel_matches_plain(B, S, H, hd, dtype, s0, floor):
    _card()
    rng = np.random.RandomState(S + hd)
    dt_ = getattr(torch, dtype)

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device="cuda")
    r, k, v = (rnd(B, S, H, hd).to(dt_) for _ in range(3))
    logw = torch.full((B, S, H, hd), -8.0, device="cuda") if floor else \
        torch.clamp(-torch.exp(rnd(B, S, H, hd)), min=-8.0)
    u = rnd(H, hd)
    state = rnd(B, H, hd, hd) if s0 else None
    assert wkv6.path(r) == _scan_path(dtype, hd)
    before = wkv6.launches
    y, s = wkv6.wkv6(r, k, v, logw, u, state)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want_y, want_s = wkv6.wkv6_plain(r, k, v, logw, u, state)
    _scan_close(y, want_y)
    _scan_close(s, want_s)


@pytest.mark.gpu
def test_scan_tensor_core_paths_read_strided_views():
    """x, B and C (SSD) and r, k, v and logw (WKV6) as views into wider
    buffers whose rows start on 16 bytes, as a fused projection would hand
    them over: read in place, and the same result as contiguous copies."""
    _card()
    rng = np.random.RandomState(11)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device="cuda")
    B, S, H, hd, N = 2, 150, 4, 64, 32
    x = rnd(B, S, H, hd + 8).to(bf)[..., :hd]
    bc = rnd(B, S, 3 * N).to(bf)
    Bm, Cm = bc[..., N:2 * N], bc[..., 2 * N:]
    d = torch.nn.functional.softplus(rnd(B, S, H))
    a = -torch.exp(rnd(H))
    got = ssm_scan.ssd_scan(x, d, a, Bm, Cm)
    want = ssm_scan.ssd_scan(x.contiguous(), d, a, Bm.contiguous(),
                             Cm.contiguous())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rkvw = rnd(B, S, H, 4 * hd)
    r, k, v = (rkvw[..., i * hd:(i + 1) * hd].to(bf) for i in range(3))
    logw = torch.clamp(-torch.exp(rkvw), min=-8.0)[..., 3 * hd:]
    u = rnd(H, hd)
    got = wkv6.wkv6(r, k, v, logw, u)
    want = wkv6.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                     logw.contiguous(), u)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_scan_tensor_core_paths_raise_on_unaligned_views():
    """The tensor-core scans copy 16-byte chunks: a bf16 view whose rows do
    not start on 16 bytes is refused, naming the stride, and launches
    nothing."""
    _card()
    bf = torch.bfloat16
    x = torch.randn(1, 8, 2, 68, device="cuda").to(bf)[..., :64]
    Bm = torch.randn(1, 8, 16, device="cuda").to(bf)
    d = torch.ones(1, 8, 2, device="cuda")
    a = -torch.ones(2, device="cuda")
    r = torch.randn(1, 8, 2, 64, device="cuda").to(bf)
    logw = torch.full((1, 8, 2, 68), -1.0, device="cuda")[..., 2:66]
    u = torch.ones(2, 64, device="cuda")
    before = (ssm_scan.launches, wkv6.launches)
    with pytest.raises(ValueError, match=r"x\.stride\(2\) is 68"):
        ssm_scan.ssd_scan(x, d, a, Bm, Bm)
    with pytest.raises(ValueError, match="logw's data pointer"):
        wkv6.wkv6(r, r, r, logw, u)
    assert (ssm_scan.launches, wkv6.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,strided", [
    (32, 200, 1024, 512, False),   # granite-moe's prefill: gate and up
    (32, 200, 512, 1024, False),   # its out product
    (32, 2, 1024, 512, False),     # its decode step over 4 slots
    (3, 1, 72, 40, False),         # ragged C, D and F
    (1, 200, 72, 40, False),       # one expert
    (4, 130, 72, 40, True),        # an expert-strided weight slice
])
def test_gmm_kernel_matches_plain(E, C, D, F, strided, dtype):
    _card()
    rng = np.random.RandomState(C + D + F)
    dt_ = getattr(torch, dtype)
    x = torch.as_tensor(rng.standard_normal((E, C, D)).astype(np.float32),
                        device="cuda").to(dt_)
    stacked = torch.as_tensor(rng.standard_normal((E, 2, D, F)).astype(
        np.float32), device="cuda").to(dt_)
    w = stacked[:, 1] if strided else stacked[:, 1].contiguous()
    assert w.is_contiguous() != strided
    before = moe_gmm.launches
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1 and got.dtype == dt_
    want = moe_gmm.gmm_plain(x, w)
    scale = max(1.0, want.float().abs().max().item())
    tol = (1e-5 if dtype == "float32" else 2 ** -7) * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("C", [1, 2, 16, 17, 200])
@pytest.mark.parametrize("strided", [False, True])
def test_gmm_both_paths_at_small_and_large_c(C, strided, dtype):
    """C <= 8 takes the GEMV path and larger C the tensor-core one in
    f16/bf16 (f32 keeps the CUDA-core kernel): granite's gate/up shape at
    each C, contiguous and as expert-strided views of wider buffers."""
    _card()
    E, D, F = 32, 1024, 512
    rng = np.random.RandomState(C)
    dt_ = getattr(torch, dtype)
    xs = torch.as_tensor(rng.standard_normal((2 * E, C, D + 8)).astype(
        np.float32), device="cuda").to(dt_)
    ws = torch.as_tensor(rng.standard_normal((2 * E, D, F)).astype(
        np.float32), device="cuda").to(dt_)
    if strided:
        x, w = xs[::2, :, :D], ws[::2]
    else:
        x, w = xs[:E, :, :D].contiguous(), ws[:E].contiguous()
    before = moe_gmm.launches
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1 and got.shape == (E, C, F)
    want = moe_gmm.gmm_plain(x, w)
    scale = max(1.0, want.float().abs().max().item())
    tol = (1e-5 if dtype == "float32" else 2 ** -7) * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("C", [2, 37])
def test_gmm_ragged_d_and_f_inside_aligned_rows(C, dtype):
    """D 76 and F 44, neither a whole number of 16-byte chunks, as views
    of buffers whose rows are: the copies' zero-filled tails and the
    scalar edge stores, on the GEMV (C 2) and tensor-core (C 37) paths."""
    _card()
    E, D, F = 3, 76, 44
    rng = np.random.RandomState(C + D + F)
    dt_ = getattr(torch, dtype)
    x = torch.as_tensor(rng.standard_normal((E, C, 80)).astype(np.float32),
                        device="cuda").to(dt_)[:, :, :D]
    w = torch.as_tensor(rng.standard_normal((E, D, 48)).astype(np.float32),
                        device="cuda").to(dt_)[:, :, :F]
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    want = moe_gmm.gmm_plain(x, w)
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7 * scale


# ------------------------------------------------- training runtime (A5)

def _elastic(root, **kw):
    """phi4 smoke in f32 with two layers through the elastic trainer on the
    card: 6 steps (or ``steps``) of 4 x 32 tokens, one loss chunk a step."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.orchestrator import Cluster
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.elastic import ElasticTrainer, ElasticTrainSpec
    arch = "phi4-mini-3.8b"
    cfg = registry.get_smoke(arch).replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    kw = {"steps": 6, **kw}
    spec = ElasticTrainSpec(cfg, registry.get_parallel(arch),
                            OptimizerConfig(warmup_steps=1, decay_steps=100),
                            seq_len=32, global_batch=4, max_data=1,
                            keep=None, verbose=False, **kw)
    trainer = ElasticTrainer(Cluster(), spec, store=ObjectStore(str(root)))
    return trainer.run()


@pytest.mark.gpu
def test_elastic_crash_run_on_the_card_matches_a_clean_run(tmp_path):
    """A crash inside chunk [2,3] at device_steps 2: restored from step 1's
    checkpoint, the run repeats the clean run's losses (1e-5 relative: the
    card may sum the embedding's grad in another order)."""
    _card()
    clean = _elastic(tmp_path / "clean", ckpt_every=0)
    out = _elastic(tmp_path / "crash", ckpt_every=2, device_steps=2,
                   fail_at=3)
    rep = out["report"]
    assert [s.outcome for s in rep.segments] == ["error", "done"]
    assert [(s.start, s.end) for s in rep.segments] == [(0, 1), (2, 5)]
    assert out["params"]["embed"].device.type == "cuda"
    np.testing.assert_allclose(out["losses"], clean["losses"], rtol=1e-5)


@pytest.mark.gpu
def test_elastic_kernel_launches_per_executed_step(tmp_path):
    """Each executed step, the re-run ones included, launches the xent
    kernels once a loss chunk and AdamW once a leaf (11 for phi4)."""
    _card()
    before = (xent.fwd_launches, xent.bwd_launches, au.launches)
    out = _elastic(tmp_path, steps=8, ckpt_every=4, device_steps=2,
                   fail_at=7)
    rep = out["report"]
    assert rep.steps_executed == 10 and rep.steps_lost == 2
    ran = (xent.fwd_launches - before[0], xent.bwd_launches - before[1],
           au.launches - before[2])
    assert ran == (10, 10, 10 * 11)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card_is_bit_exact(tmp_path):
    """bf16, f32 and int32 leaves on the card: restored bit for bit onto
    the card, and ``save_async`` holds the values of its call even when
    the leaves change in place right after it."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.data.objectstore import ObjectStore
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(64, 96, generator=gen, device="cuda")
            .to(torch.bfloat16),
            "m": {"a": torch.randn(1000, generator=gen, device="cuda")},
            "count": torch.tensor(7, dtype=torch.int32, device="cuda")}
    want = {"w": tree["w"].clone(), "a": tree["m"]["a"].clone()}
    ck = Checkpointer(ObjectStore(str(tmp_path)), keep=None)
    ck.save_async(0, tree)
    tree["w"].add_(1)
    tree["m"]["a"].mul_(3)
    ck.wait()
    got = ck.restore(0, tree, device="cuda")
    assert got["w"].device.type == "cuda" and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), want["w"].view(torch.int16))
    assert torch.equal(got["m"]["a"].view(torch.int32),
                       want["a"].view(torch.int32))
    assert int(got["count"]) == 7


@pytest.mark.gpu
def test_session_serves_on_the_card_as_on_the_cpu(monkeypatch):
    """A smoke ServeJob (f32, paged) through a Session on the card's
    ``Cluster()`` gives the greedy tokens of the same job through a CPU
    Session, with flash attention in every prefill.  Both draw their
    params on the CPU from the job's seed (a CUDA generator draws other
    numbers)."""
    _card()
    from repro_torch.api import ServeJob, Session, runners
    from repro_torch.configs import registry
    from repro_torch.core.orchestrator import Cluster
    from repro_torch.models import params as pr
    from repro_torch.serving.report import GAUGES

    cfg = registry.get_smoke("phi4-mini-3.8b").replace(
        param_dtype="float32", compute_dtype="float32")
    monkeypatch.setattr(runners, "resolve_serve_cfg", lambda job: cfg)
    draw = pr.init_params

    def init(schema, gen, dtype, device="cuda"):
        cpu = draw(schema, torch.Generator().manual_seed(gen.initial_seed()),
                   dtype, "cpu")

        def move(tree):
            return {k: move(v) for k, v in tree.items()} \
                if isinstance(tree, dict) else tree.to(device)
        return move(cpu)
    monkeypatch.setattr(pr, "init_params", init)
    job = ServeJob(name="card", n_requests=5, prompt_len=16,
                   max_new_tokens=8, slots=2, gen_lens=(8, 3), paged=True,
                   block_size=8)
    before = fa.launches
    card = Session(cluster=Cluster()).apply(job).wait(300)
    launched = fa.launches - before
    cpu = Session(cluster=Cluster(devices=[torch.device("cpu")])).apply(
        job).wait(300)
    assert card["results"] == cpu["results"]
    assert [len(card["results"][i]) for i in range(5)] == [8, 3, 8, 3, 8]
    prefills = card["metrics"].series(GAUGES.PREFILL_S).stats()["count"]
    assert prefills >= 1 and launched == cfg.num_layers * prefills


@pytest.mark.gpu
def test_connect_ffn_and_labels_on_the_card_match_the_cpu():
    """CONNECT on the card: the FFN's forward and flood fill (f32, TF32
    off, through ``reference_convs``) within 1e-4 of the output's scale of
    the CPU's on the same params (18 convolutions summed in another
    order), and ``connect_label`` equal to the CPU's exactly (integers)."""
    _card()
    from repro_torch.apps.connect import segment
    from repro_torch.models import ffn3d

    cfg = ffn3d.FFNConfig(depth=3, width=16, fov=(8, 16, 16), flood_iters=2)
    rng = np.random.RandomState(0)
    params = {k: torch.as_tensor((rng.standard_normal(p.shape) * 0.2)
                                 .astype(np.float32))
              for k, p in ffn3d.ffn_schema(cfg).items()}
    x = torch.as_tensor(rng.rand(4, *cfg.fov).astype(np.float32))
    card = {k: v.cuda() for k, v in params.items()}
    with torch.inference_mode(), ffn3d.reference_convs():
        got = ffn3d.flood_fill(cfg, card, x.cuda()).cpu()
        one = ffn3d.ffn_apply(cfg, card, x.cuda(), ffn3d.seed_mask(
            cfg, x.shape, "cuda")).cpu()
    with torch.inference_mode():
        want = ffn3d.flood_fill(cfg, params, x)
        want_one = ffn3d.ffn_apply(cfg, params, x, ffn3d.seed_mask(
            cfg, x.shape, "cpu"))
    for a, b in ((got, want), (one, want_one)):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1.0)
    for seed, shape in ((1, (8, 40, 56)), (2, (24, 64, 96))):
        mask = torch.as_tensor(np.random.RandomState(seed).rand(*shape) > 0.5)
        assert torch.equal(segment.connect_label(mask.cuda()).cpu(),
                           segment.connect_label(mask))
