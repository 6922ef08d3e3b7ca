"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device, so the CPU suite
counts none of them.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports nothing of JAX, so it runs where only PyTorch is
installed.  Tolerances: flash attention 2e-5 for f32 (the same products
summed in another order), 2e-2 for f16/bf16 (one rounding of the output;
kernel and plain version both round the scores and P to the input type,
as the JAX model does, so a score near a rounding boundary may round the
other way after another f32 sum order);
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
exactly.  The tenant backend: a full-width phi4 ServeJob through
``Session(tenant=)`` on a fabric computing on the card gives a direct
engine's tokens.  The train Functions: gmm's forward, dx and dw (three
launches) against autograd of the plain einsum, 1e-5 / 2^-7 of the scale
as the kernel, also with occupied rows (x NaN past them, the empty
experts' weights NaN: no NaN reaches the output or either gradient); one zamba2 and one rwkv6 train step's grads (the scan
kernel forward twice a layer with remat, the plain recompute backward)
against the CPU's, 1e-5 on the loss and 1e-4 of each leaf's norm (f32,
the same sums in another order).  The optimizer recipes: ``quantize`` and
``dequantize`` on the card bit for bit against the CPU at kimi's leaf
shapes (the same f32 steps), and three unclipped updates under each
recipe on the card against the CPU's: the f32 state within 1e-6 of each
leaf's largest value (the factored means summed in another order), bf16
moments also within two bf16 steps of it, int8 ``q`` equal but for +-1
flips (under 1 in 10,000), params within 1e-5 but for at most 1 in 200.
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
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,dh,causal,window,cap", [
    (1, 16, 8, 512, 512, 256, True, 4096, 50.0),   # gemma2 local at 512
    (1, 4, 2, 700, 700, 256, True, 128, 50.0),     # a window that skips
    (1, 4, 2, 700, 700, 256, True, None, 50.0),    # gemma2 global
    (1, 8, 8, 96, 520, 128, True, 128, None),      # Sq < Sk under a window
    (1, 4, 2, 130, 60, 64, True, 16, 5.0),         # Sq > Sk: empty rows
    (1, 12, 12, 384, 576, 64, False, None, None),  # whisper cross
    (1, 8, 2, 130, 200, 128, False, None, 30.0),   # cross, ragged, capped
    (2, 4, 2, 65, 65, 256, True, 1, None),         # a window of one key
    (1, 16, 2, 96, 520, 112, True, None, None),    # kimi's dh, ragged, Sq < Sk
    (1, 8, 1, 130, 130, 112, False, None, None),   # kimi's dh, non-causal
])
def test_flash_window_softcap_and_cross_match_plain(B, H, KV, Sq, Sk, dh,
                                                    causal, window, cap,
                                                    dtype):
    """gemma2's sliding window and softcap at dh 256, non-causal Sq != Sk
    (whisper's and the VLM's cross attention), and their edges; under a
    softcap q is scaled by 4 so that it bites.  The softmax is then peaked
    and outputs reach |v|'s maximum (about 4.5), where one bf16 rounding is
    0.031: the tolerance is taken of the output's scale."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(x).to("cuda", dt)
               for x in _qkv(B, H, KV, Sq, Sk, dh, seed=Sq + Sk + dh))
    if cap is not None:
        q = q * 4
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dt
    want = fa.attention_plain(q, k, v, causal=causal, window=window,
                              softcap=cap)
    tol = 2e-5 if dtype == "float32" else 2e-2
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


def _cut_views(B, H, KV, Sq, Sk, dh, dt, seed):
    """q, k, v as the models pass them: transposes of (B, S, heads, dh)
    views, here cut from (B, S + 3, heads, dh) buffers so the batch
    stride is not heads * S * dh."""
    rng = np.random.RandomState(seed)
    out = []
    for n, S in ((H, Sq), (KV, Sk), (KV, Sk)):
        buf = torch.as_tensor(rng.standard_normal((B, S + 3, n, dh))
                              .astype(np.float32)).to("cuda", dt)
        out.append(buf[:, :S].transpose(1, 2))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("mode,B,H,KV,Sq,Sk,window,cap", [
    ("causal", 1, 8, 2, 200, 200, None, None),
    ("full", 2, 4, 2, 130, 330, None, None),
    ("general", 1, 8, 4, 150, 270, 96, 30.0),
])
def test_flash_each_mask_mode_and_head_dim_on_model_views(
        mode, B, H, KV, Sq, Sk, window, cap, dh, dtype):
    """Each instantiation of the f16/bf16 kernel (mask mode x head dim x
    type) on the models' transposed views, through TMA tensor maps over
    their strides, Sq and Sk not multiples of 64 (q scaled by 4 under the
    softcap).  Each query row is held to 2e-2 of its own scale (its
    largest |output|, at least 1/16): a row that averages a hundred keys
    has outputs near 0.1, so one scale for the whole tensor would let an
    off-by-one in the mask or the window pass there."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v = _cut_views(B, H, KV, Sq, Sk, dh, dt, seed=Sq + Sk + dh)
    assert q.stride(0) != H * Sq * dh and q.stride(2) == H * dh
    if cap is not None:
        q = (q.transpose(1, 2) * 4).transpose(1, 2)   # keeps the layout
    causal = mode != "full"
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dt
    want = fa.attention_plain(q, k, v, causal=causal, window=window,
                              softcap=cap).float()
    row_scale = want.abs().amax(-1, keepdim=True).clamp_min(1 / 16)
    assert ((got.float() - want).abs() / row_scale).max().item() <= 2e-2


@pytest.mark.gpu
def test_flash_refuses_a_stride_its_tensor_maps_cannot_take():
    """k and v broadcast over their heads (an expanded axis of stride 0,
    which the 16-byte check lets through): the tensor maps refuse it, the
    wrapper names the stride and nothing launches."""
    _card()
    q, k, v = (torch.as_tensor(x).to("cuda", torch.bfloat16)
               for x in _qkv(1, 4, 1, 64, 64, 64, seed=3))
    k, v = k.expand(1, 4, 64, 64), v.expand(1, 4, 64, 64)
    before = fa.launches
    with pytest.raises(ValueError, match=r"k\.stride\(1\) is 0 elements"):
        fa.flash_attention(q, k, v)
    assert fa.launches == before


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
    (1, 1, 2, 64, 64, "bfloat16", True),       # one row
    (1, 10, 2, 64, 64, "bfloat16", False),
    (1, 63, 2, 64, 64, "bfloat16", True),      # one row short of a chunk
    (1, 64, 2, 64, 64, "bfloat16", False),     # exactly one chunk
    (1, 65, 2, 64, 64, "bfloat16", True),      # one row into a second
    (2, 200, 2, 64, 64, "bfloat16", False),
    (1, 150, 3, 32, 16, "bfloat16", False),    # N 16
    (1, 150, 3, 32, 48, "bfloat16", True),     # N 48
    (1, 150, 3, 32, 128, "bfloat16", False),   # N 128, zero state
    (1, 150, 3, 16, 64, "bfloat16", True),     # hd 16
    (1, 150, 3, 128, 64, "bfloat16", False),   # hd 128
    (1, 64, 80, 128, 128, "bfloat16", True),   # hd, N 128 on every SM: DSL 16
    (2, 1024, 80, 64, 64, "bfloat16", False),  # zamba2's train forward
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


def _wkv_walk_inputs(B, S, H, hd, s0, rng, poison=False):
    """bf16 r, k, v and f32 logw, u and s0 (or None) on the card; with
    ``poison`` r, k, v and logw are views into larger NaN-filled buffers:
    rows before and after, a head, and columns on each side."""
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device="cuda")
    if poison:
        bbuf = torch.full((B, S + 3, H + 1, 3 * hd + 16), float("nan"),
                          dtype=bf, device="cuda")
        fbuf = torch.full((B, S + 3, H + 1, hd + 16), float("nan"),
                          device="cuda")
        r, k, v = (bbuf[:, 1:S + 1, 1:, 8 + i * hd:8 + (i + 1) * hd]
                   for i in range(3))
        logw = fbuf[:, 1:S + 1, 1:, 4:4 + hd]
        for t in (r, k, v):
            t.copy_(rnd(*t.shape).to(bf))
        logw.copy_(torch.clamp(-torch.exp(rnd(*logw.shape)), min=-8.0))
    else:
        r, k, v = (rnd(B, S, H, hd).to(bf) for _ in range(3))
        logw = torch.clamp(-torch.exp(rnd(B, S, H, hd)), min=-8.0)
    return (r, k, v, logw, rnd(H, hd)), (rnd(B, H, hd, hd) if s0 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,s0", [
    (1, 1, 2, 64, True),       # one row
    (1, 63, 2, 64, False),     # one chunk but a row
    (1, 64, 2, 64, True),      # one whole chunk
    (1, 65, 2, 64, True),      # a chunk and a row: a cluster of 2
    (1, 130, 2, 16, True), (1, 130, 2, 16, False),
    (1, 150, 3, 32, True), (1, 150, 3, 32, False),
    (2, 300, 4, 128, True), (2, 300, 4, 128, False),
    (2, 1024, 32, 64, False),  # rwkv6's train forward
])
def test_wkv6_walk_edges_match_plain(B, S, H, hd, s0):
    """The Hopper WKV6 kernel at its edges (S around a chunk, hd 16, 32
    and 128, with and without s0) and at the train shape: one launch, y
    and s_last within 1e-4 of the plain version's scale."""
    _card()
    args, state = _wkv_walk_inputs(B, S, H, hd, s0,
                                   np.random.RandomState(S + hd))
    assert wkv6.path(args[0]) == "tensor-core"
    before = wkv6.launches
    y, s = wkv6.wkv6(*args, state)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want_y, want_s = wkv6.wkv6_plain(*args, state)
    _scan_close(y, want_y)
    _scan_close(s, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,s0", [
    (1, 512, 32, 64, False),   # rwkv6's prefill
    (2, 100, 3, 16, True),
    (1, 10, 2, 64, True),
    (1, 77, 2, 128, True),
])
def test_wkv6_kernel_reads_nothing_past_its_views(B, S, H, hd, s0):
    """r, k, v and logw as views into larger buffers whose other elements
    are NaN: a box that read past its rows, head or columns would show as
    a non-finite y or s_last.  Within 1e-4 of the plain version, one
    launch."""
    _card()
    args, state = _wkv_walk_inputs(B, S, H, hd, s0,
                                   np.random.RandomState(S + hd + 1),
                                   poison=True)
    before = wkv6.launches
    y, s = wkv6.wkv6(*args, state)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    want_y, want_s = wkv6.wkv6_plain(*args, state)
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
@pytest.mark.parametrize("B,S,H,hd,N,h0", [
    (1, 512, 80, 64, 64, False),   # zamba2's prefill
    (2, 100, 3, 32, 16, True),
    (1, 10, 2, 16, 48, True),
    (1, 77, 2, 128, 128, True),
])
def test_ssd_kernel_reads_nothing_past_its_views(B, S, H, hd, N, h0):
    """x, B and C as views into larger buffers whose other bytes are NaN
    (rows before and after, a head, columns on each side): a box that
    reads past its row, batch or head would show as a non-finite y or
    h_last.  Within 1e-4 of the plain version, one launch."""
    _card()
    rng = np.random.RandomState(S + N + 1)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device="cuda")
    xbuf = torch.full((B, S + 3, H + 1, hd + 8), float("nan"), dtype=bf,
                      device="cuda")
    bcbuf = torch.full((B, S + 2, 3 * N + 8), float("nan"), dtype=bf,
                       device="cuda")
    x = xbuf[:, 1:S + 1, 1:, :hd]
    Bm, Cm = bcbuf[:, 1:S + 1, 8:8 + N], bcbuf[:, 1:S + 1, 8 + 2 * N:]
    for v in (x, Bm, Cm):
        v.copy_(rnd(*v.shape).to(bf))
    d = torch.nn.functional.softplus(rnd(B, S, H))
    a = -torch.exp(rnd(H))
    state = rnd(B, H, hd, N) if h0 else None
    before = ssm_scan.launches
    y, h = ssm_scan.ssd_scan(x, d, a, Bm, Cm, state)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    want_y, want_h = ssm_scan.ssd_scan_plain(x, d, a, Bm, Cm, state)
    _scan_close(y, want_y)
    _scan_close(h, want_h)


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


def _gmm_rows(kind, E, C):
    """A rows vector on the card: every expert empty, partial (0, C/4, C/2,
    3C/4, C in turn), every one full, or random with a third empty."""
    if kind == "zero":
        r = np.zeros(E)
    elif kind == "partial":
        r = [C * (e % 5) // 4 for e in range(E)]
    elif kind == "full":
        r = np.full(E, C)
    else:
        r = np.random.RandomState(E + C).randint(0, C + 1, E)
        r[::3] = 0
    return torch.as_tensor(np.asarray(r, np.int32), device="cuda")


def _poison(x, w, rows):
    """x NaN in its rows c >= rows[e], w NaN for every empty expert."""
    x, w = x.clone(), w.clone()
    past = torch.arange(x.shape[1], device="cuda")[None] >= rows[:, None]
    x[past] = float("nan")
    w[rows == 0] = float("nan")
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("kind", ["zero", "partial", "full", "random"])
@pytest.mark.parametrize("E,C,D,F", [
    (32, 2, 1024, 512),            # the GEMV path in f16/bf16
    (32, 200, 1024, 512),          # wgmma: granite's prefill bucket
    (3, 37, 72, 40),               # wgmma with ragged C, D and F
    (8, 17, 512, 1024),            # kimi's prefill capacity
])
def test_gmm_rows_match_plain_with_nan_past_them(E, C, D, F, kind, dtype):
    """Occupied rows: the kernel against the plain version with x NaN past
    rows[e] and w NaN for the empty experts: one launch, zero rows past
    rows[e], nothing NaN (the empty experts' weights are not read)."""
    _card()
    rng = np.random.RandomState(C + D)
    dt_ = getattr(torch, dtype)
    x = torch.as_tensor(rng.standard_normal((E, C, D)).astype(np.float32),
                        device="cuda").to(dt_)
    w = torch.as_tensor(rng.standard_normal((E, D, F)).astype(np.float32),
                        device="cuda").to(dt_)
    rows = _gmm_rows(kind, E, C)
    x, w = _poison(x, w, rows)
    before = moe_gmm.launches
    got = moe_gmm.gmm(x, w, rows)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1 and got.dtype == dt_
    assert not torch.isnan(got).any()
    past = torch.arange(C, device="cuda")[None] >= rows[:, None]
    assert not got[past].any()
    want = moe_gmm.gmm_plain(x, w, rows)
    scale = max(1.0, want.float().abs().max().item())
    tol = (1e-5 if dtype == "float32" else 2 ** -7) * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


# ---------------------------------------------- train Functions (B8, A9)

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_train_backward_matches_plain_autograd(dtype):
    """A ragged bucket (E 3, C 37, D 72, F 40): the Function's forward and
    its dx and dw, three kernel launches, against autograd of the plain
    einsum on the card (1e-5 of the scale in f32, 2^-7 in bf16: one
    rounding of an f32 sum)."""
    _card()
    from repro_torch.kernels.ref import gmm_ref
    rng = np.random.RandomState(3)
    dt_ = getattr(torch, dtype)
    x, w, dy = (torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                                device="cuda").to(dt_)
                for s in [(3, 37, 72), (3, 72, 40), (3, 37, 40)])
    xk, wk = (t.clone().requires_grad_() for t in (x, w))
    before = moe_gmm.launches
    got = moe_gmm.gmm_train(xk, wk)
    got.backward(dy)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 3
    xp, wp = (t.clone().requires_grad_() for t in (x, w))
    want = gmm_ref(xp, wp)
    want.backward(dy)
    for a, b in ((got, want), (xk.grad, xp.grad), (wk.grad, wp.grad)):
        scale = max(1.0, b.float().abs().max().item())
        tol = (1e-5 if dtype == "float32" else 2 ** -7) * scale
        assert a.dtype == dt_
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_scan_train_step_grads_match_plain(arch):
    """One train step's grads of a two-layer smoke model in f32 on the card
    (the scan kernel forward, the plain recompute backward) against the
    same step on the CPU (the plain versions both ways), on
    ``profile_train.train_setup``'s weights (the contracted attention
    init, as ``chip_smoke.py`` checks them): the loss within 1e-5
    relative, every leaf within 1e-4 of its norm; the scan kernel
    launches twice a layer (the forward and its remat recompute).  Under
    the reference init zamba2's embedding grad moved by 1.3e-4 of its
    norm between card and CPU."""
    _card()
    from repro_torch.launch.profile_train import train_setup
    from repro_torch.runtime import steps
    cfg, par, _, params, _, chunk = train_setup(
        arch, layers=2, pattern=(("mamba", "mamba_attn")
                                 if arch == "zamba2-2.7b" else None),
        seq=64, batch=2, seed=1, device="cpu", smoke=True, dtype="float32")
    par = steps.train_par(par)
    batch = {k: torch.as_tensor(v[0]) for k, v in chunk(0, 1).items()}
    kernel = ssm_scan if arch == "zamba2-2.7b" else wkv6
    want_l, want_g = steps._value_and_grad(cfg, par, params, batch)
    before = kernel.launches
    got_l, got_g = steps._value_and_grad(
        cfg, par, _cuda_tree(params), {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 * cfg.num_layers
    assert abs(got_l.item() - want_l.item()) <= 1e-5 * abs(want_l.item())
    for path, w in _named(want_g):
        g = _leaf(got_g, path).cpu()
        err = ((g - w).norm() / w.norm()).item()
        assert err <= 1e-4, (path, err)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def _cuda_tree(tree):
    if isinstance(tree, dict):
        return {k: _cuda_tree(v) for k, v in tree.items()}
    return tree.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("kind", ["zero", "partial", "random"])
@pytest.mark.parametrize("E,C,D,F", [(3, 37, 72, 40), (32, 200, 512, 1024),
                                     (4, 70, 136, 200)])
def test_gmm_train_rows_backward_reads_operands_in_place(E, C, D, F, kind,
                                                         dtype):
    """The Function's forward, dx and dw with rows (x NaN past them, w NaN
    in the empty experts) in three launches, against autograd of the plain
    version: dx zero past the rows, dw zero for the empty experts, all
    finite; the backward reads w and x in place (no operand is copied)."""
    _card()
    rng = np.random.RandomState(C + F)
    dt_ = getattr(torch, dtype)
    x, w, dy = (torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                                device="cuda").to(dt_)
                for s in [(E, C, D), (E, D, F), (E, C, F)])
    rows = _gmm_rows(kind, E, C)
    x, w = _poison(x, w, rows)
    xk, wk = (t.clone().requires_grad_() for t in (x, w))
    before = moe_gmm.launches
    got = moe_gmm.gmm_train(xk, wk, rows)
    got.backward(dy)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 3
    xp, wp = (t.clone().requires_grad_() for t in (x, w))
    want = moe_gmm.gmm_plain(xp, wp, rows)
    want.backward(dy)
    for a, b in ((got, want), (xk.grad, xp.grad), (wk.grad, wp.grad)):
        assert a.dtype == dt_ and not torch.isnan(a).any()
        scale = max(1.0, b.float().abs().max().item())
        tol = (1e-5 if dtype == "float32" else 2 ** -7) * scale
        assert (a.float() - b.float()).abs().max().item() <= tol
    past = torch.arange(C, device="cuda")[None] >= rows[:, None]
    assert not xk.grad[past].any() and not wk.grad[rows == 0].any()


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


@pytest.mark.gpu
def test_tenant_session_serves_full_width_phi4_as_a_direct_engine(tmp_path):
    """A full-width phi4 ServeJob (bf16, random weights from its seed)
    through ``Session(tenant=)`` on a fabric of logical slots computing
    on the card: the fair-share scheduler places its pod, the pod builds
    the engine on the placed site's device, and the greedy tokens equal a
    direct engine's on the same job, with flash in every prefill."""
    _card()
    import gc

    from repro_torch.api import ServeJob, Session, runners
    from repro_torch.core.metrics import Registry
    from repro_torch.core.queue import WorkQueue
    from repro_torch.fabric import Fabric, FederatedStore
    from repro_torch.serving.report import GAUGES
    from repro_torch.vcluster import FairShareScheduler, TenantSpec

    fabric = Fabric(device="cuda")
    fabric.add_site("gpu", devices=[0, 1], store_root=str(tmp_path / "gpu"))
    fabric.add_site("edge", devices=[0], store_root=str(tmp_path / "edge"))
    fabric.connect("gpu", "edge", gbps=10.0, latency_ms=1.0)
    sched = FairShareScheduler(fed=FederatedStore(fabric), reconcile_s=0.01)
    job = ServeJob(name="tenant-card", arch="phi4-mini-3.8b", smoke=False,
                   n_requests=4, prompt_len=64, max_new_tokens=16, slots=2,
                   gen_lens=(16, 3), paged=True, block_size=16)
    before = fa.launches
    with sched:
        session = Session(tenant=sched.create_tenant(TenantSpec("chat")))
        h = session.apply(job)
        got = h.wait(600)
    launched = fa.launches - before
    results, site = got["results"], got["site"]
    prefills = got["metrics"].series(GAUGES.PREFILL_S).stats()["count"]
    session.forget(h)
    del got, h
    gc.collect()
    torch.cuda.empty_cache()
    engine = runners.build_engine(job, registry_out=Registry(),
                                  device="cuda")
    direct, _ = engine.run(WorkQueue(runners.serve_requests(job)),
                           default_max_new=job.max_new_tokens)
    del engine
    assert site in ("gpu", "edge")
    assert results == direct
    assert [len(results[i]) for i in range(4)] == [16, 3, 16, 3]
    assert prefills >= 1 and launched == 32 * prefills
    assert sched.metrics.series("lease_device_s/tenant-chat").total > 0


# ------------------------------------------------ optimizer recipes (A3)

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 7168), (64, 7168, 2048 // 16),
                                   (7168, 64, 112), (163_840 // 64, 7168),
                                   (300,), ()])
def test_quantize_on_the_card_is_the_cpu_bit_for_bit(shape):
    """kimi's leaf shapes (an expert slice cut along F to stay small, the
    attention slice (D, H, dh) whose last axis is not a 128 multiple, the
    embedding cut along V), a 1-D and a 0-d tensor."""
    _card()
    from repro_torch.optim import quant
    x = torch.as_tensor(np.random.RandomState(len(shape)).standard_normal(
        shape).astype(np.float32) * 0.01)
    cpu = quant.quantize(x)
    card = quant.quantize(x.cuda())
    assert torch.equal(card["q"].cpu(), cpu["q"])
    assert torch.equal(card["s"].cpu().view(torch.int32),
                       cpu["s"].view(torch.int32))
    back = quant.dequantize(card)
    assert torch.equal(back.cpu().view(torch.int32),
                       quant.dequantize(cpu).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", [dict(moment_dtype="bfloat16"),
                                    dict(moment_dtype="int8"),
                                    dict(second_moment="factored"),
                                    dict(moment_dtype="int8",
                                         second_moment="factored")])
def test_recipe_updates_on_the_card_match_the_cpu(recipe):
    _card()
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models.params import PSpec
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    schema = {"experts": PSpec((2, 8, 256, 384), ("layers", "expert",
                                                  "fsdp", None)),
              "wq": PSpec((2, 256, 8, 112), ("layers", "fsdp", None, None)),
              "norm": PSpec((2, 256), ("layers", None)),
              "embed": PSpec((1000, 256), ("vocab", "fsdp"))}
    # no clip: the CPU's f32 norm of a 1.6 M-element leaf lies 2.3e-5 from
    # float64, the card's closer, and the clip scale would carry that
    # into every moment; the update's own arithmetic is what is held here
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=1, grad_clip=0.0, **recipe)
    rng = np.random.RandomState(0)
    p0 = {k: torch.as_tensor(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in schema.items()}
    grads = [{k: torch.as_tensor(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in schema.items()} for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev, copy=True) for k, v in p0.items()}
        st = steps._zeros(adamw.opt_state_schema(schema, ocfg), "float32",
                          dev)
        for g in grads:
            p, st, _ = adamw.apply_updates(
                schema, p, {k: v.to(dev, copy=True) for k, v in g.items()},
                st, ocfg)
        out[dev] = (p, st)
    flips = total = far = n = 0
    for (key, want), (_, got) in zip(_leaves({"p": out["cpu"][0],
                                              "m": out["cpu"][1]["m"],
                                              "v": out["cpu"][1]["v"]}),
                                     _leaves({"p": out["cuda"][0],
                                              "m": out["cuda"][1]["m"],
                                              "v": out["cuda"][1]["v"]})):
        got, want = got.cpu().float(), want.float()
        diff = (got - want).abs()
        if key.endswith("/q"):
            assert diff.max().item() <= 1, key
            flips += int((diff > 0).sum())
            total += diff.numel()
        elif key.startswith("p/"):
            far += int((diff > 1e-5).sum())
            n += diff.numel()
        else:
            bound = 1e-6 * want.abs().max().item()
            if recipe.get("moment_dtype") == "bfloat16":
                bound += 2 ** -6 * want.abs().max().item()
            assert diff.max().item() <= bound, key
    assert flips <= 1e-4 * max(total, 1), (flips, total)
    assert far <= 5e-3 * n, (far, n)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{path}/{k}" if path else k)]
    return [(path, tree)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_two_ranks_on_one_card_train_as_on_the_cpu(shape):
    """granite-moe smoke (2 layers, 4 x 30 tokens) in f32, two ranks
    sharing the card over gloo against the same two ranks on the CPU: two steps' losses within
    1e-4, grad norms within 1e-4 relative, every param block within 2e-4
    (lr 3e-4), and the gmm, xent and AdamW kernels launched on each card
    rank (the CPU ranks launch none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import ranks
    cfg = registry.get_smoke("granite-moe-1b-a400m").replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    ocfg = OptimizerConfig(warmup_steps=1, decay_steps=100)
    # 30 tokens a row: not a multiple of 16, so the loss takes the chunked
    # path through the xent kernels (one chunk a step)
    batches = TokenPipeline(cfg.vocab_size, 30, 4, seed=1).chunk(0, 2)
    args = (cfg, ranks.RANK_PARALLEL, ocfg, batches)
    card = ranks.run_ranks(ranks.train_ranks, shape, args=args,
                           kwargs={"keep": True}, backend="gloo",
                           devices=["cuda:0", "cuda:0"])
    cpu = ranks.run_ranks(ranks.train_ranks, shape, args=args,
                          kwargs={"keep": True}, device="cpu", threads=2)
    for a, b in zip(card, cpu):
        assert a["coords"] == b["coords"]
        for x, y in zip(a["steps"], b["steps"]):
            assert abs(x["loss"] - y["loss"]) <= 1e-4
            assert abs(x["grad_norm"] - y["grad_norm"]) <= 1e-4 * \
                y["grad_norm"]
        for k in ("moe_gmm", "xent_fwd", "xent_bwd", "adamw_update"):
            assert b["launches"][k] == 0
        assert a["launches"]["moe_gmm"] == 2 * 2 * 12
        assert a["launches"]["xent_fwd"] == a["launches"]["xent_bwd"] == 2
        assert a["launches"]["adamw_update"] > 0
        stack = [(a["params"], b["params"])]
        while stack:
            p, q = stack.pop()
            if isinstance(p, dict):
                stack.extend((p[k], q[k]) for k in q)
            else:
                np.testing.assert_allclose(p, q, rtol=0, atol=2e-4)
