"""The flash kernel's TMA tensor maps, computed on the CPU.

The f16/bf16 flash kernel loads q, k and v with TMA through tensor maps
over (dh, seq, heads, batch) with the views' own byte strides, so the
transposes the models pass are read in place.
``flash_attention.tensor_map_geometry`` computes the dims and byte strides
the C side encodes (``encode_operand``) and names a stride it refuses;
these tests hold it, on the CPU, to the views
the models really pass at prefill: each family's full-width config cut to
one pattern group, traced on ``meta`` tensors through ``prefill_step``
with the wrapper recorded (phi4, zamba2 at dh 80, granite-moe, gemma2 at
dh 256, whisper's encoder and cross attention, the VLM's cross attention,
kimi at dh 112) and the smoke config (dh 16).  They also check each
refusal: a head dim that is not contiguous, a stride that is not a
positive multiple of 16 bytes, a head dim the kernel has no tiles for.
No JAX here.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry                        # noqa: E402
from repro_torch.kernels import flash_attention as fa           # noqa: E402
from repro_torch.launch.dryrun import _reduced_cfg              # noqa: E402
from repro_torch.models import attention as attn_mod            # noqa: E402
from repro_torch.models import params as pr                     # noqa: E402
from repro_torch.runtime import steps                           # noqa: E402

PROMPT = 512
# whisper as the engines serve it: the decoder's 448 positions less 64 to
# generate, over PROMPT + 64 frames
WHISPER_PROMPT, WHISPER_FRAMES = 384, 576
ARCHS = ["phi4-mini-3.8b", "zamba2-2.7b", "granite-moe-1b-a400m",
         "gemma2-9b", "whisper-small", "llama-3.2-vision-90b",
         "kimi-k2-1t-a32b"]


def _prefill_views(cfg, B=1, S=PROMPT):
    """(q, k, v, kwargs) of every flash call of one prefill of ``cfg`` cut
    to one pattern group, traced on meta tensors."""
    cut = _reduced_cfg(cfg, 1)
    mod = steps._model_module(cut)
    params = pr.abstract_params(mod.lm_schema(cut), cut.param_dtype)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    calls = []
    real = attn_mod.flash_attention

    def recording(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return real(q, k, v, **kw)

    attn_mod.flash_attention = recording
    try:
        with torch.no_grad():
            steps.prefill_step(cut, params, tokens,
                               extras=steps.extras_specs(cut, B))
    finally:
        attn_mod.flash_attention = real
    return calls


def _expected(t):
    B, heads, seq, dh = t.shape
    item = t.element_size()
    steps_ = []
    for axis, size in ((2, seq), (1, heads), (0, B)):
        steps_.append(dh * item if size == 1 else t.stride(axis) * item)
    return (dh, seq, heads, B), tuple(steps_)


def _check_views(calls, dh):
    assert calls, "no flash call recorded"
    for q, k, v, _kw in calls:
        for name, t in (("q", q), ("k", k), ("v", v)):
            assert t.shape[3] == dh and t.stride(3) == 1
            # the model passes transposes of (B, S, heads, dh) buffers
            assert t.stride(1) < t.stride(2), (name, t.stride())
            dims, steps_ = fa.tensor_map_geometry(
                t.shape, t.stride(), t.element_size(), name)
            assert (dims, steps_) == _expected(t)
            assert all(s % 16 == 0 and 0 < s < 1 << 40 for s in steps_)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_views_of_each_family(arch):
    cfg = registry.get_config(arch)
    if arch == "whisper-small":
        cfg = cfg.replace(encoder_frames=WHISPER_FRAMES)
    calls = _prefill_views(
        cfg, S=WHISPER_PROMPT if arch == "whisper-small" else PROMPT)
    dh = cfg.resolved_head_dim
    _check_views(calls, dh)
    q, k, _v, kw = calls[0]
    assert q.shape[1] == cfg.num_heads and k.shape[1] == cfg.num_kv_heads
    assert q.dtype in (torch.bfloat16, torch.float16)
    if arch == "zamba2-2.7b":
        assert dh == 80
    if arch == "gemma2-9b":
        assert dh == 256 and kw["softcap"] is not None
    if arch == "kimi-k2-1t-a32b":
        assert dh == 112
    if arch in ("whisper-small", "llama-3.2-vision-90b"):
        assert any(not kw["causal"] for _q, _k, _v, kw in calls)
        # cross attention reads as many keys as frames or patches
        cross = [c for c in calls if c[0].shape[2] != c[1].shape[2]]
        assert cross and all(not c[3]["causal"] for c in cross)


def test_smoke_config_views_dh16():
    cfg = registry.get_smoke("phi4-mini-3.8b")
    assert cfg.resolved_head_dim == 16
    calls = _prefill_views(cfg, B=2, S=24)
    _check_views(calls, 16)
    dims, _steps = fa.tensor_map_geometry(
        calls[0][0].shape, calls[0][0].stride(), 2)
    assert dims == (16, 24, calls[0][0].shape[1], 2)


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_each_head_dim_of_a_transposed_projection(dh):
    """A transpose of a (2, 40, 6, dh) f16 projection at every head dim
    the kernel has tiles for: rows of dh elements, heads one row apart,
    positions six rows apart."""
    t = torch.empty(2, 40, 6, dh, dtype=torch.float16,
                    device="meta").transpose(1, 2)
    dims, steps_ = fa.tensor_map_geometry(t.shape, t.stride(), 2, "k")
    assert dims == (dh, 40, 6, 2)
    assert steps_ == (6 * dh * 2, dh * 2, 40 * 6 * dh * 2)


def test_phi4_geometry_by_hand():
    """phi4's q at 512 tokens: a transpose of (1, 512, 24, 128) bf16."""
    q = torch.empty(1, 512, 24, 128, dtype=torch.bfloat16,
                    device="meta").transpose(1, 2)
    dims, steps_ = fa.tensor_map_geometry(q.shape, q.stride(), 2, "q")
    assert dims == (128, 512, 24, 1)
    # seq steps over 24 heads of 256 bytes; heads over one row; the batch
    # axis has size 1 and takes a row's bytes
    assert steps_ == (24 * 256, 256, 256)


def test_batch_stride_that_is_not_heads_times_seq_times_dh():
    """A view of a larger buffer (every other batch row) keeps its own
    batch stride."""
    buf = torch.empty(4, 300, 8, 64, dtype=torch.float16, device="meta")
    k = buf[::2].transpose(1, 2)
    dims, steps_ = fa.tensor_map_geometry(k.shape, k.stride(), 2, "k")
    assert dims == (64, 300, 8, 2)
    assert steps_ == (8 * 64 * 2, 64 * 2, 2 * 300 * 8 * 64 * 2)


def test_refuses_a_head_dim_that_is_not_contiguous():
    t = torch.empty(1, 4, 32, 64, dtype=torch.bfloat16,
                    device="meta").transpose(2, 3)
    with pytest.raises(ValueError, match=r"q\.stride\(3\)"):
        fa.tensor_map_geometry((1, 4, 64, 32), t.stride(), 2, "q")


def test_refuses_a_stride_that_is_not_16_bytes():
    """Rows of 68 bf16 (136 bytes) sliced to 64: the seq stride is no
    multiple of 16 bytes."""
    t = torch.empty(1, 4, 24, 68, dtype=torch.bfloat16,
                    device="meta")[..., :64]
    with pytest.raises(ValueError, match=r"k\.stride\(2\) is 68 elements "
                                         r"\(136 bytes\)"):
        fa.tensor_map_geometry(t.shape, t.stride(), 2, "k")
    # the head stride of a (B, S, H, 68) buffer sliced to 64
    t = torch.empty(1, 24, 4, 68, dtype=torch.bfloat16,
                    device="meta")[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match=r"v\.stride\(1\)"):
        fa.tensor_map_geometry(t.shape, t.stride(), 2, "v")


def test_refuses_a_broadcast_axis():
    """An expanded axis of size > 1 has stride 0: TMA steps no axis by 0."""
    t = torch.empty(1, 1, 24, 64, dtype=torch.bfloat16,
                    device="meta").expand(1, 4, 24, 64)
    with pytest.raises(ValueError, match=r"k\.stride\(1\) is 0 elements"):
        fa.tensor_map_geometry(t.shape, t.stride(), 2, "k")


def test_size_one_axes_take_any_stride():
    """Sq = 1 and B = 1: the view's strides on those axes are never
    stepped, so odd ones pass."""
    t = torch.empty(1, 6, 1, 32, dtype=torch.bfloat16, device="meta")
    t = t.as_strided(t.shape, (7, 32, 3, 1))
    dims, steps_ = fa.tensor_map_geometry(t.shape, t.stride(), 2, "q")
    assert dims == (32, 1, 6, 1) and steps_ == (64, 64, 64)


def test_refuses_a_head_dim_without_tiles():
    with pytest.raises(ValueError, match="head dim 48"):
        fa.tensor_map_geometry((1, 4, 24, 48), (4608, 1152, 48, 1), 2)
