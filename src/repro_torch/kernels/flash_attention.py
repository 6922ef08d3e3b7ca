"""Flash attention for the port's prefill: a hand-written Hopper kernel.

Replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py:_flash_kernel`` (its ``pl.pallas_call`` in
``flash_attention``): ``softmax(q k^T * scale [causal]) v`` with an online
max and sum over k tiles and f32 accumulators, written in q's dtype.  The
CUDA source is ``repro_torch/csrc/flash_attention.cu``; its header says how
the Pallas grid maps onto CUDA blocks.  Beyond the Pallas kernel it
computes what the JAX model's attention computes (``models/attention.py``
``_qchunk_attention``) for every family the port serves: a logit softcap
``c * tanh(s / c)`` on the scaled scores (gemma2: 50), a sliding window
on the causal mask (gemma2's local layers: key j visible to query i iff
``i + d - w < j <= i + d``, d = Sk - Sq), non-causal attention with
Sq != Sk (whisper's encoder and cross attention, the VLM's cross layers)
and head dims 112 (kimi-k2) and 256 (gemma2).

What bounds it on an H100: at phi4-mini prefill shapes (B=1, H=24, KV=8,
S=512, dh=128, bf16) the inputs and output are 8.4 MB against 1.6 GFLOP of
causal work, so the floor is memory traffic (2.5 us at 3.35 TB/s), not the
tensor cores (1.6 us at 989 TFLOP/s); what the kernel takes beyond it at
512 tokens is the latency of one q tile's chain of k tiles.  At gemma2's
5120 tokens (dh 256) the floor is the 0.2 ms of tensor-core work.  The
design reads q, k and v in place through their strides (no repeat of KV
heads, no transpose copy), keeps scores and probabilities in registers and
never writes them out, and skips k tiles above the causal diagonal and left
of a window.  In f16/bf16 it is FlashAttention-3's structure on Hopper's
own instructions: TMA loads through tensor maps over each view's strides
(``tensor_map_geometry``) into a ring of shared-memory stages completed on
mbarriers, one producer warp apart from the consumer warpgroup, ``wgmma``
for Q K^T and P V (P rounded to q's dtype in registers, as the JAX model
rounds its probabilities, ``models/attention.py``), f32 row statistics and
accumulators, S of one tile overlapped with P V of the last, and the mask
mode (causal, non-causal, or window/softcap at runtime) compiled in.  f32
keeps the first port's CUDA-core kernel: TF32 products would not hold its
tolerance.

Differences from the Pallas kernel, on purpose:
  * GQA is native: k/v are (B, KV, Sk, dh) with KV dividing H, and query
    head h reads KV head h // (H // KV) (the JAX model's grouping).
  * The causal mask is bottom-right aligned like ``ref.attention_ref``
    (``tril(k=Sk-Sq)``); the Pallas kernel's ``kpos <= qpos`` is top-left
    aligned and disagrees with its own oracle when Sq < Sk.
  * Sq and Sk need not be multiples of the tile: the ragged edge is masked
    inside the kernel.
  * Under a window the kernel skips the k tiles left of every row's band,
    so a q tile reads about w / 64 + 2 k tiles whatever Sk is.

On a CPU tensor the wrapper runs the plain version (``attention_plain``;
a ``meta`` tensor too, for shapes: ``build.takes_plain``); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)   # 80: zamba2; 112: kimi; 256: gemma2
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

launches = 0          # kernel launches in this process (chip_smoke reads it)
# replicas and RL actors prefill from their own threads
_launches_lock = threading.Lock()


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B,H,Sq,dh), (B,KV,Sk,dh)")
    B, H, Sq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    KV = k.shape[1]
    if KV < 1 or H % KV:
        raise ValueError(f"KV heads ({KV}) must divide query heads ({H})")
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")


def _check_features(window, softcap):
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window {window!r}: a positive int or None")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap {softcap!r}: a positive float or None")


def tensor_map_geometry(shape, strides, itemsize: int, name: str = "x"):
    """The TMA tensor map of one f16/bf16 operand as the C side encodes it
    from the strides it is given (``csrc/flash_attention.cu``
    ``encode_operand``): ``(dims, byte_strides)``.

    ``shape`` is (B, heads, seq, dh) and ``strides`` its element strides
    (any view whose dh is contiguous, such as a transpose of a (B, S, H,
    dh) projection).  ``dims`` runs innermost first, (dh, seq, heads, B);
    ``byte_strides`` are those of seq, heads and B.  An axis of size 1 is
    never stepped, so it takes dh's row bytes as its stride whatever the
    view says.  Raises ``ValueError`` naming the stride TMA cannot take:
    dh not contiguous, or a stride that is not a positive multiple of 16
    bytes below 2^40.  The wrapper calls it only to name the stride of a
    launch the C side refused."""
    B, heads, seq, dh = (int(n) for n in shape)
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if int(strides[3]) != 1:
        raise ValueError(f"{name}.stride(3) is {strides[3]}: the head dim "
                         f"must be contiguous")
    byte_strides = []
    for axis, size in ((2, seq), (1, heads), (0, B)):
        step = int(strides[axis]) * itemsize
        if size == 1:
            step = dh * itemsize
        elif step <= 0 or step % 16 or step >= 1 << 40:
            raise ValueError(f"{name}.stride({axis}) is {strides[axis]} "
                             f"elements ({step} bytes): a TMA tensor map "
                             f"takes positive multiples of 16 bytes below "
                             f"2^40")
        byte_strides.append(step)
    return (dh, seq, heads, B), tuple(byte_strides)


def attention_plain(q, k, v, *, causal: bool = True, scale=None,
                    window=None, softcap=None):
    """The kernel's plain version: the oracle (``ref.attention_ref``) with
    KV heads expanded (head h reads KV head h // (H // KV)), the JAX
    model's softcap and window, and P rounded as the kernel and the JAX
    model round it.  The scores are ``q k^T * scale`` in f32; with a
    softcap c they become ``c * tanh(s / c)``; with a window w (causal
    only, as in the JAX model) key j is visible to query i iff
    ``i + d - w < j <= i + d``, d = Sk - Sq; masked scores are -1e30; the
    softmax runs in f32 and P is rounded to v's dtype before P V.  In f32,
    without a window or a softcap, that is the oracle bit for bit."""
    _check(q, k, v)
    _check_features(window, softcap)
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    Sq, Sk, dh = q.shape[2], k.shape[2], q.shape[3]
    scale = dh ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        i = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        j = torch.arange(Sk, device=q.device)[None, :]
        mask = j <= i
        if window is not None:
            mask &= j > i - window
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None, window=None,
                    softcap=None) -> torch.Tensor:
    """q (B,H,Sq,dh); k/v (B,KV,Sk,dh) -> (B,H,Sq,dh) in q.dtype.

    ``window`` (an int, causal only: ignored without ``causal``, as in the
    JAX model) and ``softcap`` (a float c > 0) follow ``attention_plain``.

    The inputs may be strided views (e.g. ``x.transpose(1, 2)`` of a
    (B,S,H,dh) projection) as long as dh is contiguous, and in f16/bf16
    their rows start on 16 bytes and their strides suit a TMA tensor map
    (``ValueError`` otherwise, naming the stride).  On CUDA the result is
    a (B,H,Sq,dh) view of a (B,Sq,H,dh) buffer, so transposing it back to
    the model layout costs no copy.
    """
    global launches
    _check(q, k, v)
    _check_features(window, softcap)
    if build.takes_plain("flash_attention", q):
        return attention_plain(q, k, v, causal=causal, scale=scale,
                               window=window, softcap=softcap)
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes one of {list(_DTYPE_CODE)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if q.dtype != torch.float32:
        for name, t in (("q", q), ("k", k), ("v", v)):
            build.require_aligned16(name, t)
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    scale = dh ** -0.5 if scale is None else float(scale)
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, KV, Sq, Sk, dh, strides,
            scale, int(causal), int(window or 0) if causal else 0,
            float(softcap or 0.0), stream)
    if rc != 0:
        if q.dtype != torch.float32:   # name a stride the tensor maps refused
            for name, t in (("q", q), ("k", k), ("v", v)):
                tensor_map_geometry(t.shape, t.stride(), t.element_size(),
                                    name)
        raise RuntimeError(f"flash attention launch failed: CUDA error {rc}")
    with _launches_lock:
        launches += 1
    return out
