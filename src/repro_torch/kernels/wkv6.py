"""Chunked RWKV6 WKV scan for the port's prefill: a hand-written Hopper kernel.

Replaces the JAX package's Pallas TPU kernel ``kernels/wkv6.py:_wkv_kernel``
(its ``pl.pallas_call`` in ``wkv6``).  Per (batch, head) it computes
``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` and ``y_t = r_t (S_{t-1} +
diag(u) k_t^T v_t)`` with data-dependent per-channel decays ``w_t =
exp(logw_t)``, in chunked form: within a chunk the pairwise term
``sum_{s<t} (sum_i r_t,i k_s,i exp(cum_{t-1},i - cum_s,i)) v_s``, the
current-token bonus through u, the carried state ``(r_t exp(cum_{t-1})) S``,
then the chunk's state update.  The CUDA source is
``repro_torch/csrc/wkv6.cu``; its header says how the Pallas grid maps onto
CUDA blocks and what bounds the kernel on an H100.

Two paths, chosen by ``path`` from dtype and shape alone: bf16 r, k and v
with hd a multiple of 16 up to 128 (rwkv6's prefill) take the Hopper
kernel ``wkv_fwd_walk``, one launch a call and no scratch: a thread block
cluster a (batch, head), whose blocks build its 64-row chunks in parallel
(each chunk's decay work once, its decays as products of ``w``; loads
through TMA, products through ``wgmma``) while the state passes from
block to block through distributed shared memory.  Its launch geometry
(``walk_geometry``, the cluster size from what the card fits at once) and
tensor maps (``tma_geometry``, run after a refused launch to name the
stride) are computed here and checked on the CPU.  f32, f16 and other
widths take the first port's CUDA-core kernel (32-row chunks).  A call
counts one launch either way.

Beyond the Pallas kernel, which starts from a zero state and returns y
only, this one takes an initial state ``s0`` and returns the last state in
the decode cache's (B, H, hd_k, hd_v) layout.  r, k, v and logw are read
in place through their strides (no per-head copies).  Both kernels handle
a ragged last chunk.

On a CPU tensor the wrapper runs the plain version (``wkv6_plain``, a
transcription of the JAX model's ``models/ssm.py:_wkv_chunked`` with its
chunk rule; a ``meta`` tensor too, for shapes: ``build.takes_plain``); on
a CUDA tensor it launches the kernel or raises.

Training goes through ``wkv6_train``, a ``torch.autograd.Function``: its
forward is ``wkv6`` (the kernel on a CUDA tensor), and its backward reruns
``wkv6_plain`` on the saved inputs under autograd and returns the gradient
of that chunked form.  That is the reference's own backward: the JAX
package has no backward Pallas kernel and trains through XLA's autodiff of
``_wkv_chunked``.  It is the designed backward, not a fallback; a
hand-written backward scan kernel is ROADMAP B7.  On a CPU tensor both
directions run the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan import _recompute_grads

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 128    # the kernels keep a chunk's (rows, hd) tiles in shared memory
WALK_CHUNK = 64       # the Hopper kernel's chunk rows (wgmma's m64)
WALK_BOX = 64         # its TMA boxes' channels, and a consumer's columns
WALK_WARPGROUP = 128  # threads: the att warpgroups, then a consumer a slice
BLOCK_SMEM_MAX = 232448   # a block's largest opt-in on an H100, 227 KB

launches = 0          # kernel launches in this process (chip_smoke reads it)


def _check(r, k, v, logw, u, s0) -> None:
    if r.dim() != 4:
        raise ValueError("r, k, v, logw (B,S,H,hd); u (H,hd)")
    B, S, H, hd = r.shape
    if not (k.shape == v.shape == logw.shape == r.shape):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, logw {tuple(logw.shape)} differ")
    if u.shape != (H, hd):
        raise ValueError(f"u {tuple(u.shape)} is not {(H, hd)}")
    if s0 is not None and s0.shape != (B, H, hd, hd):
        raise ValueError(f"s0 {tuple(s0.shape)} is not {(B, H, hd, hd)}")
    if S < 1:
        raise ValueError("empty sequence")


def path(r: torch.Tensor) -> str:
    """The kernel a call with these inputs takes on the card, from dtype and
    shape alone: ``"tensor-core"`` for bf16 r, k and v whose hd is a
    multiple of 16 (up to ``MAX_HEAD_DIM``), else ``"cuda-core"``."""
    hd = r.shape[-1]
    if r.dtype == torch.bfloat16 and hd % 16 == 0 and hd <= MAX_HEAD_DIM:
        return "tensor-core"
    return "cuda-core"


def walk_smem_bytes(slices: int, stages_in: int, stages_c: int,
                    cluster: int) -> int:
    """Shared memory of one ``wkv_fwd_walk`` block, as ``walk::Layout`` in
    ``csrc/wkv6.cu`` lays it out: 1024 bytes of alignment slack; input
    stages of r's and k's bf16 boxes and logw's f32 box (64 rows x 64
    channels, a box per slice each); consumer stages of v's boxes, q and
    kd hi and lo (a box per slice each), att hi and lo (one box each) and
    e_end, rounded up to 1024 bytes; r P8 (64 rows of 64 slices + 8 f32),
    Wh (8 x 64 slices f32: each 8-row half's product of w), k~8 hi and lo
    (32 rows of 128 bytes a slice each), in a cluster the inbox of the
    state (64 x 64 f32), and one mbarrier an input stage, two a consumer
    stage and one for the state."""
    box = WALK_CHUNK * WALK_BOX * 2          # a bf16 box; logw's f32 is two
    in_bytes = slices * (2 * box + 2 * box)
    c_bytes = -(-(5 * slices * box + 2 * box + 256 * slices) // 1024) * 1024
    rp = WALK_CHUNK * (WALK_BOX * slices + 8) * 4
    inbox = WALK_BOX * WALK_BOX * 4 if cluster > 1 else 0
    return (1024 + stages_in * in_bytes + stages_c * c_bytes + rp
            + 8 * WALK_BOX * slices * 4 + 2 * 32 * 128 * slices + inbox
            + (stages_in + 2 * stages_c + 1) * 8)


def walk_geometry(B: int, S: int, H: int, hd: int, max_clusters) -> dict:
    """The Hopper kernel's launch for hd a multiple of 16 up to 128.  An
    item is one (batch, head), walked by a thread block ``cluster`` of
    blocks: block rho builds chunks rho, rho + cluster, ... (the work the
    state does not enter) and the state passes from block to block through
    distributed shared memory.  ``cluster`` is the largest, at most 8 and
    at most the chunks, whose clusters all fit on the card at once for
    every item (``max_clusters(n)``: the card's count for clusters of n
    blocks; an H100's GPCs take 30 of 4 blocks, not 33); 1 where none does
    and past hd 64.  ``grid``: (items x cluster, 1, 1).  ``slices``: the
    consumer warpgroups, 64 columns of v (``dsl``) each, 1 up to hd 64 and
    2 past it; ``threads``: 384, the att warpgroups (two at one slice, one
    at two) and one a slice.
    ``stages``: (input, consumer) stages, (2, 2) at one slice and (1, 1) at
    two, the most that fit a block's shared memory; ``smem``: the bytes
    (``walk_smem_bytes``).  The C entry point refuses a geometry that
    disagrees with its own layout."""
    slices = -(-hd // WALK_BOX)
    chunks = -(-S // WALK_CHUNK)
    items = B * H
    cluster = 1
    if slices == 1:
        for n in range(min(8, chunks), 1, -1):
            if max_clusters(n) >= items:
                cluster = n
                break
    stages = (2, 2) if slices == 1 else (1, 1)
    return {"dsl": WALK_BOX, "slices": slices, "cluster": cluster,
            "stages": stages, "items": items,
            "smem": walk_smem_bytes(slices, *stages, cluster),
            "grid": (items * cluster, 1, 1),
            "threads": WALK_WARPGROUP * 3}


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, n: int) -> int:
    """The card's count of co-resident clusters of n walk blocks."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = build.load("wkv6").repro_torch_wkv6_max_clusters(
            n, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"wkv6 cluster occupancy query failed: CUDA error "
                           f"{rc}")
    return out.value


def tma_geometry(r, k, v, logw) -> dict:
    """The Hopper kernel's four tensor maps as the C side encodes them from
    the views' strides: name -> (dims innermost first, byte strides of the
    outer dims, box).  Each is over (hd, H, S, B) in boxes of (64, 1, 64,
    1): r, k and v bf16, logw f32; channels past hd and rows past S load as
    zeros.  A dim of size 1 is never stepped and takes the packed stride.
    Raises ``ValueError`` naming a stride TMA cannot take: not a positive
    multiple of 16 bytes below 2^40."""
    return {name: build.tma_map(name, t, (3, 2, 1, 0),
                                (WALK_BOX, 1, WALK_CHUNK, 1))
            for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw))}


def wkv6_plain(r, k, v, logw, u, s0=None, *, chunk: int = 64):
    """The kernel's plain version: the JAX model's ``_wkv_chunked``.

    The chunk rule is the reference's: ``min(chunk, S)``, and the whole
    sequence when that does not divide S.  Returns (y (B,S,H,hd) f32,
    s_last (B,H,hd,hd) f32).
    """
    _check(r, k, v, logw, u, s0)
    B, S, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    nc = S // chunk

    def rs(t):
        return t.reshape(B, nc, chunk, H, hd).movedim(1, 0)

    r_c, k_c, v_c, w_c = rs(r), rs(k), rs(v), rs(logw)
    cum = torch.cumsum(w_c.float(), dim=2)      # (nc,B,c,H,hd)
    tri_lt = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(diagonal=-1)
    uf = u.float()
    ys = []
    for c in range(nc):
        rf, kf, vf = r_c[c].float(), k_c[c].float(), v_c[c].float()
        cumc, wc = cum[c], w_c[c]
        # y_t reads S_{t-1}: pair (s<t) decays by w_{s+1..t-1} =
        # exp(cum[t] - w[t] - cum[s]) — one-step shift vs the state update
        cum_prev = cumc - wc.float()
        delta = cum_prev[:, :, None] - cumc[:, None, :, :]    # (B,t,s,H,hd)
        # masked before the exp, as in ssm_scan_plain: equal values, and a
        # finite gradient where delta > 0 overflows exp (ROADMAP queue C)
        decay = torch.exp(torch.where(tri_lt[None, :, :, None, None], delta,
                                      float("-inf")))
        att = torch.einsum("bthi,bshi,btshi->btsh", rf, kf, decay)
        y = torch.einsum("btsh,bshj->bthj", att, vf)
        # current-token bonus: y[t,j] += (sum_i r[t,i] u[i] k[t,i]) v[t,j]
        y = y + torch.einsum("bthi,bthj->bthj", rf * uf[None, None] * kf, vf)
        # carried state contribution: r_t exp(cum[t-1]) @ S
        y = y + torch.einsum("bthi,bhij->bthj", rf * torch.exp(cum_prev), s)
        # new state: S' = exp(cum[last]) S + sum_s exp(cum[last]-cum[s]) k_s v_s
        dec_end = torch.exp(cumc[:, -1:] - cumc)              # (B,s,H,hd)
        s = torch.exp(cumc[:, -1])[..., None] * s + \
            torch.einsum("bshi,bshj->bhij", kf * dec_end, vf)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, hd), s


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0=None, *, chunk: int = 64):
    """r/k/v (B,S,H,hd); logw (B,S,H,hd) f32 < 0; u (H,hd) f32; s0
    (B,H,hd,hd) f32 or None (zeros).  -> (y (B,S,H,hd) f32, s_last
    (B,H,hd,hd) f32).

    r, k and v share one dtype (f32, f16 or bf16); each of r, k, v and
    logw may be a strided view whose last axis is contiguous, and on the
    tensor-core path (``path``) its rows start on 16 bytes (``ValueError``
    otherwise).  ``chunk`` is the plain version's (the CPU path); the
    kernels walk their own chunks.  On the Hopper path every global stride
    of r, k, v and logw must be a multiple of 16 bytes too (``ValueError``
    from ``tma_geometry``, which names the stride).
    """
    global launches
    _check(r, k, v, logw, u, s0)
    if build.takes_plain("wkv6", r):
        return wkv6_plain(r, k, v, logw, u, s0, chunk=chunk)
    B, S, H, hd = r.shape
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODE:
        raise TypeError(f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes one of {list(_DTYPE_CODE)}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32 or (
            s0 is not None and s0.dtype != torch.float32):
        raise TypeError("logw, u and s0 must be f32")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    tensors = (r, k, v, logw, u) + (() if s0 is None else (s0,))
    if any(t.device != r.device for t in tensors):
        raise ValueError("r, k, v, logw, u and s0 must be on one device")
    if any(t.stride(3) != 1 for t in (r, k, v, logw)):
        raise ValueError("the head dim of r, k, v and logw must be contiguous")
    if not u.is_contiguous() or (s0 is not None and not s0.is_contiguous()):
        raise ValueError("u and s0 must be contiguous")
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    strides = (ctypes.c_longlong * 12)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logw.stride()[:3])
    tensor_core = path(r) == "tensor-core"
    if tensor_core:
        for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
            build.require_aligned16(name, t)
        geo = walk_geometry(B, S, H, hd, functools.partial(
            _max_clusters, r.device.index))
    lib = build.load("wkv6")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                y.data_ptr(), s_last.data_ptr())
        if tensor_core:
            rc = lib.repro_torch_wkv6_walk(
                *args, B, S, H, hd, strides, geo["slices"], geo["cluster"],
                *geo["stages"], geo["smem"], *geo["grid"], geo["threads"],
                stream)
        else:
            rc = lib.repro_torch_wkv6(*args, _DTYPE_CODE[r.dtype], B, S, H,
                                      hd, strides, stream)
    if rc != 0:
        if tensor_core:   # name a stride the tensor maps refused
            tma_geometry(r, k, v, logw)
        raise RuntimeError(f"wkv6 launch failed: CUDA error {rc}")
    launches += 1
    return y, s_last


class _WKV6Train(torch.autograd.Function):
    """``wkv6`` from a zero state, y only, with the plain chunked form's
    gradient."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, logw, u)
        return wkv6(r, k, v, logw, u, chunk=chunk)[0]

    @staticmethod
    def backward(ctx, dy):
        return _recompute_grads(wkv6_plain, ctx.saved_tensors,
                               ctx.needs_input_grad, dy,
                               chunk=ctx.chunk) + (None,)


def wkv6_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, *,
               chunk: int = 64) -> torch.Tensor:
    """The train forward: ``wkv6`` from a zero state -> y (B,S,H,hd) f32,
    differentiable in r, k, v, logw and u.  The forward launches the kernel
    once on a CUDA tensor; the backward recomputes the chunk through
    ``wkv6_plain`` (``chunk`` is its chunk)."""
    return _WKV6Train.apply(r, k, v, logw, u, chunk)
