"""Chunked Mamba2 SSD scan for the port's prefill: a hand-written Hopper kernel.

Replaces the JAX package's Pallas TPU kernel
``kernels/ssm_scan.py:_ssd_kernel`` (its ``pl.pallas_call`` in
``ssd_scan``).  Per (batch, head) it computes the Mamba2 recurrence
``h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t`` in chunked
form: within a chunk the pairwise term ``sum_{s<=t} (C_t.B_s)
exp(cum_t - cum_s) dt_s x_s``, plus the carried state ``exp(cum_t) C_t h``,
then the chunk's state update.  The CUDA source is
``repro_torch/csrc/ssm_scan.cu``; its header says how the Pallas grid maps
onto CUDA blocks and what bounds the kernel on an H100.

Two paths, chosen by ``path`` from dtype and shape alone: bf16 x, B and C
with hd and N multiples of 16 up to 128 (zamba2's prefill) take the Hopper
kernel ``ssd_fwd_walk``, one launch a call: its blocks walk the chunks
of (batch, head, slice of hd) items in turn with the state in registers,
their loads through TMA and their products through ``wgmma``, with no
scratch.  Its launch geometry (``walk_geometry``) and tensor maps
(``tma_geometry``, run after a refused launch to name the stride) are
computed here and checked on the CPU.  f32, f16 and other widths take the
first port's CUDA-core kernel.  A call counts one launch either way.

Beyond the Pallas kernel, which starts from a zero state and returns y
only, this one takes an initial state ``h0`` and returns the last state
``h_last`` in the decode cache's (B, H, hd, N) layout: the model's prefill
caches it.  B and C are shared by all heads and read in place (the Pallas
wrapper copies them to every head), as are x and dt, through their strides.
Both kernels walk their own 64-row chunks and handle a ragged last one; the
chunked form is exact for any chunk, up to rounding.

On a CPU tensor the wrapper runs the plain version (``ssd_scan_plain``, a
transcription of the JAX model's ``models/ssm.py:_ssd_chunked`` with its
chunk rule; a ``meta`` tensor too, for shapes: ``build.takes_plain``); on
a CUDA tensor it launches the kernel or raises.

Training goes through ``ssd_scan_train``, a ``torch.autograd.Function``:
its forward is ``ssd_scan`` (the kernel on a CUDA tensor), and its backward
reruns ``ssd_scan_plain`` on the saved inputs under autograd and returns
the gradient of that chunked form.  That is the reference's own backward:
the JAX package has no backward Pallas kernel and trains through XLA's
autodiff of ``_ssd_chunked``.  It is the designed backward, not a fallback;
a hand-written backward scan kernel is ROADMAP B7.  On a CPU tensor both
directions run the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_STATE = 256       # N: the kernel keeps a chunk of B and C in shared memory
TC_MAX = 128          # the Hopper path's largest hd and N
WALK_CHUNK = 64       # its chunk rows (wgmma's m64)
WALK_THREADS = 192    # a consumer warpgroup and two producer warps
WALK_BLOCKS_PER_SM = 2
SM_SMEM = 233472      # an H100 SM's shared memory, 228 KB
BLOCK_SMEM_MAX = 232448   # a block's largest opt-in, 227 KB
BLOCK_SMEM_RESERVED = 1024  # the runtime's own share of each block

launches = 0          # kernel launches in this process (chip_smoke reads it)


def _check(x, dt, a, B_, C, h0) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or B_.dim() != 3:
        raise ValueError("x (B,S,H,hd), dt (B,S,H), a (H,), B/C (B,S,N)")
    Bsz, S, H, hd = x.shape
    N = B_.shape[-1]
    if dt.shape != (Bsz, S, H) or a.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if B_.shape != (Bsz, S, N) or C.shape != (Bsz, S, N):
        raise ValueError(f"B {tuple(B_.shape)} / C {tuple(C.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if h0 is not None and h0.shape != (Bsz, H, hd, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not {(Bsz, H, hd, N)}")
    if S < 1:
        raise ValueError("empty sequence")


def path(x: torch.Tensor, B_: torch.Tensor) -> str:
    """The kernel a call with these inputs takes on the card, from dtype and
    shape alone: ``"tensor-core"`` for bf16 x, B and C whose hd and N are
    multiples of 16 up to ``TC_MAX``, else ``"cuda-core"``."""
    hd, N = x.shape[-1], B_.shape[-1]
    if (x.dtype == torch.bfloat16 and hd % 16 == 0 and N % 16 == 0
            and hd <= TC_MAX and N <= TC_MAX):
        return "tensor-core"
    return "cuda-core"


def walk_smem_bytes(dsl: int, N: int, stages: int) -> int:
    """Shared memory of one ``ssd_fwd_walk`` block, as ``walk::Layout`` in
    ``csrc/ssm_scan.cu`` lays it out: 1024 bytes of alignment slack, the
    stages (C's and B's 64 x 64 boxes, one or two each, x's 64 x dsl tile
    and w x's hi and lo tiles), two buffers of the state's hi and lo tiles
    (64 or 128 rows of dsl), five rows of 64 f32 scalars a stage (dt,
    cumulative sums, decay factors) and three mbarriers a stage."""
    mt = 2 if N > 64 else 1
    x_bytes = WALK_CHUNK * dsl * 2
    stage = 2 * mt * WALK_CHUNK * 64 * 2 + 3 * x_bytes
    return (1024 + stages * stage + 4 * mt * 64 * dsl * 2
            + stages * 5 * WALK_CHUNK * 4 + 3 * stages * 8)


def walk_geometry(Bsz: int, H: int, hd: int, N: int, sms: int) -> dict:
    """The Hopper kernel's launch for hd and N (multiples of 16 up to 128)
    on a card of ``sms`` SMs.  Its work is ``items``: one (batch, head,
    slice of ``dsl`` columns of hd) each, dsl 32 where hd allows it, there
    is an item for every SM and two blocks fit an SM's shared memory (at 2
    stages: not at hd 128 and N 128), else 16.  The ``grid`` is (blocks,
    1, 1), two blocks an SM (the kernel's launch bounds), and the blocks
    take the items in turn: where there are more items than that, an item
    left over runs on an SM whose other block is done.  ``stages``: 3
    where two blocks of them fit, else 2; ``smem``: the bytes
    (``walk_smem_bytes``).  The C entry point refuses a geometry that
    disagrees with its own layout."""
    def fit(dsl, stages):
        return WALK_BLOCKS_PER_SM * (walk_smem_bytes(dsl, N, stages)
                                     + BLOCK_SMEM_RESERVED) <= SM_SMEM

    dsl = (32 if hd % 32 == 0 and Bsz * H * (hd // 32) >= sms
           and fit(32, 2) else 16)
    items = Bsz * H * (hd // dsl)
    stages = 3 if fit(dsl, 3) else 2
    return {"dsl": dsl, "stages": stages, "items": items,
            "smem": walk_smem_bytes(dsl, N, stages),
            "grid": (min(items, WALK_BLOCKS_PER_SM * sms), 1, 1),
            "threads": WALK_THREADS}


def tma_geometry(x, B_, C, dsl: int) -> dict:
    """The Hopper kernel's three tensor maps as the C side encodes them from
    the views' strides: name -> (dims innermost first, byte strides of the
    outer dims, box).  x: (hd, H, S, B), boxes (dsl, 1, 64, 1); B and C:
    (N, S, B), boxes (64, 64, 1) (N = 128 takes two a chunk; columns past
    N and rows past S load as zeros).  A dim of size 1 is never stepped and
    takes the packed stride.  Raises ``ValueError`` naming a stride TMA
    cannot take: not a positive multiple of 16 bytes below 2^40."""
    return {name: build.tma_map(name, t, axes, box)
            for name, t, axes, box in (
                ("x", x, (3, 2, 1, 0), (dsl, 1, WALK_CHUNK, 1)),
                ("B", B_, (2, 1, 0), (64, WALK_CHUNK, 1)),
                ("C", C, (2, 1, 0), (64, WALK_CHUNK, 1)))}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ssd_scan_plain(x, dt, a, B_, C, h0=None, *, chunk: int = 256):
    """The kernel's plain version: the JAX model's ``_ssd_chunked``, with
    C.B formed in f32 as the Pallas kernel forms it.

    The chunk rule is the reference's: ``min(chunk, S)``, and the whole
    sequence when that does not divide S.  Returns (y (B,S,H,hd) f32,
    h_last (B,H,hd,N) f32).
    """
    _check(x, dt, a, B_, C, h0)
    Bsz, S, H, hd = x.shape
    N = B_.shape[-1]
    h = (torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    nc = S // chunk

    def r(t):  # (B,S,...) -> (nc,B,c,...)
        return t.reshape(Bsz, nc, chunk, *t.shape[2:]).movedim(1, 0)

    xh_c, dt_c, B_c, C_c = r(x), r(dt), r(B_), r(C)
    cum = torch.cumsum(dt_c * a, dim=2)      # within-chunk cumulative log-decay
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc, cumc = xh_c[c], dt_c[c], B_c[c], C_c[c], cum[c]
        # C.B in f32, as the Pallas kernel and the CUDA kernel form it; the
        # JAX model's einsum rounds it to the compute dtype first (ROADMAP
        # queue C), which in bf16 moves y by more than the kernels' tolerance
        cb = torch.einsum("btn,bsn->bts", cc.float(), bc.float())
        delta = cumc[:, :, None, :] - cumc[:, None, :, :]         # (B,t,s,H)
        # masked before the exp, where the reference masks after it: the
        # values are equal, but above the diagonal delta > 0 overflows
        # exp in f32 at a long chunk's decay (zamba2's 256 rows), and the
        # reference's gradient there is 0 * inf = NaN (ROADMAP queue C)
        L = torch.exp(torch.where(tri[None, :, :, None], delta,
                                  float("-inf")))
        w = cb[..., None] * L
        dx = dtc[..., None] * xc.float()                          # (B,s,H,hd)
        y = torch.einsum("btsh,bshd->bthd", w, dx)
        y = y + torch.einsum("btn,bth,bhdn->bthd", cc.float(),
                             torch.exp(cumc), h)
        decay_to_end = torch.exp(cumc[:, -1:, :] - cumc)          # (B,s,H)
        s_chunk = torch.einsum("bsh,bsn,bshd->bhdn",
                               (dtc * decay_to_end).float(), bc.float(),
                               xc.float())
        h = torch.exp(cumc[:, -1, :])[..., None, None] * h + s_chunk
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(Bsz, S, H, hd), h


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             B_: torch.Tensor, C: torch.Tensor, h0=None, *,
             chunk: int = 256):
    """x (B,S,H,hd); dt (B,S,H) f32 > 0; a (H,) f32 < 0; B/C (B,S,N);
    h0 (B,H,hd,N) f32 or None (zeros).  -> (y (B,S,H,hd) f32, h_last
    (B,H,hd,N) f32).

    x, B and C share one dtype (f32, f16 or bf16); each may be a strided
    view whose last axis is contiguous, and on the tensor-core path
    (``path``) its rows start on 16 bytes (``ValueError`` otherwise).
    ``chunk`` is the plain version's (the CPU path); the kernels walk their
    own 64-row chunks.  On the Hopper path every global stride of x, B and
    C must be a multiple of 16 bytes too (``ValueError`` from
    ``tma_geometry``, which names the stride).
    """
    global launches
    _check(x, dt, a, B_, C, h0)
    if build.takes_plain("ssd_scan", x):
        return ssd_scan_plain(x, dt, a, B_, C, h0, chunk=chunk)
    Bsz, S, H, hd = x.shape
    N = B_.shape[-1]
    if not (x.dtype == B_.dtype == C.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x/B/C dtypes {x.dtype}/{B_.dtype}/{C.dtype}: the "
                        f"kernel takes one of {list(_DTYPE_CODE)}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise TypeError("dt, a and h0 must be f32")
    if N > MAX_STATE:
        raise ValueError(f"state dim {N} > {MAX_STATE}")
    tensors = (x, dt, a, B_, C) + (() if h0 is None else (h0,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, a, B, C and h0 must be on one device")
    if x.stride(3) != 1 or B_.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("the last axis of x, B and C must be contiguous")
    if not a.is_contiguous() or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("a and h0 must be contiguous")
    y = torch.empty((Bsz, S, H, hd), dtype=torch.float32, device=x.device)
    h_last = torch.empty((Bsz, H, hd, N), dtype=torch.float32,
                         device=x.device)
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B_.stride()[:2], *C.stride()[:2])
    tensor_core = path(x, B_) == "tensor-core"
    if tensor_core:
        for name, t in (("x", x), ("B", B_), ("C", C)):
            build.require_aligned16(name, t)
        geo = walk_geometry(Bsz, H, hd, N, _sm_count(x.device.index))
    lib = build.load("ssm_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(),
                C.data_ptr(), None if h0 is None else h0.data_ptr(),
                y.data_ptr(), h_last.data_ptr())
        if tensor_core:
            rc = lib.repro_torch_ssd_walk(
                *args, Bsz, S, H, hd, N, strides, geo["dsl"], geo["stages"],
                geo["smem"], *geo["grid"], stream)
        else:
            rc = lib.repro_torch_ssd_scan(*args, _DTYPE_CODE[x.dtype], Bsz, S,
                                          H, hd, N, strides, stream)
    if rc != 0:
        if tensor_core:   # name a stride the tensor maps refused
            tma_geometry(x, B_, C, geo["dsl"])
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    launches += 1
    return y, h_last


def _recompute_grads(plain, saved, needs, dy, **kw):
    """The backward of a scan's train Function: rerun ``plain(*saved,
    **kw)`` under autograd and return the gradient of its first output
    against ``dy`` for each input that ``needs`` one (None for the rest)."""
    ins = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
    with torch.enable_grad():
        y = plain(*ins, **kw)[0]
        grads = iter(torch.autograd.grad(
            y, [t for t in ins if t.requires_grad], dy))
    return tuple(next(grads) if t.requires_grad else None for t in ins)


class _SSDTrain(torch.autograd.Function):
    """``ssd_scan`` from a zero state, y only, with the plain chunked form's
    gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, B_, C, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, B_, C)
        return ssd_scan(x, dt, a, B_, C, chunk=chunk)[0]

    @staticmethod
    def backward(ctx, dy):
        return _recompute_grads(ssd_scan_plain, ctx.saved_tensors,
                               ctx.needs_input_grad, dy,
                               chunk=ctx.chunk) + (None,)


def ssd_scan_train(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   B_: torch.Tensor, C: torch.Tensor, *,
                   chunk: int = 256) -> torch.Tensor:
    """The train forward: ``ssd_scan`` from a zero state -> y (B,S,H,hd)
    f32, differentiable in x, dt, a, B and C.  The forward launches the
    kernel once on a CUDA tensor; the backward recomputes the chunk through
    ``ssd_scan_plain`` (``chunk`` is its chunk)."""
    return _SSDTrain.apply(x, dt, a, B_, C, chunk)
