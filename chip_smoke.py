"""Proof that the PyTorch/CUDA port builds, serves and trains on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device  — a CUDA card is required; prints its name and power limit;
  2. build   — compiles every kernel of the port from ``src/repro_torch/csrc``
               (six sources) with nvcc, all at once, and prints the build
               time;
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main path's shape and at edge shapes, with stated
               tolerances; times the kernel, the plain version and the one
               PyTorch call that computes the same function where there is
               one (a yardstick only: the port never calls it); computes the
               card's bound.  Times are device times: CUDA events around
               launches enqueued while a sleep kernel holds the stream, so
               the host's launch cost is not counted; the median of three.
               Flash attention at phi4's prefill, zamba2's (dh 80),
               granite-moe's (dh 64), the static batcher's (B=4) and
               codeqwen1.5-7b's (H = KV = 32); xent forward and backward
               at the train phase's loss chunk, and the backward with the RL learner's dy (zero on prompt rows
               and on a zero-advantage rollout, negative where the
               advantage is); AdamW at phi4's embedding; the SSD scan at
               zamba2's prefill and WKV6 at rwkv6's, each case printing the
               path it took (bf16 widths that are multiples of 16: the
               tensor-core kernels; f32, f16, other widths: the CUDA-core
               ones), timed warm and cold (rotating through copies of the
               inputs past the L2), the bound's operations at the inputs'
               type's rate; the grouped matmul at
               granite-moe's prefill and decode buckets (f32, f16, bf16),
               ragged and strided shapes, timed warm (20 launches on one
               copy) and cold (rotating through copies of x and w that
               together exceed the 50 MB L2 several times, as a decode
               step walks 72 distinct weight matrices), torch.bmm alike;
  4. small   — phi4 smoke config in f32: the card's prefill logits (through
               the kernel) against the CPU's (through the plain version);
               then zamba2 smoke with two groups (12 layers) and rwkv6 smoke
               in f32: prefill logits and every cache leaf, last states
               included, card (kernels) against CPU (plain versions); then
               granite-moe smoke with two layers in f32: a prefill and 4
               decode steps, logits and the KV cache, card against CPU;
  5. small-train — phi4 smoke in f32 with two layers: two train steps on the
               card (through the kernels) against the CPU (through the plain
               versions) on the same params and batches;
  6. serve   — full-width phi4-mini-3.8b and granite-moe-1b-a400m in bf16
               (random weights from a seed) each serve 8 requests through
               the paged pool with the prefix cache: every request
               completes, the prefix cache hits, flash ran on every layer of
               every full prefill and on no decode step, and (granite) the
               grouped matmul ran 3 times a layer in every full prefill and
               every decode step; then a short run shows paged tokens equal
               slotted tokens;
  7. serve-ssm — full-width zamba2-2.7b and rwkv6-1.6b in bf16 (random
               weights from a seed) each serve the same 8 requests through
               the slotted cache (their state caches do not page): a
               full-width prefill gives finite logits and states, every
               request completes with its stop length, and the SSD kernel
               ran on all 54 zamba2 layers (flash on its 9 shared-attention
               layers) and WKV6 on all 24 rwkv6 layers of every full prefill;
  8. train   — full-width phi4-mini-3.8b, random weights from seed 0 with
               the attention projections at their contracted fan-in: first
               the grads of the first batch in bf16 against f32 on the same
               weights, each leaf's norm within GRAD_RTOL; then in bf16 it
               takes 6 optimizer steps of 2 x 1024 tokens as two
               ``train_chunk`` calls of 3: every loss and grad norm finite,
               the last loss below the first, and exactly 2 xent forward,
               2 xent backward and 11 AdamW launches a step;
  9. elastic — phi4-mini-3.8b in bf16 at full width with depth cut to 4
               layers (1.017 B params, a 10.2 GB checkpoint) trains 8 steps
               of 2 x 1024 tokens through ``ElasticTrainer`` on a one-card
               ``Cluster``, in chunks of 2, checkpointing every 4 steps into
               a temporary directory, with one crash injected before step 7:
               segments ``error`` then ``done``, step 3 restored bit for bit
               as saved, 2 steps lost, 10 executed, exactly 20 xent forward,
               20 backward and 110 AdamW launches; every loss finite and
               equal to a clean run's (bit for bit if two clean runs agree
               bit for bit, else within twice their spread);
 10. router  — full-width phi4-mini-3.8b in bf16 (the serve phase's
               weights) behind ``serve_replicated``: 16 requests of the
               serve mix, 1 to 2 replicas of 4 slots (paged, prefix cache):
               every request completes with its stop length, the autoscaler
               scales up, flash runs on every layer of every prefill, and
               every request served on the same path as in the serve phase
               (prefilled whole, or replaying the cached prefix) has its
               tokens; then ``serve_static`` in batches of 4 on the same
               requests: every request completes with its stop length,
               flash runs on every layer of each B=4 prefill, and the share
               of requests whose tokens equal the continuous engine's is
               printed;
 11. rl      — phi4-mini-3.8b in bf16 at full width with depth cut to 4
               layers through ``run_rl_fleet``: 2 actors of 4 slots
               (paged), prompts of 128 and 128 new tokens, 8 rollouts a
               learner step, 4 steps, a publish every 2: done, every
               version published once, every actor synced, every trained
               rollout within the staleness bound, finite losses and grad
               norms, 4 xent forward, 4 backward and 44 AdamW launches, and
               flash on every layer of every actor prefill;
 12. session — one ``Session(cluster=Cluster())`` on the card, each
               workload applied as a manifest dict: a. a ServeJob of
               full-width phi4 (8 requests of 512 tokens, stops
               16/64/8/32, 4 slots, paged, prefix cache): Succeeded, the
               lifecycle in order on the handle and on the bus, every
               request at its stop length, flash 32 a prefill, tokens
               equal to a direct ``build_engine`` + ``run`` of the same
               job; b. a TrainJob of phi4 at 4 layers (the train phases'
               contracted init, lr 3e-5, 4 steps of 2 x 1024 tokens in
               chunks of 2, no checkpoint): finite losses, the last below
               the first, equal to those of a direct ``ElasticTrainer``
               run of the same spec and init (bit for bit if the elastic
               phase's clean runs agree bit for bit, else within twice
               their spread), 2/2/11 xent/AdamW launches a step; c. the same
               job for 40 steps, cancelled once its step reaches 2:
               Cancelled within one chunk, its goodbye checkpoint at the
               last step (10.17 GB, in a temporary directory), the
               seconds from ``cancel()`` to terminal printed; d. a graph
               WorkflowRun (plan -> 2 branches -> join, entrypoints in
               this script) whose branches are pods that lease the card
               in turn and run flash against its plain version, every
               marker written; e. a ServeJob of codeqwen1.5-7b at full
               width (4 requests of 512 tokens, 32 new, paged): every
               request at its stop length, flash 32 a prefill, a fresh
               prefill on the same weights finite with the session's
               first token as its argmax.
 13. connect — the CONNECT case study (paper §III) at the paper-shaped
               grid (4 chunks of 24 frames x 361 x 576) and the full FFN
               width (depth 8, width 32, fov 16 x 32 x 32, 4 flood
               iterations; 120 train steps of 4), a WorkflowRun naming
               ``repro_torch.apps.connect.pipeline:add_connect_steps``
               through ``Session(cluster=Cluster())``: Succeeded, a mask
               per chunk, objects found, the trained model's mean loss over
               its training windows below the initial model's (the first
               and last batch losses are printed, not compared: their
               windows hold 0.15 % and 1.08 % object voxels); a second apply over
               the same store skips all four steps with an equal analysis;
               the card's ``ffn_apply`` on one batch of the trained model
               within FFN_RTOL of the CPU's (f32, no TF32), and
               ``connect_label`` on chunk 0's mask equal to the CPU's;
               prints Table I, seconds a step, ms a train step, flood-fill
               voxels/s, IoU against the labels, peak GB, bytes written;
 14. fabric  — the three sites of ``examples/federated_connect.py`` (4, 2
               and 1 logical slots, 10 Gbps sdsc-calit2, 1 Gbps to edge,
               time_scale 0) computing on the card: phase 13's run with the
               locality planner, the data-blind one (more bytes moved), and
               the hub killed after download (completes on the survivors, a
               migrated step recorded), each training phase 13's model and
               finding its objects (the convolutions are deterministic);
               then through ``Session(fabric=, planner=)`` a full-width
               phi4 ServeJob (4 requests of 512 tokens, stops 16/64/8/32,
               flash 32 a prefill, the site named) and a phi4 smoke
               TrainJob whose site is killed once step 7 is logged (one
               migration, finished on the survivor, a finite loss a step,
               exact xent/AdamW launches).
The phases that write checkpoints (elastic, rl, session) print the bytes
they wrote and left on disk, and connect and fabric the bytes their runs
wrote.  Then it prints a ``{"kernels": [...]}`` line, a
``{"serve": {...}}`` line with one entry per arch, a ``{"train": {...}}``
line, an ``{"elastic": {...}}`` line, a ``{"router": ..., "static":
...}`` line, an ``{"rl": {...}}`` line, one ``{"session": {...}}`` line a
workload (apply -> Running and wall seconds, tok/s beside the direct
engine's, ms a step, events, peak GB, the card), a ``{"connect": {...}}``
and a ``{"fabric": {...}}`` line (each with the card), the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}           # H100 SXM dense, per second
PEAK_BYTES = 3.35e12                           # H100 SXM HBM3, per second
ARCH = "phi4-mini-3.8b"
ZAMBA, RWKV = "zamba2-2.7b", "rwkv6-1.6b"
GRANITE = "granite-moe-1b-a400m"
SCAN_RTOL = 1e-4          # SSD/WKV6 kernel vs plain, of the output's scale
# gmm kernel vs plain, of the output's scale: f32 sums over D in another
# order; in f16/bf16 one rounding of the output, which the other f32 sum
# can push across a rounding boundary
GMM_RTOL = {torch.float32: 1e-5, torch.float16: 2 ** -7,
            torch.bfloat16: 2 ** -7}
PROMPT, GEN, SLOTS, BLOCK = 512, 64, 4, 16
SYSTEM_PREFIX = 448                            # shared by half the requests
GEN_LENS = (16, 64, 8, 32)                     # cycled stop lengths
ZAMBA_ATTN = (1, 32, 32, PROMPT, PROMPT, 80)   # zamba2's shared attention
GRANITE_ATTN = (1, 16, 8, PROMPT, PROMPT, 64)  # granite-moe's attention
COLD_BYTES = 150e6        # cold timing: > 2x a prefill bucket, > 3x a decode
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_K = 2, 1024, 6, 3
# elastic: full width, depth cut to 4 layers (a 10.2 GB checkpoint; 38.4 GB
# at 32), 8 steps in chunks of 2, saves at steps 3 and 7, a crash before 7
ELASTIC_LAYERS, ELASTIC_STEPS, ELASTIC_K = 4, 8, 2
ELASTIC_CKPT_EVERY, ELASTIC_FAIL_AT, ELASTIC_RESTORED = 4, 7, 3
GRAD_RTOL = 0.05          # bf16 vs f32 first-batch grad norm, per leaf
# router: 16 requests of the serve mix queued at once; at 4 a replica the
# autoscaler wants 4 replicas and is clamped to 2.  Static: batches of 4.
ROUTER_REQUESTS, ROUTER_BACKLOG, STATIC_BATCH = 16, 4.0, 4
STATIC_ATTN = (STATIC_BATCH, 24, 8, PROMPT, PROMPT, 128)  # its B=4 prefill
# rl: phi4 at ELASTIC_LAYERS, 2 actors of 4 slots, prompts of 128 and 128
# new tokens, 8 rollouts a learner step, 4 steps, a publish every 2
RL_ACTORS, RL_SLOTS, RL_PROMPT, RL_GEN = 2, 4, 128, 128
RL_ROLLOUTS, RL_STEPS, RL_BROADCAST, RL_LAG = 8, 4, 2, 2
# session: one Session(cluster=Cluster()) on the card; phi4 at
# ELASTIC_LAYERS trains SESSION_STEPS steps in chunks of SESSION_K, and a
# second job of SESSION_CANCEL_STEPS is cancelled once its step reaches
# SESSION_CANCEL_AT; codeqwen serves CODEQWEN_REQUESTS of CODEQWEN_GEN
CODEQWEN = "codeqwen1.5-7b"
CODEQWEN_ATTN = (1, 32, 32, PROMPT, PROMPT, 128)   # codeqwen's prefill
CODEQWEN_REQUESTS, CODEQWEN_GEN = 4, 32
SESSION_STEPS, SESSION_K, SESSION_CANCEL_STEPS, SESSION_CANCEL_AT = 4, 2, 40, 2
# the TrainJobs' learning rate: the TrainJob's default (1e-3, one warmup
# step) is a smoke model's; at full width its first Adam step raises the
# loss of a random-init model, and 4 steps do not bring it back
SESSION_LR = 3e-5
SESSION_BRANCHES = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False
    return smi


def _ptxas_report(text: str):
    """(kernel, registers, static shared memory, spill line) for each entry
    function in nvcc's -Xptxas -v output, names demangled by c++filt where
    the machine has it."""
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used " in line and name:
            regs = line.split("Used ")[1].split(" registers")[0]
            smem = (line.split(", ")[-1].split(" bytes smem")[0]
                    if "bytes smem" in line else "0")
            rows.append([name, regs, smem, spill])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        if len(names) == len(rows):
            for row, demangled in zip(rows, names):
                row[0] = demangled.replace("(anonymous namespace)::", "")
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out = build.build_all()
    log(f"[build] {sorted(out)} in {time.perf_counter() - t0:.2f} s")
    for name, text in out.items():
        for kernel, regs, smem, spill in _ptxas_report(text):
            log(f"[build:{name}] {kernel}: {regs} registers, {smem} bytes "
                f"static shared memory; {spill}")


MAX_CLOCK_HZ = 2.0e9      # above any H100 SM clock, so holds last long enough


def _hold_stream(ms: float) -> None:
    """Keep the current stream busy for at least `ms` with a sleep kernel,
    so that launches enqueued meanwhile wait behind it: events recorded
    after it then time the device's work, not the host's launch rate (a
    wrapper call costs tens of microseconds of Python, as long as the fast
    kernels themselves)."""
    torch.cuda._sleep(int(ms * 1e-3 * MAX_CLOCK_HZ))


def _device_ms(calls) -> float:
    """Device time of the calls (a list of thunks) run back to back, in ms
    a call: the stream is held while the host enqueues them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls[0]()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    _hold_stream(2.0 + 3.0 * host_ms * len(calls))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for call in calls:
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(calls)


def _host_us(fn, calls: int = 50) -> float:
    """Host time of one call of fn in microseconds: what the Python around
    a launch costs, the floor of a host-bound loop of such calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def _time_ms(fn, iters: int = 20) -> float:
    """Warm device time of fn, one launch after another on one input: the
    median of three runs of `iters` launches."""
    for _ in range(3):
        fn()
    return statistics.median(_device_ms([fn] * iters) for _ in range(3))


def _time_cold_ms(fn, args_list, rounds: int = 4) -> float:
    """Device time of fn(*args) over `rounds` passes through args_list, whose
    entries are distinct copies of the inputs: when their bytes exceed the
    L2 cache several times over, each launch finds its inputs in HBM.  The
    median of three such runs."""
    for args in args_list:
        fn(*args)
    calls = [lambda a=args: fn(*a) for args in args_list] * rounds
    return statistics.median(_device_ms(calls) for _ in range(3))


def _attention_bound(B, H, KV, Sq, Sk, dh, causal, dtype):
    """(bound_ms, bound_by): q, k, v read once and o written once, against
    the score and PV products this mask needs (visible pairs only)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (2 * B * H * Sq * dh + 2 * B * KV * Sk * dh)
    if causal:
        pairs = sum(max(0, min(Sk, i + Sk - Sq + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    return _bound(nbytes, 4.0 * B * H * pairs * dh, dtype)


def phase_kernels(main_shape):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (B, H, KV, Sq, Sk, dh, causal, dtype, tolerance)
        main_shape + (True, torch.bfloat16, 2e-2),
        ZAMBA_ATTN + (True, torch.bfloat16, 2e-2),               # dh 80
        GRANITE_ATTN + (True, torch.bfloat16, 2e-2),             # dh 64
        STATIC_ATTN + (True, torch.bfloat16, 2e-2),              # B=4
        CODEQWEN_ATTN + (True, torch.bfloat16, 2e-2),            # KV = H
        (2, 4, 2, 130, 130, 80, True, torch.float32, 2e-5),
        (1, 24, 8, 300, 300, 128, True, torch.bfloat16, 2e-2),   # ragged
        (2, 24, 8, 300, 300, 128, False, torch.bfloat16, 2e-2),
        (1, 8, 2, 200, 200, 64, True, torch.float32, 2e-5),
        (1, 8, 8, 96, 520, 128, True, torch.float16, 2e-2),      # Sq<Sk, KV==H
        (2, 4, 4, 130, 130, 32, False, torch.float32, 2e-5),
    ]
    rows = []
    for (B, H, KV, Sq, Sk, dh, causal, dtype, tol) in cases:
        q = torch.randn(B, H, Sq, dh, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, KV, Sk, dh, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, KV, Sk, dh, generator=gen, device="cuda").to(dtype)
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        shape = f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} dh={dh} " \
                f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
        log(f"[kernels] flash_attention {shape}: max_abs_err={err:.3g} "
            f"(tolerance {tol})")
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {shape}: {err} > {tol}")
        rows.append((shape, err, q, k, v, causal))
    timed = {}
    for i, shape_args in ((0, main_shape), (1, ZAMBA_ATTN),
                          (2, GRANITE_ATTN), (3, STATIC_ATTN),
                          (4, CODEQWEN_ATTN)):
        shape, err, q, k, v, causal = rows[i]
        ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
        plain_ms = _time_ms(lambda: fa.attention_plain(q, k, v,
                                                       causal=causal))
        g = q.shape[1] // k.shape[1]
        library_ms = _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=g > 1))
        host_us = _host_us(lambda: fa.flash_attention(q, k, v,
                                                      causal=causal))
        bound_ms, bound_by = _attention_bound(*shape_args, causal, q.dtype)
        log(f"[kernels] flash timed at {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}); the wrapper's host time "
            f"{host_us:.1f} us a call")
        timed[i] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, "shape": shape,
                    "host_us": host_us}
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:25",
            "launches": None, **timed[0],
            "edge_shapes_max_abs_err": max(r[1] for r in rows[5:]),
            "zamba2_dh80": timed[1], "granite_dh64": timed[2],
            "static_b4": timed[3], "codeqwen_kv32": timed[4]}


def _bound(nbytes: float, flops: float, dtype=torch.float32):
    """(bound_ms, bound_by): bytes over the memory rate against operations
    over the peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _xent_case(R, V, *, softcap=None, dtype=torch.float32, scale=4.0,
               stride_pad=0, gen=None):
    """Logits (R, V) of ``dtype`` (a view with row stride V + stride_pad),
    int32 labels, f32 dy, all on the card."""
    full = scale * torch.randn(R, V + stride_pad, generator=gen, device="cuda")
    logits = full.to(dtype)[:, :V]
    labels = torch.randint(0, V, (R,), generator=gen, device="cuda",
                           dtype=torch.int32)
    dy = torch.randn(R, generator=gen, device="cuda")
    return logits, labels, dy, softcap


def _xent_errs(logits, labels, dy, softcap):
    """(nll err, dlogits err, nll tolerance, dlogits tolerance) of the
    kernels against their plain versions on the same inputs."""
    from repro_torch.kernels import xent
    nll, lse = xent.xent_fwd(logits, labels, softcap)
    d = xent.xent_bwd(logits, labels, lse, dy, softcap)
    torch.cuda.synchronize()
    want_nll, _ = xent.xent_fwd_plain(logits, labels, softcap)
    want_d = xent.xent_bwd_plain(logits, labels, lse, dy, softcap)
    # forward: f32 sums over V in another order, relative to the NLL's
    # scale; backward: same lse, so one exp and three roundings apart in
    # f32, one rounding of the output in bf16
    tol_nll = 1e-4 + 1e-6 * want_nll.abs().max().item()
    tol_d = (1e-5 if logits.dtype == torch.float32 else 2 ** -7) * max(
        1.0, dy.abs().max().item())
    return ((nll - want_nll).abs().max().item(),
            (d.float() - want_d.float()).abs().max().item(), tol_nll, tol_d)


def phase_xent(R: int, V: int):
    """xent forward and backward against their plain versions at the train
    phase's loss chunk (R rows, V vocab, f32) and at edge shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import xent
    gen = torch.Generator(device="cuda").manual_seed(4)
    edge = {
        "ragged R=100 V=777": _xent_case(100, 777, gen=gen),
        "V<block R=32 V=50": _xent_case(32, 50, gen=gen),
        "softcap 30 R=300 V=5000": _xent_case(300, 5000, softcap=30.0,
                                               gen=gen),
        "bf16 R=64 V=1000 row stride 1024": _xent_case(
            64, 1000, dtype=torch.bfloat16, stride_pad=24, gen=gen),
    }
    big = torch.tensor([[1000.0, 0.0, -1000.0, 500.0]] * 8, device="cuda")
    edge["logits +-1000 R=8 V=4"] = (
        big, torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int32,
                          device="cuda"), torch.ones(8, device="cuda"), None)
    # the RL learner's chunk: 8 rollouts of 256 positions, dy = mask *
    # advantage / sum(mask): 0 on prompt and pad rows and on a rollout
    # whose advantage is 0, negative where the advantage is
    rl_gen = torch.Generator(device="cuda").manual_seed(5)
    logits, labels, _, _ = _xent_case(RL_ROLLOUTS * (RL_PROMPT + RL_GEN), V,
                                      gen=rl_gen)
    mask = torch.zeros(RL_ROLLOUTS, RL_PROMPT + RL_GEN, device="cuda")
    mask[:, RL_PROMPT - 1:RL_PROMPT + RL_GEN - 1] = 1.0
    adv = torch.randn(RL_ROLLOUTS, generator=rl_gen, device="cuda")
    adv[3] = 0.0
    rl_dy = (mask * adv[:, None] / mask.sum()).reshape(-1)
    rl_case = f"rl dy R={logits.shape[0]} V={V}"
    edge[rl_case] = (logits, labels, rl_dy, None)
    edge_errs = {}
    for name, case in edge.items():
        e_nll, e_d, t_nll, t_d = _xent_errs(*case)
        log(f"[kernels] xent {name}: nll max_abs_err={e_nll:.3g} (tolerance "
            f"{t_nll:.3g}), dlogits max_abs_err={e_d:.3g} (tolerance "
            f"{t_d:.3g})")
        if not (e_nll <= t_nll and e_d <= t_d):
            raise AssertionError(f"xent disagrees with its plain version at "
                                 f"{name}")
        edge_errs[name] = (e_nll, e_d)
    _, lse = xent.xent_fwd(logits, labels)
    d = xent.xent_bwd(logits, labels, lse, rl_dy)
    zero_rows = rl_dy == 0
    log(f"[kernels] xent rl dy: {int(zero_rows.sum())} of {rl_dy.numel()} "
        f"rows with dy 0, {int((rl_dy < 0).sum())} negative; their dlogits "
        f"all zero: {not bool(d[zero_rows].any())}")
    if d[zero_rows].any() or not (rl_dy < 0).any():
        raise AssertionError("xent backward: a row with dy 0 has non-zero "
                             "dlogits, or the case has no negative dy")
    del logits, labels, d, lse

    logits, labels, dy, _ = _xent_case(R, V, gen=gen)
    e_nll, e_d, t_nll, t_d = _xent_errs(logits, labels, dy, None)
    shape = f"R={R} V={V} f32"
    log(f"[kernels] xent main {shape}: nll max_abs_err={e_nll:.3g} "
        f"(tolerance {t_nll:.3g}), dlogits max_abs_err={e_d:.3g} "
        f"(tolerance {t_d:.3g})")
    if not (e_nll <= t_nll and e_d <= t_d):
        raise AssertionError(f"xent disagrees with its plain version at "
                             f"{shape}")
    _, lse = xent.xent_fwd(logits, labels)
    lab64 = labels.long()
    fwd_ms = _time_ms(lambda: xent.xent_fwd(logits, labels))
    fwd_plain = _time_ms(lambda: xent.xent_fwd_plain(logits, labels))
    fwd_lib = _time_ms(lambda: F.cross_entropy(logits, lab64,
                                               reduction="none"))
    bwd_ms = _time_ms(lambda: xent.xent_bwd(logits, labels, lse, dy))
    bwd_plain = _time_ms(lambda: xent.xent_bwd_plain(logits, labels, lse, dy))
    leaf = logits.detach().requires_grad_()
    bwd_lib = _time_ms(lambda: torch.autograd.grad(
        F.cross_entropy(leaf, lab64, reduction="none"), leaf,
        grad_outputs=dy))
    n = R * V
    fwd_bound = _bound(4.0 * n + 12.0 * R, 4.0 * n)      # max, sub, exp, add
    bwd_bound = _bound(8.0 * n + 12.0 * R, 5.0 * n)      # sub, exp, sub, mul
    log(f"[kernels] xent main {shape}: forward {fwd_ms:.4f} ms (plain "
        f"{fwd_plain:.4f}, F.cross_entropy {fwd_lib:.4f}, bound "
        f"{fwd_bound[0]:.4f} {fwd_bound[1]}); backward {bwd_ms:.4f} ms (plain "
        f"{bwd_plain:.4f}, F.cross_entropy fwd+bwd {bwd_lib:.4f}, bound "
        f"{bwd_bound[0]:.4f} {bwd_bound[1]})")
    common = {"route": "cuda", "source": "src/repro_torch/csrc/xent.cu",
              "launches": None, "shape": shape}
    fwd = dict(common, name="xent_fwd",
               replaces="src/repro/kernels/xent.py:37", max_abs_err=e_nll,
               ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
               bound_by=fwd_bound[1], library_ms=fwd_lib,
               library="F.cross_entropy(reduction='none')",
               edge_shapes_max_abs_err=max(e[0] for e in edge_errs.values()))
    bwd = dict(common, name="xent_bwd",
               replaces="src/repro/kernels/xent.py:69", max_abs_err=e_d,
               ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0],
               bound_by=bwd_bound[1], library_ms=bwd_lib,
               library="F.cross_entropy forward+backward",
               edge_shapes_max_abs_err=max(e[1] for e in edge_errs.values()),
               rl_dy_max_abs_err=edge_errs[rl_case][1])
    return fwd, bwd


def _adamw_case(n_or_shape, pdtype, gdtype, gen):
    shape = n_or_shape if isinstance(n_or_shape, tuple) else (n_or_shape,)
    p = (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(pdtype)
    g = (1e-3 * torch.randn(shape, generator=gen, device="cuda")).to(gdtype)
    m = 1e-4 * torch.randn(shape, generator=gen, device="cuda")
    v = 1e-7 * torch.rand(shape, generator=gen, device="cuda")
    return p, g, m, v


def _adamw_errs(p, g, m, v, scalars, hyper):
    """Max abs error of (p, m, v) from the kernel against the plain version
    on the same inputs, the tolerance, and whether all three are bit equal."""
    from repro_torch.kernels import adamw_update as au
    kp, km, kv = p.clone(), m.clone(), v.clone()
    au.adamw_update(kp, g, km, kv, scalars, **hyper)
    torch.cuda.synchronize()
    wp, wm, wv = au.adamw_update_plain(p, g, m, v, scalars, **hyper)
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in ((kp, wp), (km, wm), (kv, wv))]
    exact = all(torch.equal(a, b) for a, b in ((kp, wp), (km, wm), (kv, wv)))
    # f32: the kernel rounds each step as the plain version does, so it
    # should be bit equal; allow 1e-6 of the values' scale.  bf16 p: one
    # rounding of the output, 2^-7 of |p|.
    scale = max(1e-3, wp.float().abs().max().item())
    tol_p = (1e-6 if p.dtype == torch.float32 else 2 ** -7) * scale
    tol_mv = 1e-6 * max(wm.abs().max().item(), wv.abs().max().item())
    ok = errs[0] <= tol_p and max(errs[1:]) <= tol_mv
    return max(errs), ok, exact, tol_p


def phase_adamw(embed_shape):
    """AdamW against its plain version at phi4's embedding leaf (bf16 p and
    g) and at edge cases; timed there."""
    from repro_torch.kernels import adamw_update as au
    gen = torch.Generator(device="cuda").manual_seed(6)
    scalars = torch.tensor([3e-4, 0.1, 0.05], device="cuda")
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (shape or n, p dtype, g dtype, weight decay)
        (embed_shape, bf, bf, 0.1),
        (embed_shape, bf, bf, 0.0),
        ((3072, 8192), bf, f32, 0.1),
        ((3072, 8192), f32, f32, 0.1),
        (1_000_003, f32, f32, 0.0),
        (1_000_003, bf, bf, 0.1),
        (5, f32, bf, 0.1),
    ]
    main_err = None
    for i, (shape, pdt, gdt, wd) in enumerate(cases):
        p, g, m, v = _adamw_case(shape, pdt, gdt, gen)
        hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd)
        err, ok, exact, tol = _adamw_errs(p, g, m, v, scalars, hyper)
        name = (f"{shape} p {str(pdt)[6:]} g {str(gdt)[6:]} wd {wd}")
        log(f"[kernels] adamw_update {name}: max_abs_err={err:.3g} "
            f"(tolerance {tol:.3g} on p, 1e-6 relative on m/v); bit equal: "
            f"{exact}")
        if not ok:
            raise AssertionError(f"adamw_update disagrees with its plain "
                                 f"version at {name}")
        if i == 0:
            main = (p, g, m, v, hyper, name)
            main_err = err
        else:
            del p, g, m, v
    p, g, m, v, hyper, name = main
    ms = _time_ms(lambda: au.adamw_update(p, g, m, v, scalars, **hyper))
    plain_ms = _time_ms(lambda: au.adamw_update_plain(p, g, m, v, scalars,
                                                      **hyper))
    # the library call takes one dtype for p, g, m and v: time it on f32
    # copies of p and g (more bytes than the bf16 kernel moves)
    p32, g32, m2, v2 = p.float(), g.float(), m.clone(), v.clone()
    step = [torch.ones((), device="cuda")]
    library_ms = _time_ms(lambda: torch._fused_adamw_(
        [p32], [g32], [m2], [v2], [], step, lr=3e-4, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
    n = p.numel()
    bound_ms, bound_by = _bound(22.0 * n, 16.0 * n)
    log(f"[kernels] adamw_update main {name}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch._fused_adamw_ (f32) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "adamw_update", "route": "cuda",
            "source": "src/repro_torch/csrc/adamw_update.cu",
            "replaces": "src/repro/kernels/adamw_update.py:35",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "torch._fused_adamw_ on f32 p and g", "shape": name}


def _scan_err(got, want):
    """(max abs error, tolerance): SCAN_RTOL of the plain output's scale.
    Kernel and plain version compute in f32 from the same inputs, chunked
    differently, so their sums run in another order."""
    err = (got - want).abs().max().item()
    return err, SCAN_RTOL * max(1.0, want.abs().max().item())


def _scan_check(name, case, pairs):
    """Hold each (kernel, plain) output pair within its tolerance."""
    errs = [_scan_err(g, w) for g, w in pairs]
    log(f"[kernels] {name} {case}: max_abs_err "
        f"{', '.join(f'{e:.3g} (tolerance {t:.3g})' for e, t in errs)}")
    if not all(e <= t for e, t in errs):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{case}")
    return max(e for e, _ in errs)


def _scan_phase(name, kernel, plain, route, cases, make, work, seed):
    """Hold a scan kernel against its plain version on the card at each case
    (y and the last state), printing the path each case took, then time
    both at the first case, the main path's shape: warm (one copy of the
    inputs) and cold (rotating through copies that exceed the L2).
    make(case, gen) -> (args, state, plain chunk, label); route(*args) ->
    the kernel's path; work(*args) -> (bytes moved, operations) of one call
    at that shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs, paths = [], {}
    for case in cases:
        args, state, chunk, label = make(case, gen)
        paths[label] = route(*args)
        got = kernel(*args, state, chunk=chunk)
        torch.cuda.synchronize()
        want = plain(*args, state, chunk=chunk)
        errs.append(_scan_check(name, f"{label} [{paths[label]} path]",
                                zip(got, want)))
        if len(errs) == 1:
            main_args, main_label = args, label
    nbytes, flops = work(*main_args)
    copies = [main_args] + [
        make(cases[0], gen)[0]
        for _ in range(max(1, math.ceil(COLD_BYTES / nbytes) - 1))]
    ms_cold = _time_cold_ms(kernel, copies)
    n_copies = len(copies)
    del copies
    ms = _time_ms(lambda: kernel(*main_args))
    plain_ms = _time_ms(lambda: plain(*main_args))
    host_us = _host_us(lambda: kernel(*main_args))
    dtype = main_args[0].dtype
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    # the PR 13-15 figure: the operations at f32's CUDA-core rate
    bound_f32_ms, bound_f32_by = _bound(nbytes, flops)
    log(f"[kernels] {name} main {main_label} [{paths[main_label]} path]: "
        f"warm {ms:.4f} ms, cold ({n_copies} copies, "
        f"{n_copies * nbytes / 1e6:.0f} MB) {ms_cold:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by} at "
        f"{str(dtype)[6:]}'s rates; {bound_f32_ms:.5f} ms, {bound_f32_by}, "
        f"with the operations at f32's; {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); the wrapper's host time {host_us:.1f} "
        f"us a call; no PyTorch call computes the scan")
    if not ms_cold >= bound_ms:
        raise AssertionError(f"{name}'s cold time {ms_cold} ms is below its "
                             f"bound {bound_ms} ms: the timing is wrong")
    return {"name": name, "route": "cuda", "launches": None,
            "max_abs_err": errs[0], "ms": ms, "ms_cold": ms_cold,
            "cold_copies": n_copies, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_f32_ops": bound_f32_ms, "library_ms": None,
            "host_us": host_us, "shape": main_label,
            "path": paths[main_label], "paths": paths,
            "edge_shapes_max_abs_err": max(errs[1:])}


def phase_ssd():
    """The SSD scan against its plain version at zamba2's prefill (bf16 x,
    B and C) and at edge shapes, on both paths (the bf16 cases but hd 24
    take the tensor-core one): y and the last state; timed at zamba2's."""
    from repro_torch.kernels import ssm_scan
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    main = (1, PROMPT, 80, 64, 64)      # zamba2: 2 * 2560 / 64 heads, N 64
    cases = [  # (B, S, H, hd, N, dtype, h0, plain chunk, label)
        main + (bf, False, 256, "zamba2 prefill bf16"),
        main + (f32, True, 256, "zamba2 prefill f32, h0"),
        (2, 100, 3, 32, 16, f32, True, 8, "ragged S=100 chunk 8, h0, N!=hd"),
        (2, 100, 3, 32, 16, bf, True, 8, "ragged S=100 chunk 8 bf16, h0"),
        (1, 40, 2, 24, 48, f32, True, 256, "S=40 below one chunk, hd 24"),
        (1, 130, 4, 64, 64, f16, True, 256, "f16 S=130, h0"),
        main + (bf, True, 256, "zamba2 prefill bf16, h0"),
        (1, 200, 4, 64, 64, bf, True, 256,
         "bf16 S=200, not a multiple of 64 or 16, h0"),
        (1, 10, 2, 64, 64, bf, True, 256, "bf16 S=10 below one 16-row strip, h0"),
        (2, 77, 3, 128, 128, bf, True, 256, "bf16 hd 128 N 128 S=77, h0"),
        (1, 130, 4, 16, 48, bf, False, 256, "bf16 hd 16 N 48 S=130"),
        (1, 40, 2, 24, 48, bf, True, 256, "bf16 hd 24 (not a multiple of 16)"),
    ]

    def make(case, gen):
        B, S, H, hd, N, dtype, h0, chunk, label = case
        x = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
        Bm = torch.randn(B, S, N, generator=gen, device="cuda").to(dtype)
        Cm = torch.randn(B, S, N, generator=gen, device="cuda").to(dtype)
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, H, generator=gen, device="cuda"))
        a = -torch.exp(torch.randn(H, generator=gen, device="cuda"))
        state = (torch.randn(B, H, hd, N, generator=gen, device="cuda")
                 if h0 else None)
        return (x, dt, a, Bm, Cm), state, chunk, label

    def work(x, dt, a, Bm, Cm):
        # Bytes: x, B, C read in their dtype; dt, a read and y, h_last
        # written in f32.  Flops per token, head and (d, n): the state
        # update h = exp(dt a) h + (dt x) B is 3, the read-out y = C . h is 2.
        B, S, H, hd = x.shape
        N = Bm.shape[-1]
        item = x.element_size()
        nbytes = (B * S * H * hd * (item + 4) + B * S * H * 4 + H * 4
                  + 2 * B * S * N * item + B * H * hd * N * 4)
        return nbytes, 5.0 * hd * N * B * S * H

    row = _scan_phase("ssd_scan", ssm_scan.ssd_scan, ssm_scan.ssd_scan_plain,
                      lambda x, dt, a, Bm, Cm: ssm_scan.path(x, Bm), cases,
                      make, work, seed=8)
    return {**row, "shape": f"B=1 S={PROMPT} H=80 hd=64 N=64 bf16",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:21",
            "library": "none: no single PyTorch call computes the SSD scan"}


def phase_wkv():
    """WKV6 against its plain version at rwkv6's prefill (bf16 r, k, v) and
    at edge shapes, on both paths (the bf16 cases but hd 40 take the
    tensor-core one): y and the last state; timed at rwkv6's."""
    from repro_torch.kernels import wkv6
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    main = (1, PROMPT, 32, 64)          # rwkv6: 2048 / 64 heads
    cases = [  # (B, S, H, hd, dtype, s0, logw at the -8 floor, chunk, label)
        main + (bf, False, False, 64, "rwkv6 prefill bf16"),
        main + (f32, True, False, 64, "rwkv6 prefill f32, s0"),
        (2, 100, 3, 16, f32, True, False, 8, "ragged S=100 chunk 8, s0"),
        (2, 100, 3, 16, bf, True, False, 8, "ragged S=100 chunk 8 bf16, s0"),
        (1, 20, 2, 40, f32, True, True, 64, "S=20 below one chunk, logw -8"),
        (1, 77, 2, 128, f16, True, False, 64, "f16 hd 128, s0"),
        (1, PROMPT, 32, 64, bf, True, True, 64, "rwkv6 shape, logw -8, s0"),
        (1, 200, 4, 64, bf, True, False, 64,
         "bf16 S=200, not a multiple of 64 or 16, s0"),
        (1, 10, 2, 64, bf, True, False, 64, "bf16 S=10 below one sub-chunk, s0"),
        (1, 77, 2, 128, bf, True, False, 64, "bf16 hd 128 S=77, s0"),
        (1, 100, 2, 128, bf, True, True, 64, "bf16 hd 128, logw -8, s0"),
        (2, 50, 3, 40, bf, True, False, 64, "bf16 hd 40 (not a multiple of 16)"),
    ]

    def make(case, gen):
        B, S, H, hd, dtype, s0, floor, chunk, label = case
        r, k, v = (torch.randn(B, S, H, hd, generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        logw = torch.clamp(-torch.exp(torch.randn(B, S, H, hd, generator=gen,
                                                  device="cuda")), min=-8.0)
        if floor:
            logw = torch.full_like(logw, -8.0)
        u = torch.randn(H, hd, generator=gen, device="cuda")
        state = (torch.randn(B, H, hd, hd, generator=gen, device="cuda")
                 if s0 else None)
        return (r, k, v, logw, u), state, chunk, label

    def work(r, k, v, logw, u):
        # Bytes: r, k, v read in their dtype; logw, u read and y, s_last
        # written in f32.  Flops per token and head: the state update
        # diag(w) S + k^T v is 3 hd^2, the read-out r S is 2 hd^2; the bonus
        # (r . (u * k)) v is O(hd) and left out, so the bound stays a floor.
        B, S, H, hd = r.shape
        item = r.element_size()
        nbytes = (B * S * H * hd * (3 * item + 4 + 4) + H * hd * 4
                  + B * H * hd * hd * 4)
        return nbytes, 5.0 * hd * hd * B * S * H

    row = _scan_phase("wkv6", wkv6.wkv6, wkv6.wkv6_plain,
                      lambda r, k, v, logw, u: wkv6.path(r), cases, make, work,
                      seed=9)
    return {**row, "shape": f"B=1 S={PROMPT} H=32 hd=64 bf16",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:21",
            "library": "none: no single PyTorch call computes the WKV6 scan"}


def _gmm_work(x, w):
    """(bytes, flops) of one grouped matmul: x and w read once, the output
    written once, 2 E C D F operations."""
    E, C, D = x.shape
    F = w.shape[2]
    return (x.element_size() * (E * C * D + E * D * F + E * C * F),
            2.0 * E * C * D * F)


def phase_gmm():
    """The grouped matmul against its plain version on the card at
    granite-moe's buckets (prefill C 200, decode C 2; gate/up and out) in
    bf16, f32 and f16, at tests/test_kernels.py's shapes, on both sides of
    the small-C path's limit (C 8 and 9, 16 and 17), and at ragged and
    strided edge shapes; timed at the four bf16 bucket shapes, warm and
    cold, with torch.bmm as the yardstick timed alike."""
    from repro_torch.kernels import moe_gmm
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    prefill, decode = (32, 200, 1024, 512), (32, 2, 1024, 512)
    out_pre, out_dec = (32, 200, 512, 1024), (32, 2, 512, 1024)
    cases = [  # (E, C, D, F, dtype, layout, label)
        prefill + (bf, "", "granite prefill gate/up bf16"),
        out_pre + (bf, "", "granite prefill out bf16"),
        decode + (bf, "", "granite decode gate/up bf16"),
        out_dec + (bf, "", "granite decode out bf16"),
        prefill + (f32, "", "granite prefill f32"),
        prefill + (f16, "", "granite prefill f16"),
        decode + (f32, "", "granite decode f32"),
        decode + (f16, "", "granite decode f16"),
        (2, 128, 64, 128, f32, "", "test_kernels shape 1 f32"),
        (4, 256, 128, 256, f32, "", "test_kernels shape 2 f32"),
        (1, 128, 256, 128, f32, "", "test_kernels shape 3 f32"),
        (2, 128, 64, 128, bf, "", "test_kernels shape 1 bf16"),
        (4, 256, 128, 256, bf, "", "test_kernels shape 2 bf16"),
        (1, 128, 256, 128, bf, "", "test_kernels shape 3 bf16"),
        (3, 1, 72, 40, f32, "", "ragged C=1 D=72 F=40"),
        (3, 2, 72, 40, bf, "", "ragged C=2 D=72 F=40 bf16"),
        (2, 200, 72, 40, f16, "", "ragged C=200 D=72 F=40 f16"),
        (1, 130, 1024, 512, bf, "", "one expert, C=130"),
        (4, 37, 72, 40, f32, "group", "group slice of (G,E,D,F), F=40 of 64"),
        (4, 37, 72, 40, bf, "expert", "expert-strided w and x views"),
        (32, 8, 1024, 512, bf, "", "C=8, the small-C path's largest"),
        (32, 9, 1024, 512, bf, "", "C=9, the tensor-core path's smallest"),
        (32, 16, 512, 1024, f16, "", "C=16 f16"),
        (32, 17, 512, 1024, bf, "expert", "C=17, expert-strided views"),
    ]
    errs, timed = [], []
    for E, C, D, F, dtype, layout, label in cases:
        x = torch.randn(E, C, D, generator=gen, device="cuda").to(dtype)
        if layout == "group":          # (G,E,D,F) of 64 columns: group 1,
            w = torch.randn(2, E, D, 64, generator=gen,   # 40 of them
                            device="cuda").to(dtype)[1, :, :, :F]
        elif layout == "expert":       # every other expert of wider buffers
            w = torch.randn(2 * E, D, F, generator=gen,
                            device="cuda").to(dtype)[::2]
            x = torch.randn(2 * E, C, D + 8, generator=gen,
                            device="cuda").to(dtype)[::2, :, :D]
        else:
            w = torch.randn(E, D, F, generator=gen, device="cuda").to(dtype)
        got = moe_gmm.gmm(x, w)
        torch.cuda.synchronize()
        want = moe_gmm.gmm_plain(x, w)
        err = (got.float() - want.float()).abs().max().item()
        tol = GMM_RTOL[dtype] * max(1.0, want.float().abs().max().item())
        log(f"[kernels] gmm {label} (E={E} C={C} D={D} F={F}, x strides "
            f"{x.stride()}, w strides {w.stride()}): max_abs_err={err:.3g} "
            f"(tolerance {tol:.3g})")
        if not (err <= tol and got.dtype == dtype):
            raise AssertionError(f"gmm disagrees with its plain version at "
                                 f"{label}")
        errs.append(err)
        if len(timed) < 4:
            timed.append((label, x, w, err))
        del x, w, got, want
    rows = []
    for label, x, w, err in timed:
        nbytes, flops = _gmm_work(x, w)
        copies = [(x, w)] + [
            (torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype),
             torch.randn(w.shape, generator=gen, device="cuda").to(w.dtype))
            for _ in range(max(1, math.ceil(COLD_BYTES / nbytes) - 1))]
        ms = _time_cold_ms(moe_gmm.gmm, copies)
        library_ms = _time_cold_ms(torch.bmm, copies)
        ms_warm = _time_ms(lambda: moe_gmm.gmm(x, w))
        library_warm = _time_ms(lambda: torch.bmm(x, w))
        plain_ms = _time_ms(lambda: moe_gmm.gmm_plain(x, w))
        host_us = _host_us(lambda: moe_gmm.gmm(x, w))
        n_copies = len(copies)
        del copies
        bound_ms, bound_by = _bound(nbytes, flops, x.dtype)
        log(f"[kernels] gmm timed at {label}: cold ({n_copies} copies, "
            f"{n_copies * nbytes / 1e6:.0f} MB) kernel {ms:.4f} ms, torch.bmm "
            f"{library_ms:.4f} ms; warm kernel {ms_warm:.4f} ms, torch.bmm "
            f"{library_warm:.4f} ms; plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP); the wrapper's host time "
            f"{host_us:.1f} us a call")
        rows.append({"shape": label, "max_abs_err": err, "ms": ms,
                     "host_us": host_us,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "ms_warm": ms_warm, "library_ms_warm": library_warm,
                     "cold_copies": n_copies})
    return {"name": "moe_gmm", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:21", "launches": None,
            **rows[0], "library": "torch.bmm",
            "timing": "ms and library_ms cold (inputs rotated through "
                      "copies beyond L2); *_warm and plain_ms on one copy",
            "edge_shapes_max_abs_err": max(errs[4:]),
            "prefill_out": rows[1], "decode_gate_up": rows[2],
            "decode_out": rows[3]}


def phase_small() -> None:
    """phi4 smoke in f32: prefill through the kernel on the card against the
    plain version on the CPU, on the same params."""
    from repro_torch.configs import registry
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    cfg = registry.get_smoke(ARCH).replace(param_dtype="float32",
                                           compute_dtype="float32")
    params = pr.init_params(tfm.lm_schema(cfg),
                            torch.Generator().manual_seed(1), "float32", "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 100),
                         generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want, _ = steps.prefill_step(cfg, params, toks)
        got, caches = steps.prefill_step(cfg, _to(params, "cuda"), toks.cuda())
    err = (got.cpu() - want).abs().max().item()
    log(f"[small] smoke f32 prefill logits, card vs cpu: max_abs_err={err:.3g} "
        f"(tolerance 1e-4)")
    if not (err <= 1e-4 and torch.isfinite(caches["0_attn"]["k"]).all()):
        raise AssertionError(f"smoke prefill on the card disagrees: {err}")


def _prefill_errs(got, got_c, want, want_c):
    """(logits max abs error, cache leaves' max error relative to each
    leaf's scale) of one prefill against another."""
    from repro_torch.runtime import steps
    err = (got.cpu() - want).abs().max().item()
    leaf_err = max((g.cpu() - w).abs().max().item()
                   / max(1.0, w.abs().max().item()) for g, w in
                   zip(steps.tree_leaves(got_c), steps.tree_leaves(want_c)))
    return err, leaf_err


def phase_small_ssm() -> None:
    """zamba2 smoke with two groups and rwkv6 smoke in f32: prefill through
    the kernels on the card against the plain versions on the CPU, on the
    same params: last logits and every cache leaf (conv, last states,
    shared-attention k/v, token shifts).

    The tolerance is the model's own conditioning: under the reference's
    init the 12-layer zamba2 smoke model moves its logits by about 3e-4
    when its weights move by one f32 rounding (1e-7 relative), more than
    two correct f32 implementations differ by.  So each side must agree
    within 4x what the CPU path moves under such a perturbation (and
    within 1e-4 at least); a wrong kernel moves them by the logits'
    whole scale."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan, wkv6
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    for arch, layers, want_runs in ((ZAMBA, 12, (12, 0, 2)),
                                    (RWKV, 1, (0, 1, 0))):
        cfg = registry.get_smoke(arch).replace(
            num_layers=layers, param_dtype="float32", compute_dtype="float32")
        params = pr.init_params(tfm.lm_schema(cfg),
                                torch.Generator().manual_seed(1), "float32",
                                "cpu")
        noise = torch.Generator().manual_seed(3)
        nudged = steps._map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=noise)), params)
        toks = torch.randint(1, cfg.vocab_size, (1, 100),
                             generator=torch.Generator().manual_seed(2))
        with torch.inference_mode():
            want, want_c = steps.prefill_step(cfg, params, toks)
            moved = _prefill_errs(*steps.prefill_step(cfg, nudged, toks),
                                  want, want_c)
            before = (ssm_scan.launches, wkv6.launches, fa.launches)
            got, got_c = steps.prefill_step(cfg, _to(params, "cuda"),
                                            toks.cuda())
            torch.cuda.synchronize()
        ran = (ssm_scan.launches - before[0], wkv6.launches - before[1],
               fa.launches - before[2])
        err, leaf_err = _prefill_errs(got, got_c, want, want_c)
        tol, leaf_tol = (max(1e-4, 4 * m) for m in moved)
        log(f"[small] {arch} smoke f32 ({layers} layers) prefill, card vs "
            f"cpu: logits max_abs_err={err:.3g} (tolerance {tol:.3g}); cache "
            f"leaves max error {leaf_err:.3g} of their scale (tolerance "
            f"{leaf_tol:.3g}); the cpu path under a 1e-7 weight nudge moves "
            f"{moved[0]:.3g} and {moved[1]:.3g}; launches ssd/wkv6/flash "
            f"{ran}")
        if not (err <= tol and leaf_err <= leaf_tol):
            raise AssertionError(f"{arch} smoke prefill on the card "
                                 f"disagrees with the CPU")
        if ran != want_runs:
            raise AssertionError(f"{arch} smoke launches {ran} != "
                                 f"{want_runs}")


def phase_small_moe() -> None:
    """granite-moe smoke with two layers (two groups) in f32: a B=1 prefill
    of 100 tokens and 4 decode steps through the kernels on the card
    against the plain versions on the CPU, on the same params: the logits
    of every step and the KV cache after the last.

    The limit is 1e-4 of the logits' (and each cache leaf's) scale: both
    sides compute in f32 from the same weights and route the same entries,
    and sums run in another order (the kernels' against the CPU's).  The
    config's capacity factor 1.25 holds: the prefill's 200 entries go to 4
    buckets of 78 rows, a decode step's 2 to buckets of 1."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    cfg = registry.get_smoke(GRANITE).replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    params = pr.init_params(tfm.lm_schema(cfg),
                            torch.Generator().manual_seed(1), "float32", "cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (1, 100), generator=gen)
    nxt = torch.randint(1, cfg.vocab_size, (4, 1, 1), generator=gen)
    runs = {}
    before = (moe_gmm.launches, fa.launches)
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        with torch.inference_mode():
            last, small = steps.prefill_step(cfg, p, toks.to(dev))
            cache = steps.cache_batch_insert(
                steps.init_cache(cfg, 1, 104, dev), small, 0)
            logits = [last]
            for i in range(4):
                x, cache = tfm.forward(cfg, p, nxt[i].to(dev), mode="decode",
                                       caches=cache, pos=100 + i)
                logits.append(tfm.lm_logits(cfg, p, x)[:, -1])
        runs[dev] = ([t.cpu() for t in logits],
                     [t.cpu() for t in steps.tree_leaves(cache)])
    ran = (moe_gmm.launches - before[0], fa.launches - before[1])
    errs = [(g - w).abs().max().item() / max(1.0, w.abs().max().item())
            for g, w in zip(runs["cuda"][0] + runs["cuda"][1],
                            runs["cpu"][0] + runs["cpu"][1])]
    log(f"[small] {GRANITE} smoke f32 (2 layers) prefill + 4 decode steps, "
        f"card vs cpu: logits max error {max(errs[:5]):.3g} of their scale, "
        f"cache {max(errs[5:]):.3g} (tolerance 1e-4); launches gmm/flash "
        f"{ran}")
    if not max(errs) <= 1e-4:
        raise AssertionError(f"{GRANITE} smoke on the card disagrees with "
                             f"the CPU: {errs}")
    if ran != (3 * 2 * 5, 2):
        raise AssertionError(f"{GRANITE} smoke launches gmm/flash {ran} != "
                             f"(30, 2)")


def phase_small_train() -> None:
    """phi4 smoke in f32 with two layers: two train steps on the card
    (kernels) against the CPU (plain versions), same params and batches."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import xent
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    cfg = registry.get_smoke(ARCH).replace(num_layers=2,
                                           param_dtype="float32",
                                           compute_dtype="float32")
    par = registry.get_parallel(ARCH)
    ocfg = OptimizerConfig(warmup_steps=1, decay_steps=100)
    pipe = TokenPipeline(cfg.vocab_size, 32, 4, seed=11)
    cpu = pr.init_params(tfm.lm_schema(cfg), torch.Generator().manual_seed(1),
                         "float32", "cpu")
    card = _to(cpu, "cuda")
    out = {}
    before = (xent.fwd_launches, xent.bwd_launches, au.launches)
    for dev, params in (("cpu", cpu), ("cuda", card)):
        opt = steps.init_opt_state(cfg, ocfg, dev)
        params, opt, ms = steps.train_chunk(cfg, par, ocfg, params, opt,
                                            pipe.chunk(0, 2), device=dev)
        out[dev] = (params, {k: v.cpu() for k, v in ms.items()})
    ran = (xent.fwd_launches - before[0], xent.bwd_launches - before[1],
           au.launches - before[2])
    (p_cpu, m_cpu), (p_card, m_card) = out["cpu"], out["cuda"]
    loss_err = (m_card["loss"] - m_cpu["loss"]).abs().max().item()
    norm_err = ((m_card["grad_norm"] - m_cpu["grad_norm"]).abs()
                / m_cpu["grad_norm"]).max().item()
    param_err = max((a.cpu() - b).abs().max().item() for a, b in
                    zip(steps.tree_leaves(p_card), steps.tree_leaves(p_cpu)))
    log(f"[small-train] smoke f32, 2 layers, 2 steps, card vs cpu: loss "
        f"{m_card['loss'].tolist()} vs {m_cpu['loss'].tolist()} (max_abs_err "
        f"{loss_err:.3g}, tolerance 1e-4); grad_norm rel err {norm_err:.3g} "
        f"(tolerance 1e-4); params max_abs_err {param_err:.3g} (tolerance "
        f"2e-4 at lr 3e-4); kernel launches xent fwd/bwd/adamw {ran}")
    if not (loss_err <= 1e-4 and norm_err <= 1e-4 and param_err <= 2e-4):
        raise AssertionError("train steps on the card disagree with the CPU")
    if ran != (2, 2, 2 * 11):
        raise AssertionError(f"small-train kernel launches {ran} != (2, 2, 22)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _requests(vocab: int, n: int = 8):
    gen = torch.Generator().manual_seed(3)
    system = torch.randint(1, vocab, (SYSTEM_PREFIX,), generator=gen).tolist()
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            prompt = system + torch.randint(1, vocab, (PROMPT - SYSTEM_PREFIX,),
                                            generator=gen).tolist()
        else:
            prompt = torch.randint(1, vocab, (PROMPT,), generator=gen).tolist()
        reqs.append({"id": i, "prompt": prompt,
                     "max_new_tokens": GEN_LENS[i % len(GEN_LENS)]})
    return reqs


def _count_per_call(engine, counters):
    """Wrap the engine's prefill and decode step so each call records how
    many launches of each counted kernel it made."""
    per = {"prefill": [], "decode": [], "prompts": []}

    def wrap(fn, key):
        def run(*args, **kwargs):
            before = {n: mod.launches for n, mod in counters.items()}
            out = fn(*args, **kwargs)
            per[key].append({n: mod.launches - before[n]
                             for n, mod in counters.items()})
            if key == "prefill":
                per["prompts"].append(tuple(args[1]))
            return out
        return run
    engine.prefill_into = wrap(engine.prefill_into, "prefill")
    engine.decode_step = wrap(engine.decode_step, "decode")
    return per


def phase_serve(smi: str, arch: str = ARCH):
    """Full-width phi4 or granite-moe in bf16 serves 8 requests through the
    paged pool with the prefix cache; flash runs on every layer of every
    full prefill and granite's gmm 3 times a layer in every full prefill
    and decode step; then paged equals slotted on a short run."""
    from repro_torch.configs import registry
    from repro_torch.core.queue import WorkQueue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.report import GAUGES

    torch.cuda.empty_cache()
    cfg = registry.get_config(arch)
    t0 = time.perf_counter()
    params = pr.init_params(tfm.lm_schema(cfg),
                            torch.Generator(device="cuda").manual_seed(0),
                            cfg.param_dtype, "cuda")
    torch.cuda.synchronize()
    n_params = pr.param_count(tfm.lm_schema(cfg))
    log(f"[serve:{arch}] {n_params / 1e9:.3f} B params in bf16 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(cfg, device="cuda", num_slots=SLOTS,
                           prompt_len=PROMPT, max_new_tokens=GEN,
                           params=params, paged=True, block_size=BLOCK,
                           prefix_cache=True)
    engine.warmup()
    torch.cuda.synchronize()
    reqs = _requests(cfg.vocab_size)
    queue = WorkQueue(reqs)
    counters = {"flash_attention": fa}
    moe_layers = cfg.num_groups * cfg.block_pattern.count("moe")
    if moe_layers:
        counters["moe_gmm"] = moe_gmm
    per = _count_per_call(engine, counters)
    torch.cuda.reset_peak_memory_stats()
    prefills_before = engine.metrics.series(GAUGES.PREFILL_S).stats()["count"]
    for mod in counters.values():
        mod.launches = 0
    results, metrics = engine.run(queue)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the wrappers close over the engine's bound methods: unhook them, or
    # the cycle keeps the engine and its params alive past this phase
    del engine.prefill_into, engine.decode_step
    sm = metrics.summary()
    full_prefills = sm[GAUGES.PREFILL_S]["count"] - prefills_before
    decode_steps = int(sm[GAUGES.DECODE_STEPS]["total"])
    want_tokens = sum(r["max_new_tokens"] for r in reqs)
    hits = sm.get(GAUGES.PREFIX_HITS, {}).get("total", 0)
    # every full prefill: flash on each layer, gmm 3 a MoE layer; every
    # decode step: no flash, gmm 3 a MoE layer
    want_call = {"prefill": {"flash_attention": cfg.num_layers,
                             "moe_gmm": 3 * moe_layers},
                 "decode": {"flash_attention": 0, "moe_gmm": 3 * moe_layers}}
    want_call = {k: {n: want[n] for n in counters}
                 for k, want in want_call.items()}
    bad_calls = sorted({(k, n, c[n]) for k, calls in per.items()
                        if k != "prompts"
                        for c in calls for n in c if c[n] != want_call[k][n]})
    log(f"[serve:{arch}] completed {len(results)}/{len(reqs)}, tokens "
        f"{sm[GAUGES.TOKENS]['total']:.0f}/{want_tokens}, full prefills "
        f"{full_prefills}, decode steps {decode_steps}, prefix-hit blocks "
        f"{hits:.0f}, launches {launches} ({want_call['prefill']} a full "
        f"prefill, {want_call['decode']} a decode step wanted)")
    if sorted(results) != list(range(len(reqs))):
        raise AssertionError(f"requests not all completed: {sorted(results)}")
    if any(len(results[r["id"]]) != r["max_new_tokens"] for r in reqs):
        raise AssertionError("a request's token count is not its stop length")
    if sm[GAUGES.TOKENS]["total"] != want_tokens:
        raise AssertionError("token count is not the sum of stop lengths")
    if not hits > 0:
        raise AssertionError("the prefix cache never hit")
    if (full_prefills < 1 or len(per["prefill"]) != full_prefills
            or len(per["decode"]) != decode_steps or bad_calls):
        raise AssertionError(f"kernel launches per call off: {bad_calls}")
    for name in counters:
        total = sum(c[name] for k in ("prefill", "decode") for c in per[k])
        if launches[name] != total or launches[name] < 1:
            raise AssertionError(f"{name} launches {launches[name]} != "
                                 f"{total} counted by call")
    serve = {"arch": arch, "cache": "paged", "requests": len(results),
             "tokens": int(sm[GAUGES.TOKENS]["total"]),
             "tok_s": sm[GAUGES.TOK_S]["last"],
             "decode_tok_s": sm[GAUGES.DECODE_TOK_S]["last"],
             "p50_ttft_s": sm[GAUGES.TTFT_S]["p50"],
             "prefill_s_p50": sm[GAUGES.PREFILL_S]["p50"],
             "wall_s": sm[GAUGES.WALL_S]["last"],
             "decode_steps": decode_steps,
             "full_prefills": full_prefills, "prefix_hit_blocks": hits,
             "launches": launches, "peak_mem_gb": peak_gb, "card": smi}
    del engine

    # paged (no prefix cache) against slotted on the same requests, short
    short = [dict(r, max_new_tokens=min(r["max_new_tokens"], 8)) for r in reqs]
    outs = {}
    for paged in (True, False):
        eng = ServingEngine(cfg, device="cuda", num_slots=SLOTS,
                            prompt_len=PROMPT, max_new_tokens=GEN,
                            params=params, paged=paged, block_size=BLOCK,
                            prefix_cache=False)
        outs[paged], _ = eng.run(WorkQueue(short))
        del eng
    same = outs[True] == outs[False]
    # requests that replayed a cached prefix computed their prompt's K/V
    # through decode steps (and, for MoE, routed it in decode batches), so
    # their tokens may differ in bf16: reported only
    agree = sum(results[r["id"]][:len(outs[False][r["id"]])]
                == outs[False][r["id"]] for r in reqs)
    log(f"[serve:{arch}] paged vs slotted greedy tokens on {len(short)} "
        f"requests: {'identical' if same else 'DIFFER'}; the main run agrees "
        f"with slotted on {agree}/{len(reqs)}")
    if not same:
        raise AssertionError("paged greedy tokens differ from slotted")
    del params
    # which requests this run prefilled whole (the rest replayed a cached
    # prefix): the router phase compares its tokens on like paths
    full = {r["id"] for r in reqs if tuple(r["prompt"]) in set(per["prompts"])}
    return serve, launches, {"results": results, "full": full}


def phase_serve_ssm(smi: str, arch: str):
    """Full-width zamba2 or rwkv6 in bf16 serves the phi4 phase's 8
    requests through the slotted cache; the scan kernels (and zamba2's
    flash) run on every layer of every full prefill."""
    from repro_torch.configs import registry
    from repro_torch.core.queue import WorkQueue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan, wkv6
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.report import GAUGES

    torch.cuda.empty_cache()
    cfg = registry.get_config(arch)
    t0 = time.perf_counter()
    params = pr.init_params(tfm.lm_schema(cfg),
                            torch.Generator(device="cuda").manual_seed(0),
                            cfg.param_dtype, "cuda")
    torch.cuda.synchronize()
    n_params = pr.param_count(tfm.lm_schema(cfg))
    log(f"[serve:{arch}] {n_params / 1e9:.3f} B params in bf16 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    reqs = _requests(cfg.vocab_size)
    with torch.inference_mode():       # one full-width prefill: all finite
        last, small = steps.prefill_step(
            cfg, params, torch.tensor([reqs[0]["prompt"]], device="cuda"))
        finite = bool(torch.isfinite(last).all()) and all(
            bool(torch.isfinite(leaf).all())
            for leaf in steps.tree_leaves(small))
    del small
    if not finite:
        raise AssertionError(f"{arch} prefill logits or states not finite")
    engine = ServingEngine(cfg, device="cuda", num_slots=SLOTS,
                           prompt_len=PROMPT, max_new_tokens=GEN,
                           params=params)
    if engine.paged:
        raise AssertionError(f"{arch}'s state cache was paged")
    engine.warmup()
    torch.cuda.synchronize()
    queue = WorkQueue(reqs)
    torch.cuda.reset_peak_memory_stats()
    prefills_before = engine.metrics.series(GAUGES.PREFILL_S).stats()["count"]
    counters = {"ssd_scan": ssm_scan, "wkv6": wkv6, "flash_attention": fa}
    for mod in counters.values():
        mod.launches = 0
    results, metrics = engine.run(queue)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sm = metrics.summary()
    full_prefills = sm[GAUGES.PREFILL_S]["count"] - prefills_before
    want_tokens = sum(r["max_new_tokens"] for r in reqs)
    G = cfg.num_groups
    layers = {k: G * sum(kind in kinds for kind in cfg.block_pattern)
              for k, kinds in (("ssd_scan", ("mamba", "mamba_attn")),
                               ("wkv6", ("rwkv",)),
                               ("flash_attention", ("mamba_attn",)))}
    want_launches = {k: n * full_prefills for k, n in layers.items()}
    log(f"[serve:{arch}] completed {len(results)}/{len(reqs)}, tokens "
        f"{sm[GAUGES.TOKENS]['total']:.0f}/{want_tokens}, full prefills "
        f"{full_prefills}, launches {launches} (want {want_launches})")
    if sorted(results) != list(range(len(reqs))):
        raise AssertionError(f"requests not all completed: {sorted(results)}")
    if any(len(results[r["id"]]) != r["max_new_tokens"] for r in reqs):
        raise AssertionError("a request's token count is not its stop length")
    if sm[GAUGES.TOKENS]["total"] != want_tokens:
        raise AssertionError("token count is not the sum of stop lengths")
    if launches != want_launches or full_prefills < 1:
        raise AssertionError(f"{arch} kernel launches {launches} != "
                             f"{want_launches}")
    serve = {"arch": arch, "cache": "slotted", "requests": len(results),
             "tokens": int(sm[GAUGES.TOKENS]["total"]),
             "tok_s": sm[GAUGES.TOK_S]["last"],
             "decode_tok_s": sm[GAUGES.DECODE_TOK_S]["last"],
             "p50_ttft_s": sm[GAUGES.TTFT_S]["p50"],
             "prefill_s_p50": sm[GAUGES.PREFILL_S]["p50"],
             "wall_s": sm[GAUGES.WALL_S]["last"],
             "decode_steps": int(sm[GAUGES.DECODE_STEPS]["total"]),
             "full_prefills": full_prefills, "launches": launches,
             "peak_mem_gb": peak_gb, "card": smi}
    del engine, params
    return serve, launches


def phase_train(smi: str):
    """Full-width phi4 in bf16 trains 6 steps as two train_chunk calls of 3
    on TokenPipeline batches, through the xent and AdamW kernels."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import xent
    from repro_torch.launch import grad_check
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps

    torch.cuda.empty_cache()
    cfg = registry.get_config(ARCH)
    par = registry.get_parallel(ARCH)
    ocfg = OptimizerConfig(warmup_steps=2)
    schema = tfm.lm_schema(cfg)
    n_params = pr.param_count(schema)
    n_leaves = len(pr.leaves(schema))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    # The weights: the reference's init with wq/wk/wv/wo at 1/sqrt(their
    # contracted width).  Under the reference's own 1/sqrt(shape[-2]) the
    # grads grow about 1e9-fold over 32 layers even in f32, in the JAX model
    # as in the port (ROADMAP queue C), and no few-step run can show the
    # loss fall.  First the bf16 backward is held against f32 on the same
    # weights and the first batch, leaf by leaf.
    check = grad_check.compare(ARCH, init="contracted", seq=TRAIN_SEQ,
                               batch=TRAIN_BATCH, seed=0)
    torch.cuda.empty_cache()
    worst = max(check["rel_gap"], key=check["rel_gap"].get)
    gap = check["rel_gap"][worst]
    log(f"[train] first-batch grad norms, bf16 vs f32 on the same weights: "
        f"loss {check['bfloat16']['loss']:.6f} vs "
        f"{check['float32']['loss']:.6f}; largest relative gap {gap:.3g} "
        f"({worst}: {check['bfloat16']['leaves'][worst]:.4g} vs "
        f"{check['float32']['leaves'][worst]:.4g}; tolerance {GRAD_RTOL})")
    norms32 = list(check["float32"]["leaves"].values())
    if not (all(math.isfinite(x) and x > 0 for x in norms32)
            and gap <= GRAD_RTOL):
        raise AssertionError("bf16 grads disagree with f32 grads")

    t0 = time.perf_counter()
    params = pr.init_params(schema,
                            torch.Generator(device="cuda").manual_seed(0),
                            "float32", "cuda")
    grad_check.contracted_attention_init_(cfg, params)
    params = steps._map(lambda t: t.to(torch.bfloat16), params)
    opt = steps.init_opt_state(cfg, ocfg, "cuda")
    torch.cuda.synchronize()
    log(f"[train] {ARCH}: {n_params / 1e9:.3f} B params in bf16 and f32 "
        f"moments on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    xent.fwd_launches = xent.bwd_launches = au.launches = 0
    losses, norms, chunk_s = [], [], []
    for start in range(0, TRAIN_STEPS, TRAIN_K):
        t0 = time.perf_counter()
        params, opt, ms = steps.train_chunk(cfg, par, ocfg, params, opt,
                                            pipe.chunk(start, TRAIN_K))
        loss, norm = ms["loss"].cpu(), ms["grad_norm"].cpu()   # one sync
        chunk_s.append(time.perf_counter() - t0)
        losses.extend(loss.tolist())
        norms.extend(norm.tolist())
    launches = {"xent_fwd": xent.fwd_launches, "xent_bwd": xent.bwd_launches,
                "adamw_update": au.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * s / TRAIN_K for s in chunk_s]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in norms]}; ms a step by chunk {step_ms}; peak "
        f"{peak_gb:.2f} GB; launches {launches}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    per_step = TRAIN_SEQ // 512               # loss chunks of 512 positions
    want = {"xent_fwd": TRAIN_STEPS * per_step,
            "xent_bwd": TRAIN_STEPS * per_step,
            "adamw_update": TRAIN_STEPS * n_leaves}
    if launches != want:
        raise AssertionError(f"train kernel launches {launches} != {want}")
    train = {"arch": ARCH, "params_b": n_params / 1e9, "dtype": "bfloat16",
             "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "loss_chunk": 512, "remat": par.remat,
             "tokens_per_s": tokens * TRAIN_K / chunk_s[-1],
             "tokens_per_s_all": tokens * TRAIN_STEPS / sum(chunk_s),
             "p50_step_ms": statistics.median(step_ms),
             "step_ms_by_chunk": step_ms, "loss_first": losses[0],
             "loss_last": losses[-1], "losses": losses, "grad_norms": norms,
             "grad_rel_gap_bf16_f32": gap,
             "peak_mem_gb": peak_gb, "launches": launches, "card": smi}
    return train, launches


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit pattern, so equality is bitwise (NaNs included)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def phase_elastic(smi: str):
    """phi4 at full width and 4 layers in bf16 trains through the elastic
    trainer, crashes once, restores its step-3 checkpoint and finishes."""
    import tempfile

    from repro_torch.checkpoint.checkpoint import flatten_with_paths
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.orchestrator import Cluster
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.elastic import ElasticTrainer, ElasticTrainSpec
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import xent
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm

    torch.cuda.empty_cache()
    cfg = registry.get_config(ARCH).replace(num_layers=ELASTIC_LAYERS)
    par = registry.get_parallel(ARCH)
    # the train CLI's recipe: lr 1e-3, warmup steps/20, cosine over the run
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=max(ELASTIC_STEPS // 20, 1),
                           decay_steps=ELASTIC_STEPS)
    schema = tfm.lm_schema(cfg)
    n_params, n_leaves = pr.param_count(schema), len(pr.leaves(schema))
    card = torch.device("cuda", 0)

    def trainer(store, **kw):
        spec = ElasticTrainSpec(
            cfg, par, ocfg, steps=ELASTIC_STEPS, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, base_shape=(1, 1), max_data=1,
            device_steps=ELASTIC_K, keep=2, log_every=4, seed=0,
            name="chip-smoke-elastic", device=card, **kw)
        return ElasticTrainer(Cluster(devices=[card]), spec, store=store)

    # two clean runs, checkpoints off (a throwaway store, never written)
    clean = []
    for _ in range(2):
        out = trainer(None, ckpt_every=0).run()
        clean.append((out["losses"], out["report"]))
        del out
        torch.cuda.empty_cache()
    spread = max(abs(a - b) for a, b in zip(clean[0][0], clean[1][0]))

    saved, checked = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-") as root:
        run = trainer(ObjectStore(root), ckpt_every=ELASTIC_CKPT_EVERY,
                      fail_at=ELASTIC_FAIL_AT)
        ck = run.ckpt
        save_async, restore_latest = ck.save_async, ck.restore_latest

        def save_spy(step, tree, extra=None):
            if step == ELASTIC_RESTORED:        # a device copy, a few ms
                saved.update({k: v.clone() for k, v in
                              flatten_with_paths(tree)})
            save_async(step, tree, extra)

        def restore_spy(abstract, device="cuda", **kw):
            tree, meta = restore_latest(abstract, device, **kw)
            if tree is not None:
                got = dict(flatten_with_paths(tree))
                checked["step"] = meta["step"]
                checked["keys"] = sorted(got) == sorted(saved)
                checked["unequal"] = [k for k, v in saved.items()
                                      if not torch.equal(_bits(got[k]),
                                                         _bits(v))]
                saved.clear()               # free the copy before training
            return tree, meta

        ck.save_async, ck.restore_latest = save_spy, restore_spy
        torch.cuda.reset_peak_memory_stats()
        xent.fwd_launches = xent.bwd_launches = au.launches = 0
        out = run.run()
        launches = {"xent_fwd": xent.fwd_launches,
                    "xent_bwd": xent.bwd_launches,
                    "adamw_update": au.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        kept = ck.all_steps()
        ckpt_bytes = sum(
            p.stat().st_size for p in
            Path(root, "checkpoints", f"step_{kept[-1]:010d}").rglob("*")
            if p.is_file())
        on_disk = ObjectStore(root).total_bytes()
    rep, losses = out["report"], out["losses"]
    starts_gb = [v / 1e9 for _, v in run.metrics.series(
        "elastic/segment_start_allocated_bytes").snapshot()]
    del out, run
    executed = rep.steps_executed
    wall = rep.total_wall_s
    result = {
        "arch": ARCH, "layers": ELASTIC_LAYERS, "params_b": n_params / 1e9,
        "dtype": "bfloat16", "steps": ELASTIC_STEPS, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "device_steps": ELASTIC_K,
        "ckpt_every": ELASTIC_CKPT_EVERY, "fail_at": ELASTIC_FAIL_AT,
        "outcomes": [s.outcome for s in rep.segments],
        "segments": [[s.start, s.end] for s in rep.segments],
        "restored_step": checked.get("step"),
        "restore_bit_exact": checked.get("keys") is True
        and not checked.get("unequal"),
        "kept_steps": kept, "ckpt_gb": ckpt_bytes / 1e9,
        "saves": ck.saves, "restores": ck.restores,
        "recovery_s": rep.recovery_s, "t_first_s": rep.t_first_s,
        "t_first_s_by_segment": [s.t_first_s for s in rep.segments],
        "clean_t_first_s": clean[0][1].t_first_s,
        "steps_lost": rep.steps_lost, "steps_executed": executed,
        "total_wall_s": wall, "clean_wall_s": [c[1].total_wall_s
                                               for c in clean],
        "useful_tokens_per_s": rep.tokens_per_s,
        "executed_tokens_per_s": rep.tokens_executed / max(wall, 1e-9),
        "clean_tokens_per_s": [c[1].tokens_per_s for c in clean],
        "host_syncs_per_step": rep.host_syncs_per_step,
        "segment_start_allocated_gb": starts_gb, "peak_mem_gb": peak_gb,
        "launches": launches, "losses": losses, "clean_losses": clean[0][0],
        "clean_spread": spread,
        "disk_written_gb": sum(r["bytes"] for r in ck.saves) / 1e9,
        "on_disk_gb": on_disk / 1e9, "card": smi}
    log(f"[elastic] {ARCH} at {ELASTIC_LAYERS} layers ({n_params / 1e9:.3f} B "
        f"params, bf16): outcomes {result['outcomes']} segments "
        f"{result['segments']}; restored step {result['restored_step']} "
        f"(bit exact: {result['restore_bit_exact']}); steps lost "
        f"{rep.steps_lost}, executed {executed}; checkpoint "
        f"{ckpt_bytes / 1e9:.3f} GB; saves {ck.saves}; restores "
        f"{ck.restores}; recovery_s {rep.recovery_s}; launches {launches}; "
        f"allocated at segment starts {starts_gb} GB, peak {peak_gb:.2f} GB")
    log(f"[elastic] losses {losses}; clean {clean[0][0]}; clean runs differ "
        f"by {spread:.3g} at most; disk written {result['disk_written_gb']:.2f}"
        f" GB, on disk at the end {result['on_disk_gb']:.2f} GB")

    if result["outcomes"] != ["error", "done"] or \
            result["segments"] != [[0, 5], [4, 7]]:
        raise AssertionError(f"elastic segments {rep.to_json()}")
    if rep.steps_lost != 2 or executed != 10 or kept != [3, 7]:
        raise AssertionError(f"steps lost {rep.steps_lost}, executed "
                             f"{executed}, checkpoints kept {kept}")
    if checked.get("step") != ELASTIC_RESTORED or \
            not result["restore_bit_exact"]:
        raise AssertionError(f"restore of step {ELASTIC_RESTORED}: {checked}")
    want = {"xent_fwd": executed * (TRAIN_SEQ // 512),
            "xent_bwd": executed * (TRAIN_SEQ // 512),
            "adamw_update": executed * n_leaves}
    if launches != want:
        raise AssertionError(f"elastic kernel launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses + clean[0][0]) or \
            len(losses) != ELASTIC_STEPS:
        raise AssertionError(f"elastic losses {losses}")
    gap = max(abs(a - b) for a, b in zip(losses, clean[0][0]))
    if gap > 2 * spread:
        raise AssertionError(f"crash run's losses differ from the clean "
                             f"run's by {gap:.3g} (allowed {2 * spread:.3g})")
    # the dead segment's tensors are gone before the restored one starts:
    # the second start holds at most the first's plus the step-3 copy
    if len(starts_gb) != 2 or \
            starts_gb[1] > starts_gb[0] + ckpt_bytes / 1e9 + 0.5:
        raise AssertionError(f"allocated at segment starts {starts_gb} GB")
    return result, launches


def _serve_row(metrics, smi, **extra):
    """tok/s, p50 TTFT and the rest of a serving run's gauges."""
    from repro_torch.serving.report import GAUGES
    sm = metrics.summary()
    return {"requests": int(sm[GAUGES.COMPLETED]["total"]),
            "tokens": int(sm[GAUGES.TOKENS]["total"]),
            "tok_s": sm[GAUGES.TOK_S]["last"],
            "decode_tok_s": sm.get(GAUGES.DECODE_TOK_S, {}).get("last"),
            "p50_ttft_s": sm[GAUGES.TTFT_S]["p50"],
            "p99_ttft_s": sm[GAUGES.TTFT_S]["p99"],
            "prefill_s_p50": sm[GAUGES.PREFILL_S]["p50"],
            "decode_steps": int(sm.get(GAUGES.DECODE_STEPS,
                                       {}).get("total", 0)),
            "wall_s": sm[GAUGES.WALL_S]["last"], **extra, "card": smi}


def phase_serve_router(smi: str, single):
    """Full-width phi4 in bf16 behind the router: 16 requests of the serve
    mix through ``serve_replicated`` (1 to 2 replicas of 4 slots, paged,
    prefix cache); tokens against the single-engine serve phase's.  Then
    ``serve_static`` in batches of 4 on the same requests."""
    from repro_torch.configs import registry
    from repro_torch.core.metrics import Registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve_static
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_replicated
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.report import GAUGES

    # earlier phases' objects that sit in reference cycles go first (the
    # elastic trainer used to keep its last state, 10.2 GB, in one)
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[router] {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
        f"at the phase's start ({held / 1e9:.3f} GB before a cycle "
        f"collection)")
    cfg = registry.get_config(ARCH)
    params = pr.init_params(tfm.lm_schema(cfg),
                            torch.Generator(device="cuda").manual_seed(0),
                            cfg.param_dtype, "cuda")
    reqs = _requests(cfg.vocab_size, ROUTER_REQUESTS)
    want_tokens = sum(r["max_new_tokens"] for r in reqs)
    prefilled = {}                # replica -> prompts it prefilled whole

    def factory(name, reg, dev):
        engine = ServingEngine(cfg, device=dev, num_slots=SLOTS,
                               prompt_len=PROMPT, max_new_tokens=GEN,
                               params=params, registry=reg, paged=True,
                               block_size=BLOCK, prefix_cache=True)
        engine.warmup()
        prefill = engine.prefill_into

        def counted(slot, prompt):
            prefilled.setdefault(name, []).append(tuple(prompt))
            return prefill(slot, prompt)
        engine.prefill_into = counted
        return engine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    results, metrics, events = serve_replicated(
        factory, reqs, device="cuda", min_replicas=1, max_replicas=2,
        target_backlog=ROUTER_BACKLOG, registry=Registry(), timeout_s=300.0)
    torch.cuda.synchronize()
    router_launches = fa.launches
    router_peak = torch.cuda.max_memory_allocated() / 1e9
    sm = metrics.summary()
    # every prefill (the two warmups included) ran flash on every layer
    prefills = int(sm[GAUGES.PREFILL_S]["count"])
    by_replica = {n: len(v) for n, v in prefilled.items()}
    full = {r["id"] for r in reqs
            if any(tuple(r["prompt"]) in v for v in prefilled.values())}
    scale_ups = [e for e in events if e[2] > e[1] and e[3] != "startup"]
    # like paths: prefilled whole in both runs, or replayed in both
    like = [r["id"] for r in reqs if r["id"] in single["results"]
            and (r["id"] in full) == (r["id"] in single["full"])]
    equal = [i for i in like if results[i] == single["results"][i]]
    unlike = sorted(set(single["results"]) - set(like))
    log(f"[router] {ARCH}: completed {len(results)}/{len(reqs)}, tokens "
        f"{sm[GAUGES.TOKENS]['total']:.0f}/{want_tokens}; scale events "
        f"{[(e[1], e[2], e[3]) for e in events]}; full prefills by replica "
        f"{by_replica} (prefix replays: {len(reqs) - len(full)}); flash "
        f"launches {router_launches} over {prefills} prefills; tokens equal "
        f"to the single engine's on {len(equal)}/{len(like)} requests "
        f"served on like paths (other paths: {unlike})")
    if sorted(results) != list(range(len(reqs))) or any(
            len(results[r["id"]]) != r["max_new_tokens"] for r in reqs):
        raise AssertionError("router: a request did not complete with its "
                             "stop length")
    if not scale_ups:
        raise AssertionError(f"router: no scale-up event: {events}")
    if router_launches != cfg.num_layers * prefills:
        raise AssertionError(f"router: flash launches {router_launches} != "
                             f"{cfg.num_layers} x {prefills} prefills")
    if not like or len(equal) != len(like):
        raise AssertionError(f"router: tokens differ from the single engine's "
                             f"on {sorted(set(like) - set(equal))}")
    router = _serve_row(metrics, smi, scale_events=[list(e[1:])
                                                    for e in events],
                        replicas_max=int(metrics.series(
                            GAUGES.REPLICAS).max),
                        full_prefills_by_replica=by_replica,
                        flash_launches=router_launches,
                        tokens_equal_single=f"{len(equal)}/{len(like)}",
                        peak_mem_gb=router_peak)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    static, smetrics = serve_static(
        ARCH, smoke=False, n_requests=len(reqs), prompt_len=PROMPT, gen=GEN,
        batch=STATIC_BATCH, requests=reqs, params=params, device="cuda")
    torch.cuda.synchronize()
    static_launches = fa.launches
    static_peak = torch.cuda.max_memory_allocated() / 1e9
    batches = int(smetrics.summary()[GAUGES.PREFILL_S]["count"])
    same = sum(static[r["id"]] == results[r["id"]] for r in reqs)
    log(f"[static] {ARCH}, batches of {STATIC_BATCH}: completed "
        f"{len(static)}/{len(reqs)} in {batches} B={STATIC_BATCH} prefills, "
        f"flash launches {static_launches}; tokens equal to the continuous "
        f"engine's on {same}/{len(reqs)} requests (a B=4 prefill runs GEMMs "
        f"of another M, so bf16 rounding may differ)")
    if sorted(static) != list(range(len(reqs))) or any(
            len(static[r["id"]]) != r["max_new_tokens"] for r in reqs):
        raise AssertionError("static: a request did not complete with its "
                             "stop length")
    if batches != math.ceil(len(reqs) / STATIC_BATCH) or \
            static_launches != cfg.num_layers * batches:
        raise AssertionError(f"static: flash launches {static_launches} over "
                             f"{batches} prefills")
    static_row = _serve_row(smetrics, smi, batch=STATIC_BATCH,
                            prefills=batches, flash_launches=static_launches,
                            tokens_equal_continuous=f"{same}/{len(reqs)}",
                            peak_mem_gb=static_peak)
    log(f"[router vs static] tok/s {router['tok_s']:.1f} vs "
        f"{static_row['tok_s']:.1f}; p50 TTFT {router['p50_ttft_s']:.3f} vs "
        f"{static_row['p50_ttft_s']:.3f} s; scale events "
        f"{router['scale_events']} vs none; peak {router_peak:.2f} vs "
        f"{static_peak:.2f} GB")
    del params
    return {"router": router, "static": static_row}, {
        "router": router_launches, "static": static_launches}


def phase_rl(smi: str):
    """phi4 at full width and 4 layers in bf16 through ``run_rl_fleet``:
    2 actors, the learner, the policy store, 4 learner steps."""
    import tempfile

    from repro_torch.api.resources import RLJob
    from repro_torch.api.runners import dataclass_kwargs, run_rl_fleet
    from repro_torch.configs import registry
    from repro_torch.core.metrics import Registry
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import xent
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.report import GAUGES

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[rl] {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated at the "
        f"phase's start")
    cfg = registry.get_config(ARCH).replace(num_layers=ELASTIC_LAYERS)
    n_leaves = len(pr.leaves(tfm.lm_schema(cfg)))
    job = RLJob(name="chip-smoke-rl", learner_steps=RL_STEPS, arch=ARCH,
                smoke=False, actors=RL_ACTORS,
                rollouts_per_step=RL_ROLLOUTS, prompt_len=RL_PROMPT,
                max_new_tokens=RL_GEN, seq_len=RL_PROMPT + RL_GEN,
                slots=RL_SLOTS, max_policy_lag=RL_LAG,
                broadcast_every=RL_BROADCAST, ckpt_every=0,
                config=dataclass_kwargs(cfg), paged=True)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-rl-") as root:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = xent.fwd_launches = xent.bwd_launches = au.launches = 0
        t0 = time.perf_counter()
        out = run_rl_fleet(None, job, learner_store=ObjectStore(root),
                           metrics=Registry(), device="cuda")
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches,
                    "xent_fwd": xent.fwd_launches,
                    "xent_bwd": xent.bwd_launches,
                    "adamw_update": au.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        on_disk = ObjectStore(root).total_bytes()
    gc.collect()
    rep = out["report"]
    actors = {n: m.summary() for n, m in out.pop("actor_metrics").items()}
    prefills = sum(int(a[GAUGES.PREFILL_S]["count"]) for a in actors.values())
    actor_tokens = sum(int(a[GAUGES.TOKENS]["total"]) for a in actors.values())
    saves = out["policy_saves"] + out["learner_saves"]
    written = sum(r["bytes"] for r in saves)
    want = {"flash_attention": cfg.num_layers * prefills,
            "xent_fwd": RL_STEPS, "xent_bwd": RL_STEPS,
            "adamw_update": RL_STEPS * n_leaves}
    result = {
        "arch": ARCH, "layers": ELASTIC_LAYERS, "dtype": "bfloat16",
        "actors": RL_ACTORS, "slots": RL_SLOTS, "prompt": RL_PROMPT,
        "gen": RL_GEN, "rollouts_per_step": RL_ROLLOUTS, "steps": RL_STEPS,
        "broadcast_every": RL_BROADCAST, "max_policy_lag": RL_LAG,
        "done": out["done"], "steps_done": out["steps_done"],
        "publishes": out["publishes"], "final_version": out["final_version"],
        "trained": out["trained"], "stale_dropped": out["stale_dropped"],
        "max_lag_trained": out["max_lag_trained"],
        "tickets_fed": out["tickets_fed"],
        "rollouts_pushed": out["rollouts_pushed"],
        "actor_syncs": out["actor_syncs"], "losses": rep["losses"],
        "grad_norms": rep["grad_norms"], "reward_mean": rep["reward_mean"],
        "reward_std": rep["reward_std"],
        "learner_step_ms": [1e3 * x for x in rep["chunk_s"]],
        "learner_drain_s": rep["drain_s"],
        "actor_prefills": prefills, "actor_tokens": actor_tokens,
        "actor_tok_s": actor_tokens / wall,
        "actor_busy_tok_s": {n: a[GAUGES.TOKENS]["total"] /
                             max(a[GAUGES.WALL_S]["total"], 1e-9)
                             for n, a in actors.items()},
        "publish_s": [r["snapshot_s"] + r["write_s"]
                      for r in out["policy_saves"]],
        "fetch_s": [r["seconds"] for r in out["policy_fetches"]],
        "ckpt_saves": out["learner_saves"],
        "disk_written_gb": written / 1e9, "on_disk_gb": on_disk / 1e9,
        "wall_s": wall, "peak_mem_gb": peak_gb, "launches": launches,
        "card": smi}
    log(f"[rl] {ARCH} at {ELASTIC_LAYERS} layers, bf16: done {out['done']}, "
        f"steps {out['steps_done']}/{RL_STEPS}, publishes {out['publishes']}, "
        f"final version {out['final_version']}, trained {out['trained']} "
        f"(stale {out['stale_dropped']}, max lag {out['max_lag_trained']}), "
        f"actor syncs {out['actor_syncs']}; losses {rep['losses']}; grad "
        f"norms {rep['grad_norms']}; rewards {rep['reward_mean']} (spread "
        f"{rep['reward_std']}); launches {launches} (want {want})")
    log(f"[rl] actors {actor_tokens} tokens in {prefills} prefills, "
        f"{result['actor_tok_s']:.1f} tok/s over the {wall:.1f} s run "
        f"(busy: {result['actor_busy_tok_s']}); learner step ms "
        f"{result['learner_step_ms']}, waits for rollouts "
        f"{rep['drain_s']} s; publish s {result['publish_s']}, fetch s "
        f"{result['fetch_s']}; checkpoints {out['learner_saves']}; disk "
        f"written {written / 1e9:.2f} GB, on disk at the end "
        f"{on_disk / 1e9:.2f} GB; peak {peak_gb:.2f} GB")
    log("[rl] cut: depth 4 of 32 layers (disk); no periodic checkpoint and "
        "no injected learner crash on the card (the crash and resume run "
        "on the CPU, tests/test_torch_rl.py): a periodic checkpoint adds "
        "10.17 GB to a script that writes about 35 GB, past 40 GB under the "
        "machine's 45 GiB stop")
    if not (out["done"] and out["steps_done"] == RL_STEPS):
        raise AssertionError(f"rl: not done: {rep}")
    if out["final_version"] != out["publishes"] or \
            min(out["actor_syncs"].values(), default=0) < 1:
        raise AssertionError(f"rl: versions {out['final_version']} / "
                             f"{out['publishes']}, syncs {out['actor_syncs']}")
    if out["max_lag_trained"] > RL_LAG or \
            out["trained"] != RL_STEPS * RL_ROLLOUTS:
        raise AssertionError(f"rl: trained {out['trained']}, max lag "
                             f"{out['max_lag_trained']}")
    if not all(math.isfinite(x) for x in rep["losses"] + rep["grad_norms"]):
        raise AssertionError("rl: a loss or grad norm is not finite")
    if launches != want or prefills < 1:
        raise AssertionError(f"rl kernel launches {launches} != {want}")
    return result, launches


# ---------------------------------------------------------------- session
# Entrypoints of the session phase's graph workflow: a manifest names them
# as ``__main__:<name>``, so they resolve in this script's process.
def session_plan(ctx):
    return {"items": list(range(SESSION_BRANCHES))}


def session_flash_branch(ctx):
    """One scatter branch: a pod of the session's cluster leases one device
    (the card, in turn with the other branch), runs flash attention at
    phi4's prefill shape there and holds it against the plain version."""
    from repro_torch.core.orchestrator import JobSpec
    from repro_torch.kernels import flash_attention as fa
    item = ctx.inputs["item"]

    def pod(pc):
        dev = pc.devices[0]
        gen = torch.Generator(device=dev).manual_seed(100 + item)
        B, H, KV, Sq, Sk, dh = 1, 24, 8, PROMPT, PROMPT, 128
        q, k, v = (torch.randn(B, n, S, dh, generator=gen, device=dev)
                   .to(torch.bfloat16) for n, S in ((H, Sq), (KV, Sk),
                                                    (KV, Sk)))
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=True)
        launched = fa.launches - before
        want = fa.attention_plain(q, k, v, causal=True)
        err = (got.float() - want.float()).abs().max().item()
        return {"device": str(dev), "max_abs_err": err, "launches": launched}

    deadline = time.monotonic() + 120.0
    while True:            # the other branch may hold the only card
        try:
            job = ctx.cluster.submit(ctx.namespace, JobSpec(
                f"flash-{item}", pod, replicas=1, devices_per_pod=1,
                backoff_limit=0))
            break
        except RuntimeError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)
    ctx.cluster.wait(job, timeout=300.0)
    return job.results()[0]


def session_join(ctx):
    return {"max_abs_err": max(b["max_abs_err"] for b in ctx.inputs["fan"]),
            "launches": sum(b["launches"] for b in ctx.inputs["fan"])}


def _contracted_init(cfg):
    """The train phases' weights for the session's TrainJobs: the trainer
    draws its params through ``params.init_params``, swapped here for the
    f32 draw with wq/wk/wv/wo at their contracted fan-in, cast to bf16.
    The swap is global: it is in place from before a TrainJob is applied
    until after its handle is terminal, and the session runs one workload
    at a time, so nothing else draws params meanwhile."""
    import contextlib

    from repro_torch.launch import grad_check
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps

    @contextlib.contextmanager
    def swapped():
        draw = pr.init_params

        def init(schema, gen, dtype, device="cuda"):
            params = draw(schema, gen, "float32", device)
            grad_check.contracted_attention_init_(cfg, params)
            return steps._map(lambda t: t.to(getattr(torch, dtype)), params)
        pr.init_params = init
        try:
            yield
        finally:
            pr.init_params = draw
    return swapped()


def _lifecycle(events):
    """The workload's states in order, repeats (detail updates) merged."""
    out = []
    for e in events:
        if "event" not in e and (not out or out[-1] != e["state"]):
            out.append(e["state"])
    return out


def phase_session(smi: str, clean_spread: float):
    """Phase 12: one ``Session(cluster=Cluster())`` on the card runs five
    workloads, each applied as a manifest dict: a ServeJob of full-width
    phi4, a TrainJob of phi4 at 4 layers, a second one cancelled, a graph
    WorkflowRun whose branches lease the card, a ServeJob of codeqwen.
    ``clean_spread`` is how far the elastic phase's two clean runs'
    losses differ: the TrainJob's losses must equal a direct trainer's
    bit for bit when it is 0, else lie within twice it."""
    import tempfile

    from repro_torch.api import Session, WorkloadState, runners
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs import registry
    from repro_torch.core.metrics import Registry
    from repro_torch.core.orchestrator import Cluster
    from repro_torch.core.queue import WorkQueue
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import xent
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    from repro_torch.serving.report import GAUGES

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[session] {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
        f"at the phase's start")
    rows, launches = {}, {}
    phi4, cq = registry.get_config(ARCH), registry.get_config(CODEQWEN)
    tcfg = phi4.replace(num_layers=ELASTIC_LAYERS)
    n_leaves = len(pr.leaves(tfm.lm_schema(tcfg)))

    def zero():
        fa.launches = xent.fwd_launches = xent.bwd_launches = au.launches = 0

    def counts():
        return {"flash_attention": fa.launches, "xent_fwd": xent.fwd_launches,
                "xent_bwd": xent.bwd_launches, "adamw_update": au.launches}

    def run(session, sub, manifest, during=None):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sub.poll()
        zero()
        log(f"[session] {torch.cuda.memory_allocated() / 1e9:.3f} GB "
            f"allocated before {manifest['metadata']['name']}")
        h = session.apply(manifest)
        extra = during(h) if during is not None else {}
        out = h.wait(900)                 # raises if the workload FAILED
        torch.cuda.synchronize()
        session.forget(h)                 # its result goes to the caller
        ran = counts()
        evs = h.events()
        running = next(e["ts"] for e in evs if e["state"] == "Running")
        bus = [e for e in sub.poll() if e.kind == "workload"]
        row = {"workload": h.spec.name, "kind": h.spec.KIND,
               "state": h.state.value, "lifecycle": _lifecycle(evs),
               "apply_to_running_s": running - evs[0]["ts"],
               "wall_s": evs[-1]["ts"] - evs[0]["ts"], "events": len(evs),
               "bus_events": len(bus),
               "bus_lifecycle": _lifecycle([dict(e.data) for e in bus]),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               **extra, "card": smi}
        want = ["Pending", "Placing", "Running",
                "Cancelled" if h.spec.name.endswith("cancel") else
                "Succeeded"]
        if row["lifecycle"] != want or row["bus_lifecycle"] != want:
            raise AssertionError(f"{h.spec.name}: lifecycle "
                                 f"{row['lifecycle']} / bus "
                                 f"{row['bus_lifecycle']} != {want}")
        return h, out, ran, row

    with tempfile.TemporaryDirectory(prefix="chip-smoke-session-") as root:
        session = Session(cluster=Cluster(), store=ObjectStore(root))
        sub = session.bus.subscribe(maxlen=100_000)

        # a. ServeJob: full-width phi4, the serve phase's shape of traffic
        man = {"apiVersion": "repro/v1", "kind": "ServeJob",
               "metadata": {"name": "chip-smoke-session-serve"},
               "spec": {"arch": ARCH, "smoke": False, "n_requests": 8,
                        "prompt_len": PROMPT, "max_new_tokens": GEN,
                        "gen_lens": list(GEN_LENS), "slots": SLOTS,
                        "paged": True, "block_size": BLOCK,
                        "prefix_cache": True, "seed": 0}}
        h, out, ran, row = run(session, sub, man)
        job = h.spec
        results, sm = out["results"], out["metrics"].summary()
        prefills = int(sm[GAUGES.PREFILL_S]["count"])
        stops = [GEN_LENS[i % len(GEN_LENS)] for i in range(8)]
        del out, h
        gc.collect()
        torch.cuda.empty_cache()
        engine = runners.build_engine(job, registry_out=Registry(),
                                      device="cuda")
        direct, dm = engine.run(WorkQueue(runners.serve_requests(job)),
                                default_max_new=job.max_new_tokens)
        torch.cuda.synchronize()
        del engine
        row.update(tok_s=sm[GAUGES.TOK_S]["last"],
                   direct_tok_s=dm.summary()[GAUGES.TOK_S]["last"],
                   p50_ttft_s=sm[GAUGES.TTFT_S]["p50"], prefills=prefills,
                   decode_steps=int(sm[GAUGES.DECODE_STEPS]["total"]),
                   launches=ran, tokens_equal_direct=direct == results)
        log(f"[session] serve {ARCH}: {row['state']}, lifecycle "
            f"{row['lifecycle']}; {len(results)} requests, flash "
            f"{ran['flash_attention']} over {prefills} prefills; tok/s "
            f"{row['tok_s']:.1f} (direct engine {row['direct_tok_s']:.1f}); "
            f"tokens equal to the direct engine's: {direct == results}")
        got = [len(results.get(i, [])) for i in range(8)]
        if got != stops:
            raise AssertionError(f"session serve: stop lengths {got}")
        if ran["flash_attention"] != phi4.num_layers * prefills or \
                prefills < 1:
            raise AssertionError(f"session serve: flash {ran} over "
                                 f"{prefills} prefills")
        if direct != results:
            raise AssertionError("session serve: tokens differ from a direct "
                                 "build_engine + run")
        rows["serve"], launches["serve"] = row, ran

        # b. TrainJob: phi4 at full width and 4 layers, no checkpoint
        train_spec = {"arch": ARCH, "smoke": False, "seq_len": TRAIN_SEQ,
                      "global_batch": TRAIN_BATCH, "device_steps": SESSION_K,
                      "ckpt_every": 0, "ckpt_dir": "", "log_every": SESSION_K,
                      "config": runners.dataclass_kwargs(tcfg),
                      "optimizer": {"lr": SESSION_LR}}
        man = {"kind": "TrainJob",
               "metadata": {"name": "chip-smoke-session-train"},
               "spec": {**train_spec, "steps": SESSION_STEPS}}
        card = torch.device("cuda", 0)
        with _contracted_init(tcfg):
            h, out, ran, row = run(session, sub, man)
            losses, rep = out["losses"], out["report"]
            job = h.spec
            del out, h
            gc.collect()
            torch.cuda.empty_cache()
            # the same spec and init through the trainer itself, off the
            # session: the session must train as the trainer does
            direct = ElasticTrainer(Cluster(devices=[card]),
                                    runners.elastic_spec(job, device=card),
                                    store=None).run()["losses"]
        gc.collect()
        torch.cuda.empty_cache()
        gap = max(abs(a - b) for a, b in zip(losses, direct))
        seg = rep.segments[-1]
        want = {"flash_attention": 0,
                "xent_fwd": SESSION_STEPS * (TRAIN_SEQ // 512),
                "xent_bwd": SESSION_STEPS * (TRAIN_SEQ // 512),
                "adamw_update": SESSION_STEPS * n_leaves}
        row.update(layers=ELASTIC_LAYERS, steps=SESSION_STEPS,
                   device_steps=SESSION_K, losses=losses,
                   direct_losses=direct, direct_gap=gap,
                   step_ms=1e3 * rep.total_wall_s / SESSION_STEPS,
                   chunk_step_ms=1e3 * (seg.wall_s - seg.t_first_s)
                   / max(SESSION_STEPS - SESSION_K, 1),
                   t_first_s=rep.t_first_s, launches=ran)
        log(f"[session] train {ARCH} at {ELASTIC_LAYERS} layers: "
            f"{row['state']}, losses {losses} (a direct ElasticTrainer run: "
            f"{direct}, {gap:.3g} apart, allowed {2 * clean_spread:.3g}); "
            f"{row['step_ms']:.1f} ms a step "
            f"over the run ({row['chunk_step_ms']:.1f} after the first "
            f"chunk); launches {ran} (want {want})")
        if len(losses) != SESSION_STEPS or len(direct) != SESSION_STEPS or \
                not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"session train: losses {losses}")
        if (losses != direct) if clean_spread == 0 else \
                gap > 2 * clean_spread:
            raise AssertionError(f"session train: losses {losses} differ "
                                 f"from a direct trainer's {direct}")
        if ran != want:
            raise AssertionError(f"session train: launches {ran} != {want}")
        rows["train"], launches["train"] = row, ran

        # c. the same model for 40 steps, cancelled once step >= 2
        ckroot = tempfile.mkdtemp(prefix="ckpt-", dir=root)
        man = {"kind": "TrainJob",
               "metadata": {"name": "chip-smoke-session-cancel"},
               "spec": {**train_spec, "steps": SESSION_CANCEL_STEPS,
                        "ckpt_dir": ckroot}}

        def cancel(h):
            while h.status().observed.get("step", -1) < SESSION_CANCEL_AT:
                if h.state != WorkloadState.RUNNING and \
                        h.state != WorkloadState.PLACING and \
                        h.state != WorkloadState.PENDING:
                    raise AssertionError(f"session cancel: {h.state}")
                time.sleep(0.002)
            at = h.status().observed["step"]
            t0 = time.perf_counter()
            h.cancel(wait=True, timeout=600)
            return {"cancel_at_step": at,
                    "cancel_to_terminal_s": time.perf_counter() - t0}

        with _contracted_init(tcfg):
            h, out, ran, row = run(session, sub, man, during=cancel)
        seg = out["report"].segments[-1]
        ck = Checkpointer(ObjectStore(ckroot))
        saved = ck.latest_step()
        written = ObjectStore(ckroot).total_bytes()
        del out
        row.update(steps=SESSION_CANCEL_STEPS, last_step=seg.end,
                   outcome=seg.outcome, checkpoint_step=saved,
                   disk_written_gb=written / 1e9, launches=ran)
        log(f"[session] cancel {ARCH}: {row['state']} {row['lifecycle']}; "
            f"cancel() at step {row['cancel_at_step']}, the segment ended at "
            f"step {seg.end} ({seg.outcome}); "
            f"{row['cancel_to_terminal_s']:.2f} s from cancel() to terminal "
            f"(the goodbye checkpoint of step {saved}, "
            f"{written / 1e9:.2f} GB, included)")
        if h.state != WorkloadState.CANCELLED or seg.outcome != "preempted" \
                or not seg.end <= row["cancel_at_step"] + SESSION_K \
                or saved != seg.end:
            raise AssertionError(f"session cancel: {h.state}, segment "
                                 f"{seg}, checkpoint {saved}")
        del h
        rows["cancel"], launches["cancel"] = row, ran

        # d. WorkflowRun as a graph: plan -> 2 flash branches -> join
        name = "chip-smoke-session-graph"
        man = {"kind": "WorkflowRun", "metadata": {"name": name},
               "spec": {"max_workers": SESSION_BRANCHES, "graph": {"nodes": [
                   {"step": "plan", "entrypoint": "__main__:session_plan"},
                   {"step": "fan", "deps": ["plan"],
                    "entrypoint": "__main__:session_flash_branch",
                    "scatter": {"over": "plan.items"}},
                   {"step": "join", "deps": ["fan"],
                    "entrypoint": "__main__:session_join"}]}}}
        h, out, ran, row = run(session, sub, man)
        store = ObjectStore(root)
        markers = {key: store.exists(f"workflows/{name}/{key}/_COMPLETE")
                   for key in ["plan", "fan", "join"] +
                   [f"fan#{i}" for i in range(SESSION_BRANCHES)]}
        branches = out["results"]["fan"]
        join = out["results"]["join"]
        del out, h
        row.update(branches=branches, markers=markers, launches=ran)
        log(f"[session] graph: {row['state']}, branches {branches}, markers "
            f"{markers}")
        if not all(markers.values()) or \
                join["launches"] != SESSION_BRANCHES or \
                ran["flash_attention"] != SESSION_BRANCHES or \
                not join["max_abs_err"] <= 2e-2 or \
                any(not b["device"].startswith("cuda") for b in branches):
            raise AssertionError(f"session graph: {branches}, {markers}, "
                                 f"{join}, {ran}")
        rows["graph"], launches["graph"] = row, ran

        # e. ServeJob: codeqwen1.5-7b at full width
        man = {"kind": "ServeJob",
               "metadata": {"name": "chip-smoke-session-codeqwen"},
               "spec": {"arch": CODEQWEN, "smoke": False,
                        "n_requests": CODEQWEN_REQUESTS,
                        "prompt_len": PROMPT, "max_new_tokens": CODEQWEN_GEN,
                        "slots": SLOTS, "paged": True, "block_size": BLOCK,
                        "seed": 0}}
        h, out, ran, row = run(session, sub, man)
        job = h.spec
        results, sm = out["results"], out["metrics"].summary()
        prefills = int(sm[GAUGES.PREFILL_S]["count"])
        del out, h
        gc.collect()
        torch.cuda.empty_cache()
        # one full-width prefill of request 0 on the same weights: finite
        # logits, and their argmax is the token the session generated first
        params = pr.init_params(tfm.lm_schema(cq),
                                torch.Generator(device="cuda").manual_seed(0),
                                cq.param_dtype, "cuda")
        prompt = runners.serve_requests(job)[0]["prompt"]
        with torch.inference_mode():
            last, _ = steps.prefill_step(cq, params,
                                         torch.tensor([prompt], device="cuda"))
        finite = bool(torch.isfinite(last).all())
        first = int(last.float().argmax(dim=-1)[0])
        del params, last
        row.update(params_b=pr.param_count(tfm.lm_schema(cq)) / 1e9,
                   tok_s=sm[GAUGES.TOK_S]["last"],
                   p50_ttft_s=sm[GAUGES.TTFT_S]["p50"], prefills=prefills,
                   logits_finite=finite,
                   first_token_equal_prefill=first == results[0][0],
                   launches=ran)
        log(f"[session] serve {CODEQWEN} ({row['params_b']:.3f} B params): "
            f"{row['state']}; {len(results)} requests, flash "
            f"{ran['flash_attention']} over {prefills} prefills; tok/s "
            f"{row['tok_s']:.1f}; prefill logits finite {finite}, first "
            f"token {first} vs the session's {results[0][0]}")
        if [len(results.get(i, [])) for i in range(CODEQWEN_REQUESTS)] != \
                [CODEQWEN_GEN] * CODEQWEN_REQUESTS:
            raise AssertionError("session codeqwen: stop lengths")
        if ran["flash_attention"] != cq.num_layers * prefills or \
                prefills < 1:
            raise AssertionError(f"session codeqwen: flash {ran} over "
                                 f"{prefills} prefills")
        if not finite or first != results[0][0]:
            raise AssertionError(f"session codeqwen: logits finite {finite}, "
                                 f"first token {first} vs {results[0][0]}")
        rows["codeqwen"], launches["codeqwen"] = row, ran
        sub.close()
    return rows, launches


# ---------------------------------------------------------------- connect
# The paper-shaped CONNECT run of examples/connect_workflow.py --full: 4
# chunks of 24 frames x 361 x 576 (3 events), the default FFN (depth 8,
# width 32, fov 16 x 32 x 32, 4 flood iterations), 120 train steps of 4.
CONNECT_PARAMS = {"n_chunks": 4, "download_workers": 4,
                  "inference_workers": 4,
                  "vol": {"lat": 361, "lon": 576, "frames": 24},
                  "train_steps": 120}
# the card's ffn_apply vs the CPU's in f32 (no TF32), of the output's
# scale: 18 convolutions of up to 864-term sums, added in another order
FFN_RTOL = 1e-4
# fabric TrainJob: phi4 smoke (11 leaves) for FABRIC_STEPS steps of
# FABRIC_BATCH x FABRIC_SEQ (one xent chunk a step), checkpoints every 2
# steps mirrored to a second site; its site is killed once step
# FABRIC_KILL_AT is logged (its checkpoints are tiny: phi4 at 4 layers
# would write 10.17 GB a save twice, at home and at the mirror)
FABRIC_STEPS, FABRIC_SEQ, FABRIC_BATCH, FABRIC_KILL_AT = 16, 32, 4, 7


def _tree_bytes(root) -> int:
    """Bytes of every file under ``root`` (what a run wrote there)."""
    return sum(p.stat().st_size for p in Path(root).rglob("*") if p.is_file())


def _connect_manifest():
    return {"apiVersion": "repro/v1", "kind": "WorkflowRun",
            "metadata": {"name": "chip-smoke-connect"},
            "spec": {"namespace": "atmos-science",
                     "entrypoint": "repro_torch.apps.connect.pipeline:"
                                   "add_connect_steps",
                     "params": CONNECT_PARAMS}}


def _train_set_loss(cc, params, xs, ys, batch: int = 16) -> float:
    """Mean BCE of the FFN's one-step update over every training window,
    on the card."""
    from repro_torch.models import ffn3d
    total = 0.0
    with torch.inference_mode(), ffn3d.reference_convs():
        for i in range(0, len(xs), batch):
            x = torch.as_tensor(xs[i:i + batch], device="cuda")
            y = torch.as_tensor(ys[i:i + batch], device="cuda")
            total += float(ffn3d.bce_loss(cc.ffn, params, x, y)) * len(x)
    return total / len(xs)


def phase_connect(smi: str):
    """Phase 13: the CONNECT case study at the paper-shaped grid and the
    full FFN width, a WorkflowRun through ``Session(cluster=Cluster())``:
    Succeeded, a mask per chunk, objects found, and the trained model's
    mean loss over its training windows below the initial model's (the
    first and last batch losses are printed: they are losses of
    different windows, whose object shares differ); a second apply over
    the same store skips all four steps with an equal analysis; the
    card's ``ffn_apply`` against the CPU's on one batch of the trained
    model, and ``connect_label`` card against CPU on chunk 0's mask,
    exactly."""
    import tempfile

    import numpy as np

    from repro_torch.api import Session, WorkloadState
    from repro_torch.apps.connect import pipeline, segment
    from repro_torch.core.orchestrator import Cluster
    from repro_torch.data import volumes
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.models import ffn3d
    from repro_torch.models import params as pr

    gc.collect()
    torch.cuda.empty_cache()
    cc = pipeline.connect_config(**json.loads(json.dumps(CONNECT_PARAMS)))
    ft, fy, fx = cc.ffn.fov
    with tempfile.TemporaryDirectory(prefix="chip-smoke-connect-") as root:
        store = ObjectStore(root)
        session = Session(cluster=Cluster(), store=store)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h = session.apply(_connect_manifest())
        out = h.wait(1200)                # raises if the workload FAILED
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        written = _tree_bytes(root)
        results = out["results"]
        if h.state != WorkloadState.SUCCEEDED:
            raise AssertionError(f"connect: {h.state}")
        keys = volumes.chunk_keys(cc.n_chunks)
        missing = [k for k in keys if not store.exists(f"{k}/mask.npy")]
        if missing or results["analyze"]["objects"] < 1:
            raise AssertionError(f"connect: no mask for {missing}, or no "
                                 f"object: {results['analyze']}")
        step_s = {r.step: r.total_time_s for r in out["reports"]}
        # every train step syncs on its loss: the gauge's stamps time it
        stamps = [t for t, _ in
                  session.metrics.series("ffn_train/loss").snapshot()]
        train_ms = (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3
        covered = (cc.vol.frames // ft * ft) * (cc.vol.lat // fy * fy) * \
            (cc.vol.lon // fx * fx)
        tiles = covered // (ft * fy * fx)
        ious = [float(ffn3d.iou(
            torch.as_tensor(store.get_array(f"{k}/mask.npy")),
            torch.as_tensor(store.get_array(f"{k}/labels.npy"))))
            for k in keys]

        # a second apply over the same store skips every step
        again_session = Session(cluster=Cluster(), store=store)
        again = again_session.apply(_connect_manifest()).wait(600)
        skipped = [s for s in ("download", "train", "inference", "analyze")
                   if again_session.metrics.series(
                       f"workflow/chip-smoke-connect/{s}/skipped").total]

        # did training lower the loss?  Over every training window, the
        # trained model against the initial one (the same seeded draw)
        params = pipeline._load_ffn_params(store, cc, "cuda")
        xs, ys = pipeline.train_windows(store, cc, keys[0])
        init = pr.init_params(
            ffn3d.ffn_schema(cc.ffn),
            torch.Generator(device="cuda").manual_seed(cc.seed), "float32",
            "cuda")
        set_loss = (_train_set_loss(cc, init, xs, ys),
                    _train_set_loss(cc, params, xs, ys))
        rng = np.random.RandomState(cc.seed)      # the train step's draws
        draws = [rng.randint(0, len(xs), cc.train_batch)
                 for _ in range(cc.train_steps)]
        shares = (float(ys[draws[0]].mean()), float(ys[draws[-1]].mean()))
        del xs, ys, init

        # the card's FFN forward against the CPU's on one train batch of
        # tiles of chunk 0, with the trained params
        ivt0 = store.get_array(f"{keys[0]}/ivt.npy")
        x = torch.as_tensor(np.stack([ivt0[0:ft, 0:fy, i * fx:(i + 1) * fx]
                                      for i in range(cc.train_batch)]))
        with torch.inference_mode(), ffn3d.reference_convs():
            got = ffn3d.ffn_apply(
                cc.ffn, params, x.cuda(),
                ffn3d.seed_mask(cc.ffn, x.shape, "cuda")).cpu()
            want = ffn3d.ffn_apply(
                cc.ffn, {k: v.cpu() for k, v in params.items()}, x,
                ffn3d.seed_mask(cc.ffn, x.shape, "cpu"))
        ffn_err = float((got - want).abs().max()) / \
            max(float(want.abs().max()), 1.0)

        # connect_label on chunk 0's mask: card against CPU, exactly
        mask0 = torch.as_tensor(store.get_array(f"{keys[0]}/mask.npy"))
        t1 = time.perf_counter()
        lab_card = segment.connect_label(mask0.cuda()).cpu()
        label_card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        lab_cpu = segment.connect_label(mask0)
        label_cpu_s = time.perf_counter() - t1
        label_equal = torch.equal(lab_card, lab_cpu)
        label_objects = int(torch.unique(lab_cpu).numel()) - \
            int(bool((lab_cpu == 0).any()))

    row = {"workload": "chip-smoke-connect", "kind": "WorkflowRun",
           "state": h.state.value, "params": CONNECT_PARAMS,
           "wall_s": wall, "step_s": step_s,
           "first_loss": results["train"]["first_loss"],
           "last_loss": results["train"]["last_loss"],
           "n_windows": results["train"]["n_windows"],
           "first_last_batch_object_share": shares,
           "train_set_loss_initial": set_loss[0],
           "train_set_loss_trained": set_loss[1],
           "train_ms_per_step": train_ms,
           "tiles_per_chunk": tiles,
           "flood_fill_voxels_per_s": covered * cc.n_chunks /
           step_s["inference"],
           "inference_voxels_per_s": session.metrics.series(
               "inference/voxels_per_s").last,
           "iou": ious, "objects": results["analyze"]["objects"],
           "longest_lifecycle": results["analyze"]["longest_lifecycle"],
           "unsegmented_share": 1 - covered / (cc.vol.frames * cc.vol.lat *
                                               cc.vol.lon),
           "peak_gb": peak, "bytes_written": written,
           "again_skipped": skipped,
           "again_analyze_equal": again["results"]["analyze"] ==
           results["analyze"],
           "ffn_card_vs_cpu_err": ffn_err, "ffn_rtol": FFN_RTOL,
           "label_equal": label_equal, "label_objects_chunk0": label_objects,
           "label_card_s": label_card_s, "label_cpu_s": label_cpu_s,
           "card": smi}
    log(out["table"])
    log(f"[connect] {h.state.value} in {wall:.2f} s; steps "
        f"{ {k: round(v, 3) for k, v in step_s.items()} } s; loss "
        f"{row['first_loss']:.4f} -> {row['last_loss']:.4f}; "
        f"{train_ms:.2f} ms a train step; flood fill "
        f"{row['flood_fill_voxels_per_s']:.4g} voxels/s ({tiles} tiles a "
        f"chunk, {row['unsegmented_share']:.1%} of each chunk never "
        f"tiled); IoU {[round(v, 4) for v in ious]}; objects "
        f"{row['objects']}; peak {peak:.2f} GB; {written / 1e6:.1f} MB "
        f"written")
    log(f"[connect] loss of the first batch {row['first_loss']:.4f} and "
        f"the last {row['last_loss']:.4f} ({shares[0]:.2%} and "
        f"{shares[1]:.2%} object voxels); over all {row['n_windows']} "
        f"training windows {set_loss[0]:.6f} initial -> {set_loss[1]:.6f} "
        f"trained")
    log(f"[connect] second apply skipped {skipped}, analysis equal: "
        f"{row['again_analyze_equal']}; ffn_apply card vs CPU {ffn_err:.3g}"
        f" of scale (tolerance {FFN_RTOL}); connect_label card == CPU: "
        f"{label_equal} ({label_objects} objects; card {label_card_s:.3f} "
        f"s, CPU {label_cpu_s:.3f} s)")
    if not set_loss[1] < set_loss[0]:
        raise AssertionError(f"connect: training did not lower the loss "
                             f"over its windows: {set_loss}")
    if len(skipped) != 4 or again["reports"]:
        raise AssertionError(f"connect: second apply skipped {skipped}, "
                             f"ran {[r.step for r in again['reports']]}")
    if not row["again_analyze_equal"]:
        raise AssertionError("connect: second apply's analysis differs")
    if not ffn_err <= FFN_RTOL:
        raise AssertionError(f"connect: ffn_apply card vs CPU {ffn_err}")
    if not label_equal:
        raise AssertionError("connect: connect_label card != CPU")
    return row, results


def _fabric_connect(cc, want):
    """The CONNECT run of phase 13 across the three sites of
    ``examples/federated_connect.py`` on the card: locality placement,
    data-blind placement, and the hub killed after download.  The
    convolutions are deterministic (``reference_convs``), so every run
    trains the model of phase 13 and finds its objects."""
    import tempfile

    from repro_torch.data import volumes
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.examples import federated_connect as fc

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fabric-") as root:
        for tag, blind, kill in (("locality", False, ""),
                                 ("blind", True, ""),
                                 ("site_kill", False, "sdsc")):
            sub = f"{root}/{tag}"
            t0 = time.perf_counter()
            fabric, out, stats = fc.run_once(cc, data_blind=blind,
                                             kill_site=kill, device="cuda",
                                             root=sub)
            stats["wall_s"] = time.perf_counter() - t0
            stats["bytes_written"] = _tree_bytes(sub)
            res = out["results"]
            stats.update(train=res["train"], analyze=res["analyze"])
            # each mask lies at the site its inference ran at
            for key in (f"{k}/mask.npy" for k in
                        volumes.chunk_keys(cc.n_chunks)):
                if not any(ObjectStore(f"{sub}/{s.name}").exists(key)
                           for s in fabric.up_sites()):
                    raise AssertionError(f"fabric {tag}: {key} missing")
            if tag == "locality":
                log(out["table"])
            if kill:
                log(out["table"])
                post = [r for r in out["reports"] if r.step != "download"]
                if not post or any(r.site == kill for r in post):
                    raise AssertionError(f"fabric: steps on the dead site "
                                         f"{[(r.step, r.site) for r in post]}")
                if not stats["migrated"]:
                    raise AssertionError("fabric: the kill left no migration")
                if not fabric.metrics.series(
                        "workflow/connect/download/skipped").points:
                    raise AssertionError("fabric: download ran again")
            log(f"[fabric] {tag}: sites {stats['sites']}, moved "
                f"{stats['bytes_moved']} B over the links "
                f"({stats['transfer_s']} simulated s), migrated "
                f"{stats['migrated']}; {stats['wall_s']:.2f} s; loss "
                f"{res['train']['first_loss']:.4f} -> "
                f"{res['train']['last_loss']:.4f}; objects "
                f"{res['analyze']['objects']}; "
                f"{stats['bytes_written'] / 1e6:.1f} MB written")
            if res["train"] != want["train"] or \
                    res["analyze"] != want["analyze"]:
                raise AssertionError(
                    f"fabric {tag}: {res['train']}, {res['analyze']} differ "
                    f"from the cluster run's {want['train']}, "
                    f"{want['analyze']}")
            runs[tag] = stats
    loc, bld = runs["locality"], runs["blind"]
    if not loc["bytes_moved"] < bld["bytes_moved"] or \
            not loc["transfer_s"] <= bld["transfer_s"]:
        raise AssertionError(f"fabric: locality moved {loc['bytes_moved']} "
                             f"B, blind {bld['bytes_moved']} B")
    return runs


def phase_fabric(smi: str, connect_results):
    """Phase 14: the federation on the card.  a. the CONNECT run of phase
    13 across three sites (locality, data-blind, the hub killed after
    download), each equal to phase 13's run; b. a full-width phi4
    ServeJob through ``Session(fabric=, planner=)``: 4 requests of 512
    tokens at their stop lengths, the site named, flash 32 a prefill;
    c. a phi4 smoke TrainJob there whose site is killed once step
    FABRIC_KILL_AT is logged: one migration, finished on the survivor,
    a finite loss a step, exact xent/AdamW launches."""
    import dataclasses
    import tempfile

    from repro_torch.api import Session
    from repro_torch.apps.connect import pipeline
    from repro_torch.configs import registry
    from repro_torch.core.orchestrator import PodState
    from repro_torch.examples import federated_connect as fc
    from repro_torch.fabric import FederatedStore, PlacementPlanner
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import xent
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm

    gc.collect()
    torch.cuda.empty_cache()
    cc = pipeline.connect_config(**json.loads(json.dumps(CONNECT_PARAMS)))
    runs = _fabric_connect(cc, connect_results)

    def zero():
        fa.launches = xent.fwd_launches = xent.bwd_launches = au.launches = 0

    def counts():
        return {"flash_attention": fa.launches, "xent_fwd": xent.fwd_launches,
                "xent_bwd": xent.bwd_launches, "adamw_update": au.launches}

    with tempfile.TemporaryDirectory(prefix="chip-smoke-fabric-") as root:
        fabric = fc.build_fabric(0.0, "cuda", root)
        planner = PlacementPlanner(FederatedStore(fabric))
        session = Session(fabric=fabric, planner=planner)

        # b. ServeJob: full-width phi4, 4 requests of 512 random tokens
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        h = session.apply({
            "kind": "ServeJob",
            "metadata": {"name": "chip-smoke-fabric-serve"},
            "spec": {"arch": ARCH, "smoke": False, "n_requests": 4,
                     "prompt_len": PROMPT, "max_new_tokens": GEN,
                     "gen_lens": list(GEN_LENS), "slots": SLOTS,
                     "paged": True, "block_size": BLOCK,
                     "prefix_cache": False, "seed": 0}})
        out = h.wait(900)
        torch.cuda.synchronize()
        ran = counts()
        got = [len(out["results"].get(i, [])) for i in range(4)]
        rep = out["report"]
        serve = {"workload": h.spec.name, "state": h.state.value,
                 "site": out["site"], "stop_lengths": got,
                 "wall_s": time.perf_counter() - t0,
                 "tok_s": rep.extra["tokens/s"],
                 "p50_ttft_s": rep.extra["p50 ttft (s)"],
                 "launches": ran,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "card": smi}
        session.forget(h)
        del out, h
        log(f"[fabric] serve {ARCH} at {serve['site']}: {serve['state']}, "
            f"stop lengths {got}, {serve['tok_s']:.1f} tok/s, flash "
            f"{ran['flash_attention']}, peak {serve['peak_gb']:.2f} GB")
        if serve["state"] != "Succeeded" or got != list(GEN_LENS) or \
                serve["site"] not in fabric.sites:
            raise AssertionError(f"fabric serve: {serve}")
        if ran["flash_attention"] != 32 * 4:
            raise AssertionError(f"fabric serve: flash {ran}, want 32 a "
                                 f"prefill of 4")

        # c. TrainJob: phi4 smoke; its site dies once step KILL_AT is logged
        n_leaves = len(pr.leaves(tfm.lm_schema(registry.get_smoke(ARCH))))
        xent_per_step = max(FABRIC_SEQ // 512, 1)     # one loss chunk
        gc.collect()
        torch.cuda.empty_cache()
        killed, errors = {}, []

        def kill_at_step(name, value, ts):
            if name != "elastic/step" or value < FABRIC_KILL_AT or killed:
                return
            try:
                site = next(s for s in fabric.up_sites() if any(
                    p.state == PodState.RUNNING
                    for j in s.cluster.jobs for p in j.pods))
                killed["site"], killed["step"] = site.name, int(value)
                fabric.fail_site(site.name)
            except Exception as e:         # the registry swallows it
                errors.append(e)

        fabric.metrics.add_listener(kill_at_step)
        zero()
        t0 = time.perf_counter()
        h = session.apply({
            "kind": "TrainJob",
            "metadata": {"name": "chip-smoke-fabric-train"},
            "spec": {"arch": ARCH, "smoke": True, "steps": FABRIC_STEPS,
                     "seq_len": FABRIC_SEQ, "global_batch": FABRIC_BATCH,
                     "ckpt_every": 2, "log_every": 1,
                     "rejoin_timeout_s": 0.5, "verbose": False}})
        out = h.wait(900)
        torch.cuda.synchronize()
        ran = counts()
        rep = out["report"]
        losses = out["losses"]
        executed = rep.steps_executed
        train = {"workload": h.spec.name, "state": h.state.value,
                 "killed": killed, "sites": out["sites"],
                 "migrations": [dataclasses.asdict(m)
                                for m in out["migrations"]],
                 "segments": [[s.start, s.end, s.outcome]
                              for s in rep.segments],
                 "steps_executed": executed, "steps_lost": rep.steps_lost,
                 "wall_s": time.perf_counter() - t0,
                 "launches": ran, "losses": losses,
                 "bytes_moved": fabric.metrics.series(
                     "fabric/bytes_moved").total,
                 "bytes_written": _tree_bytes(root), "card": smi}
        session.forget(h)
        del out, h
        log(f"[fabric] train {ARCH} smoke: {train['state']}; killed "
            f"{killed}; sites {train['sites']}; migrations "
            f"{train['migrations']}; segments {train['segments']}; "
            f"executed {executed}, lost {rep.steps_lost}; launches {ran}; "
            f"{train['bytes_moved']:.0f} B over the links; "
            f"{train['bytes_written'] / 1e6:.1f} MB written")
        if errors:
            raise AssertionError(f"fabric train: the kill failed: {errors}")
        if train["state"] != "Succeeded" or not killed or \
                len(train["migrations"]) != 1 or \
                train["sites"] != [killed["site"],
                                   train["migrations"][0]["to_site"]]:
            raise AssertionError(f"fabric train: {train}")
        if rep.segments[-1].end != FABRIC_STEPS - 1 or \
                len(losses) != FABRIC_STEPS or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"fabric train: losses {losses}")
        want = {"flash_attention": 0, "xent_fwd": executed * xent_per_step,
                "xent_bwd": executed * xent_per_step,
                "adamw_update": executed * n_leaves}
        if ran != want:
            raise AssertionError(f"fabric train: launches {ran} != {want}")
    return {"connect": runs, "serve": serve, "train": train}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    smi = phase_device()
    phase_build()
    main_shape = (1, 24, 8, PROMPT, PROMPT, 128)    # phi4 prefill, B=1
    flash = phase_kernels(main_shape)
    xent_fwd, xent_bwd = phase_xent(TRAIN_BATCH * 512, 200_064)
    adamw = phase_adamw((200_064, 3072))
    ssd = phase_ssd()
    wkv = phase_wkv()
    gmm = phase_gmm()
    torch.cuda.empty_cache()
    phase_small()
    phase_small_ssm()
    phase_small_moe()
    phase_small_train()
    serve, ran_phi4, phi4_run = phase_serve(smi)
    serve_granite, ran_granite, _ = phase_serve(smi, GRANITE)
    serve_zamba, ran_zamba = phase_serve_ssm(smi, ZAMBA)
    serve_rwkv, ran_rwkv = phase_serve_ssm(smi, RWKV)
    flash["launches"] = ran_phi4["flash_attention"]
    ssd["launches"] = ran_zamba["ssd_scan"]
    wkv["launches"] = ran_rwkv["wkv6"]
    gmm["launches"] = ran_granite["moe_gmm"]
    flash["launches_by_path"] = {
        f"{ARCH} serve": ran_phi4["flash_attention"],
        f"{GRANITE} serve": ran_granite["flash_attention"],
        f"{ZAMBA} serve": ran_zamba["flash_attention"]}
    train, launches = phase_train(smi)
    elastic, elastic_launches = phase_elastic(smi)
    log(f"[disk] written so far {elastic['disk_written_gb']:.2f} GB")
    router, ran_router = phase_serve_router(smi, phi4_run)
    rl, rl_launches = phase_rl(smi)
    log(f"[disk] written so far "
        f"{elastic['disk_written_gb'] + rl['disk_written_gb']:.2f} GB")
    session, session_launches = phase_session(smi, elastic["clean_spread"])
    written = elastic["disk_written_gb"] + rl["disk_written_gb"] + \
        session["cancel"]["disk_written_gb"]
    log(f"[disk] written so far {written:.2f} GB")
    connect, connect_results = phase_connect(smi)
    written += connect["bytes_written"] / 1e9
    log(f"[disk] written so far {written:.2f} GB")
    fabric = phase_fabric(smi, connect_results)
    written += (sum(r["bytes_written"] for r in fabric["connect"].values())
                + fabric["train"]["bytes_written"]) / 1e9
    log(f"[disk] written so far {written:.2f} GB")
    flash["launches_by_path"].update({
        f"{ARCH} serve router": ran_router["router"],
        f"{ARCH} serve static": ran_router["static"],
        f"{ARCH} rl actors": rl_launches["flash_attention"],
        f"{ARCH} session serve": session_launches["serve"]["flash_attention"],
        f"{ARCH} session graph": session_launches["graph"]["flash_attention"],
        f"{CODEQWEN} session serve":
            session_launches["codeqwen"]["flash_attention"],
        f"{ARCH} fabric serve":
            fabric["serve"]["launches"]["flash_attention"]})
    for row in (xent_fwd, xent_bwd, adamw):
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {
            f"{ARCH} train": launches[row["name"]],
            f"{ARCH} elastic": elastic_launches[row["name"]],
            f"{ARCH} rl learner": rl_launches[row["name"]],
            f"{ARCH} session train": session_launches["train"][row["name"]],
            f"{ARCH} session train cancelled":
                session_launches["cancel"][row["name"]],
            f"{ARCH} smoke fabric train (site killed)":
                fabric["train"]["launches"][row["name"]]}
    kernels = [flash, xent_fwd, xent_bwd, adamw, ssd, wkv, gmm]
    for row in kernels:
        row["card"] = smi
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": {ARCH: serve, GRANITE: serve_granite,
                                ZAMBA: serve_zamba, RWKV: serve_rwkv}}))
    print(json.dumps({"train": train}))
    print(json.dumps({"elastic": elastic}))
    print(json.dumps(router))
    print(json.dumps({"rl": rl}))
    for row in session.values():
        print(json.dumps({"session": row}))
    print(json.dumps({"connect": connect}))
    print(json.dumps({"fabric": fabric}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
