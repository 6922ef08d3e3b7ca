"""Proof that the PyTorch/CUDA port builds and serves on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device  — a CUDA card is required; prints its name and power limit;
  2. build   — compiles every kernel of the port from ``src/repro_torch/csrc``
               with nvcc, all sources at once, and prints the build time;
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main path's shape and at edge shapes, with stated
               tolerances; times the kernel, the plain version and the one
               PyTorch call that computes the same function (a yardstick
               only: the port never calls it); computes the card's bound;
  4. small   — phi4 smoke config in f32: the card's prefill logits (through
               the kernel) against the CPU's (through the plain version);
  5. serve   — full-width phi4-mini-3.8b in bf16 (random weights from a
               seed) serves 8 requests through the paged pool with the prefix
               cache: every request completes, the prefix cache hits, and the
               flash kernel ran on every layer of every full prefill; then a
               short run shows paged tokens equal slotted tokens.
Then it prints a ``{"kernels": [...]}`` line, a ``{"serve": {...}}`` line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}           # H100 SXM dense, per second
PEAK_BYTES = 3.35e12                           # H100 SXM HBM3, per second
ARCH = "phi4-mini-3.8b"
PROMPT, GEN, SLOTS, BLOCK = 512, 64, 4, 16
SYSTEM_PREFIX = 448                            # shared by half the requests
GEN_LENS = (16, 64, 8, 32)                     # cycled stop lengths


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


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out = build.build_all()
    log(f"[build] {sorted(out)} in {time.perf_counter() - t0:.2f} s")
    for name, text in out.items():
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in text.splitlines() if "Used " in line})
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes "
                  "spill loads" not in line]
        log(f"[build:{name}] ptxas: {', '.join(regs)} per instantiation; "
            f"spills: {spills or 'none'}")


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_bound(B, H, KV, Sq, Sk, dh, causal, dtype):
    """(bound_ms, bound_by): q, k, v read once and o written once, against
    the score and PV products this mask needs (visible pairs only)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (2 * B * H * Sq * dh + 2 * B * KV * Sk * dh)
    if causal:
        pairs = sum(max(0, min(Sk, i + Sk - Sq + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4.0 * B * H * pairs * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(main_shape):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (B, H, KV, Sq, Sk, dh, causal, dtype, tolerance)
        main_shape + (True, torch.bfloat16, 2e-2),
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
    shape, err, q, k, v, causal = rows[0]
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    plain_ms = _time_ms(lambda: fa.attention_plain(q, k, v, causal=causal))
    g = q.shape[1] // k.shape[1]
    library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=g > 1))
    bound_ms, bound_by = _attention_bound(*main_shape, causal, q.dtype)
    log(f"[kernels] main shape {shape}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:25",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": shape,
            "edge_shapes_max_abs_err": max(r[1] for r in rows[1:])}


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


def phase_serve(smi: str):
    from repro_torch.configs import registry
    from repro_torch.core.queue import WorkQueue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.report import GAUGES

    cfg = registry.get_config(ARCH)
    t0 = time.perf_counter()
    params = pr.init_params(tfm.lm_schema(cfg),
                            torch.Generator(device="cuda").manual_seed(0),
                            cfg.param_dtype, "cuda")
    torch.cuda.synchronize()
    n_params = pr.param_count(tfm.lm_schema(cfg))
    log(f"[serve] {ARCH}: {n_params / 1e9:.3f} B params in bf16 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(cfg, device="cuda", num_slots=SLOTS,
                           prompt_len=PROMPT, max_new_tokens=GEN,
                           params=params, paged=True, block_size=BLOCK,
                           prefix_cache=True)
    engine.warmup()
    torch.cuda.synchronize()
    reqs = _requests(cfg.vocab_size)
    queue = WorkQueue(reqs)
    torch.cuda.reset_peak_memory_stats()
    prefills_before = engine.metrics.series(GAUGES.PREFILL_S).stats()["count"]
    fa.launches = 0
    results, metrics = engine.run(queue)
    torch.cuda.synchronize()
    launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sm = metrics.summary()
    full_prefills = sm[GAUGES.PREFILL_S]["count"] - prefills_before
    want_tokens = sum(r["max_new_tokens"] for r in reqs)
    hits = sm.get(GAUGES.PREFIX_HITS, {}).get("total", 0)
    log(f"[serve] completed {len(results)}/{len(reqs)}, tokens "
        f"{sm[GAUGES.TOKENS]['total']:.0f}/{want_tokens}, full prefills "
        f"{full_prefills}, prefix-hit blocks {hits:.0f}, flash launches "
        f"{launches}")
    if sorted(results) != list(range(len(reqs))):
        raise AssertionError(f"requests not all completed: {sorted(results)}")
    if any(len(results[r["id"]]) != r["max_new_tokens"] for r in reqs):
        raise AssertionError("a request's token count is not its stop length")
    if sm[GAUGES.TOKENS]["total"] != want_tokens:
        raise AssertionError("token count is not the sum of stop lengths")
    if not hits > 0:
        raise AssertionError("the prefix cache never hit")
    if launches != cfg.num_layers * full_prefills or full_prefills < 1:
        raise AssertionError(f"flash kernel launches {launches} != "
                             f"{cfg.num_layers} x {full_prefills} prefills")
    serve = {"arch": ARCH, "requests": len(results),
             "tokens": int(sm[GAUGES.TOKENS]["total"]),
             "tok_s": sm[GAUGES.TOK_S]["last"],
             "decode_tok_s": sm[GAUGES.DECODE_TOK_S]["last"],
             "p50_ttft_s": sm[GAUGES.TTFT_S]["p50"],
             "prefill_s_p50": sm[GAUGES.PREFILL_S]["p50"],
             "wall_s": sm[GAUGES.WALL_S]["last"],
             "decode_steps": int(sm[GAUGES.DECODE_STEPS]["total"]),
             "full_prefills": full_prefills, "prefix_hit_blocks": hits,
             "peak_mem_gb": peak_gb, "card": smi}
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
    # through decode steps, so their tokens may differ in bf16: reported only
    agree = sum(results[r["id"]][:len(outs[False][r["id"]])]
                == outs[False][r["id"]] for r in reqs)
    log(f"[serve] paged vs slotted greedy tokens on {len(short)} requests: "
        f"{'identical' if same else 'DIFFER'}; the main run agrees with "
        f"slotted on {agree}/{len(reqs)}")
    if not same:
        raise AssertionError("paged greedy tokens differ from slotted")
    return serve, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    smi = phase_device()
    phase_build()
    main_shape = (1, 24, 8, PROMPT, PROMPT, 128)    # phi4 prefill, B=1
    kernel = phase_kernels(main_shape)
    phase_small()
    serve, launches = phase_serve(smi)
    kernel["launches"] = launches
    kernel["card"] = smi
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"serve": serve}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
