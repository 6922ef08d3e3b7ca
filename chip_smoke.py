"""Proof that the PyTorch/CUDA port builds, serves and trains on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device  — a CUDA card is required; prints its name and power limit;
               cuBLAS's per-thread workspaces are allocated first, so each
               takes a segment of its own (see phase_blas_workspaces);
  2. build   — compiles every kernel of the port from ``src/repro_torch/csrc``
               (six sources) with nvcc, all at once, and prints the build
               time, each source's nvcc seconds and each kernel's
               registers and spills;
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main path's shape and at edge shapes, with stated
               tolerances; times the kernel, the plain version and the one
               PyTorch call that computes the same function where there is
               one (a yardstick only: the port never calls it); computes the
               card's bound.  Times are device times: CUDA events around
               launches enqueued while a sleep kernel holds the stream, so
               the host's launch cost is not counted; the median of three.
               Flash attention at phi4's prefill, zamba2's (dh 80),
               granite-moe's (dh 64), the static batcher's (B=4),
               codeqwen1.5-7b's (H = KV = 32), gemma2-9b's
               (dh 256, softcap 50) local layer at 512 tokens (window
               4096) and local and global at 5120, whisper's encoder (576
               frames) and cross attention (384 against 576), the VLM's
               cross attention (512 against 1600 patches), non-causal;
               SDPA times only the rows without a softcap (it has none),
               with the window as a mask; edge shapes include a window of
               128 at Sq 96 against Sk 520 (bf16, f16), f32 at dh 256 and
               Sq > Sk under a window, then each mask mode the Hopper
               kernel compiles (causal; full; window and softcap) at every
               head dim in bf16 and f16, on transposes of (B, S, H, dh)
               views cut from longer buffers, Sq and Sk not multiples of
               64; phi4's shape through the general instantiation (a
               window of 4096, the same function) timed beside the causal
               one (B11); xent forward and backward
               at the train phase's loss chunk, and the backward with the RL learner's dy (zero on prompt rows
               and on a zero-advantage rollout, negative where the
               advantage is); AdamW at phi4's embedding; the SSD scan at
               zamba2's prefill (and with x, B and C as views into
               NaN-filled buffers) and WKV6 at rwkv6's, each case printing
               the path it took (bf16 widths that are multiples of 16: the
               tensor-core kernels; f32, f16, other widths: the CUDA-core
               ones), timed warm and cold (rotating through copies of the
               inputs past the L2), SSD also at zamba2's train forward,
               the bound's operations at the inputs' type's rate; the
               grouped matmul at
               granite-moe's prefill and decode buckets (f32, f16, bf16),
               ragged and strided shapes, each without occupied rows and
               with rows all 0, partial and random (x NaN past the rows,
               w NaN in the empty experts), timed with full buckets warm
               (20 launches on one copy) and cold (rotating through copies
               of x and w that together exceed the 50 MB L2 several times,
               as a decode step walks 72 distinct weight matrices),
               torch.bmm alike; then its autograd Function at granite's
               train buckets (E 32, cap_e 800, bf16): dx and dw against
               autograd of the plain version, with and without rows,
               three launches for forward and backward, each backward
               product timed cold and warm as the kernel reads it (no
               operand copied) beside its bound and torch.bmm;
               xent also at gemma2's softcapped loss chunk (1024 x 256,000,
               softcap 30);
  4. small   — phi4 smoke config in f32: the card's prefill logits (through
               the kernel) against the CPU's (through the plain version);
               then zamba2 smoke with two groups (12 layers) and rwkv6 smoke
               in f32: prefill logits and every cache leaf, last states
               included, card (kernels) against CPU (plain versions); then
               granite-moe smoke with two layers in f32: a prefill and 4
               decode steps, logits and the KV cache, card against CPU;
               then gemma2 smoke (its window cut to 8, under the 100-token
               prompt), whisper smoke and the VLM smoke (seeded image
               embeddings, its gates seeded nonzero) in f32 alike, flash
               once a layer of each prefill (whisper: 2 + 2 x 1);
  5. small-train — phi4 smoke in f32 with two layers: two train steps on the
               card (through the kernels) against the CPU (through the plain
               versions) on the same params and batches;
  6. serve   — full-width phi4-mini-3.8b and granite-moe-1b-a400m in bf16
               (random weights from a seed) each serve 8 requests through
               the paged pool with the prefix cache: every request
               completes, the prefix cache hits, flash ran on every layer of
               every full prefill and on no decode step, and (granite) the
               grouped matmul ran 3 times a layer in every full prefill and
               every decode step, the rows vectors its dispatch passed in
               one full prefill and one decode step recorded and the
               first layer's occupancy held and timed (x NaN past the
               rows, w NaN in the empty experts); then a short run shows
               paged tokens equal slotted tokens;
  7. serve-ssm — full-width zamba2-2.7b and rwkv6-1.6b in bf16 (random
               weights from a seed) each serve the same 8 requests through
               the slotted cache (their state caches do not page): a
               full-width prefill gives finite logits and states, every
               request completes with its stop length, and the SSD kernel
               ran on all 54 zamba2 layers (flash on its 9 shared-attention
               layers) and WKV6 on all 24 rwkv6 layers of every full prefill;
               then gemma2-9b (42 layers, 9.24 B) serves the mix paged with
               the prefix cache as phase 6 (flash 42 a prefill, paged
               tokens equal slotted) and one 5120-token request of 16 new
               tokens on a 1-slot engine (past the 4096 window; finite
               logits, flash 42); whisper-small (12 + 12 layers, prompt
               padded to 384, 576 zero frames) and llama-3.2-vision at full
               width cut to 5 layers (4 attn + 1 cross, 6.37 B) serve it
               slotted, flash 36 and 5 a prefill; the VLM's weights then
               get seeded nonzero gates and a forward with seeded image
               embeddings holds each of its flash calls (the cross one
               512 x 1600) against the plain version;
  8. train   — full-width phi4-mini-3.8b, random weights from seed 0 with
               the attention projections at their contracted fan-in: first
               the grads of the first batch in bf16 against f32 on the same
               weights, each leaf's norm within GRAD_RTOL; then in bf16 it
               takes 6 optimizer steps of 2 x 1024 tokens as two
               ``train_chunk`` calls of 3: every loss and grad norm finite,
               the last loss below the first, and exactly 2 xent forward,
               2 xent backward and 11 AdamW launches a step;
  8b. train-families — granite-moe-1b-a400m, zamba2-2.7b, rwkv6-1.6b and
               whisper-small at full depth, gemma2-9b at 14 of its 42
               layers and llama-3.2-vision at one attn and one cross layer
               of its 100, each freed before the next: first the family's
               smoke config in f32, one batch's loss and every grad leaf on
               the card within 1e-4 of the CPU's (the gmm Function's
               backward, the scans' train Functions), then in bf16 6
               optimizer steps as three ``train_chunk`` calls of 2 on 2 x
               1024 tokens (whisper: 2 x 448 with 1500 frames; extras
               random normal from the seed): finite losses and grad norms,
               the last loss below the first, and every kernel launched as
               the code implies (gmm 12 a granite layer a step, the scans
               2 a layer a step, xent once a 512-token loss chunk, AdamW
               once a leaf); tokens/s, ms a step and peak memory printed;
               nothing written to disk;
  8c. kimi   — kimi-k2-1t-a32b: flash at its dh 112 prefill (B=1, H=64,
               KV=8, 512 tokens) in bf16, f16 and f32, Sq 96 against Sk
               520 and B=4, against the plain version, timed warm and
               cold beside SDPA and the bound; ``quantize`` and
               ``dequantize`` card vs CPU bit for bit at its leaf shapes;
               serving at full width cut to 1 of 61 layers (18.2 B params,
               36.4 GB) with phase 6's mix (paged tokens equal slotted,
               flash once a prefill layer, gmm 3 a layer a step), each gmm
               bucket shape it ran (E 384, C 17 and 1) held against the
               plain version and timed with full buckets, then at the
               occupancy its dispatch gave (the rows vectors of one full
               prefill and one decode step recorded in the serve run; the
               bound over the occupied experts' weights; torch.bmm and
               torch._grouped_mm on the occupied rows as yardsticks); the smoke config's loss and grads
               card vs CPU and one int8 + factored update card vs CPU (q
               flips counted); then 2 layers of 64 experts (7.04 B params)
               under its own int8 + factored moments, 6 bf16 steps at lr
               3e-5: finite, falling losses, gmm 144 launches, no xent
               (the sharded loss) and no AdamW launch (the plain update);
               peak memory beside the dry run's count of the state
               (35.5 GB; 84.5 GB with f32 moments); nothing written to
               disk;
  8d. dryrun — the dry run (``repro_torch.launch.dryrun``, meta tensors,
               no kernel): the pass over all 32 cells of
               ``registry.cells()`` on the 16 x 16 mesh, the records kept
               in memory, one line with the cell count, failures (none
               allowed), the largest per_device_bytes and the
               counted/analytic FLOP ratios' range; the pass's argument
               bytes at one card against the growth of
               ``torch.cuda.memory_allocated()`` when the port allocates
               the same arguments, over by at most the allocator's
               rounding (512 bytes a leaf): phi4's train state (bf16
               params, f32 moments, one 2 x 1024 batch), kimi's train
               cut (2 layers x 64 experts, int8 + factored) and kimi's
               1-layer serving params and slotted cache (4 x 576); phase
               8's p50 ms a step beside the step FLOPs of
               ``roofline.flops.accounting`` at 2 x 1024 on one chip: the
               analytic TFLOP/s (those FLOPs over the measured step; the
               count scores full-context attention, the flash kernel
               skips the masked tiles) and the model-FLOPs share of 989
               TFLOP/s, with the card's name and power limit
               (information, not a limit); a ``{"dryrun": ...}`` line;
 9. elastic — phi4-mini-3.8b in bf16 at full width with depth cut to 2
               layers (an 8.15 GB checkpoint) trains 8 steps
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
 15. tenant  — a fabric of logical slots on the card (gpu 2, edge 1, hub
               1; time_scale 0) under a started ``FairShareScheduler``
               with a ``FederatedStore``, every workload a manifest through
               ``Session(tenant=)``: a full-width phi4 ServeJob of tenant
               chat (the serve phase's 8 requests: its tokens, flash 32 a
               prefill); a 1 to 2 replica phi4 ServeJob whose scale-up the
               claim caps at 1 while tenant ops holds a gpu slot; a phi4
               smoke TrainJob of tenant research preempted once by a
               priority-10 surge, resumed, its losses equal bit for bit to
               an unpreempted run's, exact xent/AdamW launches;
               ``lease_device_s`` billed per tenant within wall x slots;
               ``run_scenario`` over 3 windows (chat's waves full-width
               phi4, research's smoke TrainJob, an edge kill and a gpu-hub
               brown-out mid-wave, both restored), the grade table printed.
 16. ranks   — training across ranks (``repro_torch.launch.ranks``, one
               process a rank): granite-moe-1b-a400m at full width and 4
               of its 24 layers (bf16, f32 moments, 2 steps of 2 x 1024
               tokens) on mesh (1, 1) over NCCL, then as two ranks
               sharing the card over gloo (NCCL takes one card a rank) on
               (1, 2), its experts and their all_to_all on ``model``, and
               (2, 1), ZeRO-3 on ``data``, and on (1, 2) under its own
               ``ParallelConfig()`` (tensor and sequence parallelism);
               phi4-mini-3.8b at full width and 4 layers on (1, 2) under
               its own layout, pure FSDP, its bytes against the leaf
               shapes' count and its losses against one device's: every
               rank's losses and grad norms finite and equal (the global
               metrics), its per-step ms, collective bytes and peak
               memory printed, labeled "two ranks sharing one H100 over
               gloo" (no multi-card rate), and its gmm, xent and AdamW
               launches as ``_family_launches`` implies; then the
               two-rank runs at 2 layers and 2 x 128 tokens in f32 on the
               card against the same on the CPU (the plain versions,
               gloo): losses within 1e-4, grad norms within 1e-4
               relative, every param block within 2e-4.
 17. elastic ranks — ``ElasticTrainer`` on a cluster of 4 slots that are
               ranks sharing the card over gloo: granite-moe-1b-a400m at
               full width and 2 of its 24 layers (bf16, f32 moments,
               ``ParallelConfig()``), 6 steps of 2 x 1024 tokens, a
               checkpoint every 3 (about 1.57 GB): (2, 2) -> 2 slots fail
               -> (1, 2) at accum 2 -> they rejoin -> (2, 2); the
               outcomes node-failure, preempted, done; every rank's blocks
               after each restore, and before each save, equal bit for bit
               (sha256) the cut of the checkpoint's whole leaves for its
               mesh, so a restore onto (1, 2) holds the cut of what the
               (2, 2) saver held; losses finite and within
               ``ELASTIC_RANKS_RTOL`` of an uninterrupted one-device run's;
               xent, AdamW and gmm launches on every rank of every segment
               as ``_family_launches`` implies; per segment the mesh,
               accum, rank start-up, ``t_first_s``, save and restore
               seconds and bytes and each rank's peak memory; no rank
               process left.
The phases that write checkpoints (elastic, rl, session, elastic ranks)
print the bytes
they wrote and left on disk, and connect, fabric and tenant the bytes
their runs wrote.  Then it prints a ``{"kernels": [...]}`` line, a
``{"serve": {...}}`` line with one entry per arch, a ``{"train": {...}}``
line, a ``{"kimi": {...}}`` line, a ``{"dryrun": {...}}`` line, an
``{"elastic": {...}}`` line, a ``{"router": ..., "static":
...}`` line, an ``{"rl": {...}}`` line, one ``{"session": {...}}`` line a
workload (apply -> Running and wall seconds, tok/s beside the direct
engine's, ms a step, events, peak GB, the card), a ``{"connect": {...}}``,
a ``{"fabric": {...}}``, a ``{"tenant": {...}}``, a ``{"ranks": {...}}``
and an ``{"elastic_ranks": {...}}`` line (each with the card), the card's
name and power limit, and
as its last line ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}           # H100 SXM dense, per second
PEAK_BYTES = 3.35e12                           # H100 SXM HBM3, per second
ARCH = "phi4-mini-3.8b"
ZAMBA, RWKV = "zamba2-2.7b", "rwkv6-1.6b"
GRANITE = "granite-moe-1b-a400m"
GRANITE_TRAIN_BUCKET = (32, 800)   # E, cap_e: T 2048, top-8, cf 1.25
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
# elastic: full width, depth cut to 2 layers (an 8.15 GB checkpoint, 10.2
# GB at 4, 38.4 GB at 32: 4 GB of disk writes go to the ranks' elastic
# phase), 8 steps in chunks of 2, saves at steps 3 and 7, a crash before 7.
# The rl and session phases train phi4 at ELASTIC_LAYERS.
ELASTIC_PHASE_LAYERS = 2
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
# gemma2-9b (dh 256, window 4096 on its local layers, softcap
# 50), whisper-small (encoder over PROMPT + GEN frames, the decoder's
# prompt padded to decoder_len - GEN), llama-3.2-vision (1600 patches)
GEMMA2, WHISPER, VLM = "gemma2-9b", "whisper-small", "llama-3.2-vision-90b"
GEMMA2_WINDOW, GEMMA2_CAP = 4096, 50.0
GEMMA2_VOCAB, GEMMA2_FINAL_CAP = 256_000, 30.0    # its loss head's softcap
GEMMA2_ATTN = (1, 16, 8, PROMPT, PROMPT, 256)
GEMMA2_LONG_PROMPT, GEMMA2_LONG_GEN = 5120, 16    # past the window
GEMMA2_LONG = (1, 16, 8, GEMMA2_LONG_PROMPT, GEMMA2_LONG_PROMPT, 256)
WHISPER_FRAMES, WHISPER_PAD = PROMPT + GEN, 448 - GEN
WHISPER_ENC = (1, 12, 12, WHISPER_FRAMES, WHISPER_FRAMES, 64)
WHISPER_CROSS = (1, 12, 12, WHISPER_PAD, WHISPER_FRAMES, 64)
VLM_LAYERS = 5            # one pattern group: 6.37 B params; 100 is 87.4 B
VLM_CROSS = (1, 64, 8, PROMPT, 1600, 128)
GENERAL_ROW = 11          # phase_kernels' row of the general instantiation
SESSION_STEPS, SESSION_K, SESSION_CANCEL_STEPS, SESSION_CANCEL_AT = 4, 2, 40, 2
# the TrainJobs' learning rate: the TrainJob's default (1e-3, one warmup
# step) is a smoke model's; at full width its first Adam step raises the
# loss of a random-init model, and 4 steps do not bring it back
SESSION_LR = 3e-5
SESSION_BRANCHES = 2
# kimi-k2-1t-a32b: flash at its prefill (dh 112, 64 heads on 8 KV heads);
# served at full width cut to 1 of its 61 layers (18.2 B params, 36.4 GB in
# bf16; 2 layers, 70.4 GB, leave no room to work); trained at 2 layers and
# 64 of its 384 experts (7.04 B params) under its own int8 + factored
# moments, 6 steps as three train_chunk calls of 2 on 2 x 1024 tokens
KIMI = "kimi-k2-1t-a32b"
KIMI_ATTN = (1, 64, 8, PROMPT, PROMPT, 112)
KIMI_SERVE_LAYERS = 1
KIMI_TRAIN_LAYERS, KIMI_TRAIN_EXPERTS = 2, 64
# kimi's 64-expert cut trains at SESSION_LR: at phase_train's 3e-4 its
# loss jumps at step 2 under f32 moments through AdamW's kernel too, as
# under its own recipe (_kimi_lr_witness, at KIMI_WITNESS_EXPERTS experts
# where f32 moments fit the card: 13.47 -> 27.95 under the kernel, 28.47
# under the recipe, on an H100 80GB HBM3 at 700 W)
KIMI_LR = SESSION_LR
KIMI_WITNESS_EXPERTS = 16
KIMI_WITNESS_RTOL = 1e-3  # step-2 loss, the plain update vs the kernel's
KIMI_UPDATE_RTOL = 1e-6   # s, vr, vc card vs CPU: sums in another order
KIMI_FLIP_SHARE = 1e-4    # int8 q card vs CPU: +-1 flips, under 1 in 10^4


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


def phase_blas_workspaces() -> None:
    """cuBLAS keeps a workspace (32 MiB on an H100) for each thread that
    calls it: the host thread's and autograd's backward thread's.  Both
    are allocated here, while the caching allocator holds nothing, so each
    takes a segment of its own.  Allocated later, one can land inside a
    large cached segment and keep it from being released; the dry-run
    phase's check of allocated growth against the pass's argument bytes
    then sees that segment's free space reused whole by a leaf."""
    a = torch.ones(2, 16, 16, device="cuda", requires_grad=True)
    torch.bmm(a, a).sum().backward()
    torch.cuda.synchronize()


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
    for name, (text, seconds) in out.items():
        log(f"[build] {name}: nvcc {seconds:.2f} s")
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


def _attention_bound(B, H, KV, Sq, Sk, dh, causal, dtype, window=None):
    """(bound_ms, bound_by): q, k, v read once and o written once, against
    the score and PV products this mask needs (visible pairs only: below
    the bottom-right diagonal and, under a window, inside it)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (2 * B * H * Sq * dh + 2 * B * KV * Sk * dh)
    if causal:
        d = Sk - Sq
        w = window or Sk + Sq
        pairs = sum(max(0, min(Sk, i + d + 1) - max(0, i + d - w + 1))
                    for i in range(Sq))
    else:
        pairs = Sq * Sk
    return _bound(nbytes, 4.0 * B * H * pairs * dh, dtype)


def _sdpa(q, k, v, causal, window):
    """The one PyTorch call computing the same function (no softcap):
    SDPA, with the bottom-right window as a boolean mask where there is
    one."""
    g = q.shape[1] // k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=g > 1)
    Sq, Sk = q.shape[2], k.shape[2]
    i = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    j = torch.arange(Sk, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=g > 1)


def _flash_errs(got, want):
    """(max abs error, max over query rows of the row's abs error over the
    row's scale: its largest |want|, at least 1/16)."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1).clamp_min(1 / 16)
    return d.max().item(), (d.amax(-1) / scale).max().item()


def _cut_view(B, S, n, dh, gen, dtype, scale=1.0):
    """A (B, n, S, dh) transpose of a (B, S, n, dh) view cut from a
    (B, S + 5, n, dh) buffer of N(0, scale^2) values: the models' layout,
    with a batch stride that is not n * S * dh."""
    buf = scale * torch.randn(B, S + 5, n, dh, generator=gen, device="cuda")
    return buf.to(dtype)[:, :S].transpose(1, 2)


def _flash_mutants_fail(fa, q, k, v, kw, want, tol, shape):
    """Show that the row can fail a wrong kernel: the plain version without
    the softcap, and with the window 32 keys longer, must each miss
    ``want`` by more than the tolerance.  Only where the feature bites: a
    window longer than every row's keys masks nothing, so its mutant
    equals ``want``."""
    mutants = {}
    if kw["softcap"] is not None:
        mutants["no softcap"] = dict(kw, softcap=None)
    if kw["window"] is not None and kw["window"] < k.shape[2]:
        mutants["window + 32"] = dict(kw, window=kw["window"] + 32)
    for name, mkw in mutants.items():
        _, miss = _flash_errs(fa.attention_plain(q, k, v, **mkw), want)
        log(f"[kernels] flash_attention {shape}: a kernel with {name} "
            f"would be off by {miss:.3g} row-scaled (tolerance {tol})")
        if not miss > tol:
            raise AssertionError(f"the check at {shape} cannot tell a "
                                 f"kernel with {name}: {miss} <= {tol}")
        torch.cuda.empty_cache()


def phase_kernels(main_shape):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [  # (B, H, KV, Sq, Sk, dh, causal, dtype, tolerance, window, cap)
        main_shape + (True, bf, 2e-2, None, None),
        ZAMBA_ATTN + (True, bf, 2e-2, None, None),               # dh 80
        GRANITE_ATTN + (True, bf, 2e-2, None, None),             # dh 64
        STATIC_ATTN + (True, bf, 2e-2, None, None),              # B=4
        CODEQWEN_ATTN + (True, bf, 2e-2, None, None),            # KV = H
        # gemma2 (dh 256, window 4096, softcap 50),
        # whisper's encoder and cross attention, the VLM's cross attention
        GEMMA2_ATTN + (True, bf, 2e-2, GEMMA2_WINDOW, GEMMA2_CAP),
        GEMMA2_LONG + (True, bf, 2e-2, GEMMA2_WINDOW, GEMMA2_CAP),
        GEMMA2_LONG + (True, bf, 2e-2, None, GEMMA2_CAP),
        WHISPER_ENC + (False, bf, 2e-2, None, None),
        WHISPER_CROSS + (False, bf, 2e-2, None, None),
        VLM_CROSS + (False, bf, 2e-2, None, None),
        # edge shapes
        (2, 4, 2, 130, 130, 80, True, f32, 2e-5, None, None),
        (1, 24, 8, 300, 300, 128, True, bf, 2e-2, None, None),   # ragged
        (2, 24, 8, 300, 300, 128, False, bf, 2e-2, None, None),
        (1, 8, 2, 200, 200, 64, True, f32, 2e-5, None, None),
        (1, 8, 8, 96, 520, 128, True, f16, 2e-2, None, None),    # Sq<Sk
        (2, 4, 4, 130, 130, 32, False, f32, 2e-5, None, None),
        (1, 8, 4, 96, 520, 256, True, bf, 2e-2, 128, None),      # a small
        (1, 8, 4, 96, 520, 256, True, f16, 2e-2, 128, 50.0),     # window
        (1, 4, 2, 700, 700, 256, True, f32, 2e-5, 128, 50.0),    # f32 dh 256
        (1, 4, 2, 130, 60, 256, True, bf, 2e-2, 16, 50.0),       # Sq > Sk
    ]
    # B11: the general instantiation (a window at runtime) at phi4's shape,
    # with a window past every row's keys, so the same function as the
    # plain causal one at row 0; timed beside it
    cases.insert(GENERAL_ROW, main_shape + (True, bf, 2e-2, 4096, None))
    # every mask mode x head dim x 16-bit type the kernel compiles, on
    # transposes of (B, S, heads, dh) buffers cut from longer ones (a batch
    # stride that is not heads * S * dh), Sq and Sk not multiples of 64
    cases += [(B, H, KV, Sq, Sk, dh, causal, dtype, 2e-2, window, cap,
               "cut")
              for dh in fa.HEAD_DIMS for dtype in (bf, f16)
              for (B, H, KV, Sq, Sk, causal, window, cap) in (
                  (1, 8, 2, 200, 200, True, None, None),        # causal
                  (2, 4, 2, 130, 330, False, None, None),       # full
                  (1, 8, 4, 150, 270, True, 96, 30.0))]         # general
    rows = []
    for (B, H, KV, Sq, Sk, dh, causal, dtype, tol, window, cap,
         *layout) in cases:
        # with a softcap c, q is scaled by c so that the scores spread over
        # +-c and the cap bends them (unit q and k give scores of N(0, 1),
        # which a cap of 50 moves by less than 1e-2)
        qs = cap if cap is not None and dtype != f32 else 1.0
        if layout:
            q, k, v = (_cut_view(B, S, n, dh, gen, dtype, scale)
                       for n, S, scale in ((H, Sq, qs), (KV, Sk, 1.0),
                                           (KV, Sk, 1.0)))
        else:
            q = (qs * torch.randn(B, H, Sq, dh, generator=gen,
                                  device="cuda")).to(dtype)
            k = torch.randn(B, KV, Sk, dh, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(B, KV, Sk, dh, generator=gen,
                            device="cuda").to(dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, **kw)
        err, row_err = _flash_errs(got, want)
        shape = f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} dh={dh} " \
                f"{str(dtype)[6:]} {'causal' if causal else 'full'}" + \
                (f" window={window}" if window else "") + \
                (f" softcap={cap} q*{qs:g}" if cap else "") + \
                (" (B,S,H,dh) cut views" if layout else "")
        # f32: absolute; f16/bf16: each query row's error over that row's
        # scale (its largest |output|, at least 1/16).  Kernel and plain
        # version each round P and the output once, about 2^-8 of the
        # row's scale apiece, so small outputs (a long softmax's average)
        # are held to their own scale, and large ones (q scaled by the cap
        # picks single keys: |o| up to 5, where one rounding is 2^-5) are
        # not failed for one rounding
        held = err if dtype == f32 else row_err
        rule = "absolute" if dtype == f32 else "of each row's scale"
        log(f"[kernels] flash_attention {shape}: max_abs_err={err:.3g}, "
            f"row-scaled {row_err:.3g} (tolerance {tol} {rule})")
        if not held <= tol:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {shape}: {held} > {tol}")
        if dtype != f32:
            _flash_mutants_fail(fa, q, k, v, kw, want, tol, shape)
        rows.append((shape, err, q, k, v, kw))
        del got, want
    timed = {}
    for i in range(GENERAL_ROW + 1):  # the main paths' shapes, then B11's
        shape, err, q, k, v, kw = rows[i]
        ms = _time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.attention_plain(q, k, v, **kw))
        library_ms = None
        if kw["softcap"] is None:     # SDPA has no softcap
            library_ms = _time_ms(_sdpa(q, k, v, kw["causal"], kw["window"]))
        host_us = _host_us(lambda: fa.flash_attention(q, k, v, **kw))
        bound_ms, bound_by = _attention_bound(
            *cases[i][:6], kw["causal"], q.dtype, kw["window"])
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[kernels] flash timed at {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib}, bound {bound_ms:.5f} ms "
            f"({bound_by}); the wrapper's host time {host_us:.1f} us a call")
        timed[i] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, "shape": shape,
                    "host_us": host_us}
        torch.cuda.empty_cache()
    general = timed[GENERAL_ROW]
    log(f"[kernels] B11: flash at phi4's shape through the general "
        f"instantiation (a runtime window of 4096) {general['ms']:.4f} ms, "
        f"the causal one {timed[0]['ms']:.4f} ms: "
        f"{general['ms'] / timed[0]['ms'] - 1:+.1%}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:25",
            "launches": None, **timed[0],
            "edge_shapes_max_abs_err": max(r[1] for r in
                                           rows[GENERAL_ROW + 1:]),
            "phi4_general": general,
            "zamba2_dh80": timed[1], "granite_dh64": timed[2],
            "static_b4": timed[3], "codeqwen_kv32": timed[4],
            "gemma2_local_512": timed[5], "gemma2_local_5120": timed[6],
            "gemma2_global_5120": timed[7], "whisper_encoder": timed[8],
            "whisper_cross": timed[9], "vlm_cross": timed[10]}


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


def _xent_hold(cases: dict) -> dict:
    """Hold xent at each named case -> {name: (nll err, dlogits err)}."""
    errs = {}
    for name, case in cases.items():
        e_nll, e_d, t_nll, t_d = _xent_errs(*case)
        log(f"[kernels] xent {name}: nll max_abs_err={e_nll:.3g} (tolerance "
            f"{t_nll:.3g}), dlogits max_abs_err={e_d:.3g} (tolerance "
            f"{t_d:.3g})")
        if not (e_nll <= t_nll and e_d <= t_d):
            raise AssertionError(f"xent disagrees with its plain version at "
                                 f"{name}")
        errs[name] = (e_nll, e_d)
    return errs


def phase_xent(R: int, V: int):
    """xent forward and backward against their plain versions at the train
    phase's loss chunk (R rows, V vocab, f32), at gemma2's softcapped
    loss chunk (R rows of its 256,000 vocab, softcap 30), at the loss
    chunks of the other families whose train loss runs the kernel
    (granite-moe's R x 49,155; whisper-small's two 448-token decoder rows,
    896 x 51,865) and at edge shapes."""
    from repro_torch.configs import registry
    from repro_torch.kernels import xent
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the chunked loss's rule: 512 positions a chunk, or the whole
    # sequence where 512 does not divide it
    granite_v = registry.get_config(GRANITE).vocab_size
    whisper = registry.get_config(WHISPER)
    train_chunks = {
        f"granite-moe train chunk R={R} V={granite_v}": _xent_case(
            R, granite_v, gen=gen),
        f"whisper-small train chunk R={TRAIN_BATCH * whisper.decoder_len} "
        f"V={whisper.vocab_size}": _xent_case(
            TRAIN_BATCH * whisper.decoder_len, whisper.vocab_size, gen=gen),
    }
    train_errs = _xent_hold(train_chunks)
    del train_chunks
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
    edge_errs = _xent_hold(edge)
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

    at = _xent_timed(R, V, None, gen)
    cap = _xent_timed(R, GEMMA2_VOCAB, GEMMA2_FINAL_CAP, gen)
    common = {"route": "cuda", "source": "src/repro_torch/csrc/xent.cu",
              "launches": None, "shape": at["shape"]}
    fwd = dict(common, name="xent_fwd",
               replaces="src/repro/kernels/xent.py:37", **at["fwd"],
               library="F.cross_entropy(reduction='none')",
               edge_shapes_max_abs_err=max(e[0] for e in edge_errs.values()),
               gemma2_softcap=dict(cap["fwd"], shape=cap["shape"]),
               train_chunks_max_abs_err={k: e[0]
                                         for k, e in train_errs.items()})
    bwd = dict(common, name="xent_bwd",
               replaces="src/repro/kernels/xent.py:69", **at["bwd"],
               library="F.cross_entropy forward+backward",
               edge_shapes_max_abs_err=max(e[1] for e in edge_errs.values()),
               rl_dy_max_abs_err=edge_errs[rl_case][1],
               gemma2_softcap=dict(cap["bwd"], shape=cap["shape"]),
               train_chunks_max_abs_err={k: e[1]
                                         for k, e in train_errs.items()})
    return fwd, bwd


def _xent_timed(R: int, V: int, softcap, gen) -> dict:
    """xent forward and backward at one f32 shape: held against their
    plain versions, then timed with the plain versions, the bound and
    (without a softcap, which no one PyTorch call applies)
    F.cross_entropy.  -> {"shape", "fwd": row, "bwd": row}."""
    import torch.nn.functional as F
    from repro_torch.kernels import xent
    logits, labels, dy, _ = _xent_case(R, V, softcap=softcap, gen=gen)
    e_nll, e_d, t_nll, t_d = _xent_errs(logits, labels, dy, softcap)
    shape = f"R={R} V={V} f32" + (f" softcap {softcap}" if softcap else "")
    log(f"[kernels] xent {shape}: nll max_abs_err={e_nll:.3g} "
        f"(tolerance {t_nll:.3g}), dlogits max_abs_err={e_d:.3g} "
        f"(tolerance {t_d:.3g})")
    if not (e_nll <= t_nll and e_d <= t_d):
        raise AssertionError(f"xent disagrees with its plain version at "
                             f"{shape}")
    _, lse = xent.xent_fwd(logits, labels, softcap)
    fwd_ms = _time_ms(lambda: xent.xent_fwd(logits, labels, softcap))
    fwd_plain = _time_ms(lambda: xent.xent_fwd_plain(logits, labels,
                                                     softcap))
    bwd_ms = _time_ms(lambda: xent.xent_bwd(logits, labels, lse, dy,
                                            softcap))
    bwd_plain = _time_ms(lambda: xent.xent_bwd_plain(logits, labels, lse, dy,
                                                     softcap))
    fwd_lib = bwd_lib = None
    if softcap is None:
        lab64 = labels.long()
        fwd_lib = _time_ms(lambda: F.cross_entropy(logits, lab64,
                                                   reduction="none"))
        leaf = logits.detach().requires_grad_()
        bwd_lib = _time_ms(lambda: torch.autograd.grad(
            F.cross_entropy(leaf, lab64, reduction="none"), leaf,
            grad_outputs=dy))
    n = R * V
    # max, sub, exp, add; the backward sub, exp, sub, mul; a softcap adds
    # div, tanh, mul to both and the backward's 1 - tanh^2 and its product
    cap_ops = 3.0 if softcap else 0.0
    fwd_bound = _bound(4.0 * n + 12.0 * R, (4.0 + cap_ops) * n)
    bwd_bound = _bound(8.0 * n + 12.0 * R,
                       (5.0 + cap_ops + (2.0 if softcap else 0.0)) * n)
    log(f"[kernels] xent {shape}: forward {fwd_ms:.4f} ms (plain "
        f"{fwd_plain:.4f}, F.cross_entropy {fwd_lib}, bound "
        f"{fwd_bound[0]:.4f} {fwd_bound[1]}); backward {bwd_ms:.4f} ms (plain "
        f"{bwd_plain:.4f}, F.cross_entropy fwd+bwd {bwd_lib}, bound "
        f"{bwd_bound[0]:.4f} {bwd_bound[1]})")
    del logits, labels, dy, lse
    return {"shape": shape,
            "fwd": dict(max_abs_err=e_nll, ms=fwd_ms, plain_ms=fwd_plain,
                        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                        library_ms=fwd_lib),
            "bwd": dict(max_abs_err=e_d, ms=bwd_ms, plain_ms=bwd_plain,
                        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                        library_ms=bwd_lib)}


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


def _scan_time(kernel, plain, make, case, args, gen, work):
    """Time a scan kernel and its plain version at one case's inputs
    ``args``: warm (one copy of the inputs) and cold (rotating through
    copies that exceed the L2), with the bound of work(*args)."""
    nbytes, flops = work(*args)
    copies = [args] + [
        make(case, gen)[0]
        for _ in range(max(1, math.ceil(COLD_BYTES / nbytes) - 1))]
    ms_cold = _time_cold_ms(kernel, copies)
    n_copies = len(copies)
    del copies
    ms = _time_ms(lambda: kernel(*args))
    plain_ms = _time_ms(lambda: plain(*args))
    bound_ms, bound_by = _bound(nbytes, flops, args[0].dtype)
    if not ms_cold >= bound_ms:
        raise AssertionError(f"the cold time {ms_cold} ms is below the "
                             f"bound {bound_ms} ms: the timing is wrong")
    return {"ms": ms, "ms_cold": ms_cold, "cold_copies": n_copies,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "mb": nbytes / 1e6, "gflop": flops / 1e9}


def _scan_phase(name, kernel, plain, route, cases, make, work, seed,
                also_time=None):
    """Hold a scan kernel against its plain version on the card at each case
    (y and the last state), printing the path each case took, then time
    both at the first case, the main path's shape: warm (one copy of the
    inputs) and cold (rotating through copies that exceed the L2); and at
    the case labelled ``also_time`` (its row's "timed" entry), if given.
    make(case, gen) -> (args, state, plain chunk, label); route(*args) ->
    the kernel's path; work(*args) -> (bytes moved, operations) of one call
    at that shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs, paths, by_case = [], {}, {}
    for case in cases:
        args, state, chunk, label = make(case, gen)
        paths[label] = route(*args)
        got = kernel(*args, state, chunk=chunk)
        torch.cuda.synchronize()
        want = plain(*args, state, chunk=chunk)
        errs.append(_scan_check(name, f"{label} [{paths[label]} path]",
                                zip(got, want)))
        by_case[label] = errs[-1]
        del got, want
        if len(errs) == 1:
            main_args, main_label = args, label
    timed = _scan_time(kernel, plain, make, cases[0], main_args, gen, work)
    host_us = _host_us(lambda: kernel(*main_args))
    nbytes, flops = work(*main_args)
    dtype = main_args[0].dtype
    # the PR 13-15 figure: the operations at f32's CUDA-core rate
    bound_f32_ms, bound_f32_by = _bound(nbytes, flops)
    log(f"[kernels] {name} main {main_label} [{paths[main_label]} path]: "
        f"warm {timed['ms']:.4f} ms, cold ({timed['cold_copies']} copies, "
        f"{timed['cold_copies'] * nbytes / 1e6:.0f} MB) "
        f"{timed['ms_cold']:.4f} ms, plain {timed['plain_ms']:.4f} ms, bound "
        f"{timed['bound_ms']:.5f} ms ({timed['bound_by']} at "
        f"{str(dtype)[6:]}'s rates; {bound_f32_ms:.5f} ms, {bound_f32_by}, "
        f"with the operations at f32's; {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); the wrapper's host time {host_us:.1f} "
        f"us a call; no PyTorch call computes the scan")
    extra = {}
    if also_time is not None:
        case = next(c for c in cases if c[-1] == also_time)
        args = make(case, gen)[0]
        extra = {"timed": {"shape": also_time, "path": paths[also_time],
                           **_scan_time(kernel, plain, make, case, args, gen,
                                        work)}}
        t = extra["timed"]
        log(f"[kernels] {name} at {also_time} [{t['path']} path]: warm "
            f"{t['ms']:.4f} ms, cold ({t['cold_copies']} copies) "
            f"{t['ms_cold']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {t['mb']:.2f} MB, "
            f"{t['gflop']:.3f} GFLOP)")
        del args
    return {"name": name, "route": "cuda", "launches": None,
            "max_abs_err": errs[0], "ms": timed["ms"],
            "ms_cold": timed["ms_cold"], "cold_copies": timed["cold_copies"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "bound_ms_f32_ops": bound_f32_ms,
            "library_ms": None, "host_us": host_us, "shape": main_label,
            "path": paths[main_label], "paths": paths,
            "edge_shapes_max_abs_err": max(errs[1:]),
            "max_abs_err_by_case": by_case, **extra}


def phase_ssd():
    """The SSD scan against its plain version at zamba2's prefill (bf16 x,
    B and C), at its train forward (2 x 1024 tokens from a zero state, as
    ``ssd_scan_train`` calls it) and at edge shapes, on both paths (the
    bf16 cases but hd 24 take the tensor-core one), and with x, B and C as
    views into NaN-filled buffers (a load past a view's rows, head or
    columns would show as a non-finite output): y and the last state;
    timed at zamba2's prefill and at its train forward."""
    from repro_torch.kernels import ssm_scan
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    main = (1, PROMPT, 80, 64, 64)      # zamba2: 2 * 2560 / 64 heads, N 64
    POISONED = "zamba2 prefill bf16, h0, NaN-poisoned views"
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
        (TRAIN_BATCH, TRAIN_SEQ) + main[2:] + (bf, False, 256,
                                               "zamba2 train bf16"),
        main + (bf, True, 256, POISONED),
    ]

    def make(case, gen):
        B, S, H, hd, N, dtype, h0, chunk, label = case
        x = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
        Bm = torch.randn(B, S, N, generator=gen, device="cuda").to(dtype)
        Cm = torch.randn(B, S, N, generator=gen, device="cuda").to(dtype)
        if label == POISONED:   # rows, a head and columns of NaN around
            xbuf = torch.full((B, S + 3, H + 1, hd + 8), float("nan"),
                              dtype=dtype, device="cuda")
            bcbuf = torch.full((B, S + 2, 3 * N + 8), float("nan"),
                               dtype=dtype, device="cuda")
            views = (xbuf[:, 1:S + 1, 1:, :hd], bcbuf[:, 1:S + 1, 8:8 + N],
                     bcbuf[:, 1:S + 1, 8 + 2 * N:])
            for v, t in zip(views, (x, Bm, Cm)):
                v.copy_(t)
            x, Bm, Cm = views
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
                      make, work, seed=8, also_time="zamba2 train bf16")
    return {**row, "shape": f"B=1 S={PROMPT} H=80 hd=64 N=64 bf16",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:21",
            "library": "none: no single PyTorch call computes the SSD scan"}


def phase_wkv():
    """WKV6 against its plain version at rwkv6's prefill (bf16 r, k, v), at
    its train forward (2 x 1024 tokens from a zero state, as ``wkv6_train``
    calls it) and at edge shapes, on both paths (the bf16 cases but hd 40
    take the tensor-core one), and with r, k, v and logw as views into
    NaN-filled buffers (a load past a view's rows, head or columns would
    show as a non-finite output): y and the last state; timed at rwkv6's
    prefill and at its train forward."""
    from repro_torch.kernels import wkv6
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    main = (1, PROMPT, 32, 64)          # rwkv6: 2048 / 64 heads
    POISONED = "rwkv6 prefill bf16, s0, NaN-poisoned views"
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
        (TRAIN_BATCH, TRAIN_SEQ) + main[2:] + (bf, False, False, 64,
                                               "rwkv6 train bf16"),
        main + (bf, True, False, 64, POISONED),
    ]

    def make(case, gen):
        B, S, H, hd, dtype, s0, floor, chunk, label = case
        r, k, v = (torch.randn(B, S, H, hd, generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        logw = torch.clamp(-torch.exp(torch.randn(B, S, H, hd, generator=gen,
                                                  device="cuda")), min=-8.0)
        if floor:
            logw = torch.full_like(logw, -8.0)
        if label == POISONED:   # rows, a head and columns of NaN around
            bbuf = torch.full((B, S + 3, H + 1, 3 * hd + 16), float("nan"),
                              dtype=dtype, device="cuda")
            fbuf = torch.full((B, S + 3, H + 1, hd + 16), float("nan"),
                              device="cuda")
            views = tuple(bbuf[:, 1:S + 1, 1:, 8 + i * hd:8 + (i + 1) * hd]
                          for i in range(3)) + (fbuf[:, 1:S + 1, 1:,
                                                     4:4 + hd],)
            for view, t in zip(views, (r, k, v, logw)):
                view.copy_(t)
            r, k, v, logw = views
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
                      seed=9, also_time="rwkv6 train bf16")
    return {**row, "shape": f"B=1 S={PROMPT} H=32 hd=64 bf16",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:21",
            "library": "none: no single PyTorch call computes the WKV6 scan"}


def _gmm_work(E, C, D, F, item, rows=None, mode="fwd"):
    """(bytes, flops) of one grouped matmul of x (E,C,D) and w (E,D,F)
    ("fwd") or of its gradient products dx = dy w^T ("dx") and dw = x^T dy
    ("dw"): each operand's occupied rows read once (all C without
    ``rows``), the weights of the experts with rows > 0 read once (every
    expert's without), the whole output written once; 2 D F operations an
    occupied row."""
    if rows is None:
        live_rows, live_experts = E * C, E
    else:
        r = rows.clamp(0, C)
        live_rows, live_experts = int(r.sum()), int((r > 0).sum())
    reads = {"fwd": live_rows * D + live_experts * D * F,
             "dx": live_rows * F + live_experts * D * F,
             "dw": live_rows * (D + F)}[mode]
    writes = {"fwd": E * C * F, "dx": E * C * D, "dw": E * D * F}[mode]
    return item * (reads + writes), 2.0 * live_rows * D * F


def _gmm_rows(kind, E, C, seed):
    """A rows vector on the card: "zero" (every expert empty), "partial"
    (0, C/4, C/2, 3C/4, C in turn) or "random" (a third empty)."""
    if kind == "zero":
        r = torch.zeros(E, dtype=torch.int32)
    elif kind == "partial":
        r = torch.tensor([C * (e % 5) // 4 for e in range(E)],
                         dtype=torch.int32)
    else:
        r = torch.randint(0, C + 1, (E,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(seed))
        r[::3] = 0
    return r.cuda()


def _gmm_poisoned(t, rows, experts=False):
    """A copy of t with t's strides, NaN in its rows c >= rows[e] (or, with
    ``experts``, in every expert whose rows are 0): what the kernel must
    never let into its result."""
    u = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                            device=t.device)
    u.copy_(t)
    if experts:
        u[rows == 0] = float("nan")
    else:
        past = torch.arange(t.shape[1], device=t.device)[None] >= rows[:, None]
        u[past] = float("nan")
    return u


def _gmm_err(got, want, dtype, what):
    """max |got - want| against GMM_RTOL of want's scale; raises on a miss,
    a NaN or the wrong dtype."""
    err = (got.float() - want.float()).abs().max().item()
    tol = GMM_RTOL[dtype] * max(1.0, want.float().abs().max().item())
    if not (err <= tol and got.dtype == dtype):
        raise AssertionError(f"gmm disagrees with its plain version at "
                             f"{what}: {err:.3g} > {tol:.3g}")
    return err


def _gmm_hold(label, x, w, rows_list):
    """gmm against gmm_plain at x, w for each (name, rows) of rows_list,
    with x NaN past the rows and w NaN in the empty experts where rows are
    given: one launch a call; -> {name: max abs error}."""
    from repro_torch.kernels import moe_gmm
    errs = {}
    for name, rows in rows_list:
        xp = x if rows is None else _gmm_poisoned(x, rows)
        wp = w if rows is None else _gmm_poisoned(w, rows, experts=True)
        before = moe_gmm.launches
        got = moe_gmm.gmm(xp, wp, rows)
        torch.cuda.synchronize()
        if moe_gmm.launches != before + 1:
            raise AssertionError(f"gmm at {label} launched "
                                 f"{moe_gmm.launches - before} kernels")
        errs[name] = _gmm_err(got, moe_gmm.gmm_plain(xp, wp, rows), x.dtype,
                              f"{label}, rows {name}")
        del got, xp, wp
    return errs


def phase_gmm():
    """The grouped matmul against its plain version on the card at
    granite-moe's buckets (prefill C 200, decode C 2; gate/up and out) in
    bf16, f32 and f16, at tests/test_kernels.py's shapes, on both sides of
    the small-C path's limit (C 8 and 9, 16 and 17), and at ragged and
    strided edge shapes, each without rows and with rows all 0, partial
    and random (x NaN past the rows, w NaN in empty experts); timed at the
    four bf16 bucket shapes with full buckets, warm and cold, with
    torch.bmm as the yardstick timed alike; then the backward
    (``_gmm_backward``)."""
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
        (3, 37, 76, 44, bf, "view", "ragged C=37 D=76 F=44 in 16-byte rows"),
        (3, 2, 76, 44, f16, "view", "ragged C=2 D=76 F=44 in 16-byte rows"),
        (1, 130, 1024, 512, bf, "", "one expert, C=130"),
        (4, 37, 72, 40, f32, "group", "group slice of (G,E,D,F), F=40 of 64"),
        (4, 37, 72, 40, bf, "expert", "expert-strided w and x views"),
        (32, 8, 1024, 512, bf, "", "C=8, the small-C path's largest"),
        (32, 9, 1024, 512, bf, "", "C=9, the tensor-core path's smallest"),
        (32, 16, 512, 1024, f16, "", "C=16 f16"),
        (32, 17, 512, 1024, bf, "expert", "C=17, expert-strided views"),
    ]
    errs, errs_rows, timed = [], [], []
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
        elif layout == "view":         # rows of 16-byte chunks, D and F not
            x = torch.randn(E, C, D + 4, generator=gen,
                            device="cuda").to(dtype)[:, :, :D]
            w = torch.randn(E, D, F + 4, generator=gen,
                            device="cuda").to(dtype)[:, :, :F]
        else:
            w = torch.randn(E, D, F, generator=gen, device="cuda").to(dtype)
        held = _gmm_hold(label, x, w, [("none", None)] + [
            (kind, _gmm_rows(kind, E, C, seed=E + C))
            for kind in ("zero", "partial", "random")])
        err = held.pop("none")
        err_rows = max(held.values())
        log(f"[kernels] gmm {label} (E={E} C={C} D={D} F={F}, x strides "
            f"{x.stride()}, w strides {w.stride()}): max_abs_err={err:.3g}; "
            f"with rows 0 / partial / random and NaN past them "
            f"{err_rows:.3g} (tolerance {GMM_RTOL[dtype]:.3g} of the scale)")
        errs.append(err)
        errs_rows.append(err_rows)
        if len(timed) < 4:
            timed.append((label, x, w, err))
        del x, w
    rows = [_gmm_timed(label, "fwd", x, w, None, err, gen)
            for label, x, w, err in timed]
    del timed
    backward = _gmm_backward(gen)
    return {"name": "moe_gmm", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:21", "launches": None,
            **rows[0], "library": "torch.bmm",
            "timing": "ms and library_ms cold (inputs rotated through "
                      "copies beyond L2); *_warm and plain_ms on one copy",
            "edge_shapes_max_abs_err": max(errs[4:]),
            "with_rows_max_abs_err": max(errs_rows),
            "prefill_out": rows[1], "decode_gate_up": rows[2],
            "decode_out": rows[3], "train_backward": backward}


def _gmm_calls(mode, a, b, rows):
    """(kernel, torch.bmm, plain) thunk makers for one grouped product: the
    forward x w, or the backward's dx = dy w^T and dw = x^T dy (a, b as
    the entry point takes them; bmm reads the transposed views in place)."""
    from repro_torch.kernels import moe_gmm
    E, C = a.shape[:2]
    if mode == "fwd":
        return (lambda x, w: moe_gmm.gmm(x, w, rows), torch.bmm,
                lambda x, w: moe_gmm.gmm_plain(x, w, rows))
    if mode == "dx":                   # a = dy (E,C,F), b = w (E,D,F)
        D, F = b.shape[1:]
        return (lambda dy, w: moe_gmm._launch(moe_gmm._DX, dy, w, rows, C, D,
                                              F),
                lambda dy, w: torch.bmm(dy, w.transpose(1, 2)),
                lambda dy, w: moe_gmm._dx_plain(dy, w, rows))
    D, F = a.shape[2], b.shape[2]      # a = x (E,C,D), b = dy (E,C,F)
    return (lambda x, dy: moe_gmm._launch(moe_gmm._DW, x, dy, rows, D, F, C),
            lambda x, dy: torch.bmm(x.transpose(1, 2), dy),
            lambda x, dy: moe_gmm._dw_plain(x, dy, rows))


def _grouped_mm_args(x, w, rows):
    """torch._grouped_mm's inputs for x's occupied rows: the rows packed
    expert after expert, w, and each expert's end offset (int32)."""
    live = torch.arange(x.shape[1], device=x.device)[None] < rows[:, None]
    return x[live], w, torch.cumsum(rows, 0, dtype=torch.int32)


def _gmm_timed(label, mode, a, b, rows, err, gen) -> dict:
    """One grouped product timed cold (rotating copies of its operands
    beyond L2) and warm, with torch.bmm (the whole buckets) timed alike,
    the plain version warm and the wrapper's host time a call; with
    ``rows`` (the forward at a dispatch's occupancy) also
    torch._grouped_mm on the occupied rows packed with their offsets,
    where the card's PyTorch has it.  The bound counts what ``rows``
    occupies (``_gmm_work``), and the full buckets' beside it."""
    E, C = a.shape[:2]
    D, F = {"fwd": (a.shape[2], b.shape[2]), "dx": (b.shape[1], b.shape[2]),
            "dw": (a.shape[2], b.shape[2])}[mode]
    nbytes, flops = _gmm_work(E, C, D, F, a.element_size(), rows, mode)
    full_bytes, full_flops = _gmm_work(E, C, D, F, a.element_size(), None,
                                       mode)
    kernel, library, plain = _gmm_calls(mode, a, b, rows)
    copies = [(a, b)] + [
        (torch.randn(a.shape, generator=gen, device="cuda").to(a.dtype),
         torch.randn(b.shape, generator=gen, device="cuda").to(b.dtype))
        for _ in range(max(1, math.ceil(COLD_BYTES / nbytes) - 1))]
    ms = _time_cold_ms(kernel, copies)
    library_ms = _time_cold_ms(library, copies)
    ms_warm = _time_ms(lambda: kernel(a, b))
    library_warm = _time_ms(lambda: library(a, b))
    plain_ms = _time_ms(lambda: plain(a, b))
    host_us = _host_us(lambda: kernel(a, b))
    grouped = {}
    if rows is not None:
        if not hasattr(torch, "_grouped_mm"):
            grouped = {"grouped_mm": f"torch {torch.__version__} has no "
                                     f"torch._grouped_mm"}
        else:   # a yardstick only: a refusal is recorded, not raised
            packed = [_grouped_mm_args(x, w, rows) for x, w in copies]
            try:
                grouped = {"grouped_mm_ms": _time_cold_ms(torch._grouped_mm,
                                                          packed),
                           "grouped_mm_ms_warm": _time_ms(
                               lambda: torch._grouped_mm(*packed[0]))}
            except RuntimeError as exc:
                grouped = {"grouped_mm": f"refused: {str(exc)[:200]}"}
            del packed
    n_copies = len(copies)
    del copies
    bound_ms, bound_by = _bound(nbytes, flops, a.dtype)
    full_bound_ms, full_bound_by = _bound(full_bytes, full_flops, a.dtype)
    occ = "" if rows is None else (
        f", {int((rows > 0).sum())} of {E} experts occupied, "
        f"{int(rows.clamp(0, C).sum())} of {E * C} rows")
    log(f"[kernels] gmm timed at {label}{occ}: cold ({n_copies} copies) "
        f"kernel {ms:.4f} ms, torch.bmm {library_ms:.4f} ms; warm kernel "
        f"{ms_warm:.4f} ms, torch.bmm {library_warm:.4f} ms; {grouped}; "
        f"plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}, "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), full buckets' "
        f"{full_bound_ms:.5f} ms; the wrapper's host time {host_us:.1f} us "
        f"a call")
    out = {"shape": label, "max_abs_err": err, "ms": ms, "host_us": host_us,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "ms_warm": ms_warm,
           "library_ms_warm": library_warm, "full_bound_ms": full_bound_ms,
           "cold_copies": n_copies, **grouped}
    if rows is not None:
        out["rows"] = rows.tolist()
        out["occupied_experts"] = int((rows > 0).sum())
    return out


def _gmm_backward(gen) -> dict:
    """The gmm Function's backward at granite-moe's train buckets (E 32,
    cap_e 800: T 2048 tokens, top-8, cf 1.25) in bf16, for the gate/up and
    the out product: dx and dw through the kernel against autograd of the
    plain version (2^-7 of the output's scale: one rounding of an f32
    sum), without rows and with a random rows vector (x NaN past it, w NaN
    in its empty experts), three launches each; then each backward
    product timed at full buckets, as the kernel runs it (dy and w read in
    place for dx, x and dy for dw: no copy) beside torch.bmm on the
    transposed views."""
    from repro_torch.kernels import moe_gmm
    bf = torch.bfloat16
    E, C = GRANITE_TRAIN_BUCKET
    out = {}
    for label, D, F in (("gate/up", 1024, 512), ("out", 512, 1024)):
        x = torch.randn(E, C, D, generator=gen, device="cuda").to(bf)
        w = torch.randn(E, D, F, generator=gen, device="cuda").to(bf)
        dy = torch.randn(E, C, F, generator=gen, device="cuda").to(bf)
        errs = {}
        for kind in (None, "random"):
            rows = None if kind is None else _gmm_rows(kind, E, C, seed=D)
            xp = x if rows is None else _gmm_poisoned(x, rows)
            wp = w if rows is None else _gmm_poisoned(w, rows, experts=True)
            before = moe_gmm.launches
            xk, wk = (t.clone().requires_grad_() for t in (xp, wp))
            moe_gmm.gmm_train(xk, wk, rows).backward(dy)
            torch.cuda.synchronize()
            ran = moe_gmm.launches - before
            xq, wq = (t.clone().requires_grad_() for t in (xp, wp))
            moe_gmm.gmm_plain(xq, wq, rows).backward(dy)
            for name, got, want in (("dx", xk.grad, xq.grad),
                                    ("dw", wk.grad, wq.grad)):
                err = _gmm_err(got, want, bf, f"backward {label} {name}, "
                                              f"rows {kind}")
                errs[name] = max(errs.get(name, 0.0), err)
                log(f"[kernels] gmm backward {label} {name} "
                    f"{tuple(got.shape)}, rows {kind}: max_abs_err={err:.3g} "
                    f"against the plain version's autograd")
            if ran != 3:
                raise AssertionError(f"gmm_train forward+backward launched "
                                     f"{ran} kernels, not 3")
            del xp, wp, xk, wk, xq, wq
        out[f"{label} dx"] = _gmm_timed(
            f"granite train {label} dx (E={E} C={C} F={F} D={D})", "dx", dy,
            w, None, errs["dx"], gen)
        out[f"{label} dw"] = _gmm_timed(
            f"granite train {label} dw (E={E} D={D} C={C} F={F})", "dw", x,
            dy, None, errs["dw"], gen)
        del x, w, dy
    return out


def _moe_layers(arch: str) -> int:
    from repro_torch.configs import registry
    cfg = registry.get_config(arch)
    return cfg.num_groups * cfg.block_pattern.count("moe")


class _GmmRecorder:
    """Wraps ``models.moe.gmm`` (``with``): records every bucket shape it
    is called with and, once ``arm``-ed, the first ``per_capacity`` calls
    of each bucket capacity C with their rows (copies on the card: no host
    sync in the serve loop): with 3 a MoE layer, one full prefill's and
    one decode step's."""

    def __init__(self, per_capacity: int):
        from repro_torch.models import moe as moe_mod
        self.mod, self.inner, self.per = moe_mod, moe_mod.gmm, per_capacity
        self.shapes, self.calls, self.armed = set(), {}, False

    def __call__(self, x, w, rows=None):
        key = (tuple(x.shape), tuple(w.shape))
        self.shapes.add(key)
        if self.armed and rows is not None:
            got = self.calls.setdefault(x.shape[1], [])
            if len(got) < self.per:
                got.append((key, rows.clone()))
        return self.inner(x, w, rows)

    def __enter__(self):
        self.mod.gmm = self
        return self

    def __exit__(self, *exc):
        self.mod.gmm = self.inner

    def arm(self):
        self.armed = True

    def layers(self):
        """{C: [rows of each MoE layer's calls, in order]} on the CPU (a
        layer's gate, up and out calls share one vector)."""
        return {C: [r.cpu() for _, r in calls[::3]]
                for C, calls in self.calls.items()}


def _gmm_occupancy(arch, recorder, gen, smi) -> dict:
    """The rows vectors ``recorder`` saw in ``arch``'s serve run at the
    full prefill's capacity (its largest C) and the decode step's (its
    smallest), summarised per layer, and the forward at the first MoE
    layer's occupancy for each bucket shape (gate/up and out) on new
    random bf16 tensors: held against the plain version without rows and
    with them (x NaN past them, w NaN in the empty experts), then timed."""
    bf = torch.bfloat16
    layers = recorder.layers()
    out = {}
    for C, phase in ((max(layers), "prefill"), (min(layers), "decode")):
        occupied = [int((r > 0).sum()) for r in layers[C]]
        filled = [int(r.sum()) for r in layers[C]]
        log(f"[{arch}] gmm rows at C={C} ({phase}): occupied experts a "
            f"layer {occupied}; rows a layer {filled}; the first layer's "
            f"{layers[C][0].tolist()}")
        rows = layers[C][0].cuda()
        keys = sorted({k for k, _ in recorder.calls[C]},
                      key=lambda k: -k[0][2])
        for (E, _, D), (_, _, F) in keys:
            label = (f"{arch} {phase} {'gate/up' if D > F else 'out'} at its "
                     f"dispatch's occupancy (E={E} C={C} D={D} F={F})")
            x = torch.randn(E, C, D, generator=gen, device="cuda").to(bf)
            w = torch.randn(E, D, F, generator=gen, device="cuda").to(bf)
            held = _gmm_hold(label, x, w, [("none", None),
                                           ("dispatch", rows)])
            torch.cuda.empty_cache()
            out[label] = dict(_gmm_timed(label, "fwd", x, w, rows,
                                         held["dispatch"], gen),
                              full_max_abs_err=held["none"],
                              occupied_by_layer=occupied,
                              rows_by_layer=filled, card=smi)
            del x, w
            torch.cuda.empty_cache()
    return out


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


def phase_small_families() -> None:
    """gemma2 (the window shrunk to 8, below the 100-token prompt), whisper
    and the VLM (seeded image embeddings, its cross block's gates set to
    seeded nonzero values) smoke configs in f32: a B=1 prefill and 4 decode
    steps through the flash kernel on the card against the plain versions
    on the CPU, on the same params: every step's logits and the caches
    after the last, within 1e-4 of their scale, and flash once a layer of
    each prefill (whisper: encoder, decoder and cross attention)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps
    for arch in (GEMMA2, WHISPER, VLM):
        cfg = registry.get_smoke(arch).replace(param_dtype="float32",
                                               compute_dtype="float32")
        if arch == GEMMA2:
            cfg = cfg.replace(attn=dataclasses.replace(cfg.attn, window=8))
        cfg = steps.resolve_cfg(cfg, ShapeConfig("small", 104, 1, "prefill"))
        mod = steps._model_module(cfg)
        params = pr.init_params(mod.lm_schema(cfg),
                                torch.Generator().manual_seed(1), "float32",
                                "cpu")
        gen = torch.Generator().manual_seed(2)
        if arch == VLM:
            blk = params["blocks"]["4_cross"]
            for gate in ("gate_attn", "gate_mlp"):
                blk[gate] = 0.5 + torch.rand(blk[gate].shape, generator=gen)
        specs = steps.extras_specs(cfg, 1)
        extras = None if specs is None else {
            k: torch.randn(v.shape, generator=gen) for k, v in specs.items()}
        T = 12 if arch == WHISPER else 100       # whisper: 16 positions
        toks = torch.randint(1, cfg.vocab_size, (1, T), generator=gen)
        nxt = torch.randint(1, cfg.vocab_size, (4, 1, 1), generator=gen)
        runs = {}
        before = fa.launches
        for dev in ("cpu", "cuda"):
            p_dev = _to(params, dev)
            ex = None if extras is None else _to(extras, dev)
            with torch.inference_mode():
                last, small = steps.prefill_step(cfg, p_dev, toks.to(dev),
                                                 extras=ex)
                # whisper's self cache is decoder_len whatever S is, and
                # its cross cache holds the encoder's frames
                cache = steps.cache_batch_insert(
                    steps.init_cache(cfg, 1, cfg.encoder_frames or T + 4,
                                     dev), small, 0)
                logits = [last]
                for i in range(4):
                    x, cache = mod.forward(cfg, p_dev, nxt[i].to(dev),
                                           mode="decode", caches=cache,
                                           pos=T + i)
                    logits.append(mod.lm_logits(cfg, p_dev, x)[:, -1])
            runs[dev] = ([t.cpu() for t in logits],
                         [t.cpu() for t in steps.tree_leaves(cache)])
        ran = fa.launches - before
        errs = [(g - w).abs().max().item() / max(1.0, w.abs().max().item())
                for g, w in zip(runs["cuda"][0] + runs["cuda"][1],
                                runs["cpu"][0] + runs["cpu"][1])]
        want_ran = (cfg.encoder_layers + 2 * cfg.num_layers
                    if arch == WHISPER else cfg.num_layers)
        log(f"[small] {arch} smoke f32 ({cfg.num_layers} layers"
            f"{', window 8' if arch == GEMMA2 else ''}) prefill + 4 decode "
            f"steps, card vs cpu: logits max error {max(errs[:5]):.3g} of "
            f"their scale, cache {max(errs[5:]):.3g} (tolerance 1e-4); "
            f"flash launches {ran} (want {want_ran})")
        if not max(errs) <= 1e-4:
            raise AssertionError(f"{arch} smoke on the card disagrees with "
                                 f"the CPU: {errs}")
        if ran != want_ran:
            raise AssertionError(f"{arch} smoke flash launches {ran} != "
                                 f"{want_ran}")


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


def phase_serve(smi: str, arch: str = ARCH, after=None, layers: int = 0,
                before_run=None):
    """Full-width phi4, granite-moe, gemma2 or kimi-k2 (depth cut to
    ``layers`` where given) in bf16 serves 8 requests through the paged
    pool with the prefix cache; flash runs on every layer of every full
    prefill and the MoE's gmm 3 times a layer in every full prefill and
    decode step; then paged equals slotted on a short run.
    ``after(cfg, params)`` runs on the served weights before they are
    freed; ``before_run()`` right before the requests are served (after
    the warm-up)."""
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
    if layers:
        cfg = cfg.replace(num_layers=layers)
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
    if before_run is not None:
        before_run()
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
    serve = {"arch": arch, "layers": cfg.num_layers, "cache": "paged",
             "requests": len(results),
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
    serve["paged_equals_slotted"] = same
    if after is not None:
        serve.update(after(cfg, params))
    del params
    # which requests this run prefilled whole (the rest replayed a cached
    # prefix): the router phase compares its tokens on like paths
    full = {r["id"] for r in reqs if tuple(r["prompt"]) in set(per["prompts"])}
    return serve, launches, {"results": results, "full": full}


def gemma2_long_request(cfg, params):
    """One request of GEMMA2_LONG_PROMPT tokens and GEMMA2_LONG_GEN new ones
    on a 1-slot engine (slotted: 1.8 GB of KV): past the 4096 window, so
    the local layers' prefill (the kernel skips the k tiles left of each
    q tile's band) and decode really mask.  A direct prefill of the prompt
    gives finite logits; the request completes with its stop length and
    flash once a layer of its prefill."""
    from repro_torch.core.queue import WorkQueue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime import steps
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.report import GAUGES
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(1, cfg.vocab_size, (GEMMA2_LONG_PROMPT,),
                           generator=gen).tolist()
    with torch.inference_mode():
        last, small = steps.prefill_step(cfg, params,
                                         torch.tensor([prompt], device="cuda"))
        finite = bool(torch.isfinite(last).all())
    del small
    engine = ServingEngine(cfg, device="cuda", num_slots=1,
                           prompt_len=GEMMA2_LONG_PROMPT,
                           max_new_tokens=GEMMA2_LONG_GEN, params=params,
                           paged=False)
    kv_gb = sum(leaf.numel() * leaf.element_size() for leaf in
                steps.tree_leaves(engine._caches)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    results, metrics = engine.run(WorkQueue([{
        "id": 0, "prompt": prompt, "max_new_tokens": GEMMA2_LONG_GEN}]))
    torch.cuda.synchronize()
    ran = fa.launches
    sm = metrics.summary()
    row = {"long_prompt": GEMMA2_LONG_PROMPT,
           "long_tokens": len(results.get(0, [])),
           "long_logits_finite": finite, "long_flash": ran,
           "long_kv_gb": kv_gb, "long_ttft_s": sm[GAUGES.TTFT_S]["p50"],
           "long_tok_s": sm[GAUGES.TOK_S]["last"],
           "long_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[serve:{GEMMA2}] one {GEMMA2_LONG_PROMPT}-token request, "
        f"{GEMMA2_LONG_GEN} new (window {cfg.attn.window}): {row}")
    del engine
    if not (finite and row["long_tokens"] == GEMMA2_LONG_GEN
            and ran == cfg.num_layers):
        raise AssertionError(f"the long gemma2 request failed: {row}")
    return row


def phase_serve_slotted(smi: str, arch: str, layers: int = 0, after=None):
    """Full-width zamba2, rwkv6, whisper or the VLM (``layers`` cuts the
    depth) in bf16 serves the phi4 phase's 8 requests through the slotted
    cache (their state, self and cross caches do not page): a full-width
    prefill gives finite logits and caches, every request completes with
    its stop length, and the kernels ran on every layer of every full
    prefill: the scans on zamba2's and rwkv6's, flash on zamba2's 9
    shared-attention layers, on whisper's 12 encoder, 12 decoder and 12
    cross attentions, on all the VLM's layers (its cross attention
    included).  ``after(cfg, params)`` runs on the served weights before
    they are freed."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.queue import WorkQueue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan, wkv6
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.report import GAUGES

    torch.cuda.empty_cache()
    cfg = registry.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    cfg = steps.resolve_cfg(cfg, ShapeConfig("serve", PROMPT + GEN, SLOTS,
                                             "decode"))
    schema = steps._model_module(cfg).lm_schema(cfg)
    t0 = time.perf_counter()
    params = pr.init_params(schema,
                            torch.Generator(device="cuda").manual_seed(0),
                            cfg.param_dtype, "cuda")
    torch.cuda.synchronize()
    n_params = pr.param_count(schema)
    log(f"[serve:{arch}] {n_params / 1e9:.3f} B params in bf16 on the card "
        f"in {time.perf_counter() - t0:.1f} s ({cfg.num_layers} layers)")
    reqs = _requests(cfg.vocab_size)
    extras = steps.zero_extras(cfg, 1, "cuda")
    pad = WHISPER_PAD if cfg.family == "audio" else PROMPT
    with torch.inference_mode():       # one full-width prefill: all finite
        last, small = steps.prefill_step(
            cfg, params, torch.tensor([reqs[0]["prompt"][:pad]],
                                      device="cuda"), extras=extras)
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
        raise AssertionError(f"{arch}'s cache was paged")
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
    layers_of = {k: G * sum(kind in kinds for kind in cfg.block_pattern)
                 for k, kinds in (("ssd_scan", ("mamba", "mamba_attn")),
                                  ("wkv6", ("rwkv",)),
                                  ("flash_attention", ("mamba_attn",)))}
    if cfg.family == "audio":
        layers_of["flash_attention"] = cfg.encoder_layers + 2 * cfg.num_layers
    elif cfg.family == "vlm":
        layers_of["flash_attention"] = cfg.num_layers
    want_launches = {k: n * full_prefills for k, n in layers_of.items()}
    log(f"[serve:{arch}] completed {len(results)}/{len(reqs)}, tokens "
        f"{sm[GAUGES.TOKENS]['total']:.0f}/{want_tokens}, full prefills "
        f"{full_prefills}, launches {launches} (want {want_launches}); "
        f"{sm[GAUGES.TOK_S]['last']:.1f} tok/s, p50 TTFT "
        f"{sm[GAUGES.TTFT_S]['p50']:.3f} s, peak {peak_gb:.2f} GB, {smi}")
    if sorted(results) != list(range(len(reqs))):
        raise AssertionError(f"requests not all completed: {sorted(results)}")
    if any(len(results[r["id"]]) != r["max_new_tokens"] for r in reqs):
        raise AssertionError("a request's token count is not its stop length")
    if sm[GAUGES.TOKENS]["total"] != want_tokens:
        raise AssertionError("token count is not the sum of stop lengths")
    if launches != want_launches or full_prefills < 1:
        raise AssertionError(f"{arch} kernel launches {launches} != "
                             f"{want_launches}")
    serve = {"arch": arch, "cache": "slotted", "layers": cfg.num_layers,
             "params_b": n_params / 1e9, "requests": len(results),
             "tokens": int(sm[GAUGES.TOKENS]["total"]),
             "tok_s": sm[GAUGES.TOK_S]["last"],
             "decode_tok_s": sm[GAUGES.DECODE_TOK_S]["last"],
             "p50_ttft_s": sm[GAUGES.TTFT_S]["p50"],
             "prefill_s_p50": sm[GAUGES.PREFILL_S]["p50"],
             "wall_s": sm[GAUGES.WALL_S]["last"],
             "decode_steps": int(sm[GAUGES.DECODE_STEPS]["total"]),
             "full_prefills": full_prefills, "launches": launches,
             "prefill_flash": layers_of["flash_attention"],
             "peak_mem_gb": peak_gb, "card": smi}
    del engine
    if after is not None:
        serve.update(after(cfg, params))
    del params
    return serve, launches


def vlm_forward_check(cfg, params):
    """The full-width VLM's cross block made live (seeded gates of 0.5 to
    1.5 and seeded image embeddings, as the served mix, whose gates are the
    reference init's zeros and whose embeddings are zeros, never makes it):
    a bf16 prefill on the card gives finite logits, and each flash call of
    it (the 4 self-attention layers and the cross attention, Sq 512
    against 1600 patches) agrees with the plain version on its inputs
    within 2e-2 of the output's scale (the reference init's residual
    stream is far from unit scale at full width; one bf16 rounding of an
    output of 128 is 1.0)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn_mod
    from repro_torch.runtime import steps
    gen = torch.Generator(device="cuda").manual_seed(5)
    blk = params["blocks"]["4_cross"]
    for gate in ("gate_attn", "gate_mlp"):
        blk[gate].copy_(0.5 + torch.rand(blk[gate].shape, generator=gen,
                                         device="cuda"))
    img = torch.randn(1, cfg.num_patches, cfg.vision_dim, generator=gen,
                      device="cuda").bfloat16()
    toks = torch.randint(1, cfg.vocab_size, (1, PROMPT), generator=gen,
                         device="cuda")
    calls = []
    real = attn_mod.flash_attention

    def recording(q, k, v, **kw):
        out = real(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    attn_mod.flash_attention = recording
    try:
        with torch.inference_mode():
            last, _ = steps.prefill_step(cfg, params, toks,
                                         extras={"image_embeds": img})
            torch.cuda.synchronize()
            errs = []
            for q, k, v, kw, out in calls:
                want = fa.attention_plain(q, k, v, **kw).float()
                errs.append((out.float() - want).abs().max().item()
                            / max(1.0, want.abs().max().item()))
    finally:
        attn_mod.flash_attention = real
    cross = [i for i, c in enumerate(calls) if not c[3]["causal"]]
    finite = bool(torch.isfinite(last).all())
    log(f"[serve:{VLM}] live cross block (seeded gates and embeddings): "
        f"logits finite {finite}; flash vs plain on each of its "
        f"{len(calls)} calls: max error {max(errs):.3g} of the output's "
        f"scale (tolerance 2e-2), "
        f"the cross call (Sq {calls[cross[0]][0].shape[2]}, Sk "
        f"{calls[cross[0]][1].shape[2]}) {errs[cross[0]]:.3g}")
    if not (finite and len(calls) == cfg.num_layers and len(cross) == 1
            and max(errs) <= 2e-2):
        raise AssertionError(f"the VLM's live forward failed: finite "
                             f"{finite}, calls {len(calls)}, errs {errs}")
    return {"live_cross_max_err_of_scale": max(errs), "live_cross_calls":
            len(calls)}


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


# (arch, layers, pattern, seq) of each family phase_train_families trains:
# full depth but for gemma2 (14 of 42 layers, 7 local + 7 global: 9.24 B
# params with 12 bytes each of params, moments and grads do not fit the
# 80 GB card) and the VLM (one self- and one cross-attention layer at full
# width of its 100); whisper's seq is its encoder frames (30 s of audio),
# its tokens the decoder's 448
TRAIN_FAMILIES = ((GRANITE, 0, None, TRAIN_SEQ), (ZAMBA, 0, None, TRAIN_SEQ),
                  (RWKV, 0, None, TRAIN_SEQ), (WHISPER, 0, None, 1500),
                  (GEMMA2, 14, None, TRAIN_SEQ),
                  (VLM, 2, ("attn", "cross"), TRAIN_SEQ))
# 6 steps: at phase_train's lr (3e-4 after 2 warmup steps) the loss of
# rwkv6, gemma2 and the VLM rose at step 3 and fell below the first by
# step 5 on an H100 (PERF.md §6): Adam's first full-rate steps overshoot
# on wide layers under a random init
FAMILY_STEPS, FAMILY_K = 6, 2
# the smoke check's depth: zamba2 and the VLM at one layer of each kind,
# as tests/test_torch_train_families.py holds them against JAX (deeper,
# f32 rounding alone moves their grads by more than 1e-4 of a leaf)
SMOKE_CUTS = {ZAMBA: (2, ("mamba", "mamba_attn")), VLM: (2, ("attn", "cross")),
              GRANITE: (2, None), KIMI: (KIMI_TRAIN_LAYERS, None)}


def _train_counters():
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm, ssm_scan, wkv6, xent
    return {"xent_fwd": (xent, "fwd_launches"),
            "xent_bwd": (xent, "bwd_launches"),
            "adamw_update": (au, "launches"), "moe_gmm": (moe_gmm, "launches"),
            "ssd_scan": (ssm_scan, "launches"), "wkv6": (wkv6, "launches"),
            "flash_attention": (fa, "launches")}


def _read_counts(zero: bool = False) -> dict:
    out = {}
    for name, (mod, attr) in _train_counters().items():
        out[name] = getattr(mod, attr)
        if zero:
            setattr(mod, attr, 0)
    return out


def _family_launches(cfg, par, n_leaves: int, steps: int, T: int) -> dict:
    """The launches ``steps`` train steps of ``cfg`` imply, with remat:
    the loss's xent kernels once a 512-position chunk (one chunk when 512
    does not divide T; none on the sharded loss, plain math in the
    reference too), AdamW once a leaf, and per layer and step the scan
    twice (the forward and its recompute; the backward is plain) and gmm
    12 times (3 products forward, 3 recomputed, dx and dw of each)."""
    from repro_torch.runtime import steps as st
    par = st.train_par(par)
    sharded = (cfg.family != "audio" and cfg.vocab_size % 16 == 0
               and T % 16 == 0 and not par.pure_fsdp)
    chunks = 0 if sharded else (T // 512 if T % 512 == 0 else 1)
    fwd = 2 if par.remat else 1
    kinds = cfg.block_pattern * cfg.num_groups
    mamba = sum(k in ("mamba", "mamba_attn") for k in kinds)
    return {"xent_fwd": steps * chunks, "xent_bwd": steps * chunks,
            "adamw_update": steps * n_leaves,
            "moe_gmm": steps * kinds.count("moe") * 3 * (fwd + 2),
            "ssd_scan": steps * mamba * fwd,
            "wkv6": steps * kinds.count("rwkv") * fwd,
            "flash_attention": 0}


def _named(tree, prefix=""):
    """(path, tensor) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _train_smoke_check(arch) -> None:
    """The family's smoke config in f32: one batch's loss and every grad
    leaf on the card (the kernels, the gmm Function's backward launches,
    the scans' plain-recompute backward) against the CPU (the plain
    versions), on the same params: the loss within 1e-4 relative, each
    leaf within 1e-4 of its norm, and each kernel of the path launched as
    the code implies."""
    from repro_torch.launch.profile_train import train_setup
    from repro_torch.runtime import steps
    layers, pattern = SMOKE_CUTS.get(arch, (0, None))
    seq = 32
    cfg, par, _, params, _, chunk = train_setup(
        arch, layers=layers, pattern=pattern, seq=seq, batch=2, seed=1,
        device="cpu", smoke=True, dtype="float32")
    batch = steps._map(lambda t: torch.as_tensor(t)[0], chunk(0, 1))
    par = steps.train_par(par)
    got = {}
    for dev in ("cpu", "cuda"):
        _read_counts(zero=True)
        loss, grads = steps._value_and_grad(
            cfg, par, _to(params, dev), steps._batch_on(cfg, batch, dev))
        got[dev] = (loss.item(), {p: g.cpu() for p, g in _named(grads)})
        ran = _read_counts()
    T = steps.token_len(cfg, steps.ShapeConfig("t", seq, 2, "train"))
    want = _family_launches(cfg, par, 0, 1, T)
    ran = {k: v for k, v in ran.items() if k in ("moe_gmm", "ssd_scan",
                                                  "wkv6", "flash_attention")}
    want = {k: want[k] for k in ran}
    (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got["cuda"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    leaf_err = {p: ((g_card[p] - g).norm() / g.norm().clamp_min(1e-30)).item()
                for p, g in g_cpu.items()}
    worst = max(leaf_err, key=leaf_err.get)
    log(f"[train-families] {arch} smoke f32 ({cfg.num_layers} layers, "
        f"{cfg.block_pattern}), one batch card vs cpu: loss {l_card:.7f} vs "
        f"{l_cpu:.7f} (rel err {loss_err:.3g}, tolerance 1e-4); worst grad "
        f"leaf {worst} {leaf_err[worst]:.3g} of its norm (tolerance 1e-4); "
        f"launches {ran} (want {want})")
    if not (loss_err <= 1e-4 and leaf_err[worst] <= 1e-4):
        raise AssertionError(f"{arch} smoke train grads on the card disagree "
                             f"with the CPU")
    if ran != want:
        raise AssertionError(f"{arch} smoke train launches {ran} != {want}")


def phase_train_families(smi: str):
    """Training of the families the port used to serve only, and gemma2,
    on the card: for each, the smoke check (``_train_smoke_check``), then
    full width in bf16 with f32 moments, 6 steps as three train_chunk
    calls of 2 on TokenPipeline batches of 2 x 1024 tokens (whisper: 2 x 448,
    with 1500 frames), extras random normal from the seed, weights from
    ``profile_train.train_setup`` (the contracted attention init, the
    VLM's gates nonzero).  Each run's losses and grad norms are finite,
    its last loss is below its first, and every kernel launches as
    ``_family_launches`` implies.  Nothing is written to disk."""
    from repro_torch.configs import registry
    from repro_torch.launch.profile_train import train_setup
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps
    # phase_train's state, held by the checkpoint's reference cycles,
    # goes before the first family allocates
    gc.collect()
    torch.cuda.empty_cache()
    rows, launches = {}, {}
    for arch, layers, pattern, seq in TRAIN_FAMILIES:
        t_start = time.perf_counter()
        _train_smoke_check(arch)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg, par, ocfg, params, opt, chunk = train_setup(
            arch, layers=layers, pattern=pattern, seq=seq,
            batch=TRAIN_BATCH, seed=0)
        schema = steps._model_module(cfg).lm_schema(cfg)
        n_params, n_leaves = pr.param_count(schema), len(pr.leaves(schema))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _read_counts(zero=True)
        losses, norms, chunk_s = [], [], []
        for start in range(0, FAMILY_STEPS, FAMILY_K):
            batches = chunk(start, FAMILY_K)
            t0 = time.perf_counter()
            params, opt, ms = steps.train_chunk(cfg, par, ocfg, params, opt,
                                                batches)
            loss, norm = ms["loss"].cpu(), ms["grad_norm"].cpu()  # one sync
            chunk_s.append(time.perf_counter() - t0)
            losses.extend(loss.tolist())
            norms.extend(norm.tolist())
        ran = _read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        T = batches["tokens"].shape[-1]
        want = _family_launches(cfg, par, n_leaves, FAMILY_STEPS, T)
        step_ms = [1e3 * t / FAMILY_K for t in chunk_s]
        tokens = TRAIN_BATCH * T
        full_layers = registry.get_config(arch).num_layers
        depth = (f"{cfg.num_layers} of {full_layers} layers"
                 + (f", pattern {cfg.block_pattern}" if pattern else ""))
        log(f"[train-families] {arch} ({depth}, {n_params / 1e9:.3f} B "
            f"params, bf16): losses {[round(x, 4) for x in losses]}; grad "
            f"norms {[round(x, 4) for x in norms]}; ms a step by chunk "
            f"{step_ms}; {tokens * FAMILY_K / chunk_s[-1]:.0f} tokens/s "
            f"(last chunk); peak {peak_gb:.2f} GB; set-up {setup_s:.1f} s; "
            f"launches {ran}")
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"{arch}: a loss or grad norm is not finite")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: loss did not fall: {losses}")
        if ran != want:
            raise AssertionError(f"{arch} train launches {ran} != {want}")
        rows[arch] = {
            "layers": cfg.num_layers, "layers_full": full_layers,
            "pattern": list(cfg.block_pattern), "params_b": n_params / 1e9,
            "dtype": "bfloat16", "steps": FAMILY_STEPS, "batch": TRAIN_BATCH,
            "tokens_per_step": tokens,
            "frames": seq if cfg.family == "audio" else None,
            "remat": par.remat, "init": "contracted attention",
            "tokens_per_s": tokens * FAMILY_K / chunk_s[-1],
            "p50_step_ms": statistics.median(step_ms),
            "step_ms_by_chunk": step_ms, "losses": losses,
            "grad_norms": norms, "peak_mem_gb": peak_gb,
            "launches": ran, "phase_s": time.perf_counter() - t_start,
            "card": smi}
        launches[arch] = ran
        del params, opt, chunk, ms, batches
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


def _kimi_flash(smi: str) -> dict:
    """Flash at kimi's head dim 112 against its plain version: its prefill
    (B=1, H=64, KV=8, 512 tokens) in bf16, f16 and f32 (the CUDA-core
    kernel), a ragged Sq 96 against Sk 520, and B=4; the bf16 prefill timed
    warm and cold (rotating copies of q, k and v past L2) beside the plain
    version, SDPA and the bound."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(24)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    B, H, KV, Sq, Sk, dh = KIMI_ATTN
    cases = [KIMI_ATTN + (bf, 2e-2), KIMI_ATTN + (f16, 2e-2),
             KIMI_ATTN + (f32, 2e-5), (B, H, KV, 96, 520, dh, bf, 2e-2),
             (4, H, KV, Sq, Sk, dh, bf, 2e-2)]
    errs = {}
    for (b, h, kv, sq, sk, d, dtype, tol) in cases:
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, kv, sk, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, kv, sk, d, generator=gen, device="cuda").to(dtype)
        got = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, causal=True)
        err, row_err = _flash_errs(got, want)
        held = err if dtype == f32 else row_err
        shape = f"B={b} H={h} KV={kv} Sq={sq} Sk={sk} dh={d} {str(dtype)[6:]}"
        log(f"[kimi] flash_attention {shape} causal: max_abs_err={err:.3g}, "
            f"row-scaled {row_err:.3g} (tolerance {tol} "
            f"{'absolute' if dtype == f32 else 'of each row scale'})")
        if not held <= tol:
            raise AssertionError(f"flash at dh 112 disagrees with its plain "
                                 f"version at {shape}: {held} > {tol}")
        errs[shape] = err
        if len(errs) == 1:
            main = (q, k, v, err, shape)
        del got, want
    q, k, v, err, shape = main
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    copies = [(q, k, v)] + [tuple(torch.randn_like(t) for t in (q, k, v))
                            for _ in range(math.ceil(COLD_BYTES / nbytes))]
    ms_cold = _time_cold_ms(
        lambda a, b, c: fa.flash_attention(a, b, c, causal=True), copies)
    plain_ms = _time_ms(lambda: fa.attention_plain(q, k, v, causal=True))
    library_ms = _time_ms(_sdpa(q, k, v, True, None))
    bound_ms, bound_by = _attention_bound(*KIMI_ATTN, True, bf)
    log(f"[kimi] flash timed at {shape} causal: kernel {ms:.4f} ms warm, "
        f"{ms_cold:.4f} ms cold ({len(copies)} copies), plain {plain_ms:.4f} "
        f"ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, "
        f"{nbytes / 1e6:.2f} MB); {smi}")
    del copies, main, q, k, v
    torch.cuda.empty_cache()
    return {"shape": shape, "max_abs_err": err, "ms": ms, "ms_cold": ms_cold,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "edge_max_abs_err": errs}


def _kimi_quant() -> dict:
    """``quantize`` / ``dequantize`` on the card against the CPU, bit for
    bit, at kimi's leaf shapes: an expert slice (64, 7168, 2048) of the
    train cut, an attention slice (D, H, dh) whose last axis is not a 128
    multiple (one block a row), the router and norm slices and the tied
    embedding (163,840, 7168); values of a moment's scale."""
    from repro_torch.optim import quant
    gen = torch.Generator(device="cuda").manual_seed(25)
    shapes = [(KIMI_TRAIN_EXPERTS, 7168, 2048), (7168, 64, 112),
              (7168, KIMI_TRAIN_EXPERTS), (7168,), (163_840, 7168)]
    out = {}
    for shape in shapes:
        x = 1e-3 * torch.randn(shape, generator=gen, device="cuda")
        t0 = time.perf_counter()
        card = quant.quantize(x)
        back = quant.dequantize(card)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        xc = x.cpu()
        del x
        cpu = quant.quantize(xc)
        same = (torch.equal(card["q"].cpu(), cpu["q"])
                and torch.equal(card["s"].cpu().view(torch.int32),
                                cpu["s"].view(torch.int32))
                and torch.equal(back.cpu().view(torch.int32),
                                quant.dequantize(cpu).view(torch.int32)))
        log(f"[kimi] quantize/dequantize {shape}: card vs cpu "
            f"{'bit for bit' if same else 'DIFFER'} (card {card_s:.3f} s, "
            f"{len(card['s'].reshape(-1))} scales)")
        if not same:
            raise AssertionError(f"quantize on the card differs from the CPU "
                                 f"at {shape}")
        out[str(shape)] = same
        del card, back, xc, cpu
        torch.cuda.empty_cache()
    return out


def _kimi_update_check() -> dict:
    """One int8 + factored update on kimi's smoke config (2 layers: the
    expert leaves factored) card vs CPU from the same params, state and
    grads: int8 q equal but for +-1 flips, counted (under
    KIMI_FLIP_SHARE); s, vr and vc within KIMI_UPDATE_RTOL of each leaf's
    largest value (the factored means are sums in another order); params
    within 1e-6 but for 1 in 200, and all within lr / 20 (a q flip moves
    the next update by up to about lr / 127)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = registry.get_smoke(KIMI).replace(num_layers=KIMI_TRAIN_LAYERS)
    own = registry.get_optimizer(KIMI)
    ocfg = OptimizerConfig(warmup_steps=1, moment_dtype=own.moment_dtype,
                           second_moment=own.second_moment)
    schema = tfm.lm_schema(cfg)
    gen = torch.Generator().manual_seed(26)
    p0 = pr.init_params(schema, gen, "float32", "cpu")
    grads = [steps._map(lambda t: 0.01 * torch.randn(t.shape, generator=gen),
                        p0) for _ in range(2)]
    out = {}
    def copy(tree, dev):        # the update works in place on both
        return steps._map(lambda t: t.to(dev, copy=True), tree)
    for dev in ("cpu", "cuda"):
        p = copy(p0, dev)
        st = steps.init_opt_state(cfg, ocfg, dev)
        for g in grads:
            p, st, _ = adamw.apply_updates(schema, p, copy(g, dev), st, ocfg)
        out[dev] = {"p": p, "m": st["m"], "v": st["v"]}
    flips = total = far = n = 0
    worst = 0.0
    kinds = set()
    for (path, want), (_, got) in zip(_named(out["cpu"]), _named(out["cuda"])):
        got = got.cpu()
        kinds.add(path.rsplit("/", 1)[-1])
        diff = (got.float() - want.float()).abs()
        if path.endswith("/q"):
            if diff.max().item() > 1:
                raise AssertionError(f"kimi update {path}: q off by more "
                                     f"than 1")
            flips += int((diff > 0).sum())
            total += diff.numel()
        elif path.startswith("/p/"):
            # a q flip moves the next update by up to about lr / 127
            if diff.max().item() > ocfg.lr / 20:
                raise AssertionError(f"kimi update {path}: a param moved "
                                     f"more than lr / 20")
            far += int((diff > 1e-6).sum())
            n += diff.numel()
        else:
            rel = (diff.max() / want.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, rel)
            if rel > KIMI_UPDATE_RTOL:
                raise AssertionError(f"kimi update {path} card vs cpu "
                                     f"{rel:.3g} of its scale > "
                                     f"{KIMI_UPDATE_RTOL}")
    log(f"[kimi] int8 + factored update, smoke config x2 steps, card vs cpu: "
        f"{flips} of {total} q values one step apart (tolerance share "
        f"{KIMI_FLIP_SHARE}); s/vr/vc worst {worst:.3g} of the leaf's scale "
        f"(tolerance {KIMI_UPDATE_RTOL}); {far} of {n} params more than "
        f"1e-6 apart (tolerance share 5e-3); leaf kinds {sorted(kinds)}")
    if not {"q", "s", "vr", "vc"} <= kinds:
        raise AssertionError(f"the smoke state lacks a recipe leaf: {kinds}")
    if flips > KIMI_FLIP_SHARE * total or far > 5e-3 * n:
        raise AssertionError(f"kimi update: {flips} q flips of {total}, "
                             f"{far} params of {n} apart")
    return {"q_flips": flips, "q_values": total, "worst_rel": worst,
            "params_apart": far, "params": n}


def _kimi_gmm(recorder, smi: str) -> dict:
    """The grouped matmul at the bucket shapes the kimi serve run gave it
    (E 384; the prefill's and the decode's capacities; gate/up and out),
    on new random bf16 tensors (the served weights are freed): each held
    against its plain version and timed with full buckets as
    ``_gmm_timed`` times granite's, then at the occupancy its dispatch
    gave (``_gmm_occupancy``: NaN past the rows and in the empty experts,
    the bound over the occupied experts' weights)."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    out = {}
    for (E, C, D), (_, _, F) in sorted(recorder.shapes,
                                       key=lambda s: -s[0][1]):
        x = torch.randn(E, C, D, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(E, D, F, generator=gen, device="cuda").to(torch.bfloat16)
        label = (f"kimi {'prefill' if C > 1 else 'decode'} "
                 f"{'gate/up' if D == 7168 else 'out'} (E={E} C={C} D={D} "
                 f"F={F})")
        err = _gmm_hold(label, x, w, [("none", None)])["none"]
        log(f"[kimi] gmm {label}: max_abs_err={err:.3g}")
        torch.cuda.empty_cache()
        out[label] = dict(_gmm_timed(label, "fwd", x, w, None, err, gen),
                          card=smi)
        del x, w
        torch.cuda.empty_cache()
    out.update(_gmm_occupancy(KIMI, recorder, gen, smi))
    return out


def _fused_leaves(opt_schema) -> int:
    """Leaves whose m and v are both f32 tensors: AdamW's kernel takes
    them, the plain update the rest."""
    from repro_torch.models import params as pr
    from repro_torch.optim import adamw
    flat_m, flat_v = adamw._flat(opt_schema["m"]), adamw._flat(opt_schema["v"])
    return sum(isinstance(m, pr.PSpec) and isinstance(flat_v[k], pr.PSpec)
               and m.dtype == flat_v[k].dtype == "float32"
               for k, m in flat_m.items())


def _kimi_lr_witness(smi: str) -> dict:
    """kimi at full width cut to KIMI_TRAIN_LAYERS layers and
    KIMI_WITNESS_EXPERTS experts (f32 moments fit the card here), trained
    FAMILY_STEPS steps at phase_train's lr (3e-4) from one init and one
    batch stream, three ways: f32/full moments through AdamW's kernel, the
    same f32 moments through the plain update (``adamw._fused`` refused),
    and kimi's own int8 + factored recipe.  Checks: finite losses, the
    launches the code implies (AdamW's only in the first run), and the
    plain update's step-2 loss within KIMI_WITNESS_RTOL of the kernel's:
    one f32 update apart but for rounding.  Returns the three loss
    curves, so a jump at step 2 under the kernel too reads as the rate's,
    not the plain update's."""
    from repro_torch.launch.profile_train import train_setup
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    runs = {}
    for name, recipe, fused in (("float32/full, kernel", "float32", True),
                                ("float32/full, plain", "float32", False),
                                ("int8/factored", "int8", False)):
        cfg, par, ocfg, params, opt, chunk = train_setup(
            KIMI, layers=KIMI_TRAIN_LAYERS, experts=KIMI_WITNESS_EXPERTS,
            seq=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
        if recipe == "float32":
            del opt
            ocfg = dataclasses.replace(ocfg, moment_dtype="float32",
                                       second_moment="full")
            opt = steps.init_opt_state(cfg, ocfg, "cuda")
        schema = steps._model_module(cfg).lm_schema(cfg)
        n_fused = _fused_leaves(adamw.opt_state_schema(schema, ocfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _read_counts(zero=True)
        kernel_rule = adamw._fused
        if not fused:
            adamw._fused = lambda m, v: False
        losses, norms, t0 = [], [], time.perf_counter()
        try:
            for start in range(0, FAMILY_STEPS, FAMILY_K):
                batches = chunk(start, FAMILY_K)
                params, opt, ms = steps.train_chunk(cfg, par, ocfg, params,
                                                    opt, batches)
                losses.extend(ms["loss"].cpu().tolist())
                norms.extend(ms["grad_norm"].cpu().tolist())
        finally:
            adamw._fused = kernel_rule
        ran = _read_counts()
        want = _family_launches(cfg, par, n_fused if fused else 0,
                                FAMILY_STEPS, batches["tokens"].shape[-1])
        runs[name] = {"losses": losses, "grad_norms": norms,
                      "s_per_step": (time.perf_counter() - t0) / FAMILY_STEPS,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": ran}
        log(f"[kimi] lr witness ({cfg.num_layers} layers, "
            f"{cfg.moe.num_experts} experts, lr {ocfg.lr}, {name}): losses "
            f"{[round(x, 4) for x in losses]}; grad norms "
            f"{[round(x, 4) for x in norms]}; "
            f"{runs[name]['s_per_step']:.3f} s a step; peak "
            f"{runs[name]['peak_mem_gb']:.2f} GB; launches {ran} (want "
            f"{want}); {smi}")
        del params, opt, chunk, ms, batches
        gc.collect()
        torch.cuda.empty_cache()
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"kimi lr witness {name}: not finite")
        if ran != want:
            raise AssertionError(f"kimi lr witness {name}: launches {ran} "
                                 f"!= {want}")
    kernel = runs["float32/full, kernel"]["losses"]
    plain = runs["float32/full, plain"]["losses"]
    if abs(plain[1] - kernel[1]) > KIMI_WITNESS_RTOL * abs(kernel[1]):
        raise AssertionError(f"kimi lr witness: the plain update's step-2 "
                             f"loss {plain[1]} is not the kernel's "
                             f"{kernel[1]}")
    return {"layers": KIMI_TRAIN_LAYERS, "experts": KIMI_WITNESS_EXPERTS,
            "lr": ocfg.lr, "runs": runs, "card": smi}


def _state_bytes(cfg, par, ocfg) -> dict:
    """The dry run's count (``launch.dryrun`` on one card) of a train
    step's params, their grads (as many bytes) and optimizer state, and of
    the same with f32 moments."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps
    mesh = single_device_mesh()
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")

    def groups(oc):
        return dryrun.io_bytes(dryrun.step_io(cfg, par, oc, mesh, shape),
                               mesh)["bytes"]
    own = groups(ocfg)
    f32 = groups(dataclasses.replace(ocfg, moment_dtype="float32",
                                     second_moment="full"))
    n = pr.param_count(steps._model_module(cfg).lm_schema(cfg))
    return {"params_b": n / 1e9, "params_gb": own["params"] / 1e9,
            "grads_gb": own["params"] / 1e9,
            "opt_state_gb": own["opt_state"] / 1e9,
            "total_gb": (2 * own["params"] + own["opt_state"]) / 1e9,
            "f32_moments_total_gb": (2 * f32["params"]
                                     + f32["opt_state"]) / 1e9}


def phase_kimi(smi: str):
    """kimi-k2-1t-a32b on the card: flash at dh 112 (``_kimi_flash``), the
    quantization bit for bit (``_kimi_quant``); serving at full width cut
    to KIMI_SERVE_LAYERS layer through ``phase_serve`` (paged, prefix
    cache; paged tokens equal slotted, flash once a prefill layer, gmm 3
    times a layer a step) with every gmm bucket shape it ran recorded and
    then held against the plain version (``_kimi_gmm``); the smoke config's
    loss and grads card vs CPU (``_train_smoke_check``) and one int8 +
    factored update card vs CPU (``_kimi_update_check``); the lr witness
    (``_kimi_lr_witness``: f32 moments through AdamW's kernel and through
    the plain update, and the recipe, at 3e-4); then training at full
    width cut to KIMI_TRAIN_LAYERS layers and KIMI_TRAIN_EXPERTS
    experts under kimi's own recipe, bf16, 6 steps as three train_chunk
    calls of 2 on 2 x 1024 tokens at KIMI_LR with the contracted init:
    finite, falling losses, gmm 12 times a layer a step, and no xent
    or AdamW launch (the sharded loss is plain math, as in the reference;
    the int8 state takes the plain update).  Peak memory is printed beside
    the dry run's count of the state (``_state_bytes``), and f32 moments'
    bytes for the same cut.
    Nothing is written to disk; everything is freed before the next phase."""
    from repro_torch.configs import registry
    from repro_torch.launch.profile_train import train_setup
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    flash = _kimi_flash(smi)
    quant = _kimi_quant()

    # serving, with every gmm shape and one prefill's and one decode
    # step's rows recorded
    with _GmmRecorder(3 * KIMI_SERVE_LAYERS) as recorder:
        serve, ran, _ = phase_serve(smi, KIMI, layers=KIMI_SERVE_LAYERS,
                                    before_run=recorder.arm)
    seen = recorder.shapes
    full = registry.get_config(KIMI)
    log(f"[kimi] serve at {KIMI_SERVE_LAYERS} of {full.num_layers} layers: "
        f"{serve['tok_s']:.1f} tok/s, p50 TTFT {serve['p50_ttft_s']:.4f} s, "
        f"peak {serve['peak_mem_gb']:.2f} GB (arithmetic: 18.2 B params, "
        f"36.4 GB in bf16); gmm bucket shapes {sorted(seen)}; {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    gmm = _kimi_gmm(recorder, smi)

    # training: the smoke checks, then the full-width cut
    _train_smoke_check(KIMI)
    update = _kimi_update_check()
    witness = _kimi_lr_witness(smi)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, par, ocfg, params, opt, chunk = train_setup(
        KIMI, layers=KIMI_TRAIN_LAYERS, experts=KIMI_TRAIN_EXPERTS,
        seq=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    ocfg = dataclasses.replace(ocfg, lr=KIMI_LR)
    schema = steps._model_module(cfg).lm_schema(cfg)
    opt_schema = adamw.opt_state_schema(schema, ocfg)
    arith = _state_bytes(cfg, par, ocfg)
    fused = _fused_leaves(opt_schema)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _read_counts(zero=True)
    losses, norms, chunk_s = [], [], []
    for start in range(0, FAMILY_STEPS, FAMILY_K):
        batches = chunk(start, FAMILY_K)
        t0 = time.perf_counter()
        params, opt, ms = steps.train_chunk(cfg, par, ocfg, params, opt,
                                            batches)
        loss, norm = ms["loss"].cpu(), ms["grad_norm"].cpu()   # one sync
        chunk_s.append(time.perf_counter() - t0)
        losses.extend(loss.tolist())
        norms.extend(norm.tolist())
    ran_train = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    T = batches["tokens"].shape[-1]
    want = _family_launches(cfg, par, fused, FAMILY_STEPS, T)
    step_ms = [1e3 * t / FAMILY_K for t in chunk_s]
    tokens = TRAIN_BATCH * T
    log(f"[kimi] train ({cfg.num_layers} of {full.num_layers} layers, "
        f"{cfg.moe.num_experts} of {full.moe.num_experts} experts, top-"
        f"{cfg.moe.top_k}, {arith['params_b']:.3f} B params, bf16, moments "
        f"{ocfg.moment_dtype} + {ocfg.second_moment}): losses "
        f"{[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in norms]}; ms a step by chunk {step_ms}; "
        f"{tokens * FAMILY_K / chunk_s[-1]:.0f} tokens/s (last chunk); "
        f"{held_gb:.2f} GB held before the steps, peak {peak_gb:.2f} GB "
        f"against the dry run's count {arith['total_gb']:.2f} GB (params "
        f"{arith['params_gb']:.2f} + grads {arith['grads_gb']:.2f} + state "
        f"{arith['opt_state_gb']:.2f}); f32 moments would need "
        f"{arith['f32_moments_total_gb']:.2f} GB for the same cut; set-up "
        f"{setup_s:.1f} s; launches {ran_train} (want {want}); {smi}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("kimi: a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"kimi: loss did not fall: {losses}")
    if ran_train != want:
        raise AssertionError(f"kimi train launches {ran_train} != {want}")
    del params, opt, chunk, ms, batches
    gc.collect()
    torch.cuda.empty_cache()
    row = {"serve": serve, "train": {
        "layers": cfg.num_layers, "layers_full": full.num_layers,
        "experts": cfg.moe.num_experts, "experts_full": full.moe.num_experts,
        "params_b": arith["params_b"], "dtype": "bfloat16",
        "moments": f"{ocfg.moment_dtype}/{ocfg.second_moment}",
        "steps": FAMILY_STEPS, "batch": TRAIN_BATCH, "tokens_per_step": tokens,
        "lr": ocfg.lr,
        "init": "contracted attention", "losses": losses, "grad_norms": norms,
        "tokens_per_s": tokens * FAMILY_K / chunk_s[-1],
        "p50_step_ms": statistics.median(step_ms), "step_ms_by_chunk": step_ms,
        "held_gb": held_gb, "peak_mem_gb": peak_gb, "arithmetic": arith,
        "launches": ran_train, "card": smi},
        "update_card_vs_cpu": update, "lr_witness": witness,
        "quant_bit_for_bit": quant,
        "gmm_shapes": sorted(seen), "phase_s": time.perf_counter() - t_start,
        "card": smi}
    return row, flash, gmm, ran, ran_train


# allocated growth may exceed the pass's argument bytes by the caching
# allocator's rounding of each tensor up to a multiple of this, no more
ALLOC_ROUND_BYTES = 512


def _dryrun_sweep() -> dict:
    """The meta pass over ``registry.cells()`` on the single-pod mesh, one
    record a cell, kept in memory."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    recs, failures = [], []
    t0 = time.perf_counter()
    for arch, shape, _ in registry.cells():
        try:
            recs.append(dryrun.run_cell(arch, shape.name, mesh=mesh,
                                        verbose=False))
        except Exception as e:          # a failure here is a bug in the port
            failures.append(f"{arch}__{shape.name}__{mesh.tag}: {e!r}")
    seconds = time.perf_counter() - t0
    ratios = [r["counted_over_analytic"] for r in recs]
    biggest = max(recs, key=lambda r: r["per_device_bytes"])
    out = {"cells": len(registry.cells()), "records": len(recs),
           "failures": failures, "mesh": mesh.tag,
           "max_per_device_bytes": biggest["per_device_bytes"],
           "max_per_device_cell": f"{biggest['arch']} x {biggest['shape']}",
           "min_counted_over_analytic": min(ratios),
           "max_counted_over_analytic": max(ratios),
           "seconds": seconds}
    log(f"[dryrun] {out['records']} of {out['cells']} cells on {mesh.tag}, "
        f"{len(failures)} failures; largest per_device_bytes "
        f"{out['max_per_device_bytes'] / 2**30:.3f} GiB "
        f"({out['max_per_device_cell']}); counted/analytic "
        f"{out['min_counted_over_analytic']:.4f}-"
        f"{out['max_counted_over_analytic']:.4f}; {seconds:.1f} s")
    if failures or len(recs) != out["cells"]:
        raise AssertionError(f"dry run failures: {failures}")
    return out


def _dryrun_hold(name, shape, allocate, smi) -> dict:
    """The pass's argument bytes at one card against the allocated growth
    when the port allocates the same arguments: ``allocate()`` returns
    (the tensors, cfg, par, ocfg) and the pass counts that cfg's step."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import single_device_mesh
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    held, cfg, par, ocfg = allocate()
    gc.collect()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    del held
    gc.collect()
    torch.cuda.empty_cache()
    mesh = single_device_mesh()
    io = dryrun.step_io(cfg, par, ocfg, mesh, shape)
    want = dryrun.io_bytes(io, mesh)
    n_leaves = sum(1 for tree, axes in io.args.values()
                   for _ in dryrun.leaves(tree, axes))
    gap = grown - want["argument_bytes"]
    bound = ALLOC_ROUND_BYTES * n_leaves
    row = {"case": name, "shape": [shape.global_batch, shape.seq_len,
                                   shape.kind],
           "recipe": f"{ocfg.moment_dtype}/{ocfg.second_moment}",
           "argument_bytes": want["argument_bytes"], "bytes": want["bytes"],
           "allocated_growth": grown, "gap_bytes": gap, "leaves": n_leaves,
           "gap_bound_bytes": bound,
           "rel_gap": gap / want["argument_bytes"], "card": smi}
    log(f"[dryrun] {name}: the pass's argument bytes "
        f"{want['argument_bytes']} ({want['bytes']}) vs allocated growth "
        f"{grown}: gap {gap} bytes (allowed 0 to {bound}: "
        f"{ALLOC_ROUND_BYTES} a leaf, {n_leaves} leaves); {smi}")
    if not 0 <= gap <= bound:
        raise AssertionError(f"dry run bytes for {name}: {row}")
    return row


def phase_dryrun(smi: str, train: dict):
    """The dry run (``launch.dryrun``): the meta pass over every cell on
    the single-pod mesh (``_dryrun_sweep``); its argument bytes at one
    card held against what the port allocates (``_dryrun_hold``): phi4's
    train state as phase_train holds it (bf16 params, f32 moments, one
    batch), kimi's train cut (2 layers x 64 experts, int8 + factored; both
    from ``profile_train.train_setup``) and kimi's 1-layer serving params
    and slotted cache; then phase_train's measured ms a step beside the
    step FLOPs ``roofline.flops.accounting`` gives at its shape on one
    chip: the analytic TFLOP/s (those FLOPs over the measured step, which
    counts full-context attention scores where the flash kernel skips the
    masked tiles) and the model-FLOPs share of 989 TFLOP/s (information,
    not a limit)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.profile_train import train_setup
    from repro_torch.models import params as pr
    from repro_torch.roofline import flops as flops_mod
    from repro_torch.runtime import steps
    t_start = time.perf_counter()
    sweep = _dryrun_sweep()
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")

    def train_state(arch, layers, experts):
        def allocate():
            cfg, par, ocfg, params, opt, chunk = train_setup(
                arch, layers=layers, experts=experts, seq=TRAIN_SEQ,
                batch=TRAIN_BATCH, seed=0)
            one = chunk(0, 1)
            batch = {k: torch.as_tensor(one[k][0]).to("cuda")
                     for k in ("tokens", "labels")}
            return (params, opt, batch), cfg, par, ocfg
        return allocate

    holds = [
        _dryrun_hold(f"{ARCH} train", shape, train_state(ARCH, 0, 0), smi),
        _dryrun_hold(f"{KIMI} train ({KIMI_TRAIN_LAYERS} layers, "
                     f"{KIMI_TRAIN_EXPERTS} experts)", shape,
                     train_state(KIMI, KIMI_TRAIN_LAYERS, KIMI_TRAIN_EXPERTS),
                     smi)]

    def allocate_serve():
        cfg = registry.get_config(KIMI).replace(num_layers=KIMI_SERVE_LAYERS)
        params = pr.init_params(
            steps._model_module(cfg).lm_schema(cfg),
            torch.Generator(device="cuda").manual_seed(0), cfg.param_dtype,
            "cuda")
        cache = steps.init_cache(cfg, SLOTS, PROMPT + GEN, "cuda")
        token = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
        pos = torch.zeros((), dtype=torch.int32, device="cuda")
        return ((params, cache, token, pos), cfg,
                registry.get_parallel(KIMI), registry.get_optimizer(KIMI))
    holds.append(_dryrun_hold(
        f"{KIMI} serve ({KIMI_SERVE_LAYERS} layer, {SLOTS} slots of "
        f"{PROMPT + GEN})", ShapeConfig("serve", PROMPT + GEN, SLOTS,
                                        "decode"), allocate_serve, smi))

    # the analytic step FLOPs over phase_train's measured phi4 step
    acc = flops_mod.accounting(registry.get_config(ARCH), shape, 1,
                               registry.get_optimizer(ARCH))
    step_s = train["p50_step_ms"] / 1e3
    analytic = acc.step_flops_global / step_s
    share = acc.model_flops / step_s / PEAK_FLOPS[torch.bfloat16]
    rate = {"arch": ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "p50_step_ms": train["p50_step_ms"],
            "step_flops": acc.step_flops_global,
            "model_flops": acc.model_flops,
            "analytic_tflops": analytic / 1e12,
            "model_flops_share": share, "card": smi}
    log(f"[dryrun] {ARCH} train at {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"{train['p50_step_ms']:.1f} ms a step (phase_train's p50), "
        f"{acc.step_flops_global:.4e} step FLOPs (roofline.flops, 1 chip) "
        f"-> {analytic / 1e12:.1f} analytic TFLOP/s; model FLOPs "
        f"{acc.model_flops:.4e} -> {100 * share:.2f} % of 989 TFLOP/s; "
        f"{smi}")
    return {"sweep": sweep, "bytes": holds, "phi4_rate": rate,
            "phase_s": time.perf_counter() - t_start, "card": smi}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit pattern, so equality is bitwise (NaNs included)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def phase_elastic(smi: str):
    """phi4 at full width and 2 layers in bf16 trains through the elastic
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
    cfg = registry.get_config(ARCH).replace(num_layers=ELASTIC_PHASE_LAYERS)
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
        "arch": ARCH, "layers": ELASTIC_PHASE_LAYERS, "params_b": n_params / 1e9,
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
    log(f"[elastic] {ARCH} at {ELASTIC_PHASE_LAYERS} layers ({n_params / 1e9:.3f} B "
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


# ----------------------------------------------------------------- tenant
# tenant phase: a fabric of logical slots on the card (gpu 2, edge 1, hub
# 1; time_scale 0) under one started FairShareScheduler with a
# FederatedStore.  phi4 smoke trains TENANT_STEPS steps of FABRIC_BATCH x
# FABRIC_SEQ, saving every TENANT_CKPT; a priority-10 surge of
# TENANT_SURGE_DEVICES gpu slots fires once elastic/step reaches
# TENANT_BURST_AT.  The replicated ServeJob queues TENANT_REPLICA_REQUESTS
# (desired 2 at a backlog of ROUTER_BACKLOG a replica).
TENANT_SITES = (("gpu", 2), ("edge", 1), ("hub", 1))
TENANT_STEPS, TENANT_CKPT, TENANT_BURST_AT = 12, 2, 3
TENANT_SURGE_DEVICES, TENANT_REPLICA_REQUESTS = 2, 8
# the scenario: tests/test_scenarios.py's shape (3 windows over 120 sim-s,
# an edge kill and a gpu-hub brown-out at 50 s, restored at 110 and 100)
SCENARIO_HORIZON, SCENARIO_WINDOWS = 120.0, 3


def _tenant_fabric(root):
    from repro_torch.fabric import Fabric, FederatedStore
    from repro_torch.vcluster import FairShareScheduler
    fabric = Fabric(time_scale=0.0, device="cuda")
    for name, slots in TENANT_SITES:
        fabric.add_site(name, devices=list(range(slots)),
                        store_root=f"{root}/{name}")
    fabric.connect("gpu", "edge", gbps=10.0, latency_ms=1.0)
    fabric.connect("gpu", "hub", gbps=1.0, latency_ms=5.0)
    fabric.connect("edge", "hub", gbps=1.0, latency_ms=5.0)
    sched = FairShareScheduler(fed=FederatedStore(fabric), reconcile_s=0.02,
                               preempt_grace_s=60.0)
    sched.bus.attach_fabric(fabric)
    return fabric, sched


def _tenant_train_manifest(name, root):
    return {"kind": "TrainJob", "metadata": {"name": name},
            "spec": {"arch": ARCH, "smoke": True,
                     "steps": TENANT_STEPS, "seq_len": FABRIC_SEQ,
                     "global_batch": FABRIC_BATCH, "base_shape": [1, 1],
                     "max_data": 1, "ckpt_every": TENANT_CKPT,
                     "keep": None, "log_every": 1,
                     "ckpt_dir": f"{root}/ckpt-{name}",
                     "rejoin_timeout_s": 300.0, "verbose": False,
                     "site": "gpu", "devices": 1, "min_devices": 0,
                     "optimizer": {"warmup_steps": 2, "decay_steps": 100}}}


def phase_tenant(smi: str, phi4_run):
    """Phase 15: the tenant backend on the card.  A fabric of logical
    slots (gpu 2, edge 1, hub 1) under a started FairShareScheduler, every
    workload a manifest through ``Session(tenant=)``: a. tenant ``chat``
    (priority 5) serves full-width phi4, 8 requests of 512 tokens, tokens
    equal to the serve phase's, flash 32 a prefill; b. tenant ``ops``
    holds a gpu slot with a gated BatchJob while ``chat`` applies a 1 to 2
    replica phi4 ServeJob: the autoscaler asks for 2 and the claim grants
    1 (the replicas gauge stays 1) until ``ops`` finishes; c. tenant
    ``research`` (priority 0) trains phi4 smoke on a claim of 1 gpu slot,
    preempted once by tenant ``surge`` (priority 10, 2 gpu slots) at step
    >= TENANT_BURST_AT, resumed, every step's loss equal bit for bit to an
    unpreempted run's; d. ``lease_device_s/tenant-<t>`` billed for every
    tenant within its wall time x slots; e. ``run_scenario`` (3 windows,
    chat's waves full-width phi4, research's smoke TrainJob, an edge kill
    and a gpu-hub brown-out mid-wave, both restored): every tenant graded,
    every chaos event applied."""
    import tempfile
    import threading

    from repro_torch.configs import registry
    from repro_torch.kernels import adamw_update as au
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import xent
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.scenarios import (SLO, ChaosEvent, ChaosSchedule,
                                       DiurnalRate, ScenarioSpec, ServePlan,
                                       TrafficShape, TrainPlan, grade_table,
                                       run_scenario)
    from repro_torch.serving.report import GAUGES
    from repro_torch.vcluster import TenantSpec
    from repro_torch.api import Session

    cfg = registry.get_config(ARCH)
    n_leaves = len(pr.leaves(tfm.lm_schema(registry.get_smoke(ARCH))))
    xent_per_step = max(FABRIC_SEQ // 512, 1)      # one loss chunk a step

    def zero():
        fa.launches = xent.fwd_launches = xent.bwd_launches = au.launches = 0

    def counts():
        return {"flash_attention": fa.launches, "xent_fwd": xent.fwd_launches,
                "xent_bwd": xent.bwd_launches, "adamw_update": au.launches}

    def clear():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    def serve_manifest(name, **spec):
        return {"kind": "ServeJob", "metadata": {"name": name},
                "spec": {"arch": ARCH, "smoke": False, "prompt_len": PROMPT,
                         "max_new_tokens": GEN, "slots": SLOTS,
                         "paged": True, "block_size": BLOCK,
                         "prefix_cache": True, "seed": 0, **spec}}

    t_phase = time.perf_counter()
    out_rows, launches = {}, {}
    walls = {}                  # tenant -> [first apply, last terminal]

    def span(tenant, h):
        evs = h.events()
        w = walls.setdefault(tenant, [evs[0]["ts"], evs[-1]["ts"]])
        w[0], w[1] = min(w[0], evs[0]["ts"]), max(w[1], evs[-1]["ts"])

    with tempfile.TemporaryDirectory(prefix="chip-smoke-tenant-") as root:
        fabric, sched = _tenant_fabric(root)
        sched.start()
        try:
            chat = Session(tenant=sched.create_tenant(
                TenantSpec("chat", priority=5)))
            ops = Session(tenant=sched.create_tenant(
                TenantSpec("ops", priority=5)))
            research = Session(tenant=sched.create_tenant(
                TenantSpec("research", priority=0)))
            surge = Session(tenant=sched.create_tenant(
                TenantSpec("surge", priority=10, preemptible=False)))

            # a. full-width phi4 through the tenant's fair share
            clear()
            zero()
            reqs = _requests(cfg.vocab_size)
            h = chat.apply(serve_manifest("chip-smoke-tenant-serve",
                                          requests=reqs))
            got = h.wait(900)
            ran = counts()
            evs = h.events()
            running = next(e["ts"] for e in evs if e["state"] == "Running")
            sm = got["metrics"].summary()
            prefills = int(sm[GAUGES.PREFILL_S]["count"])
            results = got["results"]
            row = {"workload": h.spec.name, "state": h.state.value,
                   "site": got["site"], "lifecycle": _lifecycle(evs),
                   "apply_to_running_s": running - evs[0]["ts"],
                   "wall_s": evs[-1]["ts"] - evs[0]["ts"],
                   "tok_s": sm[GAUGES.TOK_S]["last"],
                   "p50_ttft_s": sm[GAUGES.TTFT_S]["p50"],
                   "prefills": prefills, "launches": ran,
                   "stop_lengths": [len(results.get(r["id"], []))
                                    for r in reqs],
                   "peak_gb": peak_gb(), "card": smi}
            span("chat", h)
            chat.forget(h)
            del got, h
            equal = sum(results.get(i) == v
                        for i, v in phi4_run["results"].items())
            row["tokens_equal_serve_phase"] = \
                f"{equal}/{len(phi4_run['results'])}"
            log(f"[tenant] a. serve {ARCH} as chat at {row['site']}: "
                f"{row['state']} {row['lifecycle']}, apply -> Running "
                f"{row['apply_to_running_s']:.3f} s, {row['tok_s']:.1f} tok/s,"
                f" p50 TTFT {row['p50_ttft_s']:.3f} s, flash "
                f"{ran['flash_attention']} over {prefills} prefills, tokens "
                f"equal to the serve phase's "
                f"{row['tokens_equal_serve_phase']}, peak "
                f"{row['peak_gb']:.2f} GB")
            if row["state"] != "Succeeded" or row["stop_lengths"] != [
                    r["max_new_tokens"] for r in reqs]:
                raise AssertionError(f"tenant serve: {row}")
            if ran["flash_attention"] != cfg.num_layers * prefills:
                raise AssertionError(f"tenant serve: flash {ran} over "
                                     f"{prefills} prefills")
            if equal != len(phi4_run["results"]):
                raise AssertionError(f"tenant serve: tokens equal the serve "
                                     f"phase's on {equal}/"
                                     f"{len(phi4_run['results'])}")
            out_rows["serve"], launches["serve"] = row, ran

            # b. claim-capped scale-up: ops holds one gpu slot
            clear()
            zero()
            gate = threading.Event()

            def hold(ctx):
                while not gate.is_set() and not ctx.should_stop():
                    time.sleep(0.01)
                return "released"

            sub = sched.bus.subscribe(maxlen=1_000_000)
            hold_h = ops.apply({"kind": "BatchJob",
                                "metadata": {"name": "chip-smoke-ops-hold"},
                                "spec": {"devices_per_pod": 1, "site": "gpu"}},
                               fn=hold)
            deadline = time.monotonic() + 60
            while hold_h.state.value != "Running":
                if time.monotonic() > deadline:
                    raise AssertionError(f"tenant ops: {hold_h.events()}")
                time.sleep(0.01)
            capped = {}

            def watch(h):
                # release ops once the autoscaler asked for 2 and got 1
                while not gate.is_set():
                    for e in sub.poll(timeout=0.05):
                        d = e.data
                        if e.kind == "sched" and e.source == "chat" and \
                                d.get("action") == "resized" and \
                                d.get("want") == 2 and d.get("granted") == 1:
                            capped.update(
                                t=time.monotonic(),
                                replicas=h.status().observed.get("replicas"))
                            gate.set()
                            break
                    if h.state.value in ("Succeeded", "Failed"):
                        gate.set()

            rep_reqs = _requests(cfg.vocab_size, TENANT_REPLICA_REQUESTS)
            h = chat.apply(serve_manifest(
                "chip-smoke-tenant-replicated", requests=rep_reqs,
                site="gpu", min_replicas=1, max_replicas=2,
                target_backlog=ROUTER_BACKLOG))
            watcher = threading.Thread(target=watch, args=(h,), daemon=True)
            watcher.start()
            got = h.wait(900)
            watcher.join(timeout=60)
            hold_out = hold_h.wait(120)
            ran = counts()
            sub.close()
            scale = [e["replicas"] for e in h.events() if "replicas" in e]
            results = got["results"]
            rrow = {"workload": h.spec.name, "state": h.state.value,
                    "capped_at": capped, "replicas_details": scale,
                    "replicas_max": int(got["metrics"].series(
                        GAUGES.REPLICAS).max),
                    "scale_events": [list(e[1:]) for e in
                                     got["scale_events"]],
                    "ops": hold_out["results"],
                    "second_replica_started": "2→2" in scale,
                    "stop_lengths": [len(results.get(r["id"], []))
                                     for r in rep_reqs],
                    "launches": ran,
                    "wall_s": h.events()[-1]["ts"] - h.events()[0]["ts"],
                    "peak_gb": peak_gb(), "card": smi}
            span("chat", h)
            span("ops", hold_h)
            chat.forget(h)
            del got, h
            log(f"[tenant] b. replicated serve: {rrow['state']}; the "
                f"autoscaler asked for 2 against ops' slot, granted 1, "
                f"replicas then {capped.get('replicas')}; replica details "
                f"{scale}; scale events {rrow['scale_events']}; ops "
                f"{rrow['ops']}; flash {ran['flash_attention']}")
            if rrow["state"] != "Succeeded" or rrow["stop_lengths"] != [
                    r["max_new_tokens"] for r in rep_reqs]:
                raise AssertionError(f"tenant replicated: {rrow}")
            if not capped or capped["replicas"] != 1 or \
                    rrow["ops"] != ["released"]:
                raise AssertionError(f"tenant replicated: the claim never "
                                     f"capped the scale-up: {rrow}")
            out_rows["replicated"], launches["replicated"] = rrow, ran

            # c. preemption and resume against unpreempted runs: one
            # before (its losses; it also takes the first training's
            # start-up costs) and one after (the wall to compare with)
            clear()

            def train(name):
                h = research.apply(_tenant_train_manifest(name, root))
                got = h.wait(900)
                evs = h.events()
                span("research", h)
                research.forget(h)
                return got, evs[-1]["ts"] - evs[0]["ts"]

            clean, _ = train("chip-smoke-tenant-train-clean")
            fired = {}

            def burst():
                while sched.metrics.series("elastic/step").last < \
                        TENANT_BURST_AT:
                    time.sleep(0.005)
                hb = surge.apply({"kind": "BatchJob",
                                  "metadata": {"name": "chip-smoke-surge"},
                                  "spec": {"devices_per_pod":
                                           TENANT_SURGE_DEVICES,
                                           "priority": 10, "site": "gpu"}},
                                 fn=lambda ctx: time.sleep(0.3) or "surge")
                fired["out"] = hb.wait(600)
                fired["state"] = hb.state.value
                span("surge", hb)

            sched.metrics.gauge("elastic/step", -1)   # not the clean run's
            zero()
            burster = threading.Thread(target=burst, daemon=True)
            burster.start()
            got, pre_wall = train("chip-smoke-tenant-train")
            burster.join(timeout=600)
            ran_pre = counts()
            rep = got["report"]
            _, clean_wall = train("chip-smoke-tenant-train-clean-2")
            losses = [got["loss_by_step"][i] for i in range(TENANT_STEPS)]
            want = [clean["loss_by_step"][i] for i in range(TENANT_STEPS)]
            executed = rep.steps_executed
            trow = {"state": "Succeeded", "surge": fired.get("state"),
                    "segments": [[s.start, s.end, s.outcome]
                                 for s in rep.segments],
                    "steps_executed": executed, "steps_lost": rep.steps_lost,
                    "recoveries": rep.recoveries,
                    "preemptions": int(sched.metrics.series(
                        "elastic/preemptions").total),
                    "segment_t_first_s": [round(s.t_first_s, 4)
                                          for s in rep.segments],
                    "wall_s": pre_wall, "unpreempted_wall_s": clean_wall,
                    "preemption_cost_s": pre_wall - clean_wall,
                    "losses": losses,
                    "losses_equal_unpreempted": losses == want,
                    "max_abs_diff": max(abs(a - b)
                                        for a, b in zip(losses, want)),
                    "launches": ran_pre,
                    "card": smi}
            del got, clean
            log(f"[tenant] c. train {ARCH} smoke as research: segments "
                f"{trow['segments']}, surge {trow['surge']}, executed "
                f"{executed}, lost {rep.steps_lost}, first-chunk seconds a "
                f"segment {trow['segment_t_first_s']}, wall {pre_wall:.2f} s "
                f"against {clean_wall:.2f} s unpreempted, launches {ran_pre}; "
                f"losses equal to an unpreempted run's "
                f"{trow['losses_equal_unpreempted']} (max diff "
                f"{trow['max_abs_diff']:.3g})")
            outcomes = [s.outcome for s in rep.segments]
            if trow["surge"] != "Succeeded" or \
                    outcomes.count("preempted") != 1 or \
                    outcomes[-1] != "done" or rep.steps_lost > 2 or \
                    not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"tenant train: {trow}")
            if not trow["losses_equal_unpreempted"]:
                raise AssertionError(f"tenant train: losses {losses} != "
                                     f"unpreempted {want}")
            want_ran = {"flash_attention": 0,
                        "xent_fwd": executed * xent_per_step,
                        "xent_bwd": executed * xent_per_step,
                        "adamw_update": executed * n_leaves}
            if ran_pre != want_ran:
                raise AssertionError(f"tenant train: launches {ran_pre} != "
                                     f"{want_ran}")
            out_rows["train"], launches["train"] = trow, ran_pre

            # d. lease billing per tenant
            slots = {"chat": 1, "ops": 1, "research": 1,
                     "surge": TENANT_SURGE_DEVICES}
            bill = {}
            for t, (t0, t1) in walls.items():
                billed = sched.metrics.series(
                    f"lease_device_s/tenant-{t}").total
                bill[t] = {"device_s": billed, "wall_s": t1 - t0,
                           "slots": slots[t]}
                if not 0 < billed <= (t1 - t0) * slots[t]:
                    raise AssertionError(f"tenant billing {t}: {bill[t]}")
            log(f"[tenant] d. lease_device_s by tenant: " + ", ".join(
                f"{t} {b['device_s']:.3f} (wall {b['wall_s']:.2f} s x "
                f"{b['slots']})" for t, b in bill.items()))
            out_rows["billing"] = bill
            out_rows["bytes_written"] = _tree_bytes(root)
        finally:
            sched.stop()

        # e. the scenario, on a fresh fabric and scheduler
        clear()
        zero()
        fabric, sched = _tenant_fabric(f"{root}/scenario")
        sched.create_tenant(TenantSpec("research", priority=0))
        sched.create_tenant(TenantSpec("chat", priority=5))
        spec = ScenarioSpec(
            name="chip-smoke-chaos", horizon_s=SCENARIO_HORIZON,
            windows=SCENARIO_WINDOWS,
            slos={"chat": SLO(p99_ttft_s=60.0, p99_latency_s=120.0,
                              min_goodput=0.5)})
        serve = {"chat": ServePlan(
            shape=TrafficShape(
                name="chat",
                rate=DiurnalRate(base_rps=0.05, peak_rps=0.15,
                                 period_s=SCENARIO_HORIZON),
                zipf_a=1.7, max_prompt_len=16, gen_mu=1.3, gen_sigma=0.5,
                max_new_tokens=8, seed=5),
            manifest={"kind": "ServeJob", "metadata": {"name": "chat"},
                      "spec": {"arch": ARCH, "smoke": False, "slots": 2,
                               "prompt_len": 16, "max_new_tokens": 8,
                               "lease_timeout": 60.0}})}
        train = {"research": TrainPlan(manifest=_tenant_train_manifest(
            "chip-smoke-scenario-train", root))}
        chaos = ChaosSchedule([
            ChaosEvent(at_s=50.0, kind="site-kill", site="edge"),
            ChaosEvent(at_s=50.0, kind="link-degrade", link=("gpu", "hub"),
                       gbps=0.05),
            ChaosEvent(at_s=100.0, kind="link-restore", link=("gpu", "hub")),
            ChaosEvent(at_s=110.0, kind="site-restore", site="edge"),
        ])
        sub = sched.bus.subscribe(maxlen=1_000_000)
        with sched:
            result = run_scenario(sched, spec, serve=serve, train=train,
                                  chaos=chaos, wave_timeout_s=900.0,
                                  train_timeout_s=900.0)
        ran = counts()
        moves = [(e.source, e.data["action"], e.data.get("site"))
                 for e in sub.poll(0) if e.kind == "sched" and
                 e.data.get("action") in ("placed", "requeued", "preempt")]
        sub.close()
        table = grade_table(list(result.grades.values()))
        log(table)
        g = result.grades["chat"]
        applied = [(r["kind"], r.get("site") or tuple(r.get("link") or ()))
                   for r in result.chaos_fired if r["applied"]]
        srow = dict(result.report(), waves=result.waves, placements=moves,
                    launches=ran,
                    train_steps_executed=result.train_results["research"][
                        "report"].steps_executed, card=smi)
        log(f"[tenant] e. scenario: {len(result.waves)} waves "
            f"{[(w['window'], w['offered'], w['served']) for w in result.waves]}"
            f", placements {moves}, chaos applied {applied}, wall "
            f"{result.wall_s:.2f} s, "
            f"launches {ran}")
        if set(result.grades) != {"chat", "research"} or \
                not g.served + g.rejected == g.offered > 0 or \
                set(g.verdicts) != {"p99_ttft", "p99_latency", "goodput"}:
            raise AssertionError(f"tenant scenario: {srow}")
        if len(applied) != 4 or len(result.chaos_fired) != 4:
            raise AssertionError(f"tenant scenario chaos: "
                                 f"{result.chaos_fired}")
        losses = result.train_results["research"]["loss_by_step"]
        if sorted(losses) != list(range(TENANT_STEPS)):
            raise AssertionError(f"tenant scenario train: {sorted(losses)}")
        if ran["flash_attention"] == 0 or \
                ran["flash_attention"] % cfg.num_layers:
            raise AssertionError(f"tenant scenario: flash {ran}")
        out_rows["scenario"], launches["scenario"] = srow, ran
        out_rows["bytes_written"] = _tree_bytes(root)
    out_rows["phase_s"] = time.perf_counter() - t_phase
    log(f"[tenant] {out_rows['bytes_written'] / 1e6:.1f} MB written; "
        f"{out_rows['phase_s']:.1f} s")
    return out_rows, launches


RANKS_MESHES = ((1, 2), (2, 1))
# granite cut to 4 of its 24 layers (0.264 B of 1.335 B params): beside
# phi4's pure-FSDP runs, the phase at full depth took 447 s of a 1,115 s
# script (its limit 1,200 s) on an H100 80GB HBM3 with a slow host; at 8
# layers 271 s of 809 s, and the elastic ranks phase after it adds about
# 160 s
RANKS_LAYERS = 4
RANKS_STEPS = 2
RANKS_CHECK = (2, 128)    # (c): layers and tokens a row, f32, card vs CPU
RANKS_LABEL = "two ranks sharing one H100 over gloo"
RANKS_KERNELS = ("moe_gmm", "xent_fwd", "xent_bwd", "adamw_update",
                 "ssd_scan", "wkv6")
RANKS_TP_MESH = (1, 2)    # (d), (e): granite's own ParallelConfig()
# (f), (g): phi4's own layout, pure FSDP on (1, 2) (the batch of 2 divides
# the two ranks), cut to 4 of 32 layers (1.02 B params, 0.61 B of them the
# embedding) to keep the phase near its earlier length
RANKS_FSDP_MESH = (1, 2)
RANKS_FSDP_LAYERS = 4
# (f) against one device's steps on the same weights and batches, in
# bf16: the two ranks' products run on one row each, one device's on
# both, so cuBLAS may round them otherwise
RANKS_ONE_DEVICE_RTOL = {"loss": 2e-3, "grad_norm": 1e-2}
# (h), (h'): zamba2 and rwkv6 at full width under their own layout, pure
# FSDP on RANKS_FSDP_MESH, zamba2 cut to one group of its pattern (6 of 54
# layers: five mamba and one with the shared attention, 0.66 B params),
# rwkv6 to 4 of 24 (0.35 B)
RANKS_SCAN_LAYERS = {ZAMBA: 6, RWKV: 4}
# (i): the f32 card-vs-CPU check at smoke size, 2 x RANKS_SCAN_CHECK_SEQ
# tokens: zamba2 at its smoke check's cut (SMOKE_CUTS: one mamba and one
# mamba_attn layer), rwkv6 at 2 layers, and zamba2's RL loss
RANKS_SCAN_CHECK_SEQ = 128
# (h), (h') against one device's steps, bf16: every step's loss and step
# 1's grad norm (the same weights on both) within RANKS_ONE_DEVICE_RTOL;
# a later step's grad norm within RANKS_SCAN_LATER_NORM_RTOL.  Adam's
# first update moves each weight by about the lr whatever its grad's
# size, so the bf16 rounding of the smallest grads sets the direction of
# some of those moves, and the recurrent kinds' next grad norm follows
# them: rwkv6 at 4 layers lay 1.06e-1 from one device's at step 2 with
# its losses 7.5e-5 apart (an H100 80GB HBM3 at 700 W), and at smoke
# widths in bf16 on the CPU zamba2's and rwkv6's lay 3e-3 to 1.4e-1
# apart at steps 2-3 at Adam eps 1e-8 and 1e-5 alike
RANKS_SCAN_LATER_NORM_RTOL = 0.25


def _one_device_steps(cfg, par, ocfg, batches) -> list:
    """``steps.train_step`` on this process's card from
    ``ranks.seeded_params(cfg, 0)``, one step a batch -> per step loss,
    grad norm and ms; the card's memory freed after."""
    from repro_torch.launch import ranks
    from repro_torch.runtime import steps
    params = steps._map(lambda t: t.cuda(), ranks.seeded_params(cfg, 0))
    opt = steps.init_opt_state(cfg, ocfg, "cuda")
    out = []
    for j in range(batches["tokens"].shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = steps.train_step(
            cfg, par, ocfg, params, opt,
            {k: v[j] for k, v in batches.items()}, device="cuda")
        m = {k: float(v) for k, v in m.items()}
        out.append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                    "ms": (time.perf_counter() - t0) * 1e3})
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ranks_run(label, shape, cfg, ocfg, batches, want, smi, par=None,
               bytes_want=None, **kw):
    """``train_ranks`` on ``shape`` through ``run_ranks`` under ``par``
    (default ``RANK_PARALLEL``): each rank's per-step loss, ms, collective
    bytes and peak memory printed; every loss and grad norm finite and
    equal on every rank (the global metrics); each rank's kernel launches
    ``want`` (None: none) and, where given, each step's collective bytes
    ``bytes_want``."""
    from repro_torch.launch import ranks
    par = par or ranks.RANK_PARALLEL
    t0 = time.perf_counter()
    res = ranks.run_ranks(ranks.train_ranks, shape,
                          args=(cfg, par, ocfg, batches), **kw)
    wall = time.perf_counter() - t0
    for r in res:
        for j, row in enumerate(r["steps"]):
            peak = row["peak_bytes"]
            log(f"[ranks] {label} mesh {shape} rank {r['rank']} "
                f"{r['coords']} step {j + 1}: loss {row['loss']:.6f} grad "
                f"norm {row['grad_norm']:.6f} {row['ms']:.1f} ms bytes "
                f"{row['bytes']} peak "
                f"{'-' if peak is None else f'{peak / 1e9:.3f} GB'}")
        log(f"[ranks] {label} mesh {shape} rank {r['rank']} launches "
            f"{r['launches']}")
    first = [row["loss"] for row in res[0]["steps"]]
    for r in res:
        got = [(row["loss"], row["grad_norm"]) for row in r["steps"]]
        if not all(math.isfinite(x) for pair in got for x in pair):
            raise AssertionError(f"[ranks] {label} {shape}: not finite {got}")
        if [g[0] for g in got] != first:
            raise AssertionError(f"[ranks] {label} {shape}: rank "
                                 f"{r['rank']}'s losses differ from rank 0's")
        ran = {k: r["launches"][k] for k in RANKS_KERNELS}
        expect = want or dict.fromkeys(RANKS_KERNELS, 0)
        if ran != expect:
            raise AssertionError(f"[ranks] {label} {shape} rank {r['rank']} "
                                 f"launches {ran} != {expect}")
        if bytes_want is not None and any(row["bytes"] != bytes_want
                                          for row in r["steps"]):
            raise AssertionError(
                f"[ranks] {label} {shape} rank {r['rank']} bytes "
                f"{[row['bytes'] for row in r['steps']]} != {bytes_want} "
                f"(the leaf shapes' prediction)")
    if bytes_want is not None:
        log(f"[ranks] {label} mesh {shape}: every rank's bytes a step equal "
            f"the leaf shapes' prediction {bytes_want}")
    return res, {"mesh": list(shape), "label": label, "arch": cfg.name,
                 "layers": cfg.num_layers, "wall_s": wall,
                 "parallel": {"tensor_parallel": par.tensor_parallel,
                              "sequence_parallel": par.sequence_parallel,
                              "pure_fsdp_train": par.pure_fsdp_train},
                 "bytes_predicted": bytes_want,
                 "ranks": [{"rank": r["rank"], "coords": r["coords"],
                            "steps": r["steps"], "launches": r["launches"]}
                           for r in res], "card": smi}


def phase_ranks(smi: str):
    """Training across ranks (``launch.ranks``) on the one card.  NCCL
    puts one rank on a card, so: (a) mesh (1, 1) over NCCL (its init and
    every collective of ``sharding.collectives`` through it); (b) two
    ranks on the card over gloo (``devices=["cuda:0", "cuda:0"]``) on
    meshes (1, 2) (experts and their all_to_all on ``model``) and (2, 1)
    (ZeRO-3 on ``data``): granite-moe-1b-a400m at full width and
    ``RANKS_LAYERS`` layers, bf16, f32 moments, 2 steps of 2 x 1024
    tokens, each rank's losses, grad norms, ms a step, collective bytes,
    peak memory and gmm/xent/AdamW launches printed ("two ranks sharing
    one H100 over gloo": no figure of (b) is a multi-card rate), the
    launches as ``_family_launches`` implies on every rank; (c) the same
    two-rank runs at ``RANKS_CHECK`` (2 layers, 2 x 128 tokens) in f32 on
    the card against the CPU (the plain versions, gloo) within
    ``phase_small_train``'s tolerances: losses 1e-4, grad norms 1e-4
    relative, every param block 2e-4 at lr 3e-4.  (b) and (c) run under
    ``RANK_PARALLEL`` (experts on ``model``, nothing else); (d) and (e)
    are (b) and (c) on ``RANKS_TP_MESH`` under granite's own layout,
    ``registry.get_parallel`` (``ParallelConfig()``: tensor and sequence
    parallelism on ``model`` besides the experts), whose xent kernels
    take each rank's sequence slice.  (f) and (g) are (b) and (c) for
    phi4-mini-3.8b at full width under its own layout on
    ``RANKS_FSDP_MESH``, pure FSDP (the batch and every leaf over
    ``("data", "model")``), (f) cut to ``RANKS_FSDP_LAYERS`` layers; its
    xent kernels take each rank's rows, AdamW each rank's blocks, and
    each rank's collective bytes a step must equal
    ``ranks.fsdp_step_bytes``' count from the leaf shapes, and its
    losses and grad norms one device's steps (``_one_device_steps``)
    within ``RANKS_ONE_DEVICE_RTOL``.  -> (rows, each run's rank-0
    launches by label)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import ranks
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps
    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    bases = {GRANITE: registry.get_config(GRANITE),
             ARCH: registry.get_config(ARCH)}

    def cut(arch, layers, dtype):
        return bases[arch].replace(num_layers=layers, param_dtype=dtype,
                                   compute_dtype=dtype)

    own = registry.get_parallel(GRANITE)
    phi4_own = registry.get_parallel(ARCH)
    fsdp = steps.train_par(phi4_own, global_batch=TRAIN_BATCH,
                           chips=math.prod(RANKS_FSDP_MESH))
    if not fsdp.pure_fsdp:
        raise AssertionError(f"[ranks] {ARCH}'s own layout on "
                             f"{RANKS_FSDP_MESH}: not pure FSDP")

    def expected(cfg, seq, par=ranks.RANK_PARALLEL, tp=1):
        # under sequence parallelism a rank's loss runs over seq / tp
        # positions a row: granite's vocab takes the chunked loss either
        # way, one xent launch a 512-position chunk; pure FSDP runs the
        # chunked loss over each rank's rows, the whole sequence
        n = len(pr.leaves(steps._model_module(cfg).lm_schema(cfg)))
        w = _family_launches(cfg, par, n, RANKS_STEPS, seq // tp)
        return {k: w[k] for k in RANKS_KERNELS}

    rows, launches = {}, {}
    cfg = cut(GRANITE, RANKS_LAYERS, "bfloat16")
    phi4 = cut(ARCH, RANKS_FSDP_LAYERS, "bfloat16")
    ocfg = OptimizerConfig(warmup_steps=2)
    batches = {arch: TokenPipeline(c.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                   seed=0).chunk(0, RANKS_STEPS)
               for arch, c in ((GRANITE, cfg), (ARCH, phi4))}
    want = expected(cfg, TRAIN_SEQ)
    shared = {"devices": ["cuda:0", "cuda:0"], "backend": "gloo"}
    tp = RANKS_TP_MESH[1]
    runs = [("(a) nccl", (1, 1), cfg, {}, want)] + [
        (f"(b) {RANKS_LABEL}", shape, cfg, shared, want)
        for shape in RANKS_MESHES] + [
        (f"(d) ParallelConfig(), {RANKS_LABEL}", RANKS_TP_MESH, cfg,
         {**shared, "par": own}, expected(cfg, TRAIN_SEQ, own, tp)),
        (f"(f) pure FSDP, {RANKS_LABEL}", RANKS_FSDP_MESH, phi4,
         {**shared, "par": phi4_own,
          "bytes_want": ranks.fsdp_step_bytes(phi4, fsdp, RANKS_FSDP_MESH)},
         expected(phi4, TRAIN_SEQ, phi4_own))]
    layers, seq = RANKS_CHECK
    small = {arch: cut(arch, layers, "float32") for arch in bases}
    small_ocfg = OptimizerConfig(warmup_steps=1, decay_steps=100)
    small_batches = {arch: TokenPipeline(c.vocab_size, seq, TRAIN_BATCH,
                                         seed=1).chunk(0, RANKS_STEPS)
                     for arch, c in small.items()}
    # (c), (e) and (g): each two ranks on the card and two on the CPU (two
    # threads each), for each mesh and layout
    checks = [("(c)", GRANITE, shape, ranks.RANK_PARALLEL, 1) for shape in
              RANKS_MESHES] + [("(e)", GRANITE, RANKS_TP_MESH, own, tp),
                               ("(g)", ARCH, RANKS_FSDP_MESH, phi4_own, 1)]

    def check(tag, arch, shape, par, n, where):
        label, want, kw = (
            (f"card, {RANKS_LABEL}", expected(small[arch], seq, par, n),
             shared) if where == "card" else
            ("cpu", None, {"device": "cpu", "threads": 2}))
        return _ranks_run(f"{tag} {label}", shape, small[arch], small_ocfg,
                          small_batches[arch], want, smi, par=par,
                          kwargs={"keep": True}, **kw)

    # phi4's CPU half of (g), the phase's longest run (full width: the
    # 200,064-word head on the CPU), runs beside (a)-(f) on the host's
    # other cores; then the other seven of (c), (e) and (g) at once
    with ThreadPoolExecutor(max_workers=1) as beside:
        g_cpu = beside.submit(check, *checks[-1], "cpu")
        for label, shape, c, kw, want in runs:
            _, row = _ranks_run(label, shape, c, ocfg, batches[c.name], want,
                                smi, **kw)
            key = f"{c.name} ranks {label.split()[0]} {shape}"
            rows[key] = row
            launches[key] = row["ranks"][0]["launches"]
        one = _one_device_steps(phi4, phi4_own, ocfg, batches[ARCH])
        got = rows[f"{ARCH} ranks (f) {RANKS_FSDP_MESH}"]["ranks"][0]["steps"]
        errs = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got, one))
                for k in RANKS_ONE_DEVICE_RTOL}
        log(f"[ranks] (f) {ARCH} one device, {RANKS_FSDP_LAYERS} layers: "
            + "; ".join(f"step {j + 1} loss {o['loss']:.6f} grad norm "
                        f"{o['grad_norm']:.6f} {o['ms']:.1f} ms"
                        for j, o in enumerate(one))
            + f"; the ranks' rel err {errs} (tolerances "
              f"{RANKS_ONE_DEVICE_RTOL})")
        if any(errs[k] > tol for k, tol in RANKS_ONE_DEVICE_RTOL.items()):
            raise AssertionError(f"[ranks] (f): the ranks disagree with one "
                                 f"device: {errs}")
        rows[f"{ARCH} ranks (f) {RANKS_FSDP_MESH}"].update(
            one_device=one, one_device_rel_err=errs)
        with ThreadPoolExecutor(max_workers=2 * len(checks) - 1) as pool:
            jobs = {(tag, shape, where): pool.submit(
                check, tag, arch, shape, par, n, where)
                for tag, arch, shape, par, n in checks
                for where in ("card", "cpu")
                if (tag, where) != ("(g)", "cpu")}
            done = {key: job.result() for key, job in jobs.items()}
        done["(g)", RANKS_FSDP_MESH, "cpu"] = g_cpu.result()
    for tag, arch, shape, _, _ in checks:
        (card, row), (cpu, _) = (done[tag, shape, "card"],
                                 done[tag, shape, "cpu"])
        loss_err = norm_err = param_err = 0.0
        for a, b in zip(card, cpu):
            for x, y in zip(a["steps"], b["steps"]):
                loss_err = max(loss_err, abs(x["loss"] - y["loss"]))
                norm_err = max(norm_err, abs(x["grad_norm"] - y["grad_norm"])
                               / y["grad_norm"])
            pa, pb = dict(_named(a["params"])), dict(_named(b["params"]))
            param_err = max(param_err, max(
                float(abs(pa[k].astype("float64") - pb[k]).max())
                for k in pb))
        log(f"[ranks] {tag} {arch} {shape} f32, {layers} layers, "
            f"{TRAIN_BATCH} x {seq} tokens, {RANKS_STEPS} steps, card vs "
            f"cpu: loss max_abs_err {loss_err:.3g} (tolerance 1e-4), grad "
            f"norm rel err {norm_err:.3g} (1e-4), param blocks max_abs_err "
            f"{param_err:.3g} (2e-4)")
        if not (loss_err <= 1e-4 and norm_err <= 1e-4 and param_err <= 2e-4):
            raise AssertionError(f"[ranks] {tag} {shape}: the card "
                                 f"disagrees with the CPU")
        key = f"{arch} ranks {tag} {shape}"
        rows[key] = {
            **row, "loss_max_abs_err": loss_err, "grad_norm_rel_err":
            norm_err, "param_max_abs_err": param_err}
        if tag == "(g)":
            launches[f"{key} f32 card"] = row["ranks"][0]["launches"]
    scan_rows, scan_launches = _ranks_scan(smi)
    rows.update(scan_rows)
    launches.update(scan_launches)
    log(f"[ranks] phase {time.perf_counter() - t_start:.1f} s")
    return rows, launches


def _rl_batches(vocab: int, seq: int, seed: int) -> dict:
    """``RANKS_STEPS`` RL batches of ``TRAIN_BATCH`` rows: tokens and
    labels, a mask of mixed zeros and ones, signed advantages."""
    import numpy as np
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (RANKS_STEPS, TRAIN_BATCH, seq + 1))
    return {"tokens": tokens[..., :seq].astype(np.int32),
            "labels": tokens[..., 1:].astype(np.int32),
            "mask": (rng.rand(RANKS_STEPS, TRAIN_BATCH, seq) < 0.6).astype(
                np.float32),
            "advantages": rng.randn(RANKS_STEPS, TRAIN_BATCH).astype(
                np.float32)}


def _ranks_scan(smi: str):
    """The recurrent kinds and the RL loss across ranks, ``phase_ranks``'
    (h), (h') and (i), all at once (each rank run's start-up and first
    step, 20-30 s, overlap; the ms a step printed are under that
    contention).  (h) zamba2-2.7b and (h') rwkv6-1.6b at full width
    under their own layout (``registry.get_parallel``: pure FSDP on
    ``RANKS_FSDP_MESH``, the batch of 2 dividing the two ranks), cut to
    ``RANKS_SCAN_LAYERS``, bf16 with f32 moments, 2 steps of 2 x 1024
    tokens as two ranks sharing the card over gloo: each rank's losses,
    grad norms, ms, collective bytes (equal to ``ranks.fsdp_step_bytes``),
    peak memory and launches (the SSD or WKV6 scan on every rank, twice a
    layer a step, as ``_family_launches`` implies), the losses and step
    1's grad norm against one device's steps within
    ``RANKS_ONE_DEVICE_RTOL``, step 2's within
    ``RANKS_SCAN_LATER_NORM_RTOL``.  (i) the smoke configs in f32 at 2 x
    ``RANKS_SCAN_CHECK_SEQ`` tokens, two ranks on the card against two on
    the CPU (the plain versions) within ``phase_small_train``'s
    tolerances (losses 1e-4, grad norms 1e-4 relative, param blocks
    2e-4): zamba2 at ``SMOKE_CUTS``' cut, rwkv6 at 2 layers, and zamba2
    under the RL loss (``train_ranks(..., rl=True)``,
    ``steps.rl_train_chunk`` across ranks).  -> (rows, each run's rank-0
    launches by label)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import ranks
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps
    t0 = time.perf_counter()
    shape = RANKS_FSDP_MESH
    shared = {"devices": ["cuda:0", "cuda:0"], "backend": "gloo"}
    rows, launches = {}, {}

    def expected(cfg, par, seq):
        n = len(pr.leaves(steps._model_module(cfg).lm_schema(cfg)))
        w = _family_launches(cfg, par, n, RANKS_STEPS, seq)
        return {k: w[k] for k in RANKS_KERNELS}

    ocfg = OptimizerConfig(warmup_steps=2)
    full = []
    for tag, arch in (("(h)", ZAMBA), ("(h')", RWKV)):
        cfg = registry.get_config(arch).replace(
            num_layers=RANKS_SCAN_LAYERS[arch], param_dtype="bfloat16",
            compute_dtype="bfloat16")
        own = registry.get_parallel(arch)
        fsdp = steps.train_par(own, global_batch=TRAIN_BATCH,
                               chips=math.prod(shape))
        if not fsdp.pure_fsdp:
            raise AssertionError(f"[ranks] {arch}'s own layout on {shape}: "
                                 f"not pure FSDP")
        batches = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                seed=0).chunk(0, RANKS_STEPS)
        full.append((tag, arch, cfg, own, batches,
                     ranks.fsdp_step_bytes(cfg, fsdp, shape)))

    seq = RANKS_SCAN_CHECK_SEQ
    small_ocfg = OptimizerConfig(warmup_steps=1, decay_steps=100)
    checks = []
    for tag, arch, rl in (("(i)", ZAMBA, False), ("(i)", RWKV, False),
                          ("(i) rl", ZAMBA, True)):
        layers, pattern = SMOKE_CUTS.get(arch, (2, None))
        cfg = registry.get_smoke(arch).replace(
            num_layers=layers, param_dtype="float32", compute_dtype="float32",
            **({} if pattern is None else {"block_pattern": pattern}))
        batches = (_rl_batches(cfg.vocab_size, seq, 1) if rl else
                   TokenPipeline(cfg.vocab_size, seq, TRAIN_BATCH,
                                 seed=1).chunk(0, RANKS_STEPS))
        checks.append((tag, arch, cfg, rl, batches))

    def check(tag, arch, cfg, rl, batches, where):
        own = registry.get_parallel(arch)
        label, want, kw = (
            (f"card, {RANKS_LABEL}", expected(cfg, own, seq), shared)
            if where == "card" else
            ("cpu", None, {"device": "cpu", "threads": 2}))
        return _ranks_run(f"{tag} {label}", shape, cfg, small_ocfg, batches,
                          want, smi, par=own,
                          kwargs={"keep": True, "rl": rl}, **kw)

    with ThreadPoolExecutor(max_workers=len(full) + 2 * len(checks)) as pool:
        runs = {tag: pool.submit(
            _ranks_run, f"{tag} pure FSDP, {RANKS_LABEL}", shape, cfg, ocfg,
            batches, expected(cfg, own, TRAIN_SEQ), smi, par=own,
            bytes_want=bytes_want, **shared)
            for tag, _, cfg, own, batches, bytes_want in full}
        jobs = {(tag, arch, where): pool.submit(check, tag, arch, cfg, rl,
                                                batches, where)
                for tag, arch, cfg, rl, batches in checks
                for where in ("card", "cpu")}
        runs = {tag: job.result() for tag, job in runs.items()}
        done = {key: job.result() for key, job in jobs.items()}
    for tag, arch, cfg, own, batches, _ in full:
        row = runs[tag][1]
        one = _one_device_steps(cfg, own, ocfg, batches)
        got = row["ranks"][0]["steps"]
        rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
               for a, b in zip(got, one)]
        errs = {"loss": max(e["loss"] for e in rel),
                "grad_norm": rel[0]["grad_norm"],
                "later_grad_norm": max(e["grad_norm"] for e in rel[1:])}
        log(f"[ranks] {tag} {arch} one device, {cfg.num_layers} layers: "
            + "; ".join(f"step {j + 1} loss {o['loss']:.6f} grad norm "
                        f"{o['grad_norm']:.6f} {o['ms']:.1f} ms"
                        for j, o in enumerate(one))
            + f"; the ranks' rel err {errs} (tolerances "
              f"{RANKS_ONE_DEVICE_RTOL}, later steps' grad norm "
              f"{RANKS_SCAN_LATER_NORM_RTOL})")
        if any(errs[k] > tol for k, tol in RANKS_ONE_DEVICE_RTOL.items()) \
                or errs["later_grad_norm"] > RANKS_SCAN_LATER_NORM_RTOL:
            raise AssertionError(f"[ranks] {tag}: the ranks disagree with "
                                 f"one device: {errs}")
        key = f"{arch} ranks {tag} {shape}"
        rows[key] = {**row, "one_device": one, "one_device_rel_err": errs}
        launches[key] = row["ranks"][0]["launches"]
    for tag, arch, cfg, _, _ in checks:
        (card, row), (cpu, _) = (done[tag, arch, "card"],
                                 done[tag, arch, "cpu"])
        loss_err = norm_err = param_err = 0.0
        for a, b in zip(card, cpu):
            for x, y in zip(a["steps"], b["steps"]):
                loss_err = max(loss_err, abs(x["loss"] - y["loss"]))
                norm_err = max(norm_err, abs(x["grad_norm"] - y["grad_norm"])
                               / y["grad_norm"])
            pa, pb = dict(_named(a["params"])), dict(_named(b["params"]))
            param_err = max(param_err, max(
                float(abs(pa[k].astype("float64") - pb[k]).max())
                for k in pb))
        log(f"[ranks] {tag} {arch} smoke {shape} f32, {cfg.num_layers} "
            f"layers {cfg.block_pattern}, {TRAIN_BATCH} x {seq} tokens, "
            f"{RANKS_STEPS} steps, card vs cpu: loss max_abs_err "
            f"{loss_err:.3g} (tolerance 1e-4), grad norm rel err "
            f"{norm_err:.3g} (1e-4), param blocks max_abs_err "
            f"{param_err:.3g} (2e-4)")
        if not (loss_err <= 1e-4 and norm_err <= 1e-4 and param_err <= 2e-4):
            raise AssertionError(f"[ranks] {tag} {arch}: the card disagrees "
                                 f"with the CPU")
        key = f"{arch} ranks {tag} {shape}"
        rows[key] = {**row, "loss_max_abs_err": loss_err,
                     "grad_norm_rel_err": norm_err,
                     "param_max_abs_err": param_err}
        launches[f"{key} f32 card"] = row["ranks"][0]["launches"]
    log(f"[ranks] (h), (h'), (i) {time.perf_counter() - t0:.1f} s")
    return rows, launches


# elastic on ranks: granite-moe at full width and 2 of 24 layers (bf16, f32
# moments: about 1.57 GB a checkpoint), its own ParallelConfig(), 4 slots
# as ranks sharing the card over gloo; 6 steps, a checkpoint every 3; 2
# slots fail once step 2 is done and rejoin once the (1, 2) segment has
# taken a step: saves at 2, at the (1, 2) segment's graceful exit and at 5
ELASTIC_RANKS_ARCH = GRANITE
ELASTIC_RANKS_LAYERS, ELASTIC_RANKS_STEPS, ELASTIC_RANKS_CKPT = 2, 6, 3
ELASTIC_RANKS_SLOTS, ELASTIC_RANKS_FAIL_AFTER = 4, 2
# the churned run's losses against one device's uninterrupted run, bf16:
# on (2, 2) granite's ParallelConfig() caps each expert's entries per model
# group, as the reference does, where one device caps them over the batch
# (in f32 at smoke size 2e-6 apart at the first step, 1.4e-3 by the
# fifth), and bf16 sums in another order: 1.5e-3 apart by the third step,
# before any churn, and 2.5e-3 at most over the run on an H100 80GB HBM3
# at 700 W (phi4's pure FSDP in phase_ranks: 1.20e-4 over 2 steps)
ELASTIC_RANKS_RTOL = 1e-2


def _digests_hold(store, trainer, cfg, par, ocfg) -> dict:
    """Every probe record of ``trainer``'s rank segments (``digest_probe``:
    each rank's blocks after a restore and before a save) against the cut
    of the checkpoint's whole leaves for that segment's mesh -> {"checked":
    blocks compared, "unequal": [(segment, event, step, rank, key)]}."""
    import itertools

    from repro_torch.checkpoint.checkpoint import (Checkpointer,
                                                   flatten_with_paths)
    from repro_torch.elastic.segment import block_digest
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import params as pr
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.sharding import specs
    schema = steps._model_module(cfg).lm_schema(cfg)
    opt_schema = adamw.opt_state_schema(schema, ocfg)
    abstract = {"params": pr.abstract_params(schema, cfg.param_dtype),
                "opt": pr.abstract_params(opt_schema, "float32")}
    ck = Checkpointer(store, keep=None)
    by_step = {}
    for i, rec in enumerate(trainer.rank_segments):
        for r, probes in enumerate(rec.get("probes", [])):
            for event, step, digests in probes:
                by_step.setdefault(step, []).append((i, rec, r, event,
                                                     digests))
    checked, unequal = 0, []
    for step, entries in sorted(by_step.items()):
        whole = dict(flatten_with_paths(ck.restore(step, abstract, "cpu")))
        for i, rec, r, event, digests in entries:
            mesh = make_mesh(rec["mesh"], ("data", "model"))
            rules = specs.logical_rules(steps.train_par(
                par, global_batch=TRAIN_BATCH, chips=math.prod(rec["mesh"])))
            coords = dict(zip(mesh.axis_names, list(itertools.product(
                *(range(n) for n in mesh.sizes)))[r]))
            for key, p in flatten_with_paths({"params": schema,
                                              "opt": opt_schema}):
                spec = specs.spec_for(p.shape, p.axes, mesh, rules)
                checked += 1
                if block_digest(specs.local_shard(
                        whole[key], spec, mesh, coords)) != digests[key]:
                    unequal.append((i, event, step, r, key))
        del whole
    return {"checked": checked, "unequal": unequal}


def phase_elastic_ranks(smi: str):
    """Elastic training segments on ranks: ``ELASTIC_RANKS_ARCH`` at full
    width and ``ELASTIC_RANKS_LAYERS`` layers under its own layout through
    ``ElasticTrainer`` on ``ELASTIC_RANKS_SLOTS`` slots that are ranks
    sharing the card over gloo ("4 ranks sharing one H100 over gloo": no
    figure here is a multi-card rate), churned (2, 2) -> (1, 2) -> (2, 2);
    checked as the module docstring's phase 17 says.  -> (row, rank 0's
    launches over the run)."""
    import tempfile
    import threading

    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.orchestrator import Cluster
    from repro_torch.data.objectstore import ObjectStore
    from repro_torch.elastic import ElasticTrainer, ElasticTrainSpec
    from repro_torch.models import params as pr
    from repro_torch.runtime import steps
    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    arch = ELASTIC_RANKS_ARCH
    cfg = registry.get_config(arch).replace(num_layers=ELASTIC_RANKS_LAYERS)
    par = registry.get_parallel(arch)
    # the train CLI's recipe: lr 1e-3, warmup steps/20, cosine over the run
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1,
                           decay_steps=ELASTIC_RANKS_STEPS)
    schema = steps._model_module(cfg).lm_schema(cfg)
    n_params, n_leaves = pr.param_count(schema), len(pr.leaves(schema))
    card = torch.device("cuda", 0)
    slots = [f"slot{i}" for i in range(ELASTIC_RANKS_SLOTS)]
    label = f"{len(slots)} ranks sharing one H100 over gloo"

    def spec(**kw):
        return ElasticTrainSpec(
            cfg, par, ocfg, steps=ELASTIC_RANKS_STEPS, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, device_steps=1, keep=None,
            log_every=1, seed=0, name="chip-smoke-elastic-ranks",
            device=card, rejoin_timeout_s=600.0, **kw)

    # the uninterrupted run: one device, the same weights (drawn on the
    # card's generator from the seed), no checkpoint
    t0 = time.perf_counter()
    one = ElasticTrainer(Cluster(devices=[card]), spec(
        base_shape=(1, 1), max_data=1, ckpt_every=0)).run()
    one_losses, one_wall = one["losses"], time.perf_counter() - t0
    del one
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-elastic-ranks-") as \
            root:
        cluster = Cluster(devices=slots, compute=card,
                          ranks={s: str(card) for s in slots})
        trainer = ElasticTrainer(
            cluster, spec(base_shape=(2, 2), max_data=None,
                          ckpt_every=ELASTIC_RANKS_CKPT, ranks=cluster.ranks),
            store=ObjectStore(root),
            probe="repro_torch.elastic.segment:digest_probe")
        victims = slots[len(slots) // 2:]
        done = threading.Event()

        def churn():
            # 2 slots fail once step FAIL_AFTER is done; they rejoin once
            # the (1, 2) segment has taken a step of its own
            while trainer.progress < ELASTIC_RANKS_FAIL_AFTER and \
                    not done.is_set():
                time.sleep(0.005)
            for d in victims:
                cluster.fail_node(d)
            while not done.is_set():
                segs = trainer.rank_segments
                if len(segs) >= 2 and segs[1].get("last", -1) >= \
                        segs[1].get("start", ELASTIC_RANKS_STEPS):
                    break
                time.sleep(0.005)
            for d in victims:
                cluster.join_node(d)

        watcher = threading.Thread(target=churn, daemon=True)
        watcher.start()
        try:
            out = trainer.run()
        finally:
            done.set()
            watcher.join(timeout=60)
        held = _digests_hold(ObjectStore(root), trainer, cfg, par, ocfg)
        del out["params"], out["opt"]
    rep, losses = out["report"], out["losses"]
    segs = trainer.rank_segments
    tp = 2
    per = _family_launches(cfg, par, n_leaves, 1, TRAIN_SEQ // tp)
    rows, launches = [], dict.fromkeys(RANKS_KERNELS, 0)
    for seg, rec in zip(rep.segments, segs):
        n = seg.steps_run
        want = {"xent_fwd": per["xent_fwd"] * n * rec["accum"],
                "xent_bwd": per["xent_bwd"] * n * rec["accum"],
                "moe_gmm": per["moe_gmm"] * n * rec["accum"],
                "ssd_scan": per["ssd_scan"] * n * rec["accum"],
                "wkv6": per["wkv6"] * n * rec["accum"],
                "adamw_update": n_leaves * n}
        for r, ran in enumerate(rec["launches"]):
            got = {k: ran[k] for k in RANKS_KERNELS}
            if got != want:
                raise AssertionError(f"[elastic-ranks] segment {seg.index} "
                                     f"rank {r} launches {got} != {want}")
        for k in RANKS_KERNELS:
            launches[k] += rec["launches"][0][k]
        row = {"mesh": list(rec["mesh"]), "accum": rec["accum"],
               "outcome": seg.outcome, "steps": [seg.start, seg.end],
               "backend": rec["backend"],
               "rank_start_s": rec.get("rank_start_s"),
               "t_first_s": seg.t_first_s, "wall_s": seg.wall_s,
               "saves": rec["saves"], "restores": rec["restores"][0],
               "peak_gb": [b / 1e9 for b in rec["peak_bytes"]],
               "launches_rank0": rec["launches"][0]}
        rows.append(row)
        log(f"[elastic-ranks] segment {seg.index} mesh {tuple(rec['mesh'])} "
            f"accum {rec['accum']} ({label}): {seg.outcome}, steps "
            f"{seg.start}..{seg.end}; rank start-up "
            f"{row['rank_start_s']:.2f} s, t_first_s {seg.t_first_s:.2f}, "
            f"wall {seg.wall_s:.2f} s; saves "
            + ", ".join(f"step {v['step']}: gather {v['snapshot_s']:.2f} s "
                        f"write {v['write_s']:.2f} s {v['bytes'] / 1e9:.3f} GB"
                        for v in rec["saves"])
            + "; restores (rank 0) "
            + ", ".join(f"step {v['step']}: {v['seconds']:.2f} s "
                        f"{v['bytes'] / 1e9:.3f} GB"
                        for v in rec["restores"][0])
            + f"; peak GB a rank {[round(g, 3) for g in row['peak_gb']]}; "
              f"launches a rank {rec['launches'][0]}")
    alive = [pid for pids in trainer.rank_pids for pid in pids
             if Path(f"/proc/{pid}").exists()]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    written = sum(v["bytes"] for rec in segs for v in rec["saves"])
    result = {
        "arch": arch, "layers": ELASTIC_RANKS_LAYERS,
        "params_b": n_params / 1e9, "dtype": "bfloat16",
        "parallel": "ParallelConfig()", "ranks": label,
        "steps": ELASTIC_RANKS_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "ckpt_every": ELASTIC_RANKS_CKPT, "segments": rows,
        "outcomes": [s.outcome for s in rep.segments],
        "recoveries": rep.recoveries, "steps_lost": rep.steps_lost,
        "recovery_s": rep.recovery_s, "total_wall_s": rep.total_wall_s,
        "global_batch_constant": rep.global_batch_constant,
        "restore_digests": held, "losses": losses,
        "one_device_losses": one_losses, "one_device_wall_s": one_wall,
        "loss_rel_err": gap, "loss_rtol": ELASTIC_RANKS_RTOL,
        "launches_rank0": launches, "disk_written_gb": written / 1e9,
        "phase_s": time.perf_counter() - t_start, "card": smi}
    log(f"[elastic-ranks] {arch} at {ELASTIC_RANKS_LAYERS} layers "
        f"({n_params / 1e9:.3f} B params, bf16, ParallelConfig()), {label}: "
        f"outcomes {result['outcomes']}; recoveries {rep.recoveries}, steps "
        f"lost {rep.steps_lost}, recovery_s {rep.recovery_s}; "
        f"{held['checked']} blocks after restores and before saves equal "
        f"to the checkpoints' cut ({len(held['unequal'])} unequal); losses "
        f"{losses}; one device {one_losses}; rel err {gap:.3g} (tolerance "
        f"{ELASTIC_RANKS_RTOL}); disk written {written / 1e9:.2f} GB; "
        f"{result['phase_s']:.1f} s; {smi}")
    shapes = [tuple(s.mesh_shape) for s in rep.segments]
    if shapes != [(2, 2), (1, 2), (2, 2)] or result["outcomes"] != [
            "node-failure", "preempted", "done"]:
        raise AssertionError(f"[elastic-ranks] segments {rep.to_json()}")
    if {tuple(r["mesh"]): r["accum"] for r in rows} != {(2, 2): 1, (1, 2): 2} \
            or not rep.global_batch_constant or rep.recoveries < 1 or \
            rep.steps_lost > ELASTIC_RANKS_CKPT:
        raise AssertionError(f"[elastic-ranks] report {rep.to_json()}")
    if any(s.steps_run < 1 for s in rep.segments[1:]):
        raise AssertionError(f"[elastic-ranks] a segment after the churn "
                             f"took no step: {rep.to_json()}")
    restored_onto_12 = [p for r in segs[1]["probes"] for p in r
                        if p[0] == "restore"]
    if held["unequal"] or len(restored_onto_12) != 2 or not held["checked"]:
        raise AssertionError(f"[elastic-ranks] restore/save blocks: {held}, "
                             f"(1, 2) restores {len(restored_onto_12)}")
    if not all(math.isfinite(x) for x in losses) or \
            len(losses) != ELASTIC_RANKS_STEPS or gap > ELASTIC_RANKS_RTOL:
        raise AssertionError(f"[elastic-ranks] losses {losses} against one "
                             f"device's {one_losses}: rel err {gap:.3g}")
    if alive:
        raise AssertionError(f"[elastic-ranks] rank processes alive: {alive}")
    return result, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    smi = phase_device()
    phase_blas_workspaces()
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
    phase_small_families()
    phase_small_train()
    serve, ran_phi4, phi4_run = phase_serve(smi)
    with _GmmRecorder(3 * _moe_layers(GRANITE)) as granite_rows:
        serve_granite, ran_granite, _ = phase_serve(
            smi, GRANITE, before_run=granite_rows.arm)
    serve_zamba, ran_zamba = phase_serve_slotted(smi, ZAMBA)
    serve_rwkv, ran_rwkv = phase_serve_slotted(smi, RWKV)
    serve_gemma2, ran_gemma2, _ = phase_serve(smi, GEMMA2,
                                              after=gemma2_long_request)
    serve_whisper, ran_whisper = phase_serve_slotted(smi, WHISPER)
    serve_vlm, ran_vlm = phase_serve_slotted(smi, VLM, layers=VLM_LAYERS,
                                             after=vlm_forward_check)
    flash["launches"] = ran_phi4["flash_attention"]
    ssd["launches"] = ran_zamba["ssd_scan"]
    wkv["launches"] = ran_rwkv["wkv6"]
    gmm["launches"] = ran_granite["moe_gmm"]
    gmm["occupancy"] = _gmm_occupancy(
        GRANITE, granite_rows, torch.Generator(device="cuda").manual_seed(11),
        smi)
    flash["launches_by_path"] = {
        f"{ARCH} serve": ran_phi4["flash_attention"],
        f"{GRANITE} serve": ran_granite["flash_attention"],
        f"{ZAMBA} serve": ran_zamba["flash_attention"],
        f"{GEMMA2} serve": ran_gemma2["flash_attention"],
        f"{GEMMA2} serve, {GEMMA2_LONG_PROMPT}-token request":
            serve_gemma2["long_flash"],
        f"{WHISPER} serve": ran_whisper["flash_attention"],
        f"{VLM} serve ({VLM_LAYERS} layers)": ran_vlm["flash_attention"]}
    train, launches = phase_train(smi)
    families, family_launches = phase_train_families(smi)
    kimi, kimi_flash, kimi_gmm, ran_kimi, ran_kimi_train = phase_kimi(smi)
    dry = phase_dryrun(smi, train)
    flash["kimi_dh112"] = kimi_flash
    gmm["kimi_serve"] = kimi_gmm
    flash["launches_by_path"][
        f"{KIMI} serve ({KIMI_SERVE_LAYERS} layer)"] = ran_kimi[
            "flash_attention"]
    ssd["launches_by_path"] = {
        f"{ZAMBA} serve": ran_zamba["ssd_scan"],
        f"{ZAMBA} train ({FAMILY_STEPS} steps)":
            family_launches[ZAMBA]["ssd_scan"]}
    wkv["launches_by_path"] = {
        f"{RWKV} serve": ran_rwkv["wkv6"],
        f"{RWKV} train ({FAMILY_STEPS} steps)":
            family_launches[RWKV]["wkv6"]}
    kimi_train = (f"{KIMI} train ({KIMI_TRAIN_LAYERS} layers, "
                  f"{KIMI_TRAIN_EXPERTS} experts, {FAMILY_STEPS} steps)")
    kimi_witness = (f"{KIMI} train, f32 moments ({KIMI_TRAIN_LAYERS} layers, "
                    f"{KIMI_WITNESS_EXPERTS} experts, {FAMILY_STEPS} steps)")
    ran_kimi_witness = kimi["lr_witness"]["runs"]["float32/full, kernel"][
        "launches"]
    gmm["launches_by_path"] = {
        f"{GRANITE} serve": ran_granite["moe_gmm"],
        f"{GRANITE} train ({FAMILY_STEPS} steps)":
            family_launches[GRANITE]["moe_gmm"],
        f"{KIMI} serve ({KIMI_SERVE_LAYERS} layer)": ran_kimi["moe_gmm"],
        kimi_train: ran_kimi_train["moe_gmm"],
        kimi_witness: ran_kimi_witness["moe_gmm"]}
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
    tenant, tenant_launches = phase_tenant(smi, phi4_run)
    written += tenant["bytes_written"] / 1e9
    log(f"[disk] written so far {written:.2f} GB")
    ranks, ranks_launches = phase_ranks(smi)
    elastic_ranks, elastic_ranks_launches = phase_elastic_ranks(smi)
    written += elastic_ranks["disk_written_gb"]
    log(f"[disk] written so far {written:.2f} GB")
    ranks_launches[f"{GRANITE} elastic ranks (2, 2) -> (1, 2) -> (2, 2)"] = \
        elastic_ranks_launches
    flash["launches_by_path"].update({
        f"{ARCH} serve router": ran_router["router"],
        f"{ARCH} serve static": ran_router["static"],
        f"{ARCH} rl actors": rl_launches["flash_attention"],
        f"{ARCH} session serve": session_launches["serve"]["flash_attention"],
        f"{ARCH} session graph": session_launches["graph"]["flash_attention"],
        f"{CODEQWEN} session serve":
            session_launches["codeqwen"]["flash_attention"],
        f"{ARCH} fabric serve":
            fabric["serve"]["launches"]["flash_attention"],
        f"{ARCH} tenant serve":
            tenant_launches["serve"]["flash_attention"],
        f"{ARCH} tenant serve replicated":
            tenant_launches["replicated"]["flash_attention"],
        f"{ARCH} scenario waves":
            tenant_launches["scenario"]["flash_attention"]})
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
                fabric["train"]["launches"][row["name"]],
            f"{ARCH} smoke tenant train (preempted)":
                tenant_launches["train"][row["name"]],
            f"{ARCH} smoke scenario train":
                tenant_launches["scenario"][row["name"]]}
        row["launches_by_path"].update({
            f"{arch} train ({FAMILY_STEPS} steps)": ran[row["name"]]
            for arch, ran in family_launches.items()})
        row["launches_by_path"][kimi_train] = ran_kimi_train[row["name"]]
        row["launches_by_path"][kimi_witness] = ran_kimi_witness[row["name"]]
    for row in (xent_fwd, xent_bwd, adamw, gmm, ssd, wkv):
        row["launches_by_path"].update({
            f"{path}, rank 0": ran[row["name"]]
            for path, ran in ranks_launches.items()})
    kernels = [flash, xent_fwd, xent_bwd, adamw, ssd, wkv, gmm]
    for row in kernels:
        row["card"] = smi
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": {ARCH: serve, GRANITE: serve_granite,
                                ZAMBA: serve_zamba, RWKV: serve_rwkv,
                                GEMMA2: serve_gemma2, WHISPER: serve_whisper,
                                VLM: serve_vlm}}))
    print(json.dumps({"train": train}))
    print(json.dumps({"train_families": families}))
    print(json.dumps({"kimi": kimi}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"elastic": elastic}))
    print(json.dumps(router))
    print(json.dumps({"rl": rl}))
    for row in session.values():
        print(json.dumps({"session": row}))
    print(json.dumps({"connect": connect}))
    print(json.dumps({"fabric": fabric}))
    print(json.dumps({"tenant": tenant}))
    print(json.dumps({"ranks": ranks}))
    print(json.dumps({"elastic_ranks": elastic_ranks}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
