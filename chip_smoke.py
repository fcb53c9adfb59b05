#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (naf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``naf_torch/kernels/csrc`` with nvcc (into
``build/naf_torch/``; ptxas spills in the K2, K3/K4 or K5 library fail),
counts the ``HGMMA`` (wgmma) instructions in the K1, K6, K2 and K3/K4
libraries with ``cuobjdump -sass`` (none fails: their bf16 kernels run on
the tensor cores) and the ``LDGSTS`` (cp.async) instructions of K5's wide
and narrow routes (none in either fails), then, each phase on its own lines:

1. K1 (fused GN -> SiLU -> conv encoder layer) against its plain PyTorch
   version at the production layer shape (1, 448, 448, 128), k = 1 and 3, f32
   (atol = rtol = 2e-4, the CUDA-core kernel) and bf16 (cosine > 0.9995
   against the f32 plain version, the tensor-core kernel), once at batch 2,
   once at 2048^2 and at a banded-encoder band (1, 262, 452, 128), k = 1 and 3,
   and at 448^2 with C = F of 48 (``NAF(dim=96)``'s width, F zero-padded to
   64 by the wrapper), 160 and 256;
2. K2 (fused pool-up + RoPE + cross-scale attention) against its plain
   version, f32 on the CUDA-core kernel (2e-4) and bf16 on the tensor-core
   kernel (cosine > 0.9995 against the f32 plain version), each call
   counted on its route: the main path's shapes (448^2 -> 448^2, identity
   pool, and 448^2 -> 2048^2, ragged pool-up), 224^2 -> 448^2,
   ``NAF(dim=96)``'s width, a 4:1 pool-down, 2 RoPE heads over 4 attention
   heads, a ratio-1 box of 16 x 16 cells (the chunked kernel), Cv 1024 (dv
   256) and a one-head dv 3 (``K2_SHAPES``);
3. the main path: ``NAFUpsampler`` with seeded random bf16 weights at the
   production config serves three 448^2 requests and one 448^2 -> 2048^2
   request, with launch counters showing 8 K1, 1 K2, 1 keys-kernel and 2
   stem-kernel launches per forward and no K6 (the kernels line's K6
   launches)
   (every bf16 K2 launch on the tensor-core route, here and in phases 10 and 12);
   its output is held against the modular path (plain attention oracle) on
   the card and against an f32 copy of the model on the CPU (cosine > 0.999);
   a torch.profiler breakdown of device time per forward by kernel, with
   K1's share; ``NAFUpsampler(dim=96)`` serves a 448^2 request with 8 K1 and
   1 K2 launches, held against its f32 CPU copy (cosine > 0.999);
   one gradient of each wrapper is held against autograd of its plain
   version (2e-3); per-forward time and the forward's own peak memory; a
   2048^2 guide + 128^2 x 384 -> 2048^2 forward's peak attributed by
   allocating frame (the top 5 printed);
4. K3 (cross-scale NA forward) and K4 (its recompute-P backward) against
   their plain versions at the training shape (4, 32^2 <- 16^2, 4 heads,
   d 64, dv 192), at 448^2 <- 28^2 (d 64, dv 96), at the ragged 100^2 <- 28^2
   and at the denoiser's dv = 3 (one head) and dv = 1 (three heads), k 9:
   f32 on the CUDA-core kernels, forward atol = rtol = 2e-4 and gradients
   2e-3; bf16 on the tensor-core kernels, cosine > 0.9995 against the f32
   plain versions, K4's dk/dv bitwise equal over two runs; each call counted
   on its route; in bf16 also boxes above 192 cells (the chunked kernels):
   NAF(dim=96) as a denoiser (256^2, ratio 1, one head, d 96, dv 3, k 9) and
   the training widths at k 11; K4 at 448^2 <- 28^2 in bands of query rows
   under a lowered partials budget against one launch, with both calls'
   peak memory; K3/K4 on an interior band (LR cell rows [7, 14) of 448^2 <-
   28^2, the spatial train step's attention) under autograd against the
   plain versions on the band (f32 out and dq 2e-4, dk/dv 2e-3; bf16 cosine
   > 0.9995), and the bf16 band split into row bands by a lowered partials
   budget against one launch; the K2 gradient check of phase 3 also shows
   that its backward ran K3 and K4;
5. the training path: ``train_upsampler`` on the production configuration
   (NAF dim 256, 4 + 4 heads, k 9, 2 layers, rope_rescale 2; AdamW 2e-4;
   batch 4; random ViT-B/14 DINOv2 backbone; img_size 448; bf16) for 20
   steps on seeded synthetic images, with 8 K1, 1 K3 and 1 K4 launches per
   step (K3/K4 on their tensor-core kernels), finite losses, the last below
   1.5x the first, a checkpoint written, reloaded and stepped once more, 4
   steps through the device-stack route (two chunks of 2, the batches
   gathered on the card), one step with use_checkpointing (2 K3 launches),
   and one f32 step at batch 1
   held against the same step on the CPU (loss rtol 1e-3, gradient cosine >
   0.999); ms per step, a step's peak memory and a torch.profiler split of
   its device time;
6. K5 (FeatUp's spatially varying conv) against its plain version at
   FeatUp's last stage (1, 454, 454, 384) k 7 and a ragged (2, 41, 57, 100)
   k 5 and (2, 152, 152, 200) k 3 (chunks of several 32-channel stages, a
   tail of 8) on the wide route, at JBU's (1, 458, 458, 3) k 11 on the
   narrow route, and at the routes' edges, (2, 19, 37) outputs at every odd
   k 1..15 with C 3 and 8 (narrow) and 9 (wide): f32 atol = rtol = 2e-4,
   bf16 cosine > 0.9995 against the f32 plain version, each call counted on
   the route the plan gives it; and one gradient of ``adaptive_conv`` per
   route against autograd of the plain version (2e-3);
7. the baselines path: ``ModelWrapper`` with seeded random f32 weights serves
   FeatUp, JBU, AnyUp, JAFAR, JBF, Bilinear, Nearest and NAF at the reference
   sweep's defaults (448^2 image, 28^2 x 384 features, 448^2 output, ratio
   16), with launch counts per forward (FeatUp 4 K5 on the wide route, JBU 1
   K5 on the narrow one, AnyUp 1 K3 and
   0 K4, NAF 8 K1 and 1 K2 on its f32 route, the others none); each output
   held against an f32 copy of the model on the CPU (cosine > 0.999; AnyUp
   and JAFAR at a 224^2 output) and AnyUp's against its own plain attention
   on the card; ms per forward over 10 forwards, the forward's own peak
   memory, and a torch.profiler split of FeatUp's and JBU's device time into
   K5 and the rest;
8. in fresh processes (``chip_smoke.py --timing PART FILE``, K2's timing in
   one of its own; torch.profiler drops kernel records late in a long
   process), the time of each kernel at the
   production shape (K2 at 448^2 and 2048^2 beside the warp-per-query
   kernel's time it replaced and the attention-only yardstick, masked SDPA
   on the plain version's queries; K3 and K4 at the training shape and
   448^2 <- 28^2, K3 also at AnyUp's f32 k 7 shape, K5 at FeatUp's four
   stages (56^2 to 448^2) and JBU's, K6 beside the K1 1x1 + 3x3 pair on the
   same halves) beside its
   plain version's, a library yardstick and the card's bound; K1 and K6 in
   bf16 and in f32 (their two kernels). Every kernel and library call by
   torch.profiler's device time, with the device time of calls queued
   behind a spinning kernel (a host wait inside them fails it) and the
   wrapper's time by CUDA events beside it; and K2's gradient at 448^2 and
   448^2 -> 2048^2 (forward + twin backward: every kernel, K3 + K4, queued,
   and the call's own peak memory).

Phases 9, 10 and 12 run after phase 4:

9. K6 (both encoder stacks' layer over the packed [pix|sem] buffer) against
   its plain version at the production layer (1, 448, 448, 256), C = 128 per
   stack, once at batch 2, at 2048^2 and at a band (1, 262, 452, 256), and at
   448^2 with C = 48 and 96 per stack: f32
   atol = rtol = 2e-4, bf16 cosine > 0.9995 against the f32 plain version
   (these launches are the kernels line's K6 ``check_launches``);
10. the banded variants against their plain versions at one interior band:
   K2 at 448^2 -> 2048^2 <- 128^2 (a slab, and ``out_acc`` + ``enc_banded``
   leaving every other row untouched) and K3 at 448^2 <- 28^2, same bars,
   and their bf16 times beside the plain versions';
12. the banded paths, each against the unbanded forward on the card (cosine
   > 0.999) with its launch counts, time and own peak memory beside the
   unbanded forward's: ``NAF(band_rows=256)`` at 448^2 + 128^2 x 384 ->
   2048^2 (8 K1, 8 K2); ``naf_streamed`` at 512^2 + 256^2 x 384 -> 4096^2,
   ``band_rows`` 512 (8 K1, 8 K2); ``naf_streamed`` at 2048^2 + 128^2 x 384 ->
   2048^2, ``band_rows`` 256, whose banded encoder turns on by itself (224
   K1: per stack 48 in the stats sweep, 32 in the keys sweep, 32 in the
   attention sweep; 8 K2), with a lower peak than the unbanded forward.

Phases 13-15 run after phase 7, before phase 8, whose fresh processes also
take phase 16:

13. the denoiser's attention (``benchmarks/denoising.json``'s NAF: one head,
   d 256, dv 3, k 15, ratio 1) at batch 1 and 448^2: K2, K3 and K4 against
   their plain versions, f32 on the chunked CUDA-core kernels
   (``csrc/na_fma.cuh``; 2e-4, gradients 2e-3) with every call asserted on
   the "fma_chunked" route, bf16 on the chunked tensor-core kernels at d 256
   (cosine > 0.9995); a shape whose box fits shared memory whole keeps the
   route "fma";
14. the denoising path at that configuration through the CLI's own
   functions (``naf_torch.denoising``): the real shard's 60 training photos
   kept on the card, 10 bf16 steps at batch 8, 448^2, sigma 0.5, in two
   chunks of 5 (per step 8 K1, 1 K2, 1 K3 and K4 in bands, all on the tensor
   cores), finite chunk losses; validation in f32 on 4 batches of 2 of the 9
   validation photos (8 K1 and 1 chunked K2 per batch), PSNR and SSIM; the
   bf16 step's time (CUDA events), device busy share (torch.profiler) and
   peak memory, validation's time and peak; the step's peak attributed by
   allocating frame (the allocator's history replayed to the peak, the live
   blocks summed by their innermost frame in naf_torch; the top 5 printed)
   without and with the encoder twin's exact-bf16 packing of its saved f32
   upcasts, and steps from the same weights under
   ``torch.use_deterministic_algorithms`` (cuDNN's deterministic flag alone
   leaves the twin's TF32 weight gradients varying by a bf16 ulp from run to
   run), two unpacked and one packed, with equal loss and gradients; one f32
   step at 64^2
   (still dim 256, k 15) on the card against the same step on the CPU (loss
   rtol 1e-3, gradient cosine > 0.999);
15. IRCNN, REDNet and Restormer through the CLI's ``main`` with the same
   command line (3 bf16 steps at batch 8, 448^2, one validation batch),
   each step's time and peak, and one f32 forward against the model's f32
   CPU copy (cosine > 0.999; Restormer at 128^2); they launch none of the
   port's kernels;
16. K2, K3 and K4 at the denoiser's attention, bf16 at batch 8 and f32 at
   batch 2 (the chunked kernels): device time, plain version and bound; no
   library call is feasible (masked SDPA would need a 200,704 x 200,704 mask
   per image).

Phase 17 runs after phase 15, before phase 8:

17. the parallel path (``naf_torch.parallel``), in spawned ranks: two ranks
   sharing the one card over gloo run the spatially sharded forward (space
   2) of the production NAF at 448^2 + 28^2 x 384 -> 448^2 and 448^2 + 128^2
   x 384 -> 2048^2 (28^2 features have no whole cell rows to band at
   2048^2), f32 and bf16, gathered and held against the one-process forward
   (f32 max abs err <= 2e-5, bf16 cosine >= 0.99999), each rank launching 8
   K1 and 1 K2 per sharded forward; a data-parallel train step over the two
   ranks at the training shape against the one-process step (bf16 loss rel
   <= 1e-2; f32 rel <= 1e-5, gradient cosine >= 0.999999); the spatially
   sharded train step (``naf_spatial_train_step``, data 1, space 2) of the
   production NAF on a seeded target at 448^2 + 28^2 x 384 -> 448^2, f32
   and bf16, 2 steps, and 448^2 + 128^2 x 384 -> 2048^2, bf16, 1 step, each
   against the one-process step on the card from the same weights (f32 loss
   rel <= 1e-5, first-step gradient cosine >= 0.999999 and rel norm <=
   5e-5, the f32 spread of cuDNN's weight gradients over other partitions
   of the pixels, ~1e-5 (``_spatial_train_check``), parameters after the
   steps within 1e-5; bf16 loss rel <= 1e-2, cosine >= 0.9995, at 448^2
   also to the f32 one-process step; at 2048^2 each rank's peak below the
   one-process step's), every rank's step
   launching 8 K1, 1 banded K2, 1 K3 and K4 in one or more bands on the
   dtype's route, the ranks' losses and parameters equal; one rank in an
   NCCL world takes the f32 step. Per-rank times and peaks.

Phases 18-19 run after phase 17, before phase 8:

18. the backbones: every name of the port's backbone registry and
   ``vit_small_patch16_224`` (the real-shard evals' backbone) with seeded
   random weights at full width and its own input size, bf16 on the card
   against an f32 copy on the CPU (cosine > 0.999), one f32 card run per
   RoPE style against the CPU (atol = rtol = 1e-3, TF32 off), each name's
   forward ms and own peak; the reference's LargeImg request
   (``naf_tpu/bench/harness.py:233-299``): ``vit_base_patch16_224.dino`` on
   the 448^2 bilinear downsample of a 896^2 and a 1792^2 image, the
   production ``NAF()`` to the full image in bf16, 8 K1 and 1 K2 per
   forward, the backbone's, NAF's and the request's ms and the request's
   peak (through the bench harness's ``benchmark_large_img`` on the same
   two models, every NAF forward of it at 8 K1 and 1 K2: median, min and
   max), profiles;
   896^2 held against an f32 CPU copy, 1792^2 against the card's f32 plain
   path (cosine > 0.999); the reference's A100 40GB times printed as context;
19. the evaluation path on the committed real shard through the port's CLIs
   at ``evaluation/eval_real_shard.py``'s arguments (f32): seg probing for
   NAF and bilinear, DAVIS J&F for NAF, each beside the JAX package's number
   in ``benchmarks/real_eval.json`` (other random weights: not a parity
   check); then the full-width probe (DINOv3 ViT-B/16 at 448^2, NAF bf16,
   8 epochs); every NAF forward on 8 K1 and 1 K2, the bilinear probe on
   none; each run's time, time per epoch and peak. Phases 18-19 print their
   own wall time.

Phase 20 runs after phase 19, before phase 8:

20. the reference sweep (``naf_tpu/bench/harness.py:31-36``) through the
   port's harness (``naf_torch.bench.harness.run_sweep``, 2 samples of 2
   calls a row): NAF in bf16 over ratio 2, 4, 8, 16, 32, embed_dim 128,
   768, 1024 and img_size 112, 224, 896, and each of the six sweep models
   at the defaults (448^2 + 28^2 x 384 -> 448^2) in f32, every row with the
   reference's backward (a 1x1 head, an SGD step). Every row has its
   forward and backward times or a skip the JAX package's own code raises,
   never an error; every NAF forward launches 8 K1 and 1 K2 (bf16 on the
   tensor cores), every NAF backward one K3 and K4 in the same bands each
   step (K2's gradient; K4 bands its query rows above 1 GiB of partials); at
   every NAF shape, on the harness's weights and inputs, the bf16 fused
   forward and the gradients of the bench's loss through it (the features',
   the head's and both encoder stacks' parameters') agree with the card's
   f32 plain path (cosine > 0.999). Rows run with TF32 off (the harness's
   default). The phase prints its wall time.

Phase 21 runs after phase 20, before phase 8:

21. the quality loop (``naf_torch.evals.distill``, the counterpart of
   ``tools/train_distilled_eval.py``), cut to fit: ``NAF()`` self-distilled
   for 300 of the CLI's 3000 bf16 steps (three chunks of 100) at 256^2,
   batch 4, on the real shard's 60 training photographs kept on the card,
   against the seeded random ViT-S/16 of the real-shard probe; then that
   probe (4 of its 8 epochs, f32, no DAVIS) on the trained weights and on
   the JAX package's (``naf_torch/assets/naf_distill_jax_ckpt3000.npz``).
   Each chunk's median and last loss, the step time, both IoUs; the counts
   zeroed before the call and read after it: every training step's forward
   on 8 K1 and its backward on one K3 and the same K4 bands, every other NAF
   forward (the run's panels, the probes) on 8 K1 + 1 K2, the CLI's own
   per-part counts summing to the totals. Finite losses, the last chunk's
   median loss below the first's. Then the JAX-trained weights in bf16 on
   the card (8 K1 + 1 K2) against their f32 CPU copy at 448^2 + 28^2 x 384
   -> 448^2 on a real-shard photograph: cosine > 0.999. The phase prints
   its wall time.

Phase 22 runs after phase 21, before phase 8:

22. the headline bench (``naf_torch.bench.headline``, the counterpart of
   ``bench.py``) at bench.py's sizes, 2 samples of 3 calls a field: the
   448^2 forward, the bench step, 2048^2, 448^2 -> 2048^2, the bare K3 and
   the streamed 4096^2 request; every field finite and positive, each
   field's call on the kernels ``headline.expected_launches`` names (8 K1 +
   1 K2 a forward, the step 8 K1 + 1 K2 + 1 K3 + 1 K4, the bare call 1 K3,
   the streamed request 8 K1 and a K2 a band) on the tensor-core route;
   then ``--stages`` (448^2 + 128^2 x 384 -> 2048^2): the forward's
   launches and its profiled stretch by span (``naf_torch.utils.spans``),
   the encoder and the attention on the device, the attention below the
   whole forward, the spans' own device times over 95% of the busy time,
   the idle parts summing to the stretch's idle. Prints the record, bench.py's line
   and the phase's wall time.

Phase 23 runs after phase 2, before phase 3:

23. the keys kernel (``kernels.rope_keys``: pooled RoPE keys and K2's
   tables in one launch) against its f32 plain version at the main path's
   shapes (448^2 + 28^2, 448^2 -> 2048^2 + 128^2, 2048^2 + 128^2; bf16, C
   256, 4 RoPE heads): keys within one rounding of the f32 keys (2^-8 |ref|
   + 1e-5 max|ref|), tables to 1e-6, one launch a call; its device time
   beside the plain version's and the bound.

Phase 24 runs after phase 23, before phase 3:

24. the stem kernel (``encoder_fused.stem_conv_fused``: a stack's stem conv,
   bias, io-dtype roundings and the first GroupNorm's channel sums in one
   launch) against its plain version (``_stem_conv`` + ``_channel_sums``,
   TF32 off) at the cells' shapes (448^2, 448^2 at batch 8, 2048^2; bf16, F
   128, k 1 and 3): y within one rounding at each of its two rounding
   points and equal on >= 99.9% of its elements, the sums and per-tile
   partials of its own y to 1e-5 of the sums of magnitudes, one launch a
   call; both stacks' device time beside the bound and the plain glue it
   replaces (cuDNN's TF32 on, as the port served it).

Prints a JSON line of per-kernel numbers (``launches_bench`` on K1-K5: the
launches of phase 20's rows; ``launches_quality`` on K1-K4: phase 21's;
``launches_spatial_train`` on K1-K4: phase 17's spatial train steps;
``launches_headline`` on K1-K6: phase 22's fields; the keys kernel's
launches from phase 3, its error and times from phase 23; the stem
kernel's launches from phase 3, its error and times from phase 24),
the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero on any failure,
and when no CUDA device is present. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

# Deterministic algorithms (phase 14's packed-twin comparison) need cuBLAS's
# deterministic workspace setting, which PyTorch reads once, at the first
# cuBLAS call of the process.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM / H200 SXM data-sheet peaks (dense): bytes/s and bf16 FLOP/s.
_PEAKS = {"H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}
# f32 FLOP/s on the CUDA cores (no tensor cores), the same on both parts.
F32_FLOPS = 67e12


def _peaks(name: str):
    for key, val in _PEAKS.items():
        if key in name:
            return val
    return _PEAKS["H100"]


def _cos(a, b, chunk: int = 1 << 24) -> float:
    """Cosine of two tensors in float64, a chunk of elements at a time (a
    4096^2 x 384 output would take 52 GB in float64 at once)."""
    a, b = a.detach().flatten(), b.detach().flatten()
    dot = na = nb = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i : i + chunk].double(), b[i : i + chunk].double()
        dot += float(x @ y)
        na += float(x @ x)
        nb += float(y @ y)
    return dot / (na * nb) ** 0.5


PROFILE_TRIES = 3  # profiles _kernel_ms takes before it gives up on one that stays empty


def _time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _kernel_ms(fn, match=None, reps: int = 20) -> float:
    """Device time per call of ``fn`` in the kernels whose name holds
    ``match`` (a string, or a tuple of strings any of which may match; every
    kernel with None), from torch.profiler (CUPTI) over ``reps`` calls after
    a warm-up: the kernels' own time, without the host time between launches
    that CUDA events around a host-bound loop would measure. A profile that
    comes back without device records (after many profiles in one process
    CUPTI sometimes hands none over) is taken again, up to PROFILE_TRIES
    times in all, and each retake is printed: a run that needed one may have
    lost records elsewhere too, and read low."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = (match,) if isinstance(match, str) else match
    for attempt in range(PROFILE_TRIES):
        if attempt:
            print(f"profile retaken ({attempt + 1} of {PROFILE_TRIES}): the last one held no "
                  f"device record of {match!r}", flush=True)
        # CPU and CUDA activity, as _profile traces: a CUDA-only trace once
        # came back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and (names is None or any(m in e.key for m in names))]
        if ev:
            return sum(e.self_device_time_total for e in ev) / reps / 1e3
    raise AssertionError(f"{PROFILE_TRIES} profiles show no kernel matching {match!r}")


def _queued_ms(fn, reps: int = 20, spin: int = 200_000_000) -> float:
    """Device time per call of ``fn`` by CUDA events around ``reps`` calls
    queued behind a spinning kernel (``torch.cuda._sleep`` of ``spin``
    cycles): the host enqueues them while the card spins, so they run back
    to back with no host time between them. The cross-check of
    ``_kernel_ms``, with no profiler in the way. Raises if the card was done
    spinning when the last call had been enqueued (checked with a 4x longer
    spin once more): then a call waited on the card, and the window holds
    host time."""
    fn()
    torch.cuda.synchronize()
    for cycles in (spin, 4 * spin):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        spun.record()
        t0.record()
        for _ in range(reps):
            fn()
        queued = not spun.query()
        t1.record()
        torch.cuda.synchronize()
        if queued:
            return t0.elapsed_time(t1) / reps
    raise AssertionError("the card finished spinning before the timed calls were all "
                         "enqueued: a call waits on the card, so its queued time holds host time")


def _check_close(name, got, want, tol, chunk: int = 1 << 26):
    """Max abs error, raising unless every element is within atol = rtol =
    tol; in float64, a chunk of elements at a time."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    got, want = got.detach().flatten(), want.detach().flatten()
    n_bad, worst = 0, 0.0
    for i in range(0, got.numel(), chunk):
        w = want[i : i + chunk].double()
        err = (got[i : i + chunk].double() - w).abs()
        n_bad += int((err > tol + tol * w.abs()).sum())
        worst = max(worst, float(err.max()))
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} elements outside atol=rtol={tol}, "
                             f"max abs err {worst:.3e}")
    return worst


def _check_cos(name, got, want, bar):
    c = _cos(got, want)
    if not c > bar:
        raise AssertionError(f"{name}: cosine {c:.6f} <= {bar}")
    return c


def phase_k1(dev):
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused, gn_silu_conv_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    # the main path's 448^2 layers, one 3x3 layer on the 2048-wide rows of a
    # 2048^2 guide (the dual route's and the banded encoder's width), and a
    # banded-encoder band: 256 rows + 2 x 3 halo rows, W no multiple of 16
    for b, k, h, w in ((1, 1, 448, 448), (1, 3, 448, 448), (2, 3, 448, 448),
                       (1, 3, 2048, 2048), (1, 3, 262, 452), (1, 1, 262, 452)):
        c = f = 128
        x = torch.randn(b, h, w, c, generator=gen, device=dev)
        scale = torch.rand(b, c, generator=gen, device=dev) * 0.5 + 0.75
        shift = torch.randn(b, c, generator=gen, device=dev) * 0.1
        wt = torch.randn(f, c, k, k, generator=gen, device=dev) * (1.0 / (c * k * k)) ** 0.5
        bias = torch.randn(f, generator=gen, device=dev) * 0.1
        y_ref, ps_ref = gn_silu_conv_ref(x, scale, shift, wt, bias)
        y, ps = gn_silu_conv_fused(x, scale, shift, wt, bias)
        torch.cuda.synchronize()
        # psums feed GroupNorm as means: compare them per pixel
        e = _check_close(f"K1 f32 y b={b} k={k}", y, y_ref, 2e-4)
        _check_close(f"K1 f32 psums b={b} k={k}", ps / (h * w), ps_ref / (h * w), 2e-4)
        yb, psb = gn_silu_conv_fused(x.bfloat16(), scale, shift, wt.bfloat16(), bias)
        torch.cuda.synchronize()
        cy = _check_cos(f"K1 bf16 y b={b} k={k}", yb.float(), y_ref, 0.9995)
        cp = _check_cos(f"K1 bf16 psums b={b} k={k}", psb, ps_ref, 0.9995)
        errs[(b, k, h)] = e
        print(f"K1 b={b} k={k} {h}x{w}: f32 max_abs_err {e:.3e}; bf16 cos y {cy:.6f} psums "
              f"{cp:.6f}", flush=True)
        del x, y, ps, yb, psb, y_ref, ps_ref
    # other widths at 448^2, C = F: NAF(dim=96)'s 48 (F zero-padded to 64 by
    # the wrapper), 160 (a zero stage past C, a halo in two chunks) and 256
    for c, k in ((48, 3), (48, 1), (160, 3), (256, 3)):
        x = torch.randn(1, 448, 448, c, generator=gen, device=dev)
        scale = torch.rand(1, c, generator=gen, device=dev) * 0.5 + 0.75
        shift = torch.randn(1, c, generator=gen, device=dev) * 0.1
        wt = torch.randn(c, c, k, k, generator=gen, device=dev) * (1.0 / (c * k * k)) ** 0.5
        bias = torch.randn(c, generator=gen, device=dev) * 0.1
        y_ref, ps_ref = gn_silu_conv_ref(x, scale, shift, wt, bias)
        y, ps = gn_silu_conv_fused(x, scale, shift, wt, bias)
        yb, psb = gn_silu_conv_fused(x.bfloat16(), scale, shift, wt.bfloat16(), bias)
        torch.cuda.synchronize()
        e = _check_close(f"K1 f32 y C={c} k={k}", y, y_ref, 2e-4)
        _check_close(f"K1 f32 psums C={c} k={k}", ps / 448**2, ps_ref / 448**2, 2e-4)
        cy = _check_cos(f"K1 bf16 y C={c} k={k}", yb.float(), y_ref, 0.9995)
        cp = _check_cos(f"K1 bf16 psums C={c} k={k}", psb, ps_ref, 0.9995)
        errs[(1, k, c)] = e
        print(f"K1 C=F={c} k={k} 448x448: f32 max_abs_err {e:.3e}; bf16 cos y {cy:.6f} psums "
              f"{cp:.6f}", flush=True)
        del x, y, ps, yb, psb, y_ref, ps_ref
    torch.cuda.empty_cache()
    return max(errs.values())


def _k2_inputs(dev, gen, hi, out=448, hk=28, c=256, cv=384, heads=4):
    """K2's inputs at NAF's widths: an (1, hi, hi, c) encoder output, its
    pooled RoPE'd keys on the hk^2 grid, hk^2 x cv values and the cos|sin
    tables of an out^2 output; RoPE over ``heads`` heads."""
    from naf_torch.nn.rope import RoPE

    rope = RoPE(c, heads).to(dev)
    enc = torch.randn(1, hi, hi, c, generator=gen, device=dev)
    keys = rope.pooled(enc, (out, out), (hk, hk)).contiguous()
    values = torch.randn(1, hk, hk, cv, generator=gen, device=dev)
    sin_r, cos_r, sin_c, cos_c = rope.tables(out, out)
    return (enc, keys, values, torch.cat([cos_r, sin_r], -1), torch.cat([cos_c, sin_c], -1),
            rope.d_head)


# (encoder side, output side, LR side, C, Cv, attention heads, RoPE heads, k):
# the main path's 448^2 (identity pool) and 448^2 -> 2048^2 (ragged pool-up,
# ragged windows that repeat LR cells), an integer pool-up, NAF(dim=96)'s
# width (d 24: a RoPE half of 12 channels, d padded to 32 on the tensor
# cores), the input guard's 4:1 pool-down, RoPE heads that straddle the
# attention heads, a ratio-1 box of 16 x 16 cells (the chunked kernel), the
# reference sweep's widest features (Cv 1024: dv 256) and a one-head dv 3
K2_SHAPES = {
    "448": (448, 448, 28, 256, 384, 4, 4, 9),
    "224->448": (224, 448, 28, 256, 384, 4, 4, 9),
    "2048": (448, 2048, 28, 256, 384, 4, 4, 9),
    "dim96": (448, 448, 28, 96, 384, 4, 4, 9),
    "pool4:1": (1792, 448, 28, 256, 384, 4, 4, 9),
    "rope2": (448, 448, 28, 256, 384, 4, 2, 9),
    "ratio1": (128, 128, 128, 256, 384, 4, 4, 9),
    "dv256": (448, 448, 28, 256, 1024, 4, 4, 9),
    "dv3": (448, 448, 28, 96, 3, 1, 4, 9),
}


def phase_k2(dev):
    """K2 against its plain version at every shape of K2_SHAPES: f32 on the
    CUDA-core kernel (2e-4), bf16 on the tensor-core kernel (cosine > 0.9995
    against the f32 plain version), each call counted on its route."""
    from naf_torch.kernels.na2d_fused_q import (
        _plan_k2,
        naf_upsample_attention,
        naf_upsample_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    routes = naf_upsample_attention.route_launches
    errs, coss = {}, {}
    for label, (hi, out, hk, c, cv, heads, rope_heads, ks) in K2_SHAPES.items():
        enc, keys, values, rt, ct, dh = _k2_inputs(dev, gen, hi, out=out, hk=hk, c=c, cv=cv,
                                                   heads=rope_heads)
        kw = dict(num_heads=heads, kernel_size=ks)
        want = naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, **kw)
        before = dict(routes)
        got = naf_upsample_attention(enc, keys, values, rt, ct, dh, **kw)
        torch.cuda.synchronize()
        e = _check_close(f"K2 f32 {label}", got, want, 2e-4)
        del got
        gb = naf_upsample_attention(enc.bfloat16(), keys.bfloat16(), values.bfloat16(),
                                    rt, ct, dh, **kw)
        torch.cuda.synchronize()
        if (routes["fma"] - before["fma"], routes["wgmma"] - before["wgmma"]) != (1, 1):
            raise AssertionError(f"K2 {label}: f32 and bf16 did not run one launch each on "
                                 f"the fma and wgmma routes: {before} -> {routes}")
        cb = _check_cos(f"K2 bf16 {label}", gb.float(), want, 0.9995)
        del gb, want
        d, dv = c // heads, cv // heads
        plan = _plan_k2(out, out, hk, hk, ks, -(-d // 16) * 16, -(-dv // 16) * 16, str(dev))
        nb, uniform = plan[4], plan[-1] / plan[-2].numel()
        errs[label], coss[label] = e, cb
        print(f"K2 {label}: enc {hi}^2 x {c} -> {out}^2 <- {hk}^2 x {cv}, {heads} heads (RoPE "
              f"{rope_heads}), k {ks}: f32 (CUDA cores) max_abs_err {e:.3e}; bf16 (wgmma, box "
              f"{nb}{', chunked' if nb > 192 else f', {100 * uniform:.0f}% uniform tiles'}) cos "
              f"{cb:.6f}", flush=True)
        del enc, keys, values
        torch.cuda.empty_cache()
    return max(errs.values()), coss


# (enc side, output side, key side) of the main path's keys-kernel calls:
# 448^2 + 28^2 (identity pool-up), 448^2 -> 2048^2 + 128^2 (ragged pool-up)
# and a 2048^2 guide + 128^2
KEYS_SHAPES = {"448": (448, 448, 28), "448to2048": (448, 2048, 128), "2048": (2048, 2048, 128)}


def phase_keys(dev, card):
    """The keys kernel (``rope_keys``: pooled RoPE keys and K2's cos|sin
    tables) against its f32 plain version on the same inputs at every shape
    of KEYS_SHAPES, bf16 at NAF's widths (C 256, 4 RoPE heads): keys within
    one rounding of the f32 keys, |got - ref| <= 2^-8 |ref| + 1e-5 max|ref|
    (the kernel sums in f32 and rounds once), tables equal to 1e-6; one
    launch a call; the kernel's device time (torch.profiler) beside the
    plain version's and the bound, max(bytes / peak bandwidth, FLOPs / f32
    peak): enc read once, the keys and both tables written once, 4 FLOPs an
    element read. No single PyTorch call computes the function."""
    from naf_torch.kernels.rope_keys import rope_keys, rope_keys_ref
    from naf_torch.nn.rope import RoPE

    bw_peak = _peaks(card)[0]
    gen = torch.Generator(device=dev).manual_seed(23)
    rope = RoPE(256, 4).to(dev)
    res = {}
    for label, (hi, out, hk) in KEYS_SHAPES.items():
        enc = torch.randn(1, hi, hi, 256, generator=gen, device=dev).bfloat16()
        up, down = (out, out), (hk, hk)
        before = rope_keys.launches
        keys, rows_tab, cols_tab = rope_keys(rope, enc, up, down)
        torch.cuda.synchronize()
        if rope_keys.launches - before != 1:
            raise AssertionError(f"keys kernel {label}: {rope_keys.launches - before} launches")
        ref_keys, ref_rows, ref_cols = rope_keys_ref(rope, enc.float(), up, down)
        err = (keys.float() - ref_keys).abs()
        bar = 2.0 ** -8 * ref_keys.abs() + 1e-5 * ref_keys.abs().max()
        share = float((err / bar).max())
        if share > 1.0:
            raise AssertionError(f"keys kernel {label}: keys {share:.3f} of the one-rounding bar")
        tab_err = max(float((rows_tab - ref_rows).abs().max()),
                      float((cols_tab - ref_cols).abs().max()))
        if tab_err > 1e-6:
            raise AssertionError(f"keys kernel {label}: tables off by {tab_err:.3e}")
        del keys, rows_tab, cols_tab, ref_keys, ref_rows, ref_cols, bar
        ms = _kernel_ms(lambda: rope_keys(rope, enc, up, down), "rope_keys", reps=20)
        plain = _time_ms(lambda: rope_keys_ref(rope, enc, up, down), iters=3)
        nbytes = 2 * (enc.numel() + hk * hk * 256) + 4 * 2 * out * 2 * 256
        flops = 4 * enc.numel()
        bound = max(nbytes / bw_peak, flops / F32_FLOPS) * 1e3
        res[label] = dict(max_abs_err=float(err.max()), bar_share=share, table_err=tab_err,
                          ms=ms, plain_ms=plain, bound_ms=bound,
                          bound_by="bytes" if nbytes / bw_peak > flops / F32_FLOPS
                          else "operations", library_ms=None)
        print(f"keys kernel {label} (enc {hi}^2 x 256 -> {out}^2 -> {hk}^2, bf16): max_abs_err "
              f"{float(err.max()):.3e} ({share:.3f} of the one-rounding bar), tables "
              f"{tab_err:.1e}; kernel {ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%}); "
              f"plain {plain:.3f} ms ({card})", flush=True)
        del enc, err
        torch.cuda.empty_cache()
    return res


# (batch, side) of the stem kernel's shapes: the inference cells' 448^2 guide,
# the denoiser's batch of 8 at 448^2, and the 2048^2 guide
STEM_SHAPES = {"448": (1, 448), "448_b8": (8, 448), "2048": (1, 2048)}


def _spacing(v, dtype):
    """The io dtype's rounding step at |v| (bf16: 8 significant bits)."""
    bits = {torch.bfloat16: 8, torch.float32: 24}[dtype]
    m = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - (bits - 1))


def stem_check(label, x, weight, bias):
    """The stem kernel on CUDA tensors against its plain version on the same
    inputs, cuDNN's TF32 off. bf16: y within one rounding step at each of
    its two rounding points (the f32 conv's, and y's after the bias add)
    and equal on >= 99.9% of its elements; f32: within (3k^2 + 1) 2^-24 of
    the sum of the terms' magnitudes of a float64 conv. The sums and the
    per-tile partials against those of the kernel's own y, in float64, to
    1e-5 of the sums of magnitudes. One launch. Returns (max abs err of y,
    share of y equal, worst sums error as a share of its bar)."""
    from naf_torch.kernels import encoder_fused as ef

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = ef.stem_conv_fused.launches
        y, part = ef._launch_stem_tiles(x, weight, bias)
        torch.cuda.synchronize()
        if ef.stem_conv_fused.launches - before != 1:
            raise AssertionError(f"stem {label}: {ef.stem_conv_fused.launches - before} launches")
        conv = ef._conv_nhwc(x, weight)
        want = (conv.to(x.dtype) + bias.to(x.dtype)).float()
        err = (y.float() - want).abs()
        if x.dtype == torch.bfloat16:
            bar = _spacing(conv, x.dtype) + _spacing(want, x.dtype)
        else:
            k = weight.shape[-1]
            want = (ef._conv_nhwc(x.double(), weight.double()) + bias.double()).float()
            err = (y - want).abs()
            mag = ef._conv_nhwc(x.double().abs(), weight.double().abs()) + bias.double().abs()
            bar = ((3 * k * k + 1) * 2.0 ** -24 * mag).float()
        del conv
        worst = float((err / bar).max())
        same = float((err == 0).double().mean())
        if worst > 1.0 or (x.dtype == torch.bfloat16 and same < 0.999):
            raise AssertionError(f"stem {label}: y {worst:.3f} of its bar, {same:.5f} equal")
        # [sum |y|, sum y^2] is the magnitude of [sum y, sum y^2]
        yd = y.double()
        tiles, tile_mags = ef.stem_tile_sums_ref(yd), ef.stem_tile_sums_ref(yd.abs())
        sum_share = max(
            float(((part.sum(dim=1).double() - tiles.sum(dim=1)).abs()
                   / (1e-5 * tile_mags.sum(dim=1) + 1e-30)).max()),
            float(((part.double() - tiles).abs() / (1e-5 * tile_mags + 1e-30)).max()))
        if sum_share > 1.0:
            raise AssertionError(f"stem {label}: sums {sum_share:.3f} of their 1e-5 bar")
        return float(err.max()), same, sum_share
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def phase_stem(dev, card):
    """Phase 24: the stem kernel (both stacks' stems, F 128, k 1 and 3, bf16,
    NAF's init scale) at STEM_SHAPES through :func:`stem_check`; its device
    time per forward (torch.profiler: the kernel, and the wrapper's whole
    work with its sum over tiles) beside the bound, max(bytes / peak
    bandwidth, FLOPs / f32 peak) per stack with the image read once and y
    and the partials written once, and beside the plain glue it replaces,
    timed as the port served it (cuDNN's TF32 on)."""
    from naf_torch.kernels.encoder_fused import stem_conv_fused, stem_conv_ref

    bw_peak = _peaks(card)[0]
    gen = torch.Generator(device=dev).manual_seed(24)
    f = 128
    stems = [(k, (torch.randn(f, 3, k, k, generator=gen, device=dev) * (3 * k * k) ** -0.5)
              .bfloat16(), (torch.randn(f, generator=gen, device=dev) * 0.1).bfloat16())
             for k in (1, 3)]
    res = {}
    for label, (b, side) in STEM_SHAPES.items():
        x = torch.randn(b, side, side, 3, generator=gen, device=dev).bfloat16()
        checks = [stem_check(f"{label} k{k}", x, w, bias) for k, w, bias in stems]
        both = lambda: [stem_conv_fused(x, w, bias) for _, w, bias in stems]  # noqa: E731
        plain = lambda: [stem_conv_ref(x, w, bias) for _, w, bias in stems]  # noqa: E731
        kernel_ms = _kernel_ms(both, "stem_conv_kernel", reps=20)
        ms = _kernel_ms(both, None, reps=20)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            plain_ms = _kernel_ms(plain, None, reps=5)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        tiles = -(-side // 8) * -(-side // 16)
        bound = 0.0
        flops_all = nbytes_all = 0
        for k, _, _ in stems:
            nbytes = 2 * b * side * side * (3 + f) + 4 * b * tiles * 2 * f
            flops = 2 * b * side * side * f * 3 * k * k
            bound += max(nbytes / bw_peak, flops / F32_FLOPS) * 1e3
            flops_all += flops
            nbytes_all += nbytes
        res[label] = dict(max_abs_err=max(c[0] for c in checks),
                          share_equal=min(c[1] for c in checks),
                          sums_bar_share=max(c[2] for c in checks), ms=ms,
                          kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by="operations" if flops_all / F32_FLOPS > nbytes_all / bw_peak
                          else "bytes", library_ms=None)
        print(f"stem kernel {label} ({b} x {side}^2 x 3 -> 2 x {f}, k 1 and 3, bf16): y max abs "
              f"err {res[label]['max_abs_err']:.3e}, {res[label]['share_equal']:.5%} equal to "
              f"the plain y; sums {res[label]['sums_bar_share']:.3f} of their bar; both stems "
              f"{ms:.4f} ms (kernels {kernel_ms:.4f}), bound {bound:.4f} ms "
              f"({bound / kernel_ms:.1%}); plain glue {plain_ms:.4f} ms ({card})", flush=True)
        del x
        torch.cuda.empty_cache()
    return res


def phase_main(dev, card):
    from naf_torch import NAFUpsampler, load_naf_params
    from naf_torch.kernels.encoder_fused import (
        gn_silu_conv_dual_fused,
        gn_silu_conv_fused,
        stem_conv_fused,
    )
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
    from naf_torch.kernels.rope_keys import rope_keys

    ups = NAFUpsampler(seed=0, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    reqs = [((448, 448), (28, 28), (448, 448))] * 3 + [((448, 448), (28, 28), (2048, 2048))]
    inputs = [(torch.randn(1, 3, *im, generator=gen, device=dev),
               torch.randn(1, 384, *lr, generator=gen, device=dev), out)
              for im, lr, out in reqs]
    outs = []
    torch.cuda.synchronize()
    _zero_counts()
    for image, feats, out in inputs:
        k1, k2 = gn_silu_conv_fused.launches, naf_upsample_attention.launches
        kk, ks = rope_keys.launches, stem_conv_fused.launches
        o = ups(image, feats, out)
        if (gn_silu_conv_fused.launches - k1, naf_upsample_attention.launches - k2,
                rope_keys.launches - kk, stem_conv_fused.launches - ks) != (8, 1, 1, 2):
            raise AssertionError("a forward did not launch K1 8 times, K2 once, the keys "
                                 "kernel once and the stem kernel twice")
        outs.append(o)
    torch.cuda.synchronize()
    launches = {"k1": gn_silu_conv_fused.launches, "k2": naf_upsample_attention.launches,
                "k2_wgmma": naf_upsample_attention.route_launches["wgmma"],
                "keys": rope_keys.launches, "stem": stem_conv_fused.launches,
                "k6": gn_silu_conv_dual_fused.launches}
    if launches != {"k1": 8 * len(reqs), "k2": len(reqs), "k2_wgmma": len(reqs),
                    "keys": len(reqs), "stem": 2 * len(reqs), "k6": 0}:
        raise AssertionError(f"launch counts {launches}: every bf16 K2 on the wgmma route, "
                             "no K6")
    for (image, feats, out), o in zip(inputs, outs):
        if o.shape != (1, 384, *out) or o.dtype != torch.bfloat16 or not bool(o.isfinite().all()):
            raise AssertionError(f"bad output {tuple(o.shape)} {o.dtype} for {out}")
    print(f"main path: 3 x 448^2 and 1 x 448^2->2048^2 served; launches {launches}", flush=True)

    # the same model's modular path: plain attention oracle on the card
    image, feats, out = inputs[0]
    with torch.inference_mode():
        mod, weights = ups.model(image.bfloat16().permute(0, 2, 3, 1).contiguous(),
                                 feats.bfloat16().permute(0, 2, 3, 1).contiguous(), out,
                                 return_weights=True)
    c_mod = _check_cos("main path vs modular path", outs[0].permute(0, 2, 3, 1).float(),
                       mod.float(), 0.999)
    del outs, mod, weights

    # an f32 copy of the model on the CPU runs only plain code
    cpu_model = load_naf_params(seed=0, device="cpu", dtype=torch.float32)
    im224 = torch.randn(1, 3, 224, 224, generator=gen, device=dev)
    ft14 = torch.randn(1, 384, 14, 14, generator=gen, device=dev)
    got = ups(im224, ft14, (224, 224)).float().cpu()
    with torch.inference_mode():
        want = cpu_model(im224.cpu().permute(0, 2, 3, 1).contiguous(),
                         ft14.cpu().permute(0, 2, 3, 1).contiguous(), (224, 224))
    c_cpu = _check_cos("card bf16 vs CPU f32 at 224^2", got.permute(0, 2, 3, 1), want, 0.999)
    print(f"main path vs modular cos {c_mod:.6f}; vs CPU f32 cos {c_cpu:.6f}", flush=True)
    c96 = _serve_dim96(dev, gen)

    stats = {}
    for label, (image, feats, out) in (("448", inputs[0]), ("2048", inputs[3])):
        ms = _time_ms(lambda: ups(image, feats, out), iters=10 if label == "448" else 3)
        # the forward's own peak: above what is allocated before it (weights,
        # the requests' inputs, cached tables)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ups(image, feats, out)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"forward 448^2 -> {label}^2 bf16: {ms:.3f} ms, peak {peak:.1f} MiB ({card})",
              flush=True)
        prof = _profile(lambda: ups(image, feats, out), f"448^2 -> {label}^2")
        stats[label] = (ms, peak, prof)
    del inputs
    torch.cuda.empty_cache()
    return launches, stats, c96, _guide_peak_frames(ups, gen, dev)


def _guide_peak_frames(ups, gen, dev):
    """A 2048^2 guide + 128^2 x 384 -> 2048^2 forward's own peak, attributed
    by allocating frame (``_peak_by_frame``): which of the forward's
    buffers are live when its memory peaks."""
    image = torch.randn(1, 3, 2048, 2048, generator=gen, device=dev)
    feats = torch.randn(1, 384, 128, 128, generator=gen, device=dev)
    ups(image, feats, (2048, 2048))
    peak, live, frames = _peak_by_frame(lambda: ups(image, feats, (2048, 2048)))
    print(f"forward 2048^2 guide -> 2048^2 bf16: peak {peak:.1f} MiB above its start, "
          f"{live:.1f} MiB of it allocated in the call; live at the peak, by frame:", flush=True)
    for key, mib, n in frames:
        print(f"  {mib:9.1f} MiB in {n:3d} blocks: {key}", flush=True)
    del image, feats
    torch.cuda.empty_cache()
    return dict(peak_mib=peak, live_mib=live, frames=[dict(frame=k, mib=m, blocks=n)
                                                      for k, m, n in frames])


def _serve_dim96(dev, gen):
    """NAF(dim=96), the denoising kernel-size ablation's width (hidden 48:
    K1's F zero-padded to 64 by its wrapper), serves one 448^2 request in
    bf16 with 8 K1 and 1 K2 launches, held against an f32 copy of the model
    on the CPU."""
    from naf_torch import NAFUpsampler, load_naf_params
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    ups = NAFUpsampler(seed=3, device=dev, dtype=torch.bfloat16, dim=96)
    image = torch.randn(1, 3, 448, 448, generator=gen, device=dev)
    feats = torch.randn(1, 384, 28, 28, generator=gen, device=dev)
    before = _all_counts()
    got = ups(image, feats, (448, 448))
    torch.cuda.synchronize()
    after = _all_counts()
    delta = tuple(after[k] - before[k] for k in ("k1", "k2", "k2_wgmma"))
    if delta != (8, 1, 1):
        raise AssertionError(f"NAF(dim=96) launched (K1, K2, K2 on wgmma) {delta}, want "
                             "(8, 1, 1)")
    cpu_model = load_naf_params(seed=3, device="cpu", dtype=torch.float32, dim=96)
    with torch.inference_mode():
        want = cpu_model(image.cpu().permute(0, 2, 3, 1).contiguous(),
                         feats.cpu().permute(0, 2, 3, 1).contiguous(), (448, 448))
    c = _check_cos("NAF(dim=96) card bf16 vs CPU f32 at 448^2",
                   got.float().cpu().permute(0, 2, 3, 1), want, 0.999)
    print(f"NAF(dim=96) 448^2 <- 28^2 x 384 bf16: launches K1 8, K2 1 (wgmma); vs CPU f32 cos "
          f"{c:.6f}", flush=True)
    return c


def _profile(fn, label, reps=3):
    """Device time per forward by kernel (torch.profiler, CUPTI), and the
    share of the forward's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    rows = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): operator and autograd
        # records on the host carry their kernels' time again
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = e.self_device_time_total / reps / 1e3
    busy = sum(rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:8]
    # K1's kernels: the tensor-core one (bf16) and the CUDA-core one (f32)
    k1 = sum(v for k, v in rows.items() if "gn_silu_conv" in k and "dual" not in k)
    k2 = sum(v for k, v in rows.items() if "fused_q_kernel" in k or "fused_q_wgmma" in k)
    print(f"profile {label}: device busy {busy:.3f} of {wall:.3f} ms wall "
          f"({100 * busy / wall:.1f}%); K1 {k1:.3f} ms ({100 * k1 / busy:.1f}% of busy), K2 "
          f"{k2:.3f} ms; top: " + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)
    return dict(busy_ms=busy, wall_ms=wall, k1_ms=k1, k2_ms=k2)


def phase_grads(dev):
    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused, gn_silu_conv_ref
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
    from naf_torch.kernels.na2d_fused_q import (
        naf_upsample_attention,
        naf_upsample_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * s).requires_grad_()

    x, sc, sh = rnd(1, 16, 16, 128), rnd(1, 128, s=0.2), rnd(1, 128, s=0.1)
    w, b = rnd(128, 128, 3, 3, s=0.03), rnd(128, s=0.1)
    cy, cp = torch.randn(1, 16, 16, 128, generator=gen, device=dev), torch.randn(
        1, 2, 128, generator=gen, device=dev) * 1e-2
    ins = (x, sc, sh, w, b)
    grads = []
    # K1's backward recomputes its plain version, whose convolution backward
    # cuDNN may sum in another order on each call (one element 3.4e-3 apart
    # in one run): deterministic algorithms make the two comparable
    torch.backends.cudnn.deterministic = True
    for fn in (gn_silu_conv_fused, gn_silu_conv_ref):
        y, ps = fn(*ins)
        grads.append(torch.autograd.grad((y * cy).sum() + (ps * cp).sum(), ins))
    torch.backends.cudnn.deterministic = False
    for a, r, n in zip(*grads, ("x", "scale", "shift", "weight", "bias")):
        _check_close(f"K1 gradient d{n}", a, r, 2e-3)

    from naf_torch.nn.rope import RoPE

    rope = RoPE(128, 2).to(dev)
    enc, values = rnd(1, 32, 32, 128), rnd(1, 16, 16, 96)
    keys = rope.pooled(enc.detach(), (64, 64), (16, 16)).contiguous().requires_grad_()
    sin_r, cos_r, sin_c, cos_c = rope.tables(64, 64)
    rt, ct = torch.cat([cos_r, sin_r], -1), torch.cat([cos_c, sin_c], -1)
    cot = torch.randn(1, 64, 64, 96, generator=gen, device=dev)
    grads = []
    before = (cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches)
    for fn in (naf_upsample_attention, naf_upsample_attention_ref):
        o = fn(enc, keys, values, rt, ct, 64, num_heads=2, kernel_size=9)
        grads.append(torch.autograd.grad((o * cot).sum(), (enc, keys, values)))
    after = (cross_scale_na2d_fused.launches, cross_scale_na2d_fused.bwd_launches)
    if after != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"K2's backward did not run K3 and K4 once each: {before} -> {after}")
    for a, r in zip(*grads):
        _check_close("K2 gradient", a, r, 2e-3)
    print("gradients of K1 and K2 match autograd of their plain versions (2e-3); K2's "
          "backward ran K3 and K4", flush=True)


# (B, Hq, Hk, n, d, dv): the training step's attention and the K2 twin's 448^2 <- 28^2
K34_SHAPES = {"train": (4, 32, 16, 4, 64, 192), "448": (1, 448, 28, 4, 64, 96)}
# checked beside them: a ragged ratio whose windows repeat LR cells, and the
# denoiser's values (the 3-channel image: dv 3 with one head, 1 with three)
K34_CHECKED = {**K34_SHAPES, "100": (1, 100, 28, 4, 64, 96), "dv3": (1, 448, 28, 1, 64, 3),
               "dv1": (1, 448, 28, 3, 32, 1),
               # the distillation step's (naf_torch.evals.distill: NAF(), ViT-S/16, batch 4,
               # 16^2 queries) at the ends of its lr grid, 4 and 10 cells: a window of 9
               # wider than the grid, and a grid wider than the window
               "distill4": (4, 16, 4, 4, 64, 96), "distill10": (4, 16, 10, 4, 64, 96)}
# boxes above 192 cells, which the bf16 kernels take in chunks, with their
# window size: NAF(dim=96) as a denoiser (ratio 1, one head, d 96, the 3
# image channels as values) and the training widths at k 11; bf16 only (the
# f32 route's K4 holds no tile of the training widths at k 11)
K34_LARGE = {"denoise": ((1, 256, 256, 1, 96, 3), 9), "train_k11": ((4, 64, 32, 4, 64, 192), 11)}


def _k34_inputs(dev, gen, shape):
    b, hq, hk, n, d, dv = shape
    q = torch.randn(b, hq, hq, n, d, generator=gen, device=dev)
    k = torch.randn(b, hk, hk, n, d, generator=gen, device=dev)
    v = torch.randn(b, hk, hk, n, dv, generator=gen, device=dev)
    g = torch.randn(b, hq, hq, n, dv, generator=gen, device=dev)
    return q, k, v, g


def phase_k34(dev):
    """K3 and K4 against their plain versions: bf16 on the tensor-core
    kernels, f32 on the CUDA-core ones, each call counted on its route; K4's
    bf16 dk/dv bitwise equal over two runs."""
    from naf_torch.kernels.na2d_fused import (
        TC_CHUNK,
        _launch_bwd,
        _plan_tc,
        cross_scale_na2d_fused,
        cross_scale_na2d_fused_bwd_ref,
        cross_scale_na2d_fused_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(5)
    errs = {"k3": 0.0, "k4": 0.0}
    routes = cross_scale_na2d_fused.route_launches
    for label, shape in K34_CHECKED.items():
        q, k, v, g = _k34_inputs(dev, gen, shape)
        want = cross_scale_na2d_fused_ref(q, k, v, 9)
        want_g = cross_scale_na2d_fused_bwd_ref(q, k, v, g, 9)
        for dt, route in ((torch.float32, "fma"), (torch.bfloat16, "wgmma")):
            before = (routes[route], routes[f"{route}_bwd"])
            ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
            out = cross_scale_na2d_fused(*ins, 9)
            got_g = torch.autograd.grad(out, ins, g.to(dt))
            torch.cuda.synchronize()
            if (routes[route], routes[f"{route}_bwd"]) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"K3/K4 {dt} {label} did not run on the {route} route")
            if dt == torch.float32:
                e3 = _check_close(f"K3 f32 {label}", out, want, 2e-4)
                e4 = max(_check_close(f"K4 f32 {label} d{n}", a, w, 2e-3)
                         for a, w, n in zip(got_g, want_g, "qkv"))
                errs["k3"], errs["k4"] = max(errs["k3"], e3), max(errs["k4"], e4)
            else:
                c3 = _check_cos(f"K3 bf16 {label}", out.float(), want, 0.9995)
                c4 = [_check_cos(f"K4 bf16 {label} d{n}", a.float(), w, 0.9995)
                      for a, w, n in zip(got_g, want_g, "qkv")]
                again = _launch_bwd(*(t.detach() for t in ins), g.to(dt), 9, shape[4] ** -0.5)
                if not all(torch.equal(a, b) for a, b in zip(got_g[1:], again[1:])):
                    raise AssertionError(f"K4 bf16 {label}: dk/dv differ between two runs")
            del out, got_g, ins
        print(f"K3/K4 {label} {tuple(shape)}: f32 (CUDA cores) max_abs_err K3 {e3:.3e} K4 "
              f"{e4:.3e}; bf16 (wgmma) cos K3 {c3:.6f} K4 dq/dk/dv "
              + "/".join(f"{c:.6f}" for c in c4) + "; K4 dk/dv bitwise reproducible",
              flush=True)
        del q, k, v, g, want, want_g
        torch.cuda.empty_cache()
    for label, (shape, ks) in K34_LARGE.items():
        q, k, v, g = _k34_inputs(dev, gen, shape)
        want = cross_scale_na2d_fused_ref(q, k, v, ks)
        want_g = cross_scale_na2d_fused_bwd_ref(q, k, v, g, ks)
        keys = ("wgmma", "wgmma_bwd", "wgmma_chunked_bwd")
        before = [routes[r] for r in keys]
        ins = [t.bfloat16().requires_grad_() for t in (q, k, v)]
        out = cross_scale_na2d_fused(*ins, ks)
        got_g = torch.autograd.grad(out, ins, g.bfloat16())
        torch.cuda.synchronize()
        if [routes[r] - n for r, n in zip(keys, before)] != [1, 1, 1]:
            raise AssertionError(f"K3/K4 bf16 {label} did not run on the wgmma route, K4 on "
                                 "its chunked boxes' two launches")
        c3 = _check_cos(f"K3 bf16 {label}", out.float(), want, 0.9995)
        c4 = [_check_cos(f"K4 bf16 {label} d{n}", a.float(), w, 0.9995)
              for a, w, n in zip(got_g, want_g, "qkv")]
        _, hq, hk, _, d, dv = shape
        nb = _plan_tc(hq, hq, hk, hk, ks, -(-d // 16) * 16, -(-dv // 16) * 16, True,
                      str(dev))[4]
        print(f"K3/K4 bf16 {label} {tuple(shape)}, k {ks}: box of {nb} cells in chunks of "
              f"{TC_CHUNK} (wgmma; K4 from K3's log-sum-exp, query- and key-major); cos K3 "
              f"{c3:.6f} K4 dq/dk/dv "
              + "/".join(f"{c:.6f}" for c in c4), flush=True)
        del q, k, v, g, want, want_g, out, got_g, ins
    _k4_bands(dev, gen)
    errs.update(_k4_banded(dev, gen))
    torch.cuda.empty_cache()
    return errs


# phase 4's banded K4: LR cell rows [7, 14) of 448^2 <- 28^2 (query rows 112 to
# 224), an interior band of the spatial train step's attention (space 4)
K4_BAND_CELLS = (7, 7)


def _k4_banded(dev, gen):
    """K3/K4 on one interior band (``row_cell0``, ``full_hq``) of 448^2 <-
    28^2 under autograd, against the plain versions on the band: f32 (CUDA
    cores) out 2e-4, dq 2e-4, dk/dv 2e-3; bf16 (tensor cores) cosine >
    0.9995; each call one K3 and one K4 launch on its route. Then the bf16
    band's K4 split into row bands by a lowered partials budget, against
    one launch (cosine >= 0.99999) and the plain version."""
    from naf_torch.kernels import na2d_fused as na

    routes = na.cross_scale_na2d_fused.route_launches
    b, hq, hk, n, d, dv = K34_SHAPES["448"]
    c0, cells = K4_BAND_CELLS
    r = hq // hk
    rows = slice(c0 * r, (c0 + cells) * r)
    q, k, v, g = _k34_inputs(dev, gen, K34_SHAPES["448"])
    q, g = q[:, rows].contiguous(), g[:, rows].contiguous()
    band = dict(row_cell0=c0, full_hq=hq)
    want = na.cross_scale_na2d_fused_ref(q, k, v, 9, **band)
    want_g = na.cross_scale_na2d_fused_bwd_ref(q, k, v, g, 9, **band)
    res = {}
    for dt, route in ((torch.float32, "fma"), (torch.bfloat16, "wgmma")):
        before = (routes[route], routes[f"{route}_bwd"])
        ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
        out = na.cross_scale_na2d_fused(*ins, 9, **band)
        got_g = torch.autograd.grad(out, ins, g.to(dt))
        torch.cuda.synchronize()
        if (routes[route], routes[f"{route}_bwd"]) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"K3/K4 banded {dt} did not run once each on the {route} "
                                 "route")
        if dt == torch.float32:
            res["k3_banded_err"] = _check_close("K3 banded f32", out, want, 2e-4)
            errs = [_check_close(f"K4 banded f32 d{nm}", a, w, tol)
                    for a, w, nm, tol in zip(got_g, want_g, "qkv", (2e-4, 2e-3, 2e-3))]
            res["k4_banded_err"] = max(errs)
        else:
            res["k4_banded_cos"] = [_check_cos(f"K4 banded bf16 d{nm}", a.float(), w, 0.9995)
                                    for a, w, nm in zip(got_g, want_g, "qkv")]
            one = got_g
        del out, ins
    qb, kb, vb, gb = (t.bfloat16() for t in (q, k, v, g))
    budget = na.PARTIAL_BUDGET
    na.PARTIAL_BUDGET = 64 * 2**20
    try:
        before = routes["wgmma_bwd"]
        split = na._launch_bwd(qb, kb, vb, gb, 9, d ** -0.5, c0 * r, hq)
        bands = routes["wgmma_bwd"] - before
    finally:
        na.PARTIAL_BUDGET = budget
    if bands < 2:
        raise AssertionError(f"K4 banded under a 64 MiB budget: {bands} launch(es)")
    cos = [min(_check_cos(f"K4 banded split vs plain d{nm}", a.float(), w, 0.9995),
               _check_cos(f"K4 banded split vs one launch d{nm}", a.float(), o.float(),
                          0.99999))
           for a, o, w, nm in zip(split, one, want_g, "qkv")]
    print(f"K4 banded 448^2 <- 28^2, LR cell rows [{c0}, {c0 + cells}) (query rows "
          f"{rows.start}-{rows.stop}): f32 (CUDA cores) max_abs_err K3 "
          f"{res['k3_banded_err']:.3e} K4 {res['k4_banded_err']:.3e}; bf16 (wgmma) cos K4 "
          f"dq/dk/dv " + "/".join(f"{c:.6f}" for c in res["k4_banded_cos"])
          + f"; in {bands} row bands under a 64 MiB budget cos dq/dk/dv "
          + "/".join(f"{c:.6f}" for c in cos), flush=True)
    res["k4_banded_split_bands"] = bands
    return res


def _k4_bands(dev, gen):
    """K4's f32 box partials at 448^2 <- 28^2 bf16: the peak of one call,
    and the same call in bands of query rows under a budget of 256 MiB,
    held against the plain version and one launch, bitwise over two runs."""
    from naf_torch.kernels import na2d_fused as na

    routes = na.cross_scale_na2d_fused.route_launches
    shape = K34_SHAPES["448"]
    q, k, v, g = _k34_inputs(dev, gen, shape)
    want = na.cross_scale_na2d_fused_bwd_ref(q, k, v, g, 9)
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    sc = shape[4] ** -0.5
    call = lambda: na._launch_bwd(q, k, v, g, 9, sc)
    whole = call()
    peak = _peak_mib(call)
    tqh, tqw, urh, urw = na._plan_tc(448, 448, 28, 28, 9, 64, 96, True, str(dev))[:4]
    part = -(-448 // tqh) * -(-448 // tqw) * 4 * urh * urw * 160 * 4 / 2**20
    budget = na.PARTIAL_BUDGET
    na.PARTIAL_BUDGET = 256 * 2**20
    try:
        before = routes["wgmma_bwd"]
        banded = call()
        bands = routes["wgmma_bwd"] - before
        again = call()
        peak_banded = _peak_mib(call)
    finally:
        na.PARTIAL_BUDGET = budget
    if bands < 2 or not all(torch.equal(a, b) for a, b in zip(banded, again)):
        raise AssertionError(f"K4 in bands: {bands} launches, or two runs differ")
    cos = [min(_check_cos(f"K4 bands vs plain d{n}", a.float(), w, 0.9995),
               _check_cos(f"K4 bands vs one launch d{n}", a.float(), b.float(), 0.99999))
           for a, b, w, n in zip(banded, whole, want, "qkv")]
    print(f"K4 bf16 448^2 <- 28^2: one launch, {part:.1f} MiB of f32 partials, call peak "
          f"{peak:.1f} MiB; in {bands} bands under a 256 MiB budget, call peak "
          f"{peak_banded:.1f} MiB, cos dq/dk/dv " + "/".join(f"{c:.6f}" for c in cos)
          + ", bitwise reproducible", flush=True)


PROD_NAF = dict(dim=256, heads_attn=4, heads_rope=4, kernel_size=9, use_encoder=True,
                img_layers=2, rope_rescale=2.0)
BACKBONE = "vit_base_patch14_dinov2.lvd142m"
IMG_SIZE, BATCH, STEPS = 448, 4, 20


def _images(batch, size, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    while True:
        yield rng.rand(batch, size, size, 3).astype(np.float32)


def _counts():
    """(K1, K3, K4) launch counts: the training path's kernels."""
    c = _all_counts()
    return c["k1"], c["k3"], c["k4"]


def _all_counts() -> dict:
    """Every kernel's launches (``naf_torch.kernels.launch_counts``) and
    K2's and K5's by route."""
    from naf_torch.kernels import launch_counts
    from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    k2_routes = naf_upsample_attention.route_launches
    return {**launch_counts(), "k2_wgmma": k2_routes["wgmma"], "k2_fma": k2_routes["fma"],
            "k2_fma_chunked": k2_routes["fma_chunked"],
            "k5_narrow": adaptive_conv_fused.route_launches["narrow"],
            "k5_wide": adaptive_conv_fused.route_launches["wide"]}


def _zero_counts():
    from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused
    from naf_torch.kernels.encoder_fused import (
        gn_silu_conv_dual_fused,
        gn_silu_conv_fused,
        stem_conv_fused,
    )
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
    from naf_torch.kernels.rope_keys import rope_keys

    gn_silu_conv_fused.launches = naf_upsample_attention.launches = rope_keys.launches = 0
    stem_conv_fused.launches = 0
    naf_upsample_attention.route_launches = dict.fromkeys(naf_upsample_attention.route_launches, 0)
    cross_scale_na2d_fused.launches = cross_scale_na2d_fused.bwd_launches = 0
    cross_scale_na2d_fused.route_launches = dict.fromkeys(cross_scale_na2d_fused.route_launches, 0)
    adaptive_conv_fused.launches = gn_silu_conv_dual_fused.launches = 0
    adaptive_conv_fused.route_launches = dict.fromkeys(adaptive_conv_fused.route_launches, 0)


def _step_inputs(backbone, img, dev):
    from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD

    x = torch.as_tensor(img, device=dev)
    ups = ((x - torch.tensor(IMAGENET_DEFAULT_MEAN, device=dev))
           / torch.tensor(IMAGENET_DEFAULT_STD, device=dev))
    return ups, backbone.normalize(x)


def phase_train(dev, card, workdir):
    import numpy as np

    from naf_torch.backbones import PretrainedViTWrapper
    from naf_torch.models.naf import NAF
    from naf_torch.train.trainer import (
        TrainConfig,
        load_checkpoint,
        make_optimizer,
        make_train_step,
        train_upsampler,
    )

    # the bf16 run as users run it: PyTorch's default lets cuDNN use TF32
    # for the f32 convolutions (K1's plain backward); the f32 check below
    # turns it off again
    torch.backends.cudnn.allow_tf32 = True
    backbone = PretrainedViTWrapper(BACKBONE, dtype=torch.bfloat16, device=dev, seed=0)
    cfg = TrainConfig(train_steps=STEPS, img_size=IMG_SIZE, lr=2e-4, weight_decay=1e-5,
                      batch_size=BATCH, use_bf16=True, log_every=1, ckpt_every=STEPS,
                      viz_every=0, log_dir=os.path.join(workdir, "train"), seed=0)
    marks, events = [], []

    def counted(data):
        for batch in data:
            marks.append(_counts())
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch

    torch.cuda.synchronize()
    _zero_counts()
    model = train_upsampler(NAF(**PROD_NAF), backbone, counted(_images(BATCH, IMG_SIZE, 0)),
                            cfg, device=dev)
    torch.cuda.synchronize()
    marks.append(_counts())
    per_step = {tuple(b - a for a, b in zip(m0, m1)) for m0, m1 in zip(marks, marks[1:])}
    if len(marks) != STEPS + 1 or per_step != {(8, 1, 1)}:
        raise AssertionError(f"launches per step (K1, K3, K4) {per_step} over {len(marks) - 1} "
                             "steps, want (8, 1, 1) each")
    launches = dict(zip(("k1", "k3", "k4"), marks[-1]))
    # bf16 training runs K3/K4 on the tensor cores
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused

    launches["routes"] = dict(cross_scale_na2d_fused.route_launches)
    if launches["routes"] != {"wgmma": STEPS, "fma": 0, "fma_chunked": 0, "wgmma_bwd": STEPS,
                              "wgmma_chunked_bwd": 0, "fma_bwd": 0, "fma_chunked_bwd": 0}:
        raise AssertionError(f"K3/K4 routes over the bf16 steps: {launches['routes']}")
    loop_ms = [a.elapsed_time(b) for a, b in zip(events[1:], events[2:])]
    run = os.path.join(cfg.log_dir, "version_0")
    losses = [json.loads(line)["loss"] for line in open(os.path.join(run, "metrics.jsonl"))]
    if len(losses) != STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < 1.5 * losses[0]:
        raise AssertionError(f"loss diverged: first {losses[0]}, last {losses[-1]}")
    print(f"train: {STEPS} bf16 steps, batch {BATCH}, {IMG_SIZE}^2; launches per step K1 8, "
          f"K3 1, K4 1 (totals {launches}); loss {losses[0]:.5f} -> {losses[-1]:.5f}; loop "
          f"(loss read every step) median {sorted(loop_ms)[len(loop_ms) // 2]:.3f} ms/step",
          flush=True)

    # checkpoint written, reloaded into a fresh model, stepped once more
    saved = load_checkpoint(os.path.join(run, f"ckpt_{STEPS}.pt"))
    cfg2 = TrainConfig(**{**cfg.__dict__, "train_steps": STEPS + 1, "ckpt_every": STEPS + 1})
    resumed = train_upsampler(NAF(**PROD_NAF), backbone, _images(BATCH, IMG_SIZE, 1), cfg2,
                              params=saved["params"], opt_state=saved["opt_state"],
                              start_step=saved["step"], device=dev)
    rec = [json.loads(line) for line in
           open(os.path.join(cfg.log_dir, "version_1", "metrics.jsonl"))]
    if [r["step"] for r in rec] != [STEPS] or not np.isfinite(rec[0]["loss"]):
        raise AssertionError(f"resumed run logged {rec}")
    if not os.path.exists(os.path.join(cfg.log_dir, "version_1", f"ckpt_{STEPS + 1}.pt")):
        raise AssertionError("the resumed run wrote no checkpoint")
    del resumed
    print(f"train: checkpoint ckpt_{STEPS}.pt reloaded and stepped once more, loss "
          f"{rec[0]['loss']:.5f}", flush=True)

    # the chunked route: six images resident on the card, two chunks of two
    # steps, each batch gathered there
    stack = torch.from_numpy(next(_images(6, IMG_SIZE, 4))).to(dev)
    cfg3 = TrainConfig(**{**cfg.__dict__, "train_steps": 4, "log_every": 2, "ckpt_every": 4})
    before = _counts()
    chunked = train_upsampler(NAF(**PROD_NAF), backbone, None, cfg3, device=dev,
                              device_stack=stack)
    delta = tuple(b - a for a, b in zip(before, _counts()))
    rec = [json.loads(line) for line in
           open(os.path.join(cfg.log_dir, "version_2", "metrics.jsonl"))]
    if delta != (32, 4, 4) or [r["step"] for r in rec] != [1, 3] or \
            not all(np.isfinite(r["loss"]) for r in rec):
        raise AssertionError(f"device-stack training: launches (K1, K3, K4) {delta}, logs {rec}")
    del chunked, stack
    print("train: device-stack route, 4 steps in two chunks: launches K1 32, K3 4, K4 4; chunk "
          "losses " + ", ".join(f"{r['loss']:.5f}" for r in rec), flush=True)

    # steady-state step time, a step's peak memory, the device split
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, backbone, opt, use_bf16=True, seed=0)
    ups, back = _step_inputs(backbone, next(_images(BATCH, IMG_SIZE, 2)), dev)
    args = ((IMG_SIZE // 2,) * 2, (IMG_SIZE // 14,) * 2, (min(224, 4 * IMG_SIZE // 14),) * 2)
    step_ms = _time_ms(lambda: step(ups, back, 0, *args), iters=10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(ups, back, 0, *args)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    split = _profile_step(lambda: step(ups, back, 0, *args))
    print(f"train step bf16 batch {BATCH} {IMG_SIZE}^2: {step_ms:.3f} ms/step (10 steps, CUDA "
          f"events), peak {peak:.1f} MiB above the {base / 2**20:.1f} MiB held before it "
          f"({card})", flush=True)
    print("train step split, torch.profiler device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items() if k not in ("top", "kernels"))
          + f"; {split['kernels']:.0f} kernels per step; device busy "
          f"{100 * split['device_total'] / step_ms:.1f}% of the step time", flush=True)
    print("  top kernels: " + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in split["top"]),
          flush=True)

    # use_checkpointing recomputes the forward: K3 twice
    step_ck = make_train_step(model, backbone, opt, use_bf16=True, use_checkpointing=True)
    before = _counts()
    loss_ck = float(step_ck(ups, back, 0, *args))
    delta = tuple(b - a for a, b in zip(before, _counts()))
    if delta != (16, 2, 1) or not np.isfinite(loss_ck):
        raise AssertionError(f"use_checkpointing step: launches (K1, K3, K4) {delta}, loss "
                             f"{loss_ck}")
    print(f"train: use_checkpointing step launched K1 16, K3 2, K4 1; loss {loss_ck:.5f}",
          flush=True)
    del model, opt, step, step_ck
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    agree = _card_vs_cpu_step(dev)
    split.pop("top")
    return launches, dict(step_ms=step_ms, loop_ms=loop_ms, peak_mib=peak, split=split,
                          losses=losses, **agree)


def _profile_step(fn, reps=3, names=("naf.backbone", "naf.forward", "naf.optimizer")):
    """torch.profiler split of one train step's device time: the kernels
    launched under the trainer's ranges ``names`` (their CPU-side
    annotations; the upsampler's naf.backbone / naf.forward / naf.optimizer
    by default), and the rest, launched from autograd's device thread, as
    the backward. The device-side spans of the ranges are not kernels and are
    left out of the sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    if not total > 0:
        raise AssertionError("torch.profiler recorded no device time")
    ranges = {e.key: e.device_time_total / reps / 1e3 for e in ev
              if e.device_type == DeviceType.CPU and e.key in names}
    split = {k.split(".")[1]: ranges.get(k, 0.0) for k in names}
    split["backward"] = total - sum(split.values())
    split["device_total"] = total
    split["wall"] = wall
    split["kernels"] = sum(e.count for e in kernels) / reps
    split["top"] = sorted(((e.key, e.self_device_time_total / reps / 1e3) for e in kernels),
                          key=lambda kv: -kv[1])[:6]
    return split


def _card_vs_cpu_step(dev):
    """One f32 step of the production configuration at batch 1 on the card
    (K1, K3, K4) and on the CPU (plain code), from the same weights, image and
    rescale draw: the loss and the flattened gradients."""
    import numpy as np

    from naf_torch.api import _init_weights
    from naf_torch.backbones import PretrainedViTWrapper
    from naf_torch.models.naf import NAF
    from naf_torch.nn.rope import RopeDraws
    from naf_torch.train.trainer import make_train_step

    src = NAF(**PROD_NAF)
    _init_weights(src, 5)
    img = next(_images(1, IMG_SIZE, 3))
    args = ((IMG_SIZE // 2,) * 2, (IMG_SIZE // 14,) * 2, (min(224, 4 * IMG_SIZE // 14),) * 2)
    res = {}
    for where in ("cpu", dev):
        model = NAF(**PROD_NAF)
        model.load_state_dict(src.state_dict())
        model.to(where)
        backbone = PretrainedViTWrapper(BACKBONE, dtype=torch.float32, device=where, seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=0.0)  # the gradients are compared
        step = make_train_step(model, backbone, opt, use_bf16=False)
        ups, back = _step_inputs(backbone, img, where)
        before = _counts()
        loss = float(step(ups, back, 0, *args, draws=RopeDraws(rescale=1.37)))
        delta = tuple(b - a for a, b in zip(before, _counts()))
        res[str(where)] = (loss, torch.cat([p.grad.flatten().cpu() for p in model.parameters()]),
                           delta)
    (l_cpu, g_cpu, d_cpu), (l_gpu, g_gpu, d_gpu) = res["cpu"], res[str(dev)]
    if d_cpu != (0, 0, 0) or d_gpu != (8, 1, 1):
        raise AssertionError(f"launches (K1, K3, K4): CPU step {d_cpu}, card step {d_gpu}")
    if not abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu):
        raise AssertionError(f"card f32 loss {l_gpu} vs CPU {l_cpu}")
    c = _check_cos("card vs CPU f32 gradients", g_gpu, g_cpu, 0.999)
    print(f"train: f32 step batch 1, card vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f} "
          f"(rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}); gradient cosine {c:.6f}", flush=True)
    return dict(cpu_loss=l_cpu, card_loss=l_gpu, grad_cos=c)


def _masked_sdpa_inputs(q, k, v, ks):
    """(B, n, Hq*Wq, d) queries over all (B, n, hk*wk, d) keys with a
    boolean mask of each query's k x k window: the library yardstick of K3."""
    from naf_torch.ops.window import cross_scale_lr_indices

    b, hq, wq, n, d = q.shape
    hk, wk = k.shape[1], k.shape[2]
    ih = torch.from_numpy(cross_scale_lr_indices(hq, hk, ks)).to(q.device)
    iw = torch.from_numpy(cross_scale_lr_indices(wq, wk, ks)).to(q.device)
    rows = torch.zeros(hq, hk, dtype=torch.bool, device=q.device)
    cols = torch.zeros(wq, wk, dtype=torch.bool, device=q.device)
    rows[torch.arange(hq, device=q.device)[:, None], ih] = True
    cols[torch.arange(wq, device=q.device)[:, None], iw] = True
    mask = (rows[:, None, :, None] & cols[None, :, None, :]).reshape(hq * wq, hk * wk)
    flat = lambda t: t.flatten(1, 2).transpose(1, 2)
    return flat(q), flat(k), flat(v), mask



# (B, H, W, C, k): FeatUp's last stage, JBU at 448^2, a ragged shape, and a
# shape whose blocks walk several stages of 32 channels through the ring, the
# last chunk a tail of 8 channels; each with the route the plan gives it
K5_SHAPES = {"featup": (1, 448, 448, 384, 7), "jbu": (1, 448, 448, 3, 11),
             "ragged": (2, 37, 53, 100, 5), "stages": (2, 150, 150, 200, 3)}
K5_ROUTES = {"featup": "wide", "jbu": "narrow", "ragged": "wide", "stages": "wide"}
# FeatUp's four K5 per forward (C 384, k 7) at the sweep's 448^2 output
K5_FEATUP_STAGES = {f"featup_{s}": (1, s, s, 384, 7) for s in (56, 112, 224)}
# the routes' edges: C at the threshold (8, narrow) and above it (9, wide),
# C 3 (JBU's), C not a multiple of 4, batch 2, H and W no multiple of a tile
K5_EDGE_C = {3: "narrow", 8: "narrow", 9: "wide"}
K5_EDGE_HW = (19, 37)


def _k5_inputs(dev, gen, shape):
    """An f32 padded source and softmax-like per-pixel weights (positive,
    each window summing to 1, as FeatUp's and JBU's are)."""
    b, h, w, c, k = shape
    src = torch.randn(b, h + k - 1, w + k - 1, c, generator=gen, device=dev)
    ker = torch.rand(b, h, w, k, k, generator=gen, device=dev)
    return src, ker / ker.sum(dim=(-2, -1), keepdim=True)


def _k5_route_call(fn, route):
    """fn()'s result, checking that it launched K5 once, on ``route``."""
    from naf_torch.kernels.adaptive_conv_fused import adaptive_conv_fused

    before = dict(adaptive_conv_fused.route_launches)
    out = fn()
    delta = {k: v - before[k] for k, v in adaptive_conv_fused.route_launches.items()}
    if delta != {r: int(r == route) for r in delta}:
        raise AssertionError(f"K5 launched {delta}, want one launch on the {route} route")
    return out


def phase_k5(dev):
    from naf_torch.kernels.adaptive_conv_fused import (
        adaptive_conv_fused,
        adaptive_conv_fused_ref,
    )
    from naf_torch.ops.adaptive_conv import adaptive_conv

    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = {**K5_SHAPES, **K5_FEATUP_STAGES}
    routes = {**K5_ROUTES, **dict.fromkeys(K5_FEATUP_STAGES, "wide")}
    for c, route in K5_EDGE_C.items():
        for k in range(1, 16, 2):
            shapes[f"c{c}_k{k}"] = (2, *K5_EDGE_HW, c, k)
            routes[f"c{c}_k{k}"] = route
    errs, coss = {}, {}
    for label, shape in shapes.items():
        src, ker = _k5_inputs(dev, gen, shape)
        want = adaptive_conv_fused_ref(src, ker)
        got = _k5_route_call(lambda: adaptive_conv_fused(src, ker), routes[label])
        torch.cuda.synchronize()
        errs[label] = _check_close(f"K5 f32 {label}", got, want, 2e-4)
        gb = _k5_route_call(lambda: adaptive_conv_fused(src.bfloat16(), ker.bfloat16()),
                            routes[label])
        torch.cuda.synchronize()
        if gb.dtype != torch.bfloat16:
            raise AssertionError(f"K5 bf16 output came back as {gb.dtype}")
        coss[label] = _check_cos(f"K5 bf16 {label}", gb.float(), want, 0.9995)
        if label in K5_SHAPES or label in K5_FEATUP_STAGES:
            print(f"K5 {label} {shape} ({routes[label]}): f32 max_abs_err {errs[label]:.3e}; "
                  f"bf16 cos {coss[label]:.6f}", flush=True)
        del src, ker, want, got, gb
    edge = [k for k in shapes if k not in K5_SHAPES and k not in K5_FEATUP_STAGES]
    print(f"K5 edges, (2, {K5_EDGE_HW[0]}, {K5_EDGE_HW[1]}) at every odd k 1..15, C "
          f"{sorted(K5_EDGE_C)} ({', '.join(f'{c} {r}' for c, r in K5_EDGE_C.items())}): f32 max "
          f"abs err {max(errs[k] for k in edge):.3e}; bf16 cos >= "
          f"{min(coss[k] for k in edge):.6f}", flush=True)

    # one gradient per route: K5 forward + plain backward against autograd
    # of the plain version
    for shape in ((2, 24, 40, 64, 7), (2, 24, 40, 3, 11)):
        src, ker = (t.requires_grad_() for t in _k5_inputs(dev, gen, shape))
        cot = torch.randn(*shape[:4], generator=gen, device=dev)
        grads = [torch.autograd.grad(fn(src, ker), (src, ker), cot)
                 for fn in (adaptive_conv, adaptive_conv_fused_ref)]
        for a, r, n in zip(*grads, ("source", "kernel")):
            _check_close(f"K5 gradient d{n} at {shape}", a, r, 2e-3)
    print("gradient of adaptive_conv (K5 forward, both routes) matches autograd of its plain "
          "version (2e-3)", flush=True)
    return max(errs.values())


BASELINES = ("FeatUp", "JBU", "AnyUp", "JAFAR", "JBF", "Bilinear", "Nearest", "NAF")
# launches per forward on the baselines path; every other count stays
BASELINE_LAUNCHES = {"FeatUp": {"k5": 4, "k5_wide": 4}, "JBU": {"k5": 1, "k5_narrow": 1},
                     "AnyUp": {"k3": 1},
                     "NAF": {"k1": 8, "k2": 1, "k2_fma": 1, "keys": 1, "stem": 2}}
RESTORERS = ("JBU", "JBF")  # forward(image_norm, image, output_size)


def _baseline_inputs(dev, gen):
    """The baselines path's inputs: an image at the sweep's 448^2, normalised
    and raw, and 28^2 x 384 features; ``args(name)`` is what model ``name``
    takes besides the output size."""
    from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD

    image = torch.rand(1, 3, 448, 448, generator=gen, device=dev)
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, device=dev)[:, None, None]
    std = torch.tensor(IMAGENET_DEFAULT_STD, device=dev)[:, None, None]
    image_norm = (image - mean) / std
    feats = torch.randn(1, 384, 28, 28, generator=gen, device=dev)
    return lambda name: (image_norm, image) if name in RESTORERS else (image_norm, feats)


def phase_baselines(dev, card):
    from naf_torch.models.registry import ModelWrapper

    args = _baseline_inputs(dev, torch.Generator(device=dev).manual_seed(7))
    out = (448, 448)

    wrappers = {name: ModelWrapper(name, seed=0, device=dev) for name in BASELINES}
    outs = {}
    torch.cuda.synchronize()
    _zero_counts()
    for name in BASELINES:
        before = _all_counts()
        o = wrappers[name](*args(name), out)
        after = _all_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: BASELINE_LAUNCHES.get(name, {}).get(k, 0) for k in after}
        if delta != want:
            raise AssertionError(f"{name}: launches per forward {delta}, want {want}")
        c = 3 if name in RESTORERS else 384
        if o.shape != (1, c, *out) or o.dtype != torch.float32 or not bool(o.isfinite().all()):
            raise AssertionError(f"{name}: bad output {tuple(o.shape)} {o.dtype}")
        outs[name] = o
    torch.cuda.synchronize()
    launches = _all_counts()
    print(f"baselines path: {', '.join(BASELINES)} served 448^2 <- 28^2 x 384 in f32; "
          f"launches {launches}", flush=True)

    # AnyUp at 448^2 against its own plain attention on the card
    wrappers["AnyUp"].model.attention.impl = "xla"
    c_xla = _check_cos("AnyUp K3 vs plain attention at 448^2",
                       outs["AnyUp"], wrappers["AnyUp"](*args("AnyUp"), out), 0.999)
    wrappers["AnyUp"].model.attention.impl = "auto"

    stats = {}
    for name in BASELINES:
        size = (224, 224) if name in ("AnyUp", "JAFAR") else out
        got = outs.pop(name) if size == out else wrappers[name](*args(name), size)
        want = ModelWrapper(name, seed=0, device="cpu")(*(a.cpu() for a in args(name)), size)
        cos = _check_cos(f"{name} card vs CPU f32 at {size[0]}^2", got.cpu(), want, 0.999)
        del got, want
        fwd = lambda: wrappers[name](*args(name), out)
        ms = _time_ms(fwd, iters=10)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        stats[name] = dict(ms=ms, peak_mib=peak, cos_cpu=cos)
        print(f"{name} f32 448^2: {ms:.3f} ms per forward, peak {peak:.1f} MiB; card vs CPU "
              f"cos {cos:.6f} at {size[0]}^2 ({card})", flush=True)
        torch.cuda.empty_cache()
    print(f"AnyUp K3 vs plain attention on the card at 448^2: cos {c_xla:.6f}", flush=True)
    splits = {}
    for name in ("FeatUp", "JBU"):
        split = _split_k5(lambda: wrappers[name](*args(name), out))
        print(f"{name} profile per forward: K5 {split['k5']:.3f} ms ({split['k5_launches']:.0f} "
              f"launches), other kernels {split['other']:.3f} ms, device busy "
              f"{split['k5'] + split['other']:.3f} of {split['wall']:.3f} ms wall; top: "
              + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in split.pop("top")), flush=True)
        splits[name] = split
    for name in ("AnyUp", "JAFAR"):
        _profile(lambda: wrappers[name](*args(name), out), f"{name} f32 448^2")
    stats["AnyUp"]["cos_xla_448"] = c_xla
    return launches, stats, splits


def _split_k5(fn, reps=3):
    """torch.profiler device time per forward of a model that runs K5: K5's
    kernel against every other kernel (the glue)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    k5 = [e for e in kernels if "adaptive_conv_" in e.key]
    if not k5:
        raise AssertionError("the profile shows no K5 kernel")
    t_k5 = sum(e.self_device_time_total for e in k5) / reps / 1e3
    total = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    return dict(k5=t_k5, other=total - t_k5, wall=wall,
                k5_launches=sum(e.count for e in k5) / reps,
                top=sorted(((e.key, e.self_device_time_total / reps / 1e3) for e in kernels),
                           key=lambda kv: -kv[1])[:5])


def _time_k5(dev, card, bw_peak):
    """K5 at FeatUp's four stages and at JBU's shape, f32 (the sweep's
    dtype): device time, queued time, through the wrapper, the plain
    version, and the bound of the bytes (each input read once, the output
    written once) and of the f32 operations; the output held against the
    plain version's (phase 6 holds the route of each of these shapes)."""
    from naf_torch.kernels.adaptive_conv_fused import (
        adaptive_conv_fused,
        adaptive_conv_fused_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(8)
    res = {}
    shapes = {**K5_FEATUP_STAGES, "featup": K5_SHAPES["featup"], "jbu": K5_SHAPES["jbu"]}
    for label, shape in shapes.items():
        b, h, w, c, k = shape
        src, ker = _k5_inputs(dev, gen, shape)
        err = _check_close(f"K5 f32 {label}", adaptive_conv_fused(src, ker),
                           adaptive_conv_fused_ref(src, ker), 2e-4)
        ms = _kernel_ms(lambda: adaptive_conv_fused(src, ker), "adaptive_conv_")
        queued = _queued_ms(lambda: adaptive_conv_fused(src, ker))
        wrapper = _time_ms(lambda: adaptive_conv_fused(src, ker), iters=20)
        plain = _time_ms(lambda: adaptive_conv_fused_ref(src, ker), iters=3)
        nbytes = 4 * (src.numel() + ker.numel() + b * h * w * c)
        flops = 2 * b * h * w * c * k * k
        bound = max(nbytes / bw_peak, flops / F32_FLOPS) * 1e3
        by = "bytes" if nbytes / bw_peak > flops / F32_FLOPS else "operations"
        res[label] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                          wrapper_ms=wrapper, queued_ms=queued)
        print(f"K5 f32 {label} src {tuple(src.shape)} k {k}: kernel {ms:.4f} ms (queued "
              f"{queued:.4f} ms, through the wrapper {wrapper:.4f} ms); plain {plain:.4f} ms; "
              f"bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
              f"{ms / bound:.2f}x the bound; max abs err {err:.2e} ({card})", flush=True)
        del src, ker
    return res


def _time_k3_anyup(dev, card, bw_peak):
    """K3 at AnyUp's shape: q (1, 448, 448, 8, 32) <- k (1, 28, 28, 8, 32),
    v (1, 28, 28, 8, 48), k 7, f32; checked against its plain version, and
    masked SDPA on the same inputs as its library yardstick."""
    import torch.nn.functional as F

    from naf_torch.kernels.na2d_fused import _launch_fwd, cross_scale_na2d_fused_ref

    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v, _ = _k34_inputs(dev, gen, (1, 448, 28, 8, 32, 48))
    sc = 32 ** -0.5
    err = _check_close("K3 f32 AnyUp shape", _launch_fwd(q, k, v, 7, sc),
                       cross_scale_na2d_fused_ref(q, k, v, 7, sc), 2e-4)
    ms = _kernel_ms(lambda: _launch_fwd(q, k, v, 7, sc), "na_fwd_kernel", reps=10)
    queued = _queued_ms(lambda: _launch_fwd(q, k, v, 7, sc), reps=10)
    wrapper = _time_ms(lambda: _launch_fwd(q, k, v, 7, sc), iters=10)
    plain = _time_ms(lambda: cross_scale_na2d_fused_ref(q, k, v, 7, sc), iters=1)
    # library yardstick, as for the training shape: masked SDPA over all LR
    # keys (448 / 28 is an integer ratio), f32 as AnyUp runs
    sq, sk, sv, mask = _masked_sdpa_inputs(q, k, v, 7)
    ref = _launch_fwd(q, k, v, 7, sc)
    lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, scale=sc)
    lib_cos = _check_cos("masked SDPA vs K3 AnyUp shape",
                         lib_out.transpose(1, 2).reshape(ref.shape), ref, 0.999)
    del lib_out, ref
    sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, scale=sc)
    lib = _kernel_ms(sdpa, reps=3)
    qlib = _queued_ms(sdpa, reps=3)
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + 448 * 448 * 8 * 48)
    flops = 2 * 448 * 448 * 8 * 49 * (32 + 48)
    bound = max(nbytes / bw_peak, flops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / bw_peak > flops / F32_FLOPS else "operations"
    print(f"K3 f32 AnyUp (1,448,448,8,32) <- 28^2, dv 48, k 7, CUDA cores: kernel {ms:.4f} ms "
          f"(queued {queued:.4f} ms, through the wrapper {wrapper:.4f} ms); plain {plain:.4f} "
          f"ms; masked SDPA {lib:.4f} ms (queued {qlib:.4f} ms; cos vs K3 {lib_cos:.6f}); bound "
          f"{bound:.4f} ms ({by}); f32 max_abs_err {err:.3e} ({card})", flush=True)
    del sq, sk, sv, mask
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err, wrapper_ms=wrapper, queued_ms=queued, library_queued_ms=qlib)


def _time_k6(dev, card, bw_peak, fl_peak):
    """K6 at the production layer (1, 448, 448, 256) packed, bf16, beside its
    plain version, the K1 pair (1x1 + 3x3) on the same halves, and cuDNN's
    1x1 + 3x3 convs on the activated halves; and K6 in f32."""
    import torch.nn.functional as F

    from naf_torch.kernels.encoder_fused import (
        gn_silu_conv_dual_fused,
        gn_silu_conv_dual_ref,
        gn_silu_conv_fused,
    )

    gen = torch.Generator(device=dev).manual_seed(14)
    x, sc, sh, wp, ws, bp, bs = _k6_inputs(dev, gen, 1)
    b, h, w, c2 = x.shape
    c = c2 // 2
    xb, wpb, wsb = x.bfloat16(), wp.bfloat16(), ws.bfloat16()
    ms = _kernel_ms(lambda: gn_silu_conv_dual_fused(xb, sc, sh, wpb, wsb, bp, bs),
                    "gn_silu_conv_dual_wgmma_kernel")
    wrapper = _time_ms(lambda: gn_silu_conv_dual_fused(xb, sc, sh, wpb, wsb, bp, bs), iters=20)
    queued = _queued_ms(lambda: gn_silu_conv_dual_fused(xb, sc, sh, wpb, wsb, bp, bs))
    ms_f32 = _kernel_ms(lambda: gn_silu_conv_dual_fused(x, sc, sh, wp, ws, bp, bs),
                        "gn_silu_conv_dual_kernel<float", reps=5)
    plain = _time_ms(lambda: gn_silu_conv_dual_ref(xb, sc, sh, wpb, wsb, bp, bs), iters=3)
    xp, xs = xb[..., :c].contiguous(), xb[..., c:].contiguous()
    pair = _kernel_ms(lambda: (gn_silu_conv_fused(xp, sc[:, :c], sh[:, :c], wpb, bp),
                               gn_silu_conv_fused(xs, sc[:, c:], sh[:, c:], wsb, bs)),
                      "gn_silu_conv_wgmma_kernel")
    z = F.silu(xb.float() * sc[:, None, None] + sh[:, None, None]).bfloat16().permute(0, 3, 1, 2)
    zp = z[:, :c].contiguous(memory_format=torch.channels_last)
    zs = F.pad(z[:, c:], (1, 1, 1, 1), mode="reflect").contiguous(
        memory_format=torch.channels_last)
    wpl = wpb.contiguous(memory_format=torch.channels_last)
    wsl = wsb.contiguous(memory_format=torch.channels_last)
    lib = _kernel_ms(lambda: (F.conv2d(zp, wpl), F.conv2d(zs, wsl)))
    qlib = _queued_ms(lambda: (F.conv2d(zp, wpl), F.conv2d(zs, wsl)))
    flops = 2 * b * h * w * c * c * (1 + 9)
    nbytes = 2 * (b * h * w * 2 * c2 + 10 * c * c) + 4 * (2 * b * c2 + c2 + 2 * b * c2)
    bound = max(nbytes / bw_peak, flops / fl_peak) * 1e3
    by = "bytes" if nbytes / bw_peak > flops / fl_peak else "operations"
    bound_f32 = max(2 * nbytes / bw_peak, flops / F32_FLOPS) * 1e3
    print(f"K6 bf16 (1,448,448,256) packed, tensor cores: kernel {ms:.4f} ms (queued "
          f"{queued:.4f} ms, through the wrapper {wrapper:.4f} ms); plain {plain:.4f} ms; "
          f"K1 1x1 + 3x3 kernels on the halves {pair:.4f} ms; "
          f"F.conv2d 1x1 + 3x3 {lib:.4f} ms (queued {qlib:.4f} ms); bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.1f} GFLOP); f32 on the CUDA cores {ms_f32:.4f} ms, bound "
          f"{bound_f32:.4f} ms ({card})", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                wrapper_ms=wrapper, k1_pair_ms=pair, ms_f32=ms_f32, bound_ms_f32=bound_f32,
                queued_ms=queued, library_queued_ms=qlib)


def phase_timing(dev, card):
    import torch.nn.functional as F

    from naf_torch.kernels.encoder_fused import gn_silu_conv_fused, gn_silu_conv_ref

    bw_peak, fl_peak = _peaks(card)
    gen = torch.Generator(device=dev).manual_seed(4)
    res = {}
    for k in (3, 1):
        b, h, w, c, f = 1, 448, 448, 128, 128
        x = torch.randn(b, h, w, c, generator=gen, device=dev).bfloat16()
        scale = torch.rand(b, c, generator=gen, device=dev) + 0.5
        shift = torch.randn(b, c, generator=gen, device=dev) * 0.1
        wt = (torch.randn(f, c, k, k, generator=gen, device=dev) * 0.03).bfloat16()
        bias = torch.randn(f, generator=gen, device=dev) * 0.1
        ms = _kernel_ms(lambda: gn_silu_conv_fused(x, scale, shift, wt, bias),
                        "gn_silu_conv_wgmma_kernel")
        wrapper = _time_ms(lambda: gn_silu_conv_fused(x, scale, shift, wt, bias), iters=20)
        queued = _queued_ms(lambda: gn_silu_conv_fused(x, scale, shift, wt, bias))
        x32, wt32 = x.float(), wt.float()
        ms_f32 = _kernel_ms(lambda: gn_silu_conv_fused(x32, scale, shift, wt32, bias),
                            "gn_silu_conv_kernel<float", reps=5)
        plain = _time_ms(lambda: gn_silu_conv_ref(x, scale, shift, wt, bias), iters=3)
        z = F.silu(x.float() * scale[:, None, None] + shift[:, None, None]).bfloat16()
        z = z.permute(0, 3, 1, 2)
        if k == 3:
            z = F.pad(z, (1, 1, 1, 1), mode="reflect")
        z = z.contiguous(memory_format=torch.channels_last)
        wl = wt.contiguous(memory_format=torch.channels_last)
        lib = _kernel_ms(lambda: F.conv2d(z, wl))
        qlib = _queued_ms(lambda: F.conv2d(z, wl))
        nbytes = 2 * (b * h * w * (c + f) + k * k * c * f) + 4 * (2 * b * c + f + 2 * b * f)
        flops = 2 * b * h * w * c * f * k * k
        bound = max(nbytes / bw_peak, flops / fl_peak) * 1e3
        bound_f32 = max(2 * nbytes / bw_peak, flops / F32_FLOPS) * 1e3
        res[f"k1_k{k}"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                               bound_by="bytes" if nbytes / bw_peak > flops / fl_peak
                               else "operations", wrapper_ms=wrapper, ms_f32=ms_f32,
                               bound_ms_f32=bound_f32, queued_ms=queued,
                               library_queued_ms=qlib)
        print(f"K1 k={k} bf16 (1,448,448,128), tensor cores: kernel {ms:.4f} ms (queued "
              f"{queued:.4f} ms, through the wrapper {wrapper:.4f} ms); bound {bound:.4f} ms; "
              f"plain {plain:.4f} ms; F.conv2d alone {lib:.4f} ms (queued {qlib:.4f} ms); f32 on "
              f"the CUDA cores "
              f"{ms_f32:.4f} ms, bound {bound_f32:.4f} ms ({card})", flush=True)
        del x32, wt32

    from naf_torch.kernels.na2d_fused import (
        _launch_bwd,
        _launch_fwd,
        cross_scale_na2d_fused_bwd_ref,
        cross_scale_na2d_fused_ref,
    )

    def bound_of(nbytes, flops):
        return (max(nbytes / bw_peak, flops / fl_peak) * 1e3,
                "bytes" if nbytes / bw_peak > flops / fl_peak else "operations")

    for label, shape in K34_SHAPES.items():
        b, hq, hk, n, d, dv = shape
        q, k, v, g = (t.bfloat16() for t in _k34_inputs(dev, gen, shape))
        sc = d ** -0.5
        it = 10 if label == "train" else 3
        # device time of the kernels (K4: the tile kernel and its reduce
        # pass), and the time through the wrapper (CUDA events)
        ms3 = _kernel_ms(lambda: _launch_fwd(q, k, v, 9, sc), "na_fwd_wgmma_kernel")
        ms4 = _kernel_ms(lambda: _launch_bwd(q, k, v, g, 9, sc),
                         ("na_bwd_wgmma_kernel", "na_bwd_reduce_kernel"))
        ms4_tile = _kernel_ms(lambda: _launch_bwd(q, k, v, g, 9, sc), "na_bwd_wgmma_kernel")
        w3 = _time_ms(lambda: _launch_fwd(q, k, v, 9, sc), iters=2 * it)
        w4 = _time_ms(lambda: _launch_bwd(q, k, v, g, 9, sc), iters=2 * it)
        qd3 = _queued_ms(lambda: _launch_fwd(q, k, v, 9, sc))
        qd4 = _queued_ms(lambda: _launch_bwd(q, k, v, g, 9, sc))
        plain3 = _time_ms(lambda: cross_scale_na2d_fused_ref(q, k, v, 9), iters=1)
        plain4 = _time_ms(lambda: cross_scale_na2d_fused_bwd_ref(q, k, v, g, 9), iters=1)
        # library yardstick: masked SDPA over all LR keys (integer ratio: no
        # window holds a cell twice, so it computes K3's function), its
        # kernels' device time by the same method
        sq, sk, sv, mask = _masked_sdpa_inputs(q, k, v, 9)
        ref = _launch_fwd(q, k, v, 9, sc)
        lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, scale=sc)
        lib_cos = _check_cos(f"masked SDPA vs K3 {label}",
                             lib_out.transpose(1, 2).reshape(ref.shape).float(), ref.float(),
                             0.999)
        sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, scale=sc)
        lib3 = _kernel_ms(sdpa, reps=it)
        qlib3 = _queued_ms(sdpa, reps=it)
        lq, lk, lv = (t.detach().requires_grad_() for t in (sq, sk, sv))
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, scale=sc)
        lg = g.flatten(1, 2).transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(lo, (lq, lk, lv), lg, retain_graph=True)
        lib4 = _kernel_ms(sdpa_bwd, reps=it)
        qlib4 = _queued_ms(sdpa_bwd, reps=it)
        pix, lr = b * hq * hq * n, b * hk * hk * n
        b3, by3 = bound_of(2 * (pix * (d + dv) + lr * (d + dv)), 2 * pix * 81 * (d + dv))
        b4, by4 = bound_of(2 * (pix * (2 * d + dv) + 2 * lr * (d + dv)),
                           2 * pix * 81 * (3 * d + 2 * dv))
        res[f"k3_{label}"] = dict(ms=ms3, plain_ms=plain3, library_ms=lib3, bound_ms=b3,
                                  bound_by=by3, wrapper_ms=w3, queued_ms=qd3,
                                  library_queued_ms=qlib3)
        res[f"k4_{label}"] = dict(ms=ms4, plain_ms=plain4, library_ms=lib4, bound_ms=b4,
                                  bound_by=by4, wrapper_ms=w4, queued_ms=qd4,
                                  tile_ms=ms4_tile, library_queued_ms=qlib4)
        print(f"K3 bf16 {label} {tuple(shape)}, tensor cores: kernel {ms3:.4f} ms (queued "
              f"{qd3:.4f} ms, through the wrapper {w3:.4f} ms); plain {plain3:.4f} ms; masked "
              f"SDPA {lib3:.4f} ms (queued {qlib3:.4f} ms; cos vs K3 {lib_cos:.6f}); "
              f"bound {b3:.4f} ms ({by3}) ({card})", flush=True)
        print(f"K4 bf16 {label} {tuple(shape)}, tensor cores: kernels {ms4:.4f} ms, its tile "
              f"kernel {ms4_tile:.4f} ms and the rest the reduce pass (queued {qd4:.4f} ms, "
              f"through the wrapper {w4:.4f} ms); plain {plain4:.4f} ms; masked SDPA backward "
              f"{lib4:.4f} ms (queued {qlib4:.4f} ms); bound {b4:.4f} ms ({by4}) ({card})",
              flush=True)
        del q, k, v, g, sq, sk, sv, mask, lq, lk, lv, lo, lg, lib_out, ref
        torch.cuda.empty_cache()
    res["k3_anyup"] = _time_k3_anyup(dev, card, bw_peak)
    res["k6"] = _time_k6(dev, card, bw_peak, fl_peak)
    res.update({f"k5_{k}": v for k, v in _time_k5(dev, card, bw_peak).items()})
    return res


# K2's bf16 device time per call at 448^2 and 448^2 -> 2048^2 of the
# warp-per-query CUDA-core kernel that the tensor-core one replaced
# (chip_smoke.py phase 8 on an NVIDIA H100 80GB HBM3 at 700 W)
K2_WARP_PER_QUERY_MS = {448: 3.7398, 2048: 83.6287}


def _k2_query(enc, rt, ct, dh, heads):
    """(B, Hq, Wq, heads, d) f32: the pooled, RoPE'd queries the plain
    version builds."""
    from naf_torch.nn.rope import rotate_half
    from naf_torch.ops.pool import adaptive_avg_pool2d

    c = enc.shape[-1]
    xu = adaptive_avg_pool2d(enc.float(), (rt.shape[0], ct.shape[0]))
    q = xu * (rt[:, None, :c] * ct[None, :, :c]) + rotate_half(xu, dh) * (
        rt[:, None, c:] * ct[None, :, c:])
    return q.reshape(*q.shape[:3], heads, c // heads)


def _time_k2(dev, card, bw_peak, fl_peak, gen):
    """K2 in bf16 at 448^2 -> 448^2 and -> 2048^2: the tensor-core kernel's
    device time (torch.profiler), queued time and time through the wrapper,
    the f32 CUDA-core kernel's device time at 448^2, the plain version, the
    bound, and the attention-only yardstick: masked SDPA over every LR key on
    the plain version's pooled, RoPE'd queries (no single PyTorch call
    computes K2's pool + RoPE + windowed attention; at 2048^2 <- 28^2 the
    ragged windows hold some cells twice, which a boolean mask counts once,
    so there it is timed, not compared)."""
    import torch.nn.functional as F

    from naf_torch.kernels.na2d_fused import _plan_tc
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref

    kw = dict(num_heads=4, kernel_size=9)
    res = {}
    for out in (448, 2048):
        enc, keys, values, rt, ct, dh = _k2_inputs(dev, gen, 448, out=out)
        enc, keys, values = enc.bfloat16(), keys.bfloat16(), values.bfloat16()
        call = lambda: naf_upsample_attention(enc, keys, values, rt, ct, dh, **kw)
        reps = 10 if out == 448 else 3
        ms = _kernel_ms(call, "fused_q_wgmma", reps=reps)
        queued = _queued_ms(call, reps=reps)
        wrapper = _time_ms(call, iters=reps)
        plain = _time_ms(
            lambda: naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, **kw), iters=1)
        ms_f32 = None
        if out == 448:
            e32, k32, v32 = enc.float(), keys.float(), values.float()
            ms_f32 = _kernel_ms(
                lambda: naf_upsample_attention(e32, k32, v32, rt, ct, dh, **kw),
                "fused_q_kernel", reps=3)
            del e32, k32, v32
        # the yardstick: attention alone, on the plain version's queries
        q = _k2_query(enc, rt, ct, dh, 4).bfloat16()
        sq, sk, sv, mask = _masked_sdpa_inputs(q, keys.reshape(1, 28, 28, 4, 64),
                                               values.reshape(1, 28, 28, 4, 96), 9)
        del q
        sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                      scale=64 ** -0.5)
        lib_cos = None
        if out == 448:
            lib_cos = _check_cos("masked SDPA vs K2 at 448^2",
                                 sdpa().transpose(1, 2).reshape(1, out, out, 384).float(),
                                 call().float(), 0.999)
        lib = _kernel_ms(sdpa, reps=reps)
        del sq, sk, sv, mask
        plan = _plan_tc(out, out, 28, 28, 9, 64, 96, False, str(dev))
        nbytes = 2 * (enc.numel() + keys.numel() + values.numel() + out * out * 384) \
            + 4 * (rt.numel() + ct.numel()) + plan[5].numel() + plan[6].numel()
        flops = 2 * out * out * 4 * 81 * (64 + 96)
        bound = max(nbytes / bw_peak, flops / fl_peak) * 1e3
        res[f"k2_{out}"] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
                                bound_by="bytes" if nbytes / bw_peak > flops / fl_peak
                                else "operations", wrapper_ms=wrapper, queued_ms=queued,
                                attention_sdpa_ms=lib, attention_sdpa_cos=lib_cos,
                                ms_f32=ms_f32)
        print(f"K2 bf16 448^2 -> {out}^2 <- 28^2x384, tensor cores: kernel {ms:.4f} ms "
              f"[warp-per-query kernel it replaced: {K2_WARP_PER_QUERY_MS[out]:.4f} ms] (queued "
              f"{queued:.4f} ms, through the wrapper {wrapper:.4f} ms); bound {bound:.4f} ms; "
              f"plain {plain:.4f} ms"
              + (f"; f32 on the CUDA cores {ms_f32:.4f} ms" if ms_f32 else "")
              + f"; attention alone, masked SDPA on the plain version's queries {lib:.4f} ms"
              + (f" (cos vs K2 {lib_cos:.6f})" if lib_cos else " (repeated cells counted once)")
              + f" ({card})", flush=True)
        del enc, keys, values
        torch.cuda.empty_cache()
    return res


def k2_grad_step(dev, gen, out):
    """One call of K2's gradient at NAF's widths, bf16: K2's forward from a
    448^2 x 256 encoder output, 28^2 x 256 keys and 28^2 x 384 values (4
    heads, k 9) to an out^2 output, and the backward through its twin
    (pool-up, RoPE, K3 and K4, and their autograd)."""
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention

    enc, keys, values, rt, ct, dh = _k2_inputs(dev, gen, 448, out=out)
    ins = tuple(t.bfloat16().requires_grad_() for t in (enc, keys, values))
    cot = torch.randn(1, out, out, 384, generator=gen, device=dev).bfloat16()

    def step():
        o = naf_upsample_attention(*ins, rt, ct, dh, num_heads=4, kernel_size=9)
        return torch.autograd.grad(o, ins, cot)

    return step


def _time_k2_grad(dev, card):
    """K2's gradient at 448^2 and 448^2 -> 2048^2 (K4 at 2048^2 <- 28^2, the
    ragged ratio, in bands of query rows): device time of every kernel and
    of K3 + K4, the queued time, and the call's own peak memory."""
    from naf_torch.kernels import na2d_fused as na

    fused = na.cross_scale_na2d_fused
    gen = torch.Generator(device=dev).manual_seed(11)
    res = {}
    for out in (448, 2048):
        step = k2_grad_step(dev, gen, out)
        before = (fused.launches, fused.bwd_launches)
        grads = step()
        torch.cuda.synchronize()
        k3, k4 = fused.launches - before[0], fused.bwd_launches - before[1]
        if k3 != 1 or k4 < 1 or not all(torch.isfinite(t).all() for t in grads):
            raise AssertionError(f"K2's gradient at {out}^2: {k3} K3, {k4} K4 launches, or "
                                 "values not finite")
        del grads
        reps = 10 if out == 448 else 3
        ms = _kernel_ms(step, reps=reps)
        k34 = _kernel_ms(step, ("na_fwd", "na_bwd"), reps=reps)
        try:
            queued = _queued_ms(step, reps=reps, spin=1_000_000_000)
            queued_text = f"queued {queued:.4f} ms"
        except AssertionError:  # the pool-up's tables come from pageable host memory
            queued, queued_text = None, "queued: not measured, a call waits on the card"
        peak = _peak_mib(step)
        res[str(out)] = dict(ms=ms, k34_ms=k34, queued_ms=queued, peak_mib=peak, k4_launches=k4)
        print(f"K2 gradient bf16 448^2 -> {out}^2 <- 28^2 x 384 (forward + twin backward): "
              f"kernels {ms:.4f} ms, of them K3 + K4 {k34:.4f} ms ({queued_text}); "
              f"{k4} K4 launches (partials budget {na.PARTIAL_BUDGET / 2**20:.0f} MiB); call "
              f"peak {peak:.1f} MiB ({card})", flush=True)
        del step
        torch.cuda.empty_cache()
    return res


def _k6_inputs(dev, gen, b, h=448, w=448, c=128):
    """A packed (b, h, w, 2c) layer input, per-sample GroupNorm affines and
    both stacks' weights at NAF's scale."""
    x = torch.randn(b, h, w, 2 * c, generator=gen, device=dev)
    scale = torch.rand(b, 2 * c, generator=gen, device=dev) * 0.5 + 0.75
    shift = torch.randn(b, 2 * c, generator=gen, device=dev) * 0.1
    wp = torch.randn(c, c, 1, 1, generator=gen, device=dev) * c ** -0.5
    ws = torch.randn(c, c, 3, 3, generator=gen, device=dev) * (9 * c) ** -0.5
    bp = torch.randn(c, generator=gen, device=dev) * 0.1
    bs = torch.randn(c, generator=gen, device=dev) * 0.1
    return x, scale, shift, wp, ws, bp, bs


def phase_k6(dev):
    """K6 against its plain version; returns the largest f32 error and
    K6's launches."""
    from naf_torch.kernels.encoder_fused import gn_silu_conv_dual_fused, gn_silu_conv_dual_ref

    gen = torch.Generator(device=dev).manual_seed(10)
    errs = {}
    launches = gn_silu_conv_dual_fused.launches
    # the production layer at batch 1 and 2, a 2048^2 guide,
    # and a band of 256 + 2 x 3 halo rows of a 452-wide image
    # and the production shape at C = 48 (the tensor-core kernel's N = 64)
    # and 96 (a partial N = 128) per stack
    for b, h, w, c in ((1, 448, 448, 128), (2, 448, 448, 128), (1, 2048, 2048, 128),
                       (1, 262, 452, 128), (1, 448, 448, 48), (1, 448, 448, 96)):
        x, sc, sh, wp, ws, bp, bs = _k6_inputs(dev, gen, b, h, w, c)
        hw = x.shape[1] * x.shape[2]
        y_ref, ps_ref = gn_silu_conv_dual_ref(x, sc, sh, wp, ws, bp, bs)
        y, ps = gn_silu_conv_dual_fused(x, sc, sh, wp, ws, bp, bs)
        torch.cuda.synchronize()
        e = _check_close(f"K6 f32 y b={b}", y, y_ref, 2e-4)
        _check_close(f"K6 f32 psums b={b}", ps / hw, ps_ref / hw, 2e-4)
        del y, ps
        yb, psb = gn_silu_conv_dual_fused(x.bfloat16(), sc, sh, wp.bfloat16(), ws.bfloat16(),
                                          bp, bs)
        torch.cuda.synchronize()
        if yb.dtype != torch.bfloat16:
            raise AssertionError(f"K6 bf16 output came back as {yb.dtype}")
        cy = _check_cos(f"K6 bf16 y b={b}", yb.float(), y_ref, 0.9995)
        cp = _check_cos(f"K6 bf16 psums b={b}", psb, ps_ref, 0.9995)
        errs[(b, h, w, c)] = e
        print(f"K6 ({b}, {h}, {w}, {2 * c}) packed, C {c} per stack: f32 max_abs_err {e:.3e}; "
              f"bf16 cos y {cy:.6f} psums {cp:.6f}", flush=True)
        del x, yb, psb, y_ref, ps_ref
    torch.cuda.empty_cache()
    return max(errs.values()), gn_silu_conv_dual_fused.launches - launches


def phase_banded_kernels(dev):
    """K2's banded variants and K3's banded forward against their plain
    versions at one interior band."""
    from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused, cross_scale_na2d_fused_ref
    from naf_torch.kernels.na2d_fused_q import (
        naf_upsample_attention,
        naf_upsample_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    kw = dict(num_heads=4, kernel_size=9)
    # 448^2 -> 2048^2 <- 128^2: a band of 256 output rows (16 cell rows) at
    # cell row 48; its encoder rows are [168, 224) of 448
    enc, keys, values, rt, ct, dh = _k2_inputs(dev, gen, 448, out=2048, hk=128)
    band = dict(row_cell0=48, band_cells=16)
    before = _all_counts()
    y0, bh, e0, eh = 768, 256, 168, 56
    want = naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, **kw, **band)
    got = naf_upsample_attention(enc, keys, values, rt, ct, dh, **kw, **band)
    torch.cuda.synchronize()
    e_slab = _check_close("K2 banded f32 slab", got, want, 2e-4)
    buf = torch.full((1, 2048, 2048, 384), 7.0, device=dev)
    naf_upsample_attention(enc[:, e0 : e0 + eh].contiguous(), keys, values, rt, ct, dh, **kw,
                           **band, out_acc=buf, enc_banded=True)
    torch.cuda.synchronize()
    e_acc = _check_close("K2 banded f32 out_acc + enc_banded", buf[:, y0 : y0 + bh], want, 2e-4)
    if not (bool((buf[:, :y0] == 7.0).all()) and bool((buf[:, y0 + bh :] == 7.0).all())):
        raise AssertionError("K2 out_acc wrote rows outside its band")
    del buf
    bufb = torch.zeros((1, 2048, 2048, 384), dtype=torch.bfloat16, device=dev)
    naf_upsample_attention(enc[:, e0 : e0 + eh].bfloat16().contiguous(), keys.bfloat16(),
                           values.bfloat16(), rt, ct, dh, **kw, **band, out_acc=bufb,
                           enc_banded=True)
    torch.cuda.synchronize()
    c2 = _check_cos("K2 banded bf16", bufb[:, y0 : y0 + bh].float(), want, 0.9995)
    after = _all_counts()
    if (after["k2_fma"] - before["k2_fma"], after["k2_wgmma"] - before["k2_wgmma"]) != (2, 1):
        raise AssertionError("banded K2: the two f32 calls did not run on the fma route and "
                             "the bf16 call on the wgmma route")
    eb_, kb_, vb_ = enc[:, e0 : e0 + eh].bfloat16().contiguous(), keys.bfloat16(), values.bfloat16()
    band_b = dict(**kw, **band, out_acc=bufb, enc_banded=True)
    ms2 = _time_ms(lambda: naf_upsample_attention(eb_, kb_, vb_, rt, ct, dh, **band_b))
    plain2 = _time_ms(lambda: naf_upsample_attention_ref(eb_, kb_, vb_, rt, ct, dh, **band_b),
                      iters=1)
    print(f"K2 banded 448^2 -> 2048^2 <- 128^2, cell rows [48, 64): f32 max_abs_err slab "
          f"{e_slab:.3e}, out_acc + enc_banded {e_acc:.3e} (other rows untouched); bf16 cos "
          f"{c2:.6f}; bf16 {ms2:.4f} ms, plain {plain2:.4f} ms", flush=True)
    del enc, keys, values, want, got, bufb, eb_, kb_, vb_
    # K3: 448^2 <- 28^2, the query rows of cell rows [8, 12)
    q = torch.randn(1, 64, 448, 4, 64, generator=gen, device=dev)
    k = torch.randn(1, 28, 28, 4, 64, generator=gen, device=dev)
    v = torch.randn(1, 28, 28, 4, 96, generator=gen, device=dev)
    b3 = dict(row_cell0=8, full_hq=448)
    want = cross_scale_na2d_fused_ref(q, k, v, 9, **b3)
    before = cross_scale_na2d_fused.launches
    with torch.no_grad():
        got = cross_scale_na2d_fused(q, k, v, 9, **b3)
        gotb = cross_scale_na2d_fused(q.bfloat16(), k.bfloat16(), v.bfloat16(), 9, **b3)
    torch.cuda.synchronize()
    if cross_scale_na2d_fused.launches != before + 2:
        raise AssertionError("banded K3 did not launch its kernel")
    e3 = _check_close("K3 banded f32", got, want, 2e-4)
    c3 = _check_cos("K3 banded bf16", gotb.float(), want, 0.9995)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with torch.no_grad():
        ms3 = _time_ms(lambda: cross_scale_na2d_fused(qb, kb, vb, 9, **b3))
        plain3 = _time_ms(lambda: cross_scale_na2d_fused_ref(qb, kb, vb, 9, **b3), iters=3)
    print(f"K3 banded 448^2 <- 28^2, rows [128, 192): f32 max_abs_err {e3:.3e}; bf16 cos "
          f"{c3:.6f}; bf16 {ms3:.4f} ms, plain {plain3:.4f} ms", flush=True)
    # bounds (bf16): each band's own inputs read once (its encoder or query
    # rows, the key/value cell rows its windows reach, its table rows) and
    # its output rows written once, against the card's peaks
    bw, fl = _peaks(torch.cuda.get_device_name(0))

    def bound(nbytes, flops):
        return dict(bound_ms=max(nbytes / bw, flops / fl) * 1e3,
                    bound_by="bytes" if nbytes / bw > flops / fl else "operations")

    kv2 = min(128, 48 + 16 + 4) - max(0, 48 - 4)
    k2b = bound(2 * (eh * 448 * 256 + kv2 * 128 * (256 + 384) + bh * 2048 * 384)
                + 4 * (bh + 2048) * rt.shape[1], 2 * bh * 2048 * 4 * 81 * (64 + 96))
    kv3 = min(28, 8 + 4 + 4) - max(0, 8 - 4)
    k3b = bound(2 * (q.numel() + kv3 * 28 * 4 * (64 + 96) + 64 * 448 * 4 * 96),
                2 * 64 * 448 * 4 * 81 * (64 + 96))
    print(f"bounds of the banded calls (bf16): K2 {k2b['bound_ms']:.4f} ms ({k2b['bound_by']}), "
          f"K3 {k3b['bound_ms']:.4f} ms ({k3b['bound_by']})", flush=True)
    return (dict(max_abs_err=max(e_slab, e_acc), ms=ms2, plain_ms=plain2, **k2b),
            dict(max_abs_err=e3, ms=ms3, plain_ms=plain3, **k3b))


def _nhwc_request(dev, gen, img, lr, cv=384):
    image = torch.randn(1, img, img, 3, generator=gen, device=dev).bfloat16()
    feats = torch.randn(1, lr, lr, cv, generator=gen, device=dev).bfloat16()
    return image, feats


def _peak_mib(fn) -> float:
    """The call's own peak memory, MiB above what was allocated before it
    (its result included)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _frame_key(frames) -> str:
    """The innermost frame of this repository's code in an allocation's
    stack, with its caller there: "file:line function < file:line caller";
    "(no frame of naf_torch: autograd engine)" for an allocation made by a
    C++ backward node."""
    ours = [f for f in frames if "naf_torch/" in f["filename"]]
    if not ours:
        return "(no frame of naf_torch: autograd engine)"
    def name(f):
        return f"{f['filename'].split('naf_torch/')[-1]}:{f['line']} {f['name']}"

    return " < ".join(name(f) for f in ours[:2])


def _peak_by_frame(fn, top: int = 5):
    """Run ``fn`` once under the allocator's history and attribute its peak:
    the trace is replayed (alloc +, free -; frees of blocks allocated before
    the call count too) to find the peak, then the blocks live at it are
    summed by :func:`_frame_key`. Returns (peak MiB above the start, MiB of
    the blocks allocated during the call and live at the peak, [(frame,
    MiB, blocks), ...] largest first)."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=4_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = [e for e in snap["device_traces"][torch.cuda.current_device()]
             if e["action"] in ("alloc", "free_requested")]
    cur, peak, at = 0, 0, -1
    for i, e in enumerate(trace):
        cur += e["size"] if e["action"] == "alloc" else -e["size"]
        if cur > peak:
            peak, at = cur, i
    live = {}
    for e in trace[: at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        else:
            live.pop(e["addr"], None)
    groups = {}
    for e in live.values():
        key = _frame_key(e.get("frames", []))
        size, n = groups.get(key, (0, 0))
        groups[key] = (size + e["size"], n + 1)
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])
    return (peak / 2**20, sum(s for s, _ in groups.values()) / 2**20,
            [(k, s / 2**20, n) for k, (s, n) in ranked[:top]])


def _k2_band_check(label, model, image, feats, out, band_rows, enc_banded, got):
    """K2 against its plain version at the main path's own shape: on one
    interior band, the plain version (f32) on the encoder output, keys and
    features of the unbanded path is held against K2's rows of the banded
    output ``got`` (bf16, cosine > 0.9995) and against K2 launched in f32 on
    the same inputs with the same band arguments (2e-4). With ``enc_banded``
    both take only the band's encoder rows."""
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref
    from naf_torch.models.naf import band_cells

    hk = feats.shape[1]
    cpb = band_cells(out, hk, band_rows)
    c0 = (hk // cpb // 2) * cpb
    r_h = out // hk
    y0, bh = c0 * r_h, cpb * r_h
    enc, keys, rt, ct = model._fused_q_inputs(image, feats, (out, out))
    if enc_banded:
        hi = enc.shape[1]
        enc = enc[:, c0 * r_h * hi // out : (c0 + cpb) * r_h * hi // out]
    args = (enc.float().contiguous(), keys.float(), feats.float(), rt, ct,
            model.image_encoder.rope.d_head)
    kw = dict(num_heads=model.heads_attn, kernel_size=model.kernel_size, row_cell0=c0,
              band_cells=cpb, enc_banded=enc_banded)
    want = naf_upsample_attention_ref(*args, **kw)
    e = _check_close(f"{label}: K2 f32 band", naf_upsample_attention(*args, **kw), want, 2e-4)
    c = _check_cos(f"{label}: K2's rows of the bf16 output", got[:, y0 : y0 + bh].float(), want,
                   0.9995)
    print(f"{label}: K2 at cell rows [{c0}, {c0 + cpb}) of {hk}"
          f"{', enc_banded' if enc_banded else ''} vs its plain version: f32 max_abs_err "
          f"{e:.3e}; the banded output's rows cos {c:.6f}", flush=True)
    return dict(max_abs_err=e, cos=c)


def phase_banded(dev, card):
    """NAF(band_rows), naf_streamed at the bench shape, and naf_streamed with
    the banded encoder, each with its launch counts, against the unbanded
    forward on the card and, on one interior band, K2 against its plain
    version, with time and the call's own peak memory."""
    from naf_torch import load_naf_params
    from naf_torch.api import naf_streamed

    model = load_naf_params(seed=0, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(13)
    res = {}
    cases = (
        # (label, image, lr, out, band_rows, K1 and K2 launches, banded call)
        ("band_rows", 448, 128, 2048, 256, (8, 8),
         lambda im, ft, o, br: model(im, ft, (o, o), band_rows=br)),
        ("streamed", 512, 256, 4096, 512, (8, 8),
         lambda im, ft, o, br: naf_streamed(model, im, ft, (o, o), br)),
        ("streamed_encoder", 2048, 128, 2048, 256, (224, 8),
         lambda im, ft, o, br: naf_streamed(model, im, ft, (o, o), br)),
    )
    launches = {"k1": 0, "k2": 0}
    for label, img, lr, out, br, want, banded in cases:
        image, feats = _nhwc_request(dev, gen, img, lr)
        with torch.inference_mode():
            torch.cuda.synchronize()
            _zero_counts()
            got = banded(image, feats, out, br)
            torch.cuda.synchronize()
            c = _all_counts()
            if (c["k1"], c["k2"], c["k2_wgmma"]) != (*want, want[1]) or c["k6"] or c["k3"]:
                raise AssertionError(f"{label}: launches {c}, want K1 {want[0]}, K2 {want[1]} "
                                     "(wgmma)")
            launches["k1"] += c["k1"]
            launches["k2"] += c["k2"]
            if got.shape != (1, out, out, 384) or not bool(got.isfinite().all()):
                raise AssertionError(f"{label}: bad output {tuple(got.shape)}")
            full = model(image, feats, (out, out))
            cos = _check_cos(f"{label} vs the unbanded forward", got, full, 0.999)
            del full
            band = _k2_band_check(label, model, image, feats, out, br,
                                  label == "streamed_encoder", got)
            del got
            torch.cuda.empty_cache()
            peak_b = _peak_mib(lambda: banded(image, feats, out, br))
            peak_u = _peak_mib(lambda: model(image, feats, (out, out)))
            ms_b = _time_ms(lambda: banded(image, feats, out, br), iters=1)
            ms_u = _time_ms(lambda: model(image, feats, (out, out)), iters=1)
            profiles = {}
            if label == "streamed_encoder":
                # the encoder's (K1) and the attention's (K2) device time on
                # both paths at a 2048^2 guide
                profiles["unbanded"] = _profile(lambda: model(image, feats, (out, out)),
                                                f"unbanded {img}^2 -> {out}^2", reps=1)
                profiles["banded"] = _profile(lambda: banded(image, feats, out, br),
                                              f"{label} {img}^2 -> {out}^2", reps=1)
        res[label] = dict(ms=ms_b, ms_unbanded=ms_u, peak_mib=peak_b, peak_mib_unbanded=peak_u,
                          cos=cos, launches_k1=want[0], launches_k2=want[1], k2_band=band,
                          **({"profiles": profiles} if profiles else {}))
        print(f"{label}: {img}^2 + {lr}^2 x 384 -> {out}^2 bf16, band_rows {br}: launches K1 "
              f"{want[0]}, K2 {want[1]}; cos vs unbanded {cos:.6f}; {ms_b:.3f} ms, peak "
              f"{peak_b:.1f} MiB; unbanded {ms_u:.3f} ms, peak {peak_u:.1f} MiB ({card})",
              flush=True)
        del image, feats
        torch.cuda.empty_cache()
    if not res["streamed_encoder"]["peak_mib"] < res["streamed_encoder"]["peak_mib_unbanded"]:
        raise AssertionError("the banded encoder did not lower the peak memory")
    return launches, res


# The denoising path at the repository's own denoiser configuration:
# benchmarks/denoising.json's "naf" entry (its overrides of config/model/
# naf.yaml, batch 8 at 448^2 on the real shard's 60 training photos, sigma
# 0.5), at the CLI's bf16 default, 10 steps in two chunks, validation in f32
# on the 9 validation photos at batch 2
SHARD = "benchmarks/real_shard/ade20k/images"
DENOISE_OVERRIDES = [
    "model=naf", "model.kernel_size=15", "model.heads_attn=1", "model.heads_rope=1",
    "denoising.noise_params.std=0.5", "train_dataloader.batch_size=8", "train_steps=10",
    "val_steps=4", "log_every=5", f"dataset.root={SHARD}/training",
    f"dataset.val_root={SHARD}/validation"]
DENOISE_STEPS, DENOISE_BATCH, DENOISE_VAL, DENOISE_K = 10, 8, 4, 15
DENOISE_NAF = dict(dim=256, heads_attn=1, heads_rope=1, kernel_size=15, img_layers=2,
                   rope_rescale=2.0)


def _denoise_attention_inputs(dev, gen, b=1, size=448):
    """The denoiser's attention at batch b: K2's inputs (a size^2 x 256
    encoder output, its pooled RoPE'd keys on the same grid, the 3 value
    channels, one RoPE head) and K3/K4's (q, k, v, dO), one head of d 256,
    dv 3, k 15, ratio 1."""
    from naf_torch.nn.rope import RoPE

    rope = RoPE(256, 1).to(dev)
    enc = torch.randn(b, size, size, 256, generator=gen, device=dev)
    keys = rope.pooled(enc, (size, size), (size, size)).contiguous()
    values = torch.rand(b, size, size, 3, generator=gen, device=dev)
    sin_r, cos_r, sin_c, cos_c = rope.tables(size, size)
    k2 = (enc, keys, values, torch.cat([cos_r, sin_r], -1), torch.cat([cos_c, sin_c], -1),
          rope.d_head)
    return k2, _k34_inputs(dev, gen, (b, size, size, 1, 256, 3))


def _route_delta(routes, before):
    return {k: v - before[k] for k, v in routes.items() if v != before[k]}


def phase_denoise_kernels(dev):
    """K2, K3 and K4 at the denoiser's attention (batch 1, 448^2, one head,
    d 256, dv 3, k 15, ratio 1) against their plain versions: f32 on the
    chunked CUDA-core kernels (2e-4, gradients 2e-3), each call asserted on
    "fma_chunked"; bf16 on the chunked tensor-core kernels at d 256 (cosine
    > 0.9995), asserted on "wgmma"; and a shape whose box fits whole,
    asserted on its old route "fma"."""
    from naf_torch.kernels import na2d_fused as na
    from naf_torch.kernels.na2d_fused_q import _TILES as K2_TILES
    from naf_torch.kernels.na2d_fused_q import _lib as k2_lib
    from naf_torch.kernels.na2d_fused_q import (
        _plan_k2,
        naf_upsample_attention,
        naf_upsample_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(12)
    (enc, keys, values, rt, ct, dh), (q, k, v, g) = _denoise_attention_inputs(dev, gen)
    kw = dict(num_heads=1, kernel_size=DENOISE_K)
    r2, r34 = naf_upsample_attention.route_launches, na.cross_scale_na2d_fused.route_launches
    res = {}
    want = naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, **kw)
    for dt, route in ((torch.float32, "fma_chunked"), (torch.bfloat16, "wgmma")):
        before = dict(r2)
        got = naf_upsample_attention(enc.to(dt), keys.to(dt), values.to(dt), rt, ct, dh, **kw)
        torch.cuda.synchronize()
        if _route_delta(r2, before) != {route: 1} or got.shape != want.shape:
            raise AssertionError(f"K2 {dt} at the denoiser's shape: routes "
                                 f"{_route_delta(r2, before)}, shape {tuple(got.shape)}")
        if dt == torch.float32:
            res["k2_err"] = _check_close("K2 f32 chunked, denoiser", got, want, 2e-4)
        else:
            res["k2_cos"] = _check_cos("K2 bf16, denoiser", got.float(), want, 0.9995)
        del got
    del want
    nb2 = _plan_k2(448, 448, 448, 448, DENOISE_K, 256, 16, str(dev))[4]
    want = na.cross_scale_na2d_fused_ref(q, k, v, DENOISE_K)
    want_g = na.cross_scale_na2d_fused_bwd_ref(q, k, v, g, DENOISE_K)
    for dt, route in ((torch.float32, "fma_chunked"), (torch.bfloat16, "wgmma")):
        before = dict(r34)
        ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
        out = na.cross_scale_na2d_fused(*ins, DENOISE_K)
        grads = torch.autograd.grad(out, ins, g.to(dt))
        torch.cuda.synchronize()
        delta = _route_delta(r34, before)
        # bf16: one chunked K4 call (its two launches); f32: its row bands
        extra = {"wgmma_chunked_bwd"} if route == "wgmma" else set()
        if (set(delta) != {route, f"{route}_bwd", *extra} or delta[route] != 1
                or (extra and (delta[f"{route}_bwd"], delta["wgmma_chunked_bwd"]) != (1, 1))):
            raise AssertionError(f"K3/K4 {dt} at the denoiser's shape: routes {delta}")
        res[f"k4_launches_{route}"] = delta[f"{route}_bwd"]
        if dt == torch.float32:
            res["k3_err"] = _check_close("K3 f32 chunked, denoiser", out, want, 2e-4)
            res["k4_err"] = max(_check_close(f"K4 f32 chunked, denoiser d{n}", a, w, 2e-3)
                                for a, w, n in zip(grads, want_g, "qkv"))
        else:
            res["k3_cos"] = _check_cos("K3 bf16, denoiser", out.float(), want, 0.9995)
            res["k4_cos"] = min(_check_cos(f"K4 bf16, denoiser d{n}", a.float(), w, 0.9995)
                                for a, w, n in zip(grads, want_g, "qkv"))
        del out, grads, ins
    plans = {}
    both = (na.SMEM_BUDGET, na.SMEM_MAX)
    for name, lib, smem, tiles, limits, dv in (
            ("k2", k2_lib, "naf_fused_q", K2_TILES, both, 3),
            ("k3", na._lib, "naf_na_fwd", na._TILES, both, 4),
            ("k4", na._lib, "naf_na_bwd", na._TILES, (na.SMEM_MAX,), 4)):
        route, plan = na._plan_fma(lib, f"{smem}_smem", f"{smem}_chunk_smem", tiles, limits,
                                   448, 448, 448, 448, DENOISE_K, 256, dv, str(dev))
        plans[name] = dict(route=route, tile=plan[:2], box=plan[2:4], chunk=plan[8:])
    nb34 = na._plan_tc(448, 448, 448, 448, DENOISE_K, 256, 16, True, str(dev))[4]
    # a shape whose box fits whole keeps the whole-box kernels
    qs, ks_, vs, gs = _k34_inputs(dev, gen, (1, 64, 16, 2, 32, 48))
    before = dict(r34)
    ins = [t.requires_grad_() for t in (qs, ks_, vs)]
    torch.autograd.grad(na.cross_scale_na2d_fused(*ins, 9), ins, gs)
    torch.cuda.synchronize()
    if _route_delta(r34, before) != {"fma": 1, "fma_bwd": 1}:
        raise AssertionError(f"a whole-box f32 shape left its route: {_route_delta(r34, before)}")
    print(f"denoiser attention (1, 448^2, one head, d 256, dv 3, k 15, ratio 1): f32 chunked "
          f"(CUDA cores) max_abs_err K2 {res['k2_err']:.3e} K3 {res['k3_err']:.3e} K4 "
          f"{res['k4_err']:.3e} ({res['k4_launches_fma_chunked']} K4 launch(es)); plans "
          + "; ".join(f"{n} tile {p['tile']} box {p['box']} chunks {p['chunk']}"
                      for n, p in plans.items())
          + f"; bf16 (wgmma, boxes of {nb2} / {nb34} cells in chunks of {na.TC_CHUNK}) cos K2 "
          f"{res['k2_cos']:.6f} K3 {res['k3_cos']:.6f} K4 {res['k4_cos']:.6f} "
          f"({res['k4_launches_wgmma']} K4 call: a query-major and a key-major launch); "
          f"(1, 64^2 <- 16^2, d 32) stays on fma",
          flush=True)
    res["plans"] = plans
    del enc, keys, values, q, k, v, g, want, want_g
    torch.cuda.empty_cache()
    return res


def _denoise_step(model, dcfg, use_bf16, noise_gen=None):
    from naf_torch.evals.denoising import DenoisingLoss, NoiseGenerator
    from naf_torch.train.denoise import make_denoise_step, make_optimizer

    return make_denoise_step(
        model, make_optimizer(model, dcfg),
        DenoisingLoss(dcfg.l1_weight, dcfg.l2_weight, dcfg.ssim_weight),
        noise_gen or NoiseGenerator(dcfg.noise_type), dcfg.noise_params,
        (dcfg.img_size, dcfg.img_size), use_bf16)


def phase_denoiser(dev, card, workdir):
    """The denoiser at full width through the CLI's own functions: the real
    shard device-cached, 10 bf16 steps in two chunks (8 K1, 1 K2, 1 K3 and
    the K4 bands per step), validation in f32 (8 K1 and 1 chunked K2 per
    batch), the step's time, busy share and peak, and one f32 step on the
    card against the CPU at 64^2 (still d 256, k 15)."""
    import numpy as np

    from naf_torch.config import load_config
    from naf_torch.denoising import build_denoiser, denoise_config, load_data
    from naf_torch.kernels import na2d_fused as na
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
    from naf_torch.train.denoise import train_denoiser, validate_denoiser
    from naf_torch.train.trainer import step_generator

    torch.backends.cudnn.allow_tf32 = True  # the bf16 run as users run it
    run_dir = os.path.join(workdir, "denoise")
    cfg = load_config("base_denoising", DENOISE_OVERRIDES + [f"run_dir={run_dir}"])
    dcfg = denoise_config(cfg)
    model = build_denoiser(cfg["model"])
    t0 = time.perf_counter()
    train_iter, stack, val_iter = load_data(cfg, dcfg, dev)
    load_s = time.perf_counter() - t0
    if stack is None or train_iter is not None or tuple(stack.shape) != (60, 448, 448, 3):
        raise AssertionError("the real shard did not take the device-cache route")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    model = train_denoiser(model, None, dcfg, device_stack=stack, batch_size=DENOISE_BATCH,
                           device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    c, r2 = _all_counts(), dict(naf_upsample_attention.route_launches)
    r34 = dict(na.cross_scale_na2d_fused.route_launches)
    bands = c["k4"] // DENOISE_STEPS
    want = {"k1": 8 * DENOISE_STEPS, "k2": DENOISE_STEPS, "k3": DENOISE_STEPS}
    # the chunked boxes' K4: one call a step (two launches, no bands)
    if ({k: c[k] for k in want} != want or r2["wgmma"] != DENOISE_STEPS
            or r34["wgmma"] != DENOISE_STEPS or r34["wgmma_bwd"] != c["k4"]
            or r34["wgmma_chunked_bwd"] != c["k4"] or c["k4_chunked"] != c["k4"]
            or c["k4"] != bands * DENOISE_STEPS or bands != 1 or c["k5"] or c["k6"]):
        raise AssertionError(f"denoiser launches over {DENOISE_STEPS} steps: {c}, K2 routes "
                             f"{r2}, K3/K4 routes {r34}")
    launches = dict(k1=c["k1"], k2=c["k2"], k3=c["k3"], k4=c["k4"], k4_bands=bands,
                    routes={"k2": r2, "k34": r34})
    recs = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs]
    if [r["step"] for r in recs] != [4, 9] or not all(np.isfinite(losses)):
        raise AssertionError(f"chunk logs {recs}")
    torch.backends.cudnn.allow_tf32 = False
    _zero_counts()
    t0 = time.perf_counter()
    metrics = validate_denoiser(model, val_iter, dcfg,
                                viz_path=os.path.join(run_dir, "val_panel.png"))
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    c, r2 = _all_counts(), dict(naf_upsample_attention.route_launches)
    if (c["k1"], c["k2"], r2["fma_chunked"]) != (8 * DENOISE_VAL, DENOISE_VAL, DENOISE_VAL) or \
            not (np.isfinite(metrics["psnr"]) and 0 < metrics["ssim"] <= 1):
        raise AssertionError(f"validation: launches {c}, K2 routes {r2}, metrics {metrics}")
    launches.update(val_k1=c["k1"], val_k2_fma_chunked=r2["fma_chunked"])
    print(f"denoiser (NAF dim 256, 1 + 1 heads, k 15; batch {DENOISE_BATCH}, 448^2, real shard "
          f"device-cached in {load_s:.1f} s): {DENOISE_STEPS} bf16 steps in two chunks in "
          f"{train_s:.1f} s (first steps build plans), chunk losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f"; launches per step K1 8, K2 1 (wgmma), K3 1 (wgmma), K4 {bands} bands (wgmma); "
          f"validation f32 on {DENOISE_VAL} batches of 2 in {val_s:.2f} s: PSNR "
          f"{metrics['psnr']:.3f} dB, SSIM {metrics['ssim']:.4f}, K1 8 and K2 1 "
          f"(fma_chunked) per batch ({card})", flush=True)

    # the bf16 step's time (CUDA events), busy share (torch.profiler) and peak
    torch.backends.cudnn.allow_tf32 = True
    step = _denoise_step(model, dcfg, True)
    clean = stack[:DENOISE_BATCH]
    call = lambda: step(clean, step_generator(0, 0, dev))  # noqa: E731
    step_ms = _time_ms(call, iters=5)
    peak = _peak_mib(call)
    split = _profile_step(call, reps=2, names=("denoise.forward", "denoise.optimizer"))
    busy = split["device_total"] / step_ms
    print(f"denoiser step bf16 batch {DENOISE_BATCH} 448^2: {step_ms:.3f} ms/step (5 steps, "
          f"CUDA events), peak {peak:.1f} MiB above what the step starts with; device time "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items()
                      if k not in ("top", "kernels", "wall"))
          + f"; device busy {100 * busy:.1f}% of the step ({card})", flush=True)
    print("  top kernels: " + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in split["top"]),
          flush=True)
    attribution = _denoiser_peak(model, dcfg, clean, dev, card)
    # validation's time per batch of 2 in f32, and its peak
    torch.backends.cudnn.allow_tf32 = False
    vbatch = stack[:2]
    val_call = lambda: validate_denoiser(model, iter([vbatch]), dcfg)  # noqa: E731
    val_ms = _time_ms(val_call, iters=3)
    val_peak = _peak_mib(val_call)
    del step, clean, model, stack, val_iter
    torch.cuda.empty_cache()
    agree = _denoise_card_vs_cpu(dev, dcfg)
    split.pop("top")
    return launches, dict(step_ms=step_ms, peak_mib=peak, busy=busy, split=split,
                          peak_by_frame=attribution,
                          chunk_losses=losses, train_s=train_s, val_s=val_s,
                          val_ms_per_batch=val_ms, val_peak_mib=val_peak,
                          psnr=metrics["psnr"], ssim=metrics["ssim"], **agree)


def _denoiser_peak(model, dcfg, clean, dev, card):
    """The bf16 denoiser step's peak, attributed by allocating frame
    (:func:`_peak_by_frame`), without and with the encoder twin's bf16
    packing of its f32 widenings (``encoder_fused._pack_exact_bf16``; off
    when ``_PACK_MIN`` is out of reach): the port before and after the cut.
    Then steps from the same weights under deterministic algorithms, two
    unpacked and one packed: the packed step's loss and gradients must be as
    close to the unpacked one's as the two unpacked steps are to each other,
    or within rel 1e-6. With cuDNN's deterministic flag alone the twin's
    TF32 convs still give one of two weight gradients in the semantic stack
    from run to run, packed or not, so one pair of unpacked steps may agree
    bitwise while the packed step lands on the other; the global mode makes
    the step reproducible bitwise."""
    import copy

    from naf_torch.kernels import encoder_fused as ef
    from naf_torch.train.trainer import step_generator

    shipped, res, steps = ef._PACK_MIN, {}, {}

    def det_step(label):
        torch.use_deterministic_algorithms(True)
        try:
            twin = copy.deepcopy(model)
            loss = float(_denoise_step(twin, dcfg, True)(clean, step_generator(0, 0, dev)))
        finally:
            torch.use_deterministic_algorithms(False)
        steps[label] = (loss, [p.grad.float() for p in twin.parameters()])

    def rel(a, b):
        (la, ga), (lb, gb) = steps[a], steps[b]
        return abs(la - lb) / abs(lb), max(float((x - y).abs().max() / y.abs().max()
                                                 .clamp_min(1e-30)) for x, y in zip(ga, gb))

    try:
        for label, pack_min in (("unpacked", 1 << 62), ("packed", shipped)):
            ef._PACK_MIN = pack_min
            step = _denoise_step(copy.deepcopy(model), dcfg, True)
            call = lambda: step(clean, step_generator(0, 0, dev))  # noqa: E731
            step_ms = _time_ms(call, iters=3)
            peak, live, top = _peak_by_frame(call)
            print(f"denoiser step peak by allocating frame, twin {label}: {peak:.1f} MiB above "
                  f"the step's start ({live:.1f} MiB allocated in the step and live at the "
                  f"peak), {step_ms:.3f} ms/step (3 steps); top 5: "
                  + "; ".join(f"{k} {mib:.1f} MiB ({n} blocks)" for k, mib, n in top)
                  + f" ({card})", flush=True)
            res[label] = dict(peak_mib=peak, live_mib=live, top=top, step_ms=step_ms)
            del step, call
            det_step(label)
            if label == "unpacked":
                det_step("unpacked_again")
    finally:
        ef._PACK_MIN = shipped
    base_loss, base_grad = rel("unpacked_again", "unpacked")
    loss_rel, grad_rel = rel("packed", "unpacked")
    if loss_rel > max(4 * base_loss, 1e-6) or grad_rel > max(4 * base_grad, 1e-6):
        raise AssertionError(f"the packed twin changed the step: loss rel {loss_rel:.2e}, "
                             f"gradients rel {grad_rel:.2e}; unpacked run to run {base_loss:.2e}, "
                             f"{base_grad:.2e}")
    print(f"denoiser step with the packed twin (deterministic algorithms): loss "
          f"{steps['packed'][0]:.6f} vs {steps['unpacked'][0]:.6f} (rel {loss_rel:.2e}), "
          f"gradients rel {grad_rel:.2e}; two unpacked steps: loss rel {base_loss:.2e}, "
          f"gradients rel {base_grad:.2e}; peak {res['unpacked']['peak_mib']:.1f} -> "
          f"{res['packed']['peak_mib']:.1f} MiB ({card})", flush=True)
    return dict(res, loss_rel=loss_rel, grad_rel=grad_rel, run_to_run_loss_rel=base_loss,
                run_to_run_grad_rel=base_grad)


def _denoise_card_vs_cpu(dev, dcfg, size=64):
    """One f32 denoiser step at full width (dim 256, one head, k 15) at
    size^2 on the card (K1, chunked K2 forward; K3 and K4 in the twin's
    backward) and on the CPU (plain code), from the same weights, image and
    noise: the loss and the flattened gradients."""
    import dataclasses

    from naf_torch.api import _init_weights
    from naf_torch.models.naf import NAF

    src = NAF(**DENOISE_NAF)
    _init_weights(src, 6)
    gen = torch.Generator().manual_seed(7)
    clean = torch.rand(1, size, size, 3, generator=gen)
    noise = 0.5 * torch.randn(1, size, size, 3, generator=gen)
    cfg = dataclasses.replace(dcfg, img_size=size, use_bf16=False)
    res = {}
    for where in ("cpu", dev):
        model = NAF(**DENOISE_NAF)
        model.load_state_dict(src.state_dict())
        model.to(where)
        n = noise.to(where)
        step = _denoise_step(model, cfg, False, noise_gen=lambda _g, img, _p: img + n)
        before = _all_counts()
        loss = float(step(clean.to(where), None))
        delta = {k: v - before[k] for k, v in _all_counts().items() if v != before[k]}
        res[str(where)] = (loss, torch.cat([p.grad.flatten().cpu() for p in model.parameters()]),
                           delta)
    (l_cpu, g_cpu, d_cpu), (l_gpu, g_gpu, d_gpu) = res["cpu"], res[str(dev)]
    if d_cpu or (d_gpu.get("k1"), d_gpu.get("k2_fma_chunked"), d_gpu.get("k3")) != (8, 1, 1) \
            or not d_gpu.get("k4"):
        raise AssertionError(f"launches: CPU step {d_cpu}, card step {d_gpu}")
    if not abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu):
        raise AssertionError(f"card f32 denoiser loss {l_gpu} vs CPU {l_cpu}")
    c = _check_cos("card vs CPU f32 denoiser gradients", g_gpu, g_cpu, 0.999)
    print(f"denoiser: f32 step at {size}^2 (dim 256, k 15), card vs CPU: loss {l_gpu:.6f} vs "
          f"{l_cpu:.6f} (rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}); gradient cosine {c:.6f}; "
          f"card launches {d_gpu}", flush=True)
    return dict(cpu_loss=l_cpu, card_loss=l_gpu, grad_cos=c)


def phase_restorers(dev, card, workdir):
    """IRCNN, REDNet and Restormer through the CLI's ``main`` with the
    denoiser's command line (3 bf16 steps at 448^2, batch 8, on the
    device-cached real shard, one validation batch), then each step's time
    and peak, and one f32 forward on the card against the model's f32 CPU
    copy (cosine > 0.999; Restormer at 128^2 to keep the CPU short). The
    restorers launch none of the port's kernels."""
    import copy

    from naf_torch.api import _init_weights
    from naf_torch.config import load_config
    from naf_torch.denoising import build_denoiser, denoise_config, main
    from naf_torch.train.trainer import step_generator

    res = {}
    for name in ("ircnn", "rednet", "restormer"):
        argv = [f"model={name}" if a == "model=naf" else a for a in DENOISE_OVERRIDES]
        argv += ["train_steps=3", "val_steps=1", f"run_dir={os.path.join(workdir, name)}"]
        torch.backends.cudnn.allow_tf32 = True
        _zero_counts()
        metrics = main(argv)
        torch.cuda.synchronize()
        if any(_all_counts().values()):
            raise AssertionError(f"{name} launched port kernels: {_all_counts()}")
        cfg = load_config("base_denoising", argv)
        dcfg = denoise_config(cfg)
        model = build_denoiser(cfg["model"])
        _init_weights(model, 0)
        cpu_model = copy.deepcopy(model)
        model.to(dev)
        step = _denoise_step(model, dcfg, True)
        clean = torch.rand(DENOISE_BATCH, 448, 448, 3, generator=torch.Generator(
            device=dev).manual_seed(8), device=dev)
        call = lambda: step(clean, step_generator(0, 0, dev))  # noqa: E731
        step_ms = _time_ms(call, iters=3)
        peak = _peak_mib(call)
        del step, clean
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        size = 128 if name == "restormer" else 448
        x = torch.rand(1, size, size, 3, generator=torch.Generator().manual_seed(9))
        cpu_model.load_state_dict(model.state_dict())
        with torch.no_grad():
            want = cpu_model(x, x, (size, size))
            got = model(x.to(dev), x.to(dev), (size, size)).cpu()
        cos = _check_cos(f"{name} f32 card vs CPU", got, want, 0.999)
        res[name] = dict(step_ms=step_ms, peak_mib=peak, psnr=metrics["psnr"],
                         ssim=metrics["ssim"], cos_cpu=cos)
        print(f"{name}: CLI 3 bf16 steps, batch {DENOISE_BATCH}, 448^2 + validation (PSNR "
              f"{metrics['psnr']:.3f} dB, SSIM {metrics['ssim']:.4f}); step {step_ms:.3f} "
              f"ms (3 steps, CUDA events), peak {peak:.1f} MiB; f32 forward at {size}^2 vs "
              f"its CPU copy cos {cos:.6f} ({card})", flush=True)
        del model, cpu_model
        torch.cuda.empty_cache()
    return res


def _time_denoise_kernels(dev, card):
    """K2, K3 and K4 at the denoiser's attention: bf16 at the training batch
    (8, the chunked tensor-core kernels) and f32 at the validation batch (2,
    the chunked CUDA-core kernels; K3 and K4 there are the f32 step's):
    device time (torch.profiler), the plain version, the bound. bf16 K4 is
    its two launches from K3's statistics, as autograd runs it ("k4"), and
    a direct call that runs the K3 feeding them first ("k4_k3"). No library
    call computes this attention: masked SDPA over every key would need a
    200,704 x 200,704 mask per image (40 GB as bool)."""
    from naf_torch.kernels import na2d_fused as na
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention, naf_upsample_attention_ref

    bw_peak, fl_peak = _peaks(card)
    gen = torch.Generator(device=dev).manual_seed(13)
    kw = dict(num_heads=1, kernel_size=DENOISE_K)
    d, dv, slots = 256, 3, DENOISE_K ** 2
    res = {}
    for dt, b, names in (
            (torch.bfloat16, DENOISE_BATCH, ("fused_q_wgmma_chunked", "na_fwd_wgmma_chunked",
                                             "na_bwd_wgmma_chunked",
                                             ("na_fwd_wgmma_chunked", "na_bwd_wgmma_chunked"))),
            (torch.float32, 2, ("fused_q_chunked_kernel", "na_fwd_chunked_kernel",
                                ("na_bwd_chunked_kernel", "na_bwd_reduce")))):
        (enc, keys, values, rt, ct, dh), (q, k, v, g) = _denoise_attention_inputs(dev, gen, b)
        enc, keys, values, q, k, v, g = (t.to(dt) for t in (enc, keys, values, q, k, v, g))
        sc = d ** -0.5
        esz = 2 if dt == torch.bfloat16 else 4
        peak = fl_peak if dt == torch.bfloat16 else F32_FLOPS
        pix = b * 448 * 448

        def bound(nbytes, flops):
            return (max(nbytes / bw_peak, flops / peak) * 1e3,
                    "bytes" if nbytes / bw_peak > flops / peak else "operations")

        stats = na._fwd(q, k, v, DENOISE_K, sc) if dt == torch.bfloat16 else None
        b3 = (esz * pix * 2 * (d + dv), 2 * pix * slots * (d + dv))
        b4 = (esz * pix * (2 * d + dv + 2 * (d + dv)), 2 * pix * slots * (3 * d + 2 * dv))
        calls = {
            "k2": (lambda: naf_upsample_attention(enc, keys, values, rt, ct, dh, **kw),
                   lambda: naf_upsample_attention_ref(enc, keys, values, rt, ct, dh, **kw),
                   bound(esz * pix * (2 * d + 2 * dv) + 4 * (rt.numel() + ct.numel()),
                         2 * pix * slots * (d + dv))),
            "k3": (lambda: na._launch_fwd(q, k, v, DENOISE_K, sc),
                   lambda: na.cross_scale_na2d_fused_ref(q, k, v, DENOISE_K), bound(*b3)),
            "k4": (lambda: na._launch_bwd(q, k, v, g, DENOISE_K, sc, stats=stats),
                   lambda: na.cross_scale_na2d_fused_bwd_ref(q, k, v, g, DENOISE_K), bound(*b4)),
        }
        if stats is not None:
            calls["k4_k3"] = (lambda: na._launch_bwd(q, k, v, g, DENOISE_K, sc),
                              lambda: na.cross_scale_na2d_fused_bwd_ref(q, k, v, g, DENOISE_K),
                              bound(b3[0] + b4[0], b3[1] + b4[1]))
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for (name, (fn, plain_fn, (b_ms, b_by))), match in zip(calls.items(), names):
            ms = _kernel_ms(fn, match, reps=3)
            plain = _time_ms(plain_fn, iters=1)
            res[f"{name}_denoise_{tag}"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                                bound_by=b_by, library_ms=None, batch=b)
            print(f"{name.upper()} {tag} denoiser attention ({b}, 448^2, d 256, dv 3, k 15, "
                  f"ratio 1), chunked: kernels {match} {ms:.4f} ms; plain {plain:.4f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by}); library: none feasible (masked SDPA needs a "
                  f"200,704 x 200,704 mask) ({card})", flush=True)
        del enc, keys, values, q, k, v, g, stats
        torch.cuda.empty_cache()
    return res


# phase 17: (image side, LR side, output side) of the sharded forwards; 2048^2
# takes 128^2 features, as phase 12's banded request: 2048 % 28 != 0, so the
# 28^2 grid of the ragged 448^2 -> 2048^2 request has no whole cell rows to
# band (the port raises there, as the JAX package's spatial forward does)
PARALLEL_SHAPES = {"448": (448, 28, 448), "2048": (448, 128, 2048)}
PARALLEL_RANKS = 2
PARALLEL_REPS = 5  # timed sharded (and one-process) forwards per rank
# phase 17's spatially sharded train steps: (image side, LR side, output side,
# bf16, steps), each from the same weights as the one-process step it is held
# against, on a target drawn from a seed; the cases of one shape take the same
# image and features, so a bf16 step is also held against the f32 one-process
# step of its shape where there is one
SPATIAL_TRAIN = {"448_f32": (448, 28, 448, False, 2), "448_bf16": (448, 28, 448, True, 2),
                 "2048_bf16": (448, 128, 2048, True, 1)}


def phase_parallel(dev, card):
    """17. The parallel path (``naf_torch.parallel``): two ranks spawned on
    the one card over gloo (file rendezvous) run the spatially sharded
    forward (space 2) of the production NAF at 448^2 + 28^2 x 384 -> 448^2
    and 448^2 + 128^2 x 384 -> 2048^2, f32 and bf16, each gathered and held
    against the one-process forward on the card (f32 max abs err <= 2e-5, the
    JAX package's bar for this path; bf16 cosine >= 0.99999), every rank's
    sharded forward launching 8 K1 and 1 K2 on the dtype's route; a
    data-parallel train step over the two ranks at the training shape (batch
    4, 448^2, random ViT-B/14) against the one-process step (loss rel <=
    1e-2 in bf16; <= 1e-5 in f32 with the gradients before the optimizer at
    cosine >= 0.999999); the spatially sharded train step at
    ``SPATIAL_TRAIN``'s shapes against the one-process step
    (:func:`_spatial_train_check`); and one rank in an NCCL world taking the
    f32 step through its all_reduce. Per-rank wall times are of two ranks
    sharing one card."""
    import numpy as np

    from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    from naf_torch.dryrun import each, spatial_case, train_case
    from naf_torch.parallel import run_ranks

    rng = np.random.RandomState(17)
    calls, labels = [], []
    for tag, (side, hk, out) in PARALLEL_SHAPES.items():
        img = rng.randn(1, side, side, 3).astype(np.float32)
        feats = rng.randn(1, hk, hk, 384).astype(np.float32)
        for dtype in ("float32", "bfloat16"):
            calls.append((spatial_case, dict(naf=PROD_NAF, seed=0, image=img, feats=feats,
                                             out_hw=(out, out), data=1, space=PARALLEL_RANKS,
                                             dtype=dtype, compare=True, reps=PARALLEL_REPS)))
            labels.append(f"{tag}_{dtype}")
    img = next(_images(BATCH, IMG_SIZE, 17))
    mean, std = np.asarray(IMAGENET_DEFAULT_MEAN), np.asarray(IMAGENET_DEFAULT_STD)
    norm = ((img - mean) / std).astype(np.float32)  # DINOv2 takes ImageNet's statistics too
    hr = IMG_SIZE // 14
    step = dict(naf=PROD_NAF, seed=0, backbone=dict(name=BACKBONE, seed=0), ups=norm,
                back=norm, steps=2, lr_size=(IMG_SIZE // 2,) * 2, out_hw=(hr, hr),
                crop_hw=(min(224, 4 * hr),) * 2, one_process=True)
    for use_bf16 in (True, False):
        calls.append((train_case, dict(step, use_bf16=use_bf16)))
    calls += _spatial_train_calls(PARALLEL_RANKS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(each, PARALLEL_RANKS, args=(calls,), device="cuda", timeout=900)
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = run_ranks(each, 1, args=([(train_case, dict(step, use_bf16=False))],),
                        device="cuda", timeout=600)
    nccl_s = time.perf_counter() - t0
    nccl = nccl[0]

    res = {"ranks": PARALLEL_RANKS, "note": "two ranks sharing one card over gloo",
           "spawn_and_run_s": gloo_s, "nccl_spawn_and_run_s": nccl_s}
    launches = {"k1": 0, "k2": 0}
    for i, label in enumerate(labels):
        per = [r[i] for r in ranks]
        route = "wgmma" if label.endswith("bfloat16") else "fma"
        for r in per:
            ln = r["launches"]
            want = (8 * PARALLEL_REPS, PARALLEL_REPS, PARALLEL_REPS, "gloo")
            if (ln["k1"], ln["k2"], ln[f"k2_{route}"], r["backend"]) != want:
                raise AssertionError(f"parallel {label}: rank {r['rank']} launches {ln}, "
                                     f"backend {r['backend']}")
            launches["k1"] += ln["k1"]
            launches["k2"] += ln["k2"]
        top = per[0]
        side, hk, out = PARALLEL_SHAPES[label.split("_")[0]]
        if top["shape"] != (1, out, out, 384) or not top["finite"]:
            raise AssertionError(f"parallel {label}: gathered {top['shape']}, finite "
                                 f"{top['finite']}")
        if label.endswith("float32") and not top["max_abs_err"] <= 2e-5:
            raise AssertionError(f"parallel {label}: max abs err {top['max_abs_err']:.3e} to "
                                 "the one-process forward")
        if label.endswith("bfloat16") and not top["cos"] >= 0.99999:
            raise AssertionError(f"parallel {label}: cosine {top['cos']:.7f} to the "
                                 "one-process forward")
        res[label] = dict(max_abs_err=top["max_abs_err"], cos=top["cos"],
                          single_ms=top["single_ms"], rank_ms=[r["ms"] for r in per],
                          rank_peak_mib=[r["peak_mib"] for r in per], route=route,
                          launches_per_rank_forward={"k1": 8, "k2": 1})
        print(f"parallel {label}: {side}^2 + {hk}^2 x 384 -> {out}^2 over {PARALLEL_RANKS} "
              f"ranks (space {PARALLEL_RANKS}, gloo, sharing one card): each rank 8 K1, 1 K2 "
              f"({route}); max abs err {top['max_abs_err']:.3e}, cosine {top['cos']:.7f} to "
              f"the one-process forward; rank ms a forward ({PARALLEL_REPS} forwards) "
              + ", ".join(f"{r['ms']:.3f}" for r in per)
              + f" (one process {top['single_ms']:.3f} ms); rank peak MiB "
              + ", ".join(f"{r['peak_mib']:.1f}" for r in per) + f" ({card})", flush=True)

    def step_check(label, dp, single, loss_rel):
        """Both steps' losses, and the first step's gradients before the
        optimizer; the second step's wall time (the first builds plans)."""
        rel = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"], single["losses"]))
        g_dp = torch.cat([g.flatten() for g in dp["grads"].values()])
        g_one = torch.cat([single["grads"][k].flatten() for k in dp["grads"]])
        cos = _cos(g_dp, g_one)
        if not rel <= loss_rel or (loss_rel <= 1e-5 and not cos >= 0.999999):
            raise AssertionError(f"{label}: losses {dp['losses']} vs one process "
                                 f"{single['losses']} (rel {rel:.2e}), gradient cosine "
                                 f"{cos:.7f}")
        return dict(losses=dp["losses"], single_losses=single["losses"], loss_rel=rel,
                    grad_cos=cos, step_ms=dp["ms"][-1], single_step_ms=single["ms"][-1],
                    peak_mib=dp.get("peak_mib"))

    n = len(labels)
    for j, (tag, bar) in enumerate((("bf16", 1e-2), ("f32", 1e-5))):
        dp = [r[n + j] for r in ranks]
        if {r["backend"] for r in dp} != {"gloo"}:
            raise AssertionError(f"data-parallel step {tag}: backends {[r['backend'] for r in dp]}")
        res[f"dp_step_{tag}"] = step_check(f"data-parallel step {tag}", dp[0]["dp"],
                                           dp[0]["single"], bar)
        res[f"dp_step_{tag}"]["rank_step_ms"] = [r["dp"]["ms"][-1] for r in dp]
    if nccl["backend"] != "nccl":
        raise AssertionError(f"the one-rank world ran {nccl['backend']}, not NCCL")
    res["nccl_step_f32"] = step_check("one-rank NCCL step f32", nccl["dp"], nccl["single"], 1e-6)
    for tag in ("dp_step_bf16", "dp_step_f32", "nccl_step_f32"):
        r = res[tag]
        print(f"parallel {tag}: batch {BATCH} {IMG_SIZE}^2 (random ViT-B/14), 2 steps, losses "
              + ", ".join(f"{x:.6f}" for x in r["losses"]) + " vs one process "
              + ", ".join(f"{x:.6f}" for x in r["single_losses"])
              + f" (rel {r['loss_rel']:.2e}), first-step gradient cosine {r['grad_cos']:.7f}; "
              f"second step {r['step_ms']:.1f} ms (one process {r['single_step_ms']:.1f}), "
              f"peak {r['peak_mib']:.1f} MiB ({card})", flush=True)
    f32_steps = {}
    for j, (tag, spec) in enumerate(SPATIAL_TRAIN.items()):
        per = [r[n + 2 + j] for r in ranks]
        shape = spec[:3]
        res[f"spatial_train_{tag}"] = _spatial_train_check(tag, spec, per, card,
                                                           f32_steps.get(shape))
        if not spec[3]:
            f32_steps[shape] = per[0]["single"]
        for r in per:
            for name in ("k1", "k2", "k3", "k4"):
                launches[f"train_{name}"] = launches.get(f"train_{name}", 0) + sum(
                    ln[name] for ln in r["spatial"]["launches"])
    print(f"parallel: {PARALLEL_RANKS} gloo ranks started and run in {gloo_s:.1f} s, the NCCL "
          f"rank in {nccl_s:.1f} s", flush=True)
    return launches, res


def _spatial_train_calls(space: int) -> list:
    """Phase 17's ``(spatial_train_case, spec)`` calls, one per
    ``SPATIAL_TRAIN`` case: data 1, the production NAF from seed 0, the
    image and features of the case's shape drawn from one seed."""
    import numpy as np

    from naf_torch.dryrun import spatial_train_case

    calls, inputs = [], {}
    rng = np.random.RandomState(18)
    for side, hk, out, use_bf16, steps in SPATIAL_TRAIN.values():
        if (side, hk) not in inputs:
            inputs[side, hk] = (rng.randn(1, side, side, 3).astype(np.float32),
                                rng.randn(1, hk, hk, 384).astype(np.float32))
        image, feats = inputs[side, hk]
        calls.append((spatial_train_case, dict(
            naf=PROD_NAF, seed=0, image=image, feats=feats, target_shape=(1, out, out, 384),
            target_seed=17, out_hw=(out, out), data=1, space=space, use_bf16=use_bf16,
            steps=steps, one_process=True)))
    return calls


def _flat_grads(run, names) -> torch.Tensor:
    return torch.cat([run["grads"][k].flatten() for k in names])


def _spatial_train_check(tag, spec, per, card, f32_single=None) -> dict:
    """Phase 17's spatial train step on each rank against the one-process
    step on rank 0: every step of every rank (and of the one-process run)
    on 8 K1, one K2, one K3 and K4 in one or more bands, all on the dtype's
    route; the ranks' losses and parameters equal; the losses, the first
    step's gradients and (f32) the parameters after the steps within the
    bars; at 2048^2 every rank's peak below the one-process step's. A bf16
    step whose shape has an f32 case (``f32_single``, that case's
    one-process run: the same weights and inputs) is also held against the
    f32 one-process gradient, beside the bf16 one-process step's cosine to
    it. The f32 gradients' rel norm bar is 5e-5, not 1e-5: the ranks'
    cuDNN weight gradients of the 3x3 encoder convs sum other partitions of
    the 448^2 pixels than the one process's, and that alone gives ~1e-5
    (``naf_torch/tools/wgrad_partition.py``: the same activations' weight
    gradients over two row halves against one whole-grid call, 9.6e-6 of
    the gradient's norm; the step's own 1.09e-5, all of it in the encoder
    convs; the one-process step 1.01e-5 from the float64 sums; two
    one-process steps 1.7e-6 apart)."""
    side, hk, out, use_bf16, steps = spec
    route = "wgmma" if use_bf16 else "fma"
    label = f"spatial train {tag}"
    one = per[0]["single"]
    for who, run in [*((f"rank {r['rank']}", r["spatial"]) for r in per), ("one process", one)]:
        for i, ln in enumerate(run["launches"]):
            got = (ln["k1"], ln["k2"], ln[f"k2_{route}"], ln["k3"], ln[f"k34_{route}"])
            if got != (8, 1, 1, 1, 1) or ln["k4"] < 1 or ln[f"k34_{route}_bwd"] != ln["k4"]:
                raise AssertionError(f"{label}: {who} step {i} launches {ln}")
    sp = per[0]["spatial"]
    for r in per[1:]:
        other = r["spatial"]
        if other["losses"] != sp["losses"] or not all(
                torch.equal(other["params"][k], v) for k, v in sp["params"].items()):
            raise AssertionError(f"{label}: rank {r['rank']} holds other losses or parameters")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sp["losses"], one["losses"]))
    names = list(sp["grads"])
    g_sp, g_one = _flat_grads(sp, names), _flat_grads(one, names)
    cos = _cos(g_sp, g_one)
    grad_rel = float((g_sp.double() - g_one.double()).norm() / g_one.double().norm())
    param_err = max(float((v - one["params"][k]).abs().max()) for k, v in sp["params"].items())
    cos_f32 = cos_one_f32 = None
    if f32_single is not None:
        g_f32 = _flat_grads(f32_single, names)
        cos_f32, cos_one_f32 = _cos(g_sp, g_f32), _cos(g_one, g_f32)
    if use_bf16:
        ok = loss_rel <= 1e-2 and cos >= 0.9995 and (cos_f32 is None or cos_f32 >= 0.9995)
    else:
        ok = loss_rel <= 1e-5 and cos >= 0.999999 and grad_rel <= 5e-5 and param_err <= 1e-5
    if not ok:
        raise AssertionError(f"{label}: losses {sp['losses']} vs one process {one['losses']} "
                             f"(rel {loss_rel:.2e}), gradient cosine {cos:.7f} (to the f32 "
                             f"one-process step {cos_f32}), rel norm {grad_rel:.2e}, "
                             f"parameters max abs diff {param_err:.2e}")
    peaks = [r["spatial"]["peak_mib"] for r in per]
    if out == 2048 and not max(peaks) < one["peak_mib"]:
        raise AssertionError(f"{label}: rank peaks {peaks} MiB not below the one-process "
                             f"step's {one['peak_mib']:.1f} MiB")
    k4 = [ln["k4"] for ln in sp["launches"]]
    print(f"parallel {label}: {side}^2 + {hk}^2 x 384 -> {out}^2, "
          f"{'bf16' if use_bf16 else 'f32'}, {steps} step(s) over {len(per)} ranks (data 1, "
          f"space {len(per)}, gloo, sharing one card): each rank per step 8 K1, 1 banded K2, 1 "
          f"K3, K4 {k4} ({route}); losses " + ", ".join(f"{x:.7f}" for x in sp["losses"])
          + " vs one process " + ", ".join(f"{x:.7f}" for x in one["losses"])
          + f" (rel {loss_rel:.2e}); first-step gradient cosine {cos:.8f}, rel norm "
          f"{grad_rel:.2e}"
          + ("" if cos_f32 is None else f"; cosine to the f32 one-process step {cos_f32:.8f} "
             f"(the bf16 one-process step's {cos_one_f32:.8f})")
          + f"; parameters after the steps max abs diff {param_err:.2e}; rank ms "
          f"a step (last) " + ", ".join(f"{r['spatial']['ms'][-1]:.1f}" for r in per)
          + f" (one process {one['ms'][-1]:.1f}); rank peak MiB "
          + ", ".join(f"{p:.1f}" for p in peaks) + f" (one process {one['peak_mib']:.1f}) "
          f"({card})", flush=True)
    return dict(losses=sp["losses"], single_losses=one["losses"], loss_rel=loss_rel,
                grad_cos=cos, grad_rel=grad_rel, param_max_abs_diff=param_err,
                grad_cos_f32=cos_f32, single_grad_cos_f32=cos_one_f32,
                rank_step_ms=[r["spatial"]["ms"] for r in per], single_step_ms=one["ms"],
                rank_peak_mib=peaks, single_peak_mib=one["peak_mib"], route=route,
                k4_per_step=k4)


# the backbones of phase 18: every name of the port's registry, and the
# real-shard evals' backbone (evaluation/eval_real_shard.py:49,63)
EVAL_BACKBONE = "vit_small_patch16_224"
# the reference's LargeImg request (naf_tpu/bench/harness.py:233-299): a
# ViT-B/16 DINO on the 448^2 bilinear downsample, the production NAF to the
# full image; (output side, ratio) and the reference's A100 40GB times
# (harness.py:238-239), printed as context only
LARGE_IMG = ((896, 2, "cpu"), (1792, 4, "card"))  # and where its f32 reference runs
LARGE_IMG_BACKBONE = "vit_base_patch16_224.dino"
LARGE_IMG_A100_MS = {896: 110.05, 1792: 1035.68}
# the full-width probe of phase 19: DINOv3 ViT-B/16 (768 wide, 4 registers,
# RoPE) at 448^2, NAF in bf16
FULL_PROBE = ["img_size=448", "backbone.name=vit_base_patch16_dinov3.lvd1689m", "dtype=bfloat16"]


def phase_backbones(dev, card):
    """Phase 18, the backbones: every registry name and the real-shard
    evals' backbone with seeded random weights at full width and its own
    input size, bf16 on the card against an f32 copy on the CPU (cosine >
    0.999); one f32 card run per RoPE style (none, rotate-half,
    interleaved) against the CPU at atol = rtol = 1e-3 (TF32 off); each
    name's forward ms (CUDA events, 5 forwards) and own peak."""
    from naf_torch.backbones import BACKBONE_REGISTRY, PretrainedViTWrapper

    res, styles = {}, {}
    for name in sorted(BACKBONE_REGISTRY) + [EVAL_BACKBONE]:
        cpu = PretrainedViTWrapper(name, device="cpu", seed=0)
        size = cpu.config["input_size"][1]
        x = torch.randn(1, size, size, 3, generator=torch.Generator().manual_seed(7))
        with torch.inference_mode():
            want = cpu(x)
        del cpu
        bb = PretrainedViTWrapper(name, device=dev, dtype=torch.bfloat16, seed=0)
        xb = x.to(dev, torch.bfloat16)
        with torch.inference_mode():
            got = bb(xb).float().cpu()
            c = _check_cos(f"{name} bf16 card vs f32 CPU", got, want, 0.999)
            ms = _time_ms(lambda: bb(xb), iters=5)
            peak = _peak_mib(lambda: bb(xb))
        cfg = bb.vit_config
        style = "none" if cfg.rope_theta is None else cfg.rope_style
        rec = dict(input=size, width=cfg.embed_dim, heads=cfg.num_heads, rope=style,
                   registers=cfg.num_reg_tokens, ms=ms, peak_mib=peak, cos_cpu=c)
        del bb
        if style not in styles:
            f32 = PretrainedViTWrapper(name, device=dev, seed=0)
            with torch.inference_mode():
                rec["f32_max_abs_err"] = _check_close(f"{name} f32 card vs CPU",
                                                      f32(x.to(dev)).cpu(), want, 1e-3)
            styles[style] = name
            del f32
        print(f"backbone {name}: {size}^2, width {cfg.embed_dim}, {cfg.num_heads} heads, RoPE "
              f"{style}, {cfg.num_reg_tokens} registers; bf16 {ms:.3f} ms, peak {peak:.1f} MiB, "
              f"cos vs CPU f32 {c:.6f}"
              + (f"; f32 max abs err vs CPU {rec['f32_max_abs_err']:.2e}"
                 if "f32_max_abs_err" in rec else "") + f" ({card})", flush=True)
        res[name] = rec
    return res


def _naf_plain(model, image, feats, out):
    """The NAF fused path's plain version on the card: the input guard's
    bilinear downscale, both encoder stacks by their modules' own forward
    (GroupNorm, SiLU, conv; no K1), the keys and tables as the fused path
    builds them, then K2's plain version."""
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention_ref
    from naf_torch.ops.resize import resize_bilinear

    ie = model.image_encoder
    image = resize_bilinear(image, ie.guard_size(*image.shape[1:3], *out))
    enc = torch.cat([ie.encoder(image), ie.sem_encoder(image)], dim=-1)
    keys = ie.rope.pooled(enc, out, tuple(feats.shape[1:3]))
    sin_r, cos_r, sin_c, cos_c = ie.rope.tables(*out)
    return naf_upsample_attention_ref(
        enc, keys, feats, torch.cat([cos_r, sin_r], dim=-1), torch.cat([cos_c, sin_c], dim=-1),
        ie.rope.d_head, num_heads=model.heads_attn, kernel_size=model.kernel_size)


def _large_img_row(dev, out, ratio, workdir, bb, model):
    """The LargeImg request's row through the bench harness
    (``benchmark_large_img`` on ``bb`` and ``model``: 3 samples of 5 calls
    each); fails on a skip or an error row, or unless every NAF forward in
    it launched 8 K1 and 1 K2 (wgmma). Returns the row and its forwards."""
    from naf_torch.bench.harness import benchmark_large_img

    _zero_counts()
    with _NafForwards() as rec:
        row = benchmark_large_img(out, ratio, dtype=torch.bfloat16, iters=5, repeats=3,
                                  out_path=os.path.join(workdir, "large_img.json"), device=dev,
                                  backbone=bb, naf=model)
    counts = _all_counts()
    if "fwd_ms" not in row:
        raise AssertionError(f"LargeImg {out}^2: benchmark_large_img gave {row}")
    if not rec.calls or any(c != (8, 1) for c in rec.calls) or \
            counts["k2_wgmma"] != len(rec.calls):
        raise AssertionError(f"LargeImg {out}^2: benchmark_large_img's NAF forwards launched "
                             f"{set(rec.calls)} (K1, K2), {counts}; want (8, 1) each, wgmma")
    return row, len(rec.calls)


def phase_large_img(dev, card, workdir):
    """Phase 18, the reference's LargeImg request: ``vit_base_patch16_224.dino``
    on the 448^2 bilinear downsample (``jax.image.resize``'s "linear") of a
    896^2 / 1792^2 image, then the production ``NAF()`` to the full image,
    bf16, batch 1, with 8 K1 and 1 K2 (wgmma) per forward; the backbone's,
    NAF's and the request's ms through the bench harness's
    ``benchmark_large_img`` on the same two models (CUDA events, median, min
    and max of 3 samples of 5 calls; each NAF forward of it at 8 K1 and 1
    K2), the request's own peak from it, and torch.profiler's device time of
    the backbone and the request by kernel; 896^2 held against an f32 CPU
    copy, 1792^2 against the card's f32 plain path (cosine > 0.999)."""
    from naf_torch import load_naf_params
    from naf_torch.backbones import PretrainedViTWrapper
    from naf_torch.backbones.vit import resize_jax

    bb = PretrainedViTWrapper(LARGE_IMG_BACKBONE, device=dev, dtype=torch.bfloat16, seed=0)
    model = load_naf_params(seed=0, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(11)
    res, launches = {}, {"k1": 0, "k2": 0}
    for out, ratio, ref_on in LARGE_IMG:
        image = torch.randn(1, out, out, 3, generator=gen, device=dev).bfloat16()
        lr_side = out // ratio

        def backbone(image=image, lr_side=lr_side):
            return bb(resize_jax(image, (lr_side, lr_side), "linear").bfloat16())

        def request(image=image, out=out):
            return model(image, backbone(), (out, out))

        with torch.inference_mode():
            torch.cuda.synchronize()
            _zero_counts()
            got = request()
            torch.cuda.synchronize()
            counts = _all_counts()
            if (counts["k1"], counts["k2"], counts["k2_wgmma"]) != (8, 1, 1):
                raise AssertionError(f"LargeImg {out}^2 launched {counts}, want 8 K1, 1 K2 "
                                     "(wgmma)")
            launches["k1"] += counts["k1"]
            launches["k2"] += counts["k2"]
            row, timed = _large_img_row(dev, out, ratio, workdir, bb, model)
            bb_ms, naf_ms, total_ms = row["fwd_ms_backbone"], row["fwd_ms_naf"], row["fwd_ms"]
            peak = row["fwd_mem_mb"]
            prof_bb = _profile(backbone, f"LargeImg {out}^2 backbone")
            prof = _profile(request, f"LargeImg {out}^2 request")
            if got.shape != (1, out, out, 768) or not bool(got.isfinite().all()):
                raise AssertionError(f"LargeImg {out}^2: bad output {tuple(got.shape)}")
            image32 = image.float()
            if ref_on == "cpu":
                cpu_bb = PretrainedViTWrapper(LARGE_IMG_BACKBONE, device="cpu", seed=0)
                cpu_model = load_naf_params(seed=0, device="cpu")
                x = image32.cpu()
                want = cpu_model(x, cpu_bb(resize_jax(x, (lr_side, lr_side), "linear")), (out, out))
                ref = "f32 CPU copy"
                got = got.float().cpu()
            else:
                bb32 = PretrainedViTWrapper(LARGE_IMG_BACKBONE, device=dev, seed=0)
                m32 = load_naf_params(seed=0, device=dev)
                want = _naf_plain(m32, image32, bb32(resize_jax(image32, (lr_side, lr_side),
                                                                 "linear")), (out, out))
                ref = "card f32 plain path"
                del bb32, m32
            c = _check_cos(f"LargeImg {out}^2 bf16 vs {ref}", got.float(), want, 0.999)
            del got, want
        res[str(out)] = dict(ratio=ratio, backbone_ms=bb_ms, naf_ms=naf_ms, total_ms=total_ms,
                             bench_row=row, peak_mb=peak, naf_forwards_timed=timed, cos=c, against=ref, profile=prof,
                             backbone_profile=prof_bb,
                             a100_40gb_reference_ms=LARGE_IMG_A100_MS[out])
        print(f"LargeImg {out}^2 (ratio {ratio}, ViT-B/16 at {lr_side}^2 -> {lr_side // 16}^2 x "
              f"768, NAF bf16 batch 1; benchmark_large_img, median [min-max] of 3 x 5 calls): "
              f"backbone {bb_ms:.3f} [{row['fwd_ms_backbone_min']:.3f}-"
              f"{row['fwd_ms_backbone_max']:.3f}] ms, NAF {naf_ms:.3f} "
              f"[{row['fwd_ms_naf_min']:.3f}-{row['fwd_ms_naf_max']:.3f}] ms, total "
              f"{total_ms:.3f} [{row['fwd_ms_min']:.3f}-{row['fwd_ms_max']:.3f}] ms, "
              f"peak {peak:.1f} MiB; launches K1 8, K2 1 (wgmma) in each of {timed} NAF "
              f"forwards, the timed ones included; cos vs {ref} {c:.6f} ({card}); "
              f"the reference's A100 40GB time {LARGE_IMG_A100_MS[out]} ms is context, not a "
              "target", flush=True)
        torch.cuda.empty_cache()
    return launches, res


class _NafForwards:
    """Counts K1 and K2 launches per ``NAF.forward`` on the card while
    active: every such call's (K1, K2) in ``calls``, and whether it ran with
    gradients enabled in ``grad_flags`` (their number in ``grad_calls``).
    Calls on CPU tensors (the bench harness's FLOP census) are not
    counted."""

    def __enter__(self):
        from naf_torch.models.naf import NAF

        self.calls, self.grad_flags, self._orig = [], [], NAF.forward
        orig, calls = self._orig, self.calls

        def forward(model, image, *args, **kwargs):
            if not image.is_cuda:
                return orig(model, image, *args, **kwargs)
            before = _all_counts()
            out = orig(model, image, *args, **kwargs)
            after = _all_counts()
            calls.append((after["k1"] - before["k1"], after["k2"] - before["k2"]))
            self.grad_flags.append(torch.is_grad_enabled())
            return out

        NAF.forward = forward
        return self

    @property
    def grad_calls(self) -> int:
        return sum(self.grad_flags)

    def __exit__(self, *exc):
        from naf_torch.models.naf import NAF

        NAF.forward = self._orig


def _eval_run(label, fn, argv, naf_forwards: bool):
    """One eval CLI run with its launch counts zeroed before and read after:
    every NAF forward on 8 K1 and 1 K2, or (bilinear) no launch at all.
    Returns (its result, seconds, peak MiB, NAF forwards)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with _NafForwards() as rec:
        out = fn(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _all_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    if naf_forwards:
        if not rec.calls or any(c != (8, 1) for c in rec.calls):
            raise AssertionError(f"{label}: NAF forwards launched {set(rec.calls)} (K1, K2), "
                                 "want (8, 1) each")
        if (counts["k1"], counts["k2"]) != (8 * len(rec.calls), len(rec.calls)):
            raise AssertionError(f"{label}: {counts} outside the NAF forwards")
    elif rec.calls or counts["k1"] or counts["k2"]:
        raise AssertionError(f"{label}: launched {counts} with no NAF forward expected")
    return out, secs, peak, len(rec.calls)


def phase_evals(dev, card):
    """Phase 19, the evaluation path on the committed real shard through the
    port's CLIs at ``evaluation/eval_real_shard.py``'s arguments (f32, as
    the JAX CLIs run): seg probing for ``naf`` and ``bilinear`` and DAVIS J&F
    for ``naf``, each metric printed beside the JAX package's number in
    ``benchmarks/real_eval.json`` (different random weights: not a parity
    check); then the full-width probe (DINOv3 ViT-B/16 at 448^2, NAF bf16 ->
    448^2, 8 epochs) with its IoU, time per epoch and peak. Every NAF
    forward launches 8 K1 and 1 K2; the bilinear probe launches none."""
    from naf_torch.evals import real_shard, seg_probing, video_seg

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks",
                           "real_eval.json")) as f:
        jax_numbers = json.load(f)
    note = "different random weights, not a parity check"
    res, launches = {}, {"k1": 0, "k2": 0}
    runs = [("seg_probing_naf", seg_probing.main, real_shard.seg_args("naf"), True),
            ("seg_probing_bilinear", seg_probing.main, real_shard.seg_args("bilinear"), False),
            ("davis_jf_naf", video_seg.main, real_shard.video_args(), True),
            ("seg_probing_dinov3_b16_448_bf16", seg_probing.main,
             [*real_shard.seg_args("naf"), *FULL_PROBE], True)]
    for label, fn, argv, naf_forwards in runs:
        out, secs, peak, n = _eval_run(label, fn, argv, naf_forwards)
        launches["k1"] += 8 * n
        launches["k2"] += n
        rec = dict(out, seconds=secs, peak_mib=peak, naf_forwards=n)
        metric = "J&F-Mean" if label.startswith("davis") else "iou"
        jax_val = jax_numbers.get(label, {}).get(metric)
        beside = (f"JAX package {jax_val:.4f} ({note})" if jax_val is not None
                  else "no JAX number")
        epochs = (f", {sum(out['epoch_s']) / len(out['epoch_s']):.3f} s an epoch"
                  if "epoch_s" in out else "")
        kernels = (f"{n} NAF forwards at 8 K1 + 1 K2 each" if naf_forwards
                   else "no K1 or K2 launch")
        print(f"eval {label}: {metric} {out[metric]:.4f} ({beside}); {secs:.1f} s{epochs}, "
              f"peak {peak:.1f} MiB, {kernels} ({card})", flush=True)
        res[label] = rec
    return launches, res


# phase 20: the reference sweep (naf_tpu/bench/harness.py:31-36) through the
# port's harness, cut to fit: NAF in bf16 over each factor's new values, and
# each model at the defaults in f32, every row with its backward
BENCH_NAF_SWEEPS = (("ratio", (2, 4, 8, 16, 32)), ("embed_dim", (128, 768, 1024)),
                    ("img_size", (112, 224, 896)))
BENCH_ITERS, BENCH_REPEATS = 2, 2
# the skips the JAX package's own code raises at sweep shapes: FeatUp's ratio
# assert (r32), NAF's window wider than its axis (an output below k rows)
BENCH_SKIPS = ("ratio must be one of 2/4/8/16", "must be >= kernel*dilation")
BENCH_KERNELS = ("k1", "k2", "k3", "k4", "k5")


def _bench_row(dev, workdir, factor, value, name, dtype):
    """One sweep row through ``run_sweep`` with the launch counts zeroed
    before and read after: the row, its launches, and NAF's forwards (K1,
    K2 each) and forwards with gradients."""
    from naf_torch.bench.harness import run_sweep

    torch.cuda.synchronize()
    _zero_counts()
    with _NafForwards() as rec:
        (row,) = run_sweep(factor, models=[name], values=[value], dtype=dtype,
                           out_path=os.path.join(workdir, "results.json"), iters=BENCH_ITERS,
                           repeats=BENCH_REPEATS, device=dev)
    torch.cuda.synchronize()
    return row, _all_counts(), rec


def _check_bench_row(label, row, counts, rec, bf16):
    """A row has fwd_ms and bwd_ms, or a skip of the JAX package's own; a
    NAF row launched 8 K1 and 1 K2 per forward (bf16 on "wgmma"), and one
    K3 and K4 in as many bands of query rows as its partials need per
    backward (K2's gradient): the same number of bands each step."""
    if "skip" in row:
        if not any(cause in row["skip"] for cause in BENCH_SKIPS):
            raise AssertionError(f"bench {label}: skip outside the JAX package's own: {row}")
        return
    missing = [k for k in ("fwd_ms", "bwd_ms") if k not in row]
    if missing or "error" in row or "bwd_error" in row:
        raise AssertionError(f"bench {label}: no {missing} or an error: {row}")
    if row["model"] != "NAF":
        return
    if not rec.calls or any(c != (8, 1) for c in rec.calls):
        raise AssertionError(f"bench {label}: NAF forwards launched {set(rec.calls)} (K1, K2), "
                             "want (8, 1) each")
    if bf16 and counts["k2_wgmma"] != counts["k2"]:
        raise AssertionError(f"bench {label}: bf16 K2 off the wgmma route: {counts}")
    steps = rec.grad_calls
    if not steps or counts["k3"] != steps or counts["k4"] < steps or counts["k4"] % steps:
        raise AssertionError(f"bench {label}: {steps} backward steps launched "
                             f"{counts['k3']} K3 and {counts['k4']} K4, want one K3 and the "
                             "same K4 bands each step")


def _naf_plain_grads(model, head, image, feats, out):
    """The bench's loss (``harness._bench_loss``) through the card's f32
    plain path (``_naf_plain``'s steps), backward: returns the output, and
    the gradients land in the ``.grad`` of ``feats``, ``head`` and the
    parameters. The attention's plain version runs one LR cell row of the
    output at a time, each row's share of the loss backward on its own (all
    its gathered windows would not fit the card at once), into the encoder
    output and keys; those then take one backward through the encoder."""
    from naf_torch.kernels.na2d_fused_q import naf_upsample_attention_ref
    from naf_torch.ops.resize import resize_bilinear

    ie = model.image_encoder
    image = resize_bilinear(image, ie.guard_size(*image.shape[1:3], *out))
    enc = torch.cat([ie.encoder(image), ie.sem_encoder(image)], dim=-1)
    keys = ie.rope.pooled(enc, out, tuple(feats.shape[1:3]))
    sin_r, cos_r, sin_c, cos_c = ie.rope.tables(*out)
    rows, cols = torch.cat([cos_r, sin_r], dim=-1), torch.cat([cos_c, sin_c], dim=-1)
    enc_d, keys_d = enc.detach().requires_grad_(), keys.detach().requires_grad_()
    n, bands = out[0] * out[1] * head.shape[1], []
    for c0 in range(feats.shape[1]):
        band = naf_upsample_attention_ref(
            enc_d, keys_d, feats, rows, cols, ie.rope.d_head, num_heads=model.heads_attn,
            kernel_size=model.kernel_size, row_cell0=c0, band_cells=1)
        (((band @ head) ** 2).sum() / n).backward()
        bands.append(band.detach())
    torch.autograd.backward([enc, keys], [enc_d.grad, keys_d.grad])
    return torch.cat(bands, dim=1)


# the gradients phase 20 holds at cosine > 0.999: the features', the head's,
# and each encoder stack's parameters' (together, all of NAF's)
BENCH_GRADS = ("feats", "head", "image_encoder.encoder", "image_encoder.sem_encoder")


def _bench_agree(dev, cfg):
    """At a sweep shape, on the harness's own weights and inputs
    (``harness._bench_inputs``): the card's bf16 fused forward, and the
    gradients of the bench's loss through it (K1's backward, K2's gradient
    on K3/K4), against the card's f32 plain path, by cosine > 0.999 for the
    output and each of ``BENCH_GRADS``. Returns the cosines."""
    from naf_torch.bench.harness import _bench_inputs, _bench_loss

    shape = (cfg["img_size"], cfg["embed_dim"], cfg["lr_size"], cfg["out_size"])
    out, outs, grads = (cfg["out_size"],) * 2, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        model, image, feats, head = _bench_inputs("NAF", *shape, dtype, dev)
        feats.requires_grad_()
        if dtype == torch.bfloat16:
            with torch.no_grad():
                outs[dtype] = model(image, feats, out).float()
            _bench_loss(model, head, image, feats, out).backward()
        else:
            outs[dtype] = _naf_plain_grads(model, head, image, feats, out)
        grads[dtype] = {"feats": feats.grad.float(), "head": head.grad.float()}
        for prefix in BENCH_GRADS[2:]:
            ps = [p for name, p in model.named_parameters() if name.startswith(prefix + ".")]
            if not ps or any(p.grad is None for p in ps):
                raise AssertionError(f"bench NAF {cfg}: {prefix} without gradients ({dtype})")
            grads[dtype][prefix] = torch.cat([p.grad.float().flatten() for p in ps])
        del model, image, feats, head
    label = f"bench NAF {cfg} bf16 vs the card's f32 plain path"
    res = {"out": _check_cos(label, outs[torch.bfloat16], outs[torch.float32], 0.999)}
    for k in BENCH_GRADS:
        res[k] = _check_cos(f"{label}, d loss / d {k}", grads[torch.bfloat16][k],
                            grads[torch.float32][k], 0.999)
    return res


def phase_bench(dev, card):
    """Phase 20, the reference sweep on the card through the port's harness
    (``naf_torch.bench.harness.run_sweep``, 2 samples of 2 calls a row): NAF
    in bf16 over ratio 2-32, embed_dim 128, 768, 1024 and img_size 112, 224,
    896, with backward; each of the six sweep models at the defaults in
    f32, with backward. Every row has fwd_ms and bwd_ms or one of the JAX
    package's own skips, never an error; every NAF forward launches 8 K1
    and 1 K2, every NAF backward one K3 and K4 in the same bands each step;
    at every NAF shape the bf16 fused forward, and the gradients of the
    bench's loss through it, agree with the card's f32 plain path (cosine >
    0.999; ``_bench_agree``). Returns the launches per kernel and the
    rows."""
    from naf_torch.bench.harness import DEFAULTS, MODELS, _config_from_factor

    t0 = time.perf_counter()
    launches, rows, cos = dict.fromkeys(BENCH_KERNELS, 0), [], {}
    runs = [(factor, value, "NAF", torch.bfloat16) for factor, values in BENCH_NAF_SWEEPS
            for value in values]
    runs += [("ratio", DEFAULTS["ratio"], name, torch.float32) for name in MODELS]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        for factor, value, name, dtype in runs:
            label = f"{name} {factor}={value} {str(dtype)[6:]}"
            row, counts, rec = _bench_row(dev, work, factor, value, name, dtype)
            _check_bench_row(label, row, counts, rec, dtype == torch.bfloat16)
            for k in BENCH_KERNELS:
                launches[k] += counts[k]
            cfg = _config_from_factor(factor, value)
            shape = (cfg["img_size"], cfg["embed_dim"], cfg["lr_size"], cfg["out_size"])
            if name == "NAF" and "skip" not in row and shape not in cos:
                cos[shape] = row["cos_f32_plain"] = _bench_agree(dev, cfg)
                torch.cuda.empty_cache()
            rows.append(row)
            times = ("skip: " + row["skip"] if "skip" in row else
                     f"fwd {row['fwd_ms']:.3f} [{row['fwd_ms_min']:.3f}-{row['fwd_ms_max']:.3f}] "
                     f"ms, bwd {row['bwd_ms']:.3f} [{row['bwd_ms_min']:.3f}-"
                     f"{row['bwd_ms_max']:.3f}] ms, {row['fwd_mem_mb']} / {row['bwd_mem_mb']} "
                     f"MiB, {row['gflops']} GFLOP, {row['params']} params")
            bands = (f" ({counts['k4'] // rec.grad_calls} K4 band(s) a backward step)"
                     if rec.grad_calls else "")
            print(f"bench {label} ({cfg['img_size']}^2 + {cfg['lr_size']}^2 x "
                  f"{cfg['embed_dim']} -> {cfg['out_size']}^2): {times}; launches "
                  + ", ".join(f"{k.upper()} {counts[k]}" for k in BENCH_KERNELS) + bands
                  + ("; cos vs f32 plain " + ", ".join(
                      f"{k.removeprefix('image_encoder.')} {v:.6f}"
                      for k, v in row["cos_f32_plain"].items())
                     if "cos_f32_plain" in row else "") + f" ({card})", flush=True)
    print(f"phase 20 (the reference sweep): {len(rows)} rows, {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, rows


# phase 21: the quality loop (naf_torch.evals.distill), cut to fit: 300 of
# its 3000 steps (three chunks of 100), the probes at 4 of their 8 epochs,
# no DAVIS
QUALITY_STEPS, QUALITY_EPOCHS = 300, 4
# the lr sizes at which phase 21 holds the distillation step against its
# plain version: the ends of the drawn range (256 x U(0.25, 0.60) to a
# multiple of 16: 64..160 px, 4..10 cells) and the grid as wide as k 9
DISTILL_LR = (64, 144, 160)


class _FixedFeatures:
    """A backbone's stand-in: returns the f32 features it holds for the
    input's height, in the input's dtype and on its device."""

    def __init__(self, feats: dict):
        self.feats = feats

    def __call__(self, x):
        return self.feats[x.shape[1]].to(x.device, x.dtype)


def _distill_steps_agree(dev):
    """The distillation step at the path's own shapes, against its plain
    version: ``make_train_step`` as ``naf_torch.evals.distill`` has
    ``train_upsampler`` build it (``NAF()`` at seed 0's weights, the first 4
    real-shard photographs at 256^2, the 64^2 crop, 16^2 out, step 0's RoPE
    draw), bf16 on the card (8 K1; K3 at 16^2 queries over an lr grid of 4,
    9 and 10 cells with k 9; K4) against f32 on the CPU (the plain
    versions). Both take the same features, the seeded ViT-S/16's in f32 on
    the CPU, as their backbone's output, so the step's own numerics are what
    is compared: loss rel <= 1e-2, gradient cosine > 0.9995 over all of
    NAF's parameters and over each encoder stack's. Returns the numbers."""
    import numpy as np

    from naf_torch.api import _init_weights
    from naf_torch.backbones import load_multiple_backbones
    from naf_torch.config import load_config
    from naf_torch.data import image_folder
    from naf_torch.evals.real_shard import seg_args
    from naf_torch.models.naf import NAF
    from naf_torch.ops.resize import resize_bilinear
    from naf_torch.train.trainer import make_train_step

    cfg = load_config("eval_probing", seg_args("naf"))
    vit = load_multiple_backbones(cfg["backbone"], dtype=torch.float32, device="cpu")[0]
    photos = image_folder(os.path.join(cfg["dataset"]["root"], "images", "training"), 256)
    img = np.stack([photos[i]["image"] for i in range(4)]).astype(np.float32)
    ups, back = _step_inputs(vit, img, "cpu")
    src = NAF()
    _init_weights(src, 0)
    groups = ("", "image_encoder.encoder.", "image_encoder.sem_encoder.")
    res = {}
    for lr in DISTILL_LR:
        with torch.no_grad():
            feats = {256: vit(back), lr: vit(resize_bilinear(back, (lr, lr)))}
        got = {}
        for where, bf16 in (("cpu", False), (dev, True)):
            model = NAF()
            model.load_state_dict(src.state_dict())
            model.to(where)
            opt = torch.optim.AdamW(model.parameters(), lr=0.0)  # the gradients are compared
            step = make_train_step(model, _FixedFeatures(feats), opt, use_bf16=bf16)
            before = _counts()
            loss = float(step(ups.to(where), back.to(where), 0, (lr, lr), (16, 16), (64, 64)))
            delta = tuple(b - a for a, b in zip(before, _counts()))
            grads = {g: torch.cat([p.grad.float().flatten().cpu()
                                   for n, p in model.named_parameters() if n.startswith(g)])
                     for g in groups}
            got[bf16] = (loss, grads, delta)
        (l32, g32, d32), (l16, g16, d16) = got[False], got[True]
        if d32 != (0, 0, 0) or d16[:2] != (8, 1) or d16[2] < 1:
            raise AssertionError(f"distillation step lr {lr}: launches (K1, K3, K4) CPU {d32}, "
                                 f"card {d16}")
        rel = abs(l16 - l32) / abs(l32)
        if not rel <= 1e-2:
            raise AssertionError(f"distillation step lr {lr}: card bf16 loss {l16} vs CPU f32 "
                                 f"{l32} (rel {rel:.2e})")
        cos = {g.rstrip(".") or "all": _check_cos(
            f"distillation step lr {lr} ({lr // 16} cells), gradients {g or 'all'}",
            g16[g], g32[g], 0.9995) for g in groups}
        print(f"quality: the distillation step at lr {lr} ({lr // 16}^2 cells, k 9), card bf16 "
              f"(K1, K3, K4 {d16}) vs CPU f32: loss {l16:.6f} vs {l32:.6f} (rel {rel:.2e}); "
              "gradient cosine " + ", ".join(f"{k} {v:.6f}" for k, v in cos.items()), flush=True)
        res[str(lr)] = {"loss_rel": rel, "grad_cos": cos, "launches_k1_k3_k4": list(d16)}
    return res


def _jax_weights_on_the_card(dev, card):
    """The JAX package's trained NAF in bf16 on the card against its f32 CPU
    copy at 448^2 + 28^2 x 384 -> 448^2 (a real-shard photograph, seeded
    features): 8 K1 + 1 K2, cosine > 0.999."""
    import numpy as np
    from PIL import Image

    from naf_torch.backbones.wrapper import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    from naf_torch.convert import naf_state_from_npz
    from naf_torch.data.transforms import image_transform
    from naf_torch.models.naf import NAF

    shard = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "real_shard",
                         "ade20k", "images", "training")
    photo = image_transform(Image.open(os.path.join(shard, sorted(os.listdir(shard))[0]))
                            .convert("RGB"), 448)
    image = torch.from_numpy(((photo - np.array(IMAGENET_DEFAULT_MEAN))
                              / np.array(IMAGENET_DEFAULT_STD))[None].astype(np.float32))
    feats = torch.from_numpy(np.random.RandomState(0).randn(1, 28, 28, 384).astype(np.float32))
    state = naf_state_from_npz()
    model, plain = NAF().to(dev, torch.bfloat16).eval(), NAF().eval()
    model.load_state_dict(state)
    plain.load_state_dict(state)
    torch.cuda.synchronize()
    _zero_counts()
    with torch.no_grad():
        got = model(image.to(dev, torch.bfloat16), feats.to(dev, torch.bfloat16), (448, 448))
        torch.cuda.synchronize()
        counts = _all_counts()
        want = plain(image, feats, (448, 448))
    if (counts["k1"], counts["k2"]) != (8, 1) or not torch.isfinite(got).all():
        raise AssertionError(f"JAX-trained NAF on the card: launches {counts}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    c = _check_cos("JAX-trained NAF bf16 vs its f32 CPU copy, 448^2 + 28^2 x 384 -> 448^2",
                   got.float().cpu(), want, 0.999)
    print(f"quality: the JAX package's trained NAF (naf_torch/assets/"
          f"naf_distill_jax_ckpt3000.npz) bf16 on the card, 8 K1 + 1 K2, cos vs its f32 CPU "
          f"copy {c:.6f} ({card})", flush=True)
    return c


def phase_quality(dev, card, workdir):
    """Phase 21, the quality loop through ``naf_torch.evals.distill.main``
    (cut: QUALITY_STEPS steps, QUALITY_EPOCHS probe epochs, no DAVIS): NAF()
    self-distilled on the real shard's 60 photographs kept on the card
    (256^2, batch 4, ViT-S/16, bf16, 100 steps a chunk), then the probe on
    the trained weights and on the JAX package's. The launch counts are
    zeroed before the call and read after it: every training step's forward
    on 8 K1 and its backward on one K3 and the same K4 bands, every other
    NAF forward (the run's panels, the probes) on 8 K1 + 1 K2, and the CLI's
    own per-part counts sum to the totals. Finite chunk losses, the last
    chunk's median loss below the first's; then the JAX-trained weights in
    bf16 against their f32 CPU copy (``_jax_weights_on_the_card``), and the
    step at the path's own shapes against its f32 plain version on the CPU
    (``_distill_steps_agree``)."""
    from naf_torch.evals import distill

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _zero_counts()
    with _NafForwards() as rec:
        res = distill.main([str(QUALITY_STEPS), "--no-davis", f"num_epochs={QUALITY_EPOCHS}",
                            f"out={os.path.join(workdir, 'real_eval_distilled.json')}"])
    torch.cuda.synchronize()
    counts = _all_counts()
    train, steps = res["train"], QUALITY_STEPS
    chunks = train["chunks"]
    for c in chunks:
        print(f"quality: chunk to step {c['step'] + 1}, lr {c['lr_size']}: loss median "
              f"{c['loss_median']:.5f}, last {c['loss']:.5f}, {1e3 * c['chunk_s']:.1f} ms",
              flush=True)
    if not all(math.isfinite(c[k]) for c in chunks for k in ("loss", "loss_median")):
        raise AssertionError(f"quality: a chunk's loss is not finite: {chunks}")
    if not chunks[-1]["loss_median"] < chunks[0]["loss_median"]:
        raise AssertionError(f"quality: the last chunk's median loss {chunks[-1]['loss_median']} "
                             f"is not below the first's {chunks[0]['loss_median']}")
    steps_seen = [c for c, grad in zip(rec.calls, rec.grad_flags) if grad]
    others = [c for c, grad in zip(rec.calls, rec.grad_flags) if not grad]
    bands = counts["k4"] // steps
    if (len(steps_seen) != steps or set(steps_seen) != {(8, 0)} or set(others) != {(8, 1)}
            or counts["k3"] != steps or counts["k4"] != bands * steps or not bands
            or (counts["k1"], counts["k2"]) != (8 * len(rec.calls), len(others))):
        raise AssertionError(f"quality: launches {counts}; step forwards {set(steps_seen)} x "
                             f"{len(steps_seen)}, other forwards {set(others)} x {len(others)}")
    parts = [train["launches"]] + [res[k]["launches"] for k in res if k.startswith("seg_")]
    if any(sum(p[k] for p in parts) != counts[k] for k in ("k1", "k2", "k3", "k4")):
        raise AssertionError(f"quality: the CLI's counts {parts} do not sum to {counts}")
    probes = {k: res[k] for k in res if k.startswith("seg_")}
    for k, p in probes.items():
        print(f"quality: {k} iou {p['iou']:.4f}, accuracy {p['accuracy']:.4f}, "
              f"{sum(p['epoch_s']) / len(p['epoch_s']):.3f} s an epoch, "
              f"{p['launches']['k2']} NAF forwards at 8 K1 + 1 K2 ({card})", flush=True)
    panels = len(others) - sum(p["launches"]["k2"] for p in probes.values())
    print(f"quality: {steps} steps in {train['train_s']:.1f} s, {train['step_ms']:.3f} ms a step "
          f"after the first chunk; a step launches 8 K1, 1 K3, {bands} K4; every other NAF "
          f"forward 8 K1 + 1 K2 ({len(others)}: {panels} panels, the rest the probes) "
          f"({card})", flush=True)
    cos = _jax_weights_on_the_card(dev, card)
    steps_agree = _distill_steps_agree(dev)
    secs = time.perf_counter() - t0
    print(f"phase 21 (the quality loop): {secs:.1f} s", flush=True)
    launches = {k: counts[k] for k in ("k1", "k2", "k3", "k4")}
    return launches, {"train": {k: train[k] for k in ("train_steps", "train_s", "step_ms",
                                                       "chunks", "launches")},
                      **{k: {m: p[m] for m in ("iou", "accuracy", "epoch_s", "launches")}
                         for k, p in probes.items()},
                      "k4_bands_per_step": bands, "jax_weights_cos_f32_cpu": cos,
                      "distill_step_vs_cpu_f32": steps_agree,
                      "seconds": secs}


# phase 22: the headline bench (naf_torch.bench.headline, the counterpart of
# bench.py) at its full size, 2 samples of 3 calls a field and a stage
HEADLINE_TIMER = dict(iters=3, repeats=2, warmup=1)


def phase_headline(dev, card):
    """Phase 22, the headline bench through ``naf_torch.bench.headline.run``
    (bench.py's fields at its sizes: bf16, NAF at seed 0's weights, the
    inputs of one RandomState(0) in bench.py's order) and ``stages`` (448^2
    + 128^2 x 384 -> 2048^2), each at 2 samples of 3 calls: every field's
    median, min and max finite and positive, each field's call on the
    kernels of ``headline.expected_launches`` (``fps_4096``: one K2 a band)
    on the tensor-core route, the stages' forward on 8 K1 + 1 K2, and its
    profiled stretch by span: the encoder's and the attention's device time
    positive, the attention's below the whole forward, the spans' own
    device times over 95% of the device's busy time, the idle parts summing
    to the stretch's idle. Prints the record, bench.py's line and the spans.
    Returns the launches of the run (counts zeroed before it, read after it)
    and the results."""
    from naf_torch.bench import headline

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _zero_counts()
    rec = headline.run(device=dev, **HEADLINE_TIMER)
    torch.cuda.synchronize()
    counts = _all_counts()
    want = headline.expected_launches()
    for name, res in rec["fields"].items():
        headline.check_launches(name, res["launches"], want[name])
        if not all(math.isfinite(res[k]) and res[k] > 0 for k in ("ms", "ms_min", "ms_max",
                                                                  "value")):
            raise AssertionError(f"headline {name}: not finite and positive: {res}")
    line = headline.bench_line(rec)
    st = headline.stages(device=dev, **HEADLINE_TIMER)
    headline.check_launches("stages", st["launches"], headline.STAGE_LAUNCHES)
    sp = st["spans"]
    idle = sum(v["idle_ms"] for v in sp.values())
    if not (0 < sp["naf.encoder"]["device_ms"]
            and 0 < sp["naf.attention"]["device_ms"] < st["model_ms"]
            and sum(sp[n]["device_ms"] for n in headline.STAGE_SPANS) >= 0.95 * st["busy_ms"]
            and abs(idle - (st["window_ms"] - st["busy_ms"])) <= 1e-6 * st["window_ms"]):
        raise AssertionError(f"headline stages: {sp}, window {st['window_ms']} ms, busy "
                             f"{st['busy_ms']} ms a call")
    for name, res in rec["fields"].items():
        print(f"headline {name}: {res['value']:.3f} ({res['ms']:.3f} ms [{res['ms_min']:.3f}-"
              f"{res['ms_max']:.3f}]), peak {res['peak_mib']} MiB, a call launches "
              + ", ".join(f"{k} {v}" for k, v in res["launches"].items()) + f" ({card})",
              flush=True)
    print(f"headline stages, 448^2 + 128^2 x 384 -> {st['out']}^2: canary "
          f"{st['canary_ms']:.3f} ms; model {st['model_ms']:.3f} ms; " + "; ".join(
              k + "".join(f" {m} {v[m]:.3f}" for m in ("device_ms", "host_self_ms", "idle_ms")
                          if m in v) for k, v in sp.items()) + f" a call ({card})", flush=True)
    print(json.dumps(rec), flush=True)
    print(json.dumps(line), flush=True)
    secs = time.perf_counter() - t0
    print(f"phase 22 (the headline): {secs:.1f} s", flush=True)
    launches = {k: counts[k] for k in ("k1", "k2", "k3", "k4", "k5", "k6")}
    return launches, {"record": rec, "line": line, "stages": st, "seconds": secs}


def _sass(name: str) -> str:
    """The SASS of a kernel library, from the cuobjdump of the toolkit whose
    nvcc built it."""
    from pathlib import Path

    from naf_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(_build._target(name))],
                          capture_output=True, text=True, check=True).stdout


def _hgmma_counts() -> dict:
    """HGMMA (wgmma) instructions in the SASS of the libraries whose bf16
    kernels run on the tensor cores (K1, K6, K2, K3/K4); none fails."""
    counts = {}
    for name in ("encoder_fused", "encoder_dual", "na2d_fused_q", "na2d_fused"):
        counts[name] = len(re.findall(r"\bHGMMA\b", _sass(name)))
    print("HGMMA instructions (cuobjdump -sass): "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if not all(counts.values()):
        raise AssertionError(f"a bf16 tensor-core library has no wgmma: {counts}")
    return counts


def _ldgsts_counts() -> dict:
    """LDGSTS (cp.async) instructions in the SASS of K5's two routes; none
    in either fails (the wide route's stages and the narrow route's weights
    arrive by cp.async)."""
    counts = dict.fromkeys(("wide", "narrow"), 0)
    for fn in re.split(r"\n\s*Function : ", _sass("adaptive_conv"))[1:]:
        for route in counts:
            if f"adaptive_conv_{route}_kernel" in fn.split("\n", 1)[0]:
                counts[route] += len(re.findall(r"\bLDGSTS\b", fn))
    print("LDGSTS instructions (cuobjdump -sass): adaptive_conv "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if not all(counts.values()):
        raise AssertionError(f"a K5 route has no cp.async in its SASS: {counts}")
    return counts


def _setup():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from naf_torch.utils.benchmarking import card_line

    return torch.device("cuda", 0), card_line()


def _timing_k2(dev, card) -> dict:
    return _time_k2(dev, card, *_peaks(card), torch.Generator(device=dev).manual_seed(4))


def _timing_rest(dev, card) -> dict:
    return {**phase_timing(dev, card), "k2_grad": _time_k2_grad(dev, card)}


# the parts of phase 8, each run in a process of its own
TIMING_PARTS = {"k2": _timing_k2, "rest": _timing_rest, "denoise": _time_denoise_kernels}


def _timing_child(part: str, path: str) -> int:
    """One part of phase 8, its results as JSON into ``path``."""
    dev, card = _setup()
    with open(path, "w") as f:
        json.dump(TIMING_PARTS[part](dev, card), f)
    return 0


def _phase_timing_fresh() -> dict:
    """Phase 8, each part in a fresh process (``chip_smoke.py --timing PART
    FILE``): torch.profiler drops kernel records late in a long process, and
    every kernel and library call is timed by the profiler's device time."""
    torch.cuda.empty_cache()
    res = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        for part in TIMING_PARTS:
            path = os.path.join(work, f"timing_{part}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--timing", part, path],
                           check=True)
            with open(path) as f:
                res.update(json.load(f))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--timing"]:
        return _timing_child(sys.argv[2], sys.argv[3])
    dev, card = _setup()
    from naf_torch.kernels import _build

    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"nvcc build {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)
    for name in _build.SOURCES:  # built by this run or, within it, before it
        if not (_build.BUILD_DIR / f"{name}.ptxas.log").exists():
            continue
        log = (_build.BUILD_DIR / f"{name}.ptxas.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"spill stores up to {max(spills, default=0)} bytes", flush=True)
        if name in ("na2d_fused_q", "na2d_fused", "adaptive_conv") and any(spills):
            raise AssertionError(f"ptxas spills in {name}'s kernels: {spills}")
    hgmma = _hgmma_counts()
    ldgsts = _ldgsts_counts()

    k1_err = phase_k1(dev)
    k2_err, k2_cos = phase_k2(dev)
    keys = phase_keys(dev, card)
    stem = phase_stem(dev, card)
    launches, stats, c96, guide_peak = phase_main(dev, card)
    phase_grads(dev)
    k34_err = phase_k34(dev)
    k6_err, k6_launches = phase_k6(dev)
    k2_band, k3_band = phase_banded_kernels(dev)
    band_launches, banded = phase_banded(dev, card)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        train_launches, train = phase_train(dev, card, work)
    k5_err = phase_k5(dev)
    base_launches, baselines, k5_splits = phase_baselines(dev, card)
    den_kernels = phase_denoise_kernels(dev)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        den_launches, denoiser = phase_denoiser(dev, card, work)
        restorers = phase_restorers(dev, card, work)
    par_launches, parallel = phase_parallel(dev, card)
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    backbones = phase_backbones(dev, card)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        large_launches, large_img = phase_large_img(dev, card, work)
    eval_launches, evals = phase_evals(dev, card)
    print(f"phases 18-19 (backbones, LargeImg, evals): {time.perf_counter() - t18:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    bench_launches, bench = phase_bench(dev, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        quality_launches, quality = phase_quality(dev, card, work)
    torch.cuda.empty_cache()
    head_launches, head = phase_headline(dev, card)
    timing = _phase_timing_fresh()

    k1, k1b = timing["k1_k3"], timing["k1_k1"]
    kernels = [
        dict(name="gn_silu_conv_fused", route="cuda",
             source="naf_torch/kernels/csrc/encoder_fused.cu",
             replaces="naf_tpu/kernels/encoder_fused.py:390", launches=launches["k1"],
             max_abs_err=k1_err, **k1,
             ms_1x1=k1b["ms"], plain_ms_1x1=k1b["plain_ms"],
             library_ms_1x1=k1b["library_ms"], bound_ms_1x1=k1b["bound_ms"],
             wrapper_ms_1x1=k1b["wrapper_ms"], ms_f32_1x1=k1b["ms_f32"],
             bound_ms_f32_1x1=k1b["bound_ms_f32"],
             hgmma=hgmma["encoder_fused"]),
        # K2: launches from the main path (bf16: the tensor-core kernel on
        # csrc/na_tc.cuh), times at 448^2 and 448^2 -> 2048^2
        dict(name="naf_upsample_attention", route="cuda",
             source="naf_torch/kernels/csrc/na2d_fused_q.cu",
             replaces="naf_tpu/kernels/na2d_fused_q.py:767", launches=launches["k2"],
             max_abs_err=k2_err, **timing["k2_448"],
             **{f"{k}_2048": v for k, v in timing["k2_2048"].items() if k != "bound_by"},
             kernel_route={"bfloat16": "wgmma (csrc/na_tc.cuh)", "float32": "fma"},
             launches_by_route={"wgmma": launches["k2_wgmma"]}, bf16_cos=k2_cos,
             hgmma=hgmma["na2d_fused_q"]),
        # K3/K4: launches from the training path (bf16: the tensor-core
        # kernels of csrc/na_tc.cuh), times at its shape; f32 (AnyUp, the
        # f32 step) runs the CUDA-core kernels of na2d_fused.cu
        dict(name="cross_scale_na2d_fused", route="cuda",
             source="naf_torch/kernels/csrc/na2d_fused.cu",
             replaces="naf_tpu/kernels/na2d_fused.py:834", launches=train_launches["k3"],
             max_abs_err=k34_err["k3"], **timing["k3_train"],
             **{f"{k}_448": v for k, v in timing["k3_448"].items() if k != "bound_by"},
             kernel_route={"bfloat16": "wgmma (csrc/na_tc.cuh)", "float32": "fma"},
             launches_by_route={k: v for k, v in train_launches["routes"].items()
                                if "bwd" not in k},
             hgmma=hgmma["na2d_fused"]),
        dict(name="cross_scale_na2d_fused_bwd", route="cuda",
             source="naf_torch/kernels/csrc/na2d_fused.cu",
             replaces="naf_tpu/kernels/na2d_fused.py:760", launches=train_launches["k4"],
             max_abs_err=k34_err["k4"], **timing["k4_train"],
             **{f"{k}_448": v for k, v in timing["k4_448"].items() if k != "bound_by"},
             kernel_route={"bfloat16": "wgmma (csrc/na_tc.cuh)", "float32": "fma"},
             launches_by_route={k[:-4]: v for k, v in train_launches["routes"].items()
                                if "bwd" in k},
             hgmma=hgmma["na2d_fused"]),
        # K5: launches from the baselines path (FeatUp 4 wide, JBU 1
        # narrow), times at FeatUp's last stage, its three earlier stages
        # and JBU's shape
        dict(name="adaptive_conv_fused", route="cuda",
             source="naf_torch/kernels/csrc/adaptive_conv.cu",
             replaces="naf_tpu/kernels/adaptive_conv_fused.py:76", launches=base_launches["k5"],
             max_abs_err=k5_err, **timing["k5_featup"],
             **{f"{k}_{label.removeprefix('k5_').removeprefix('featup_')}": v
                for label in timing if label.startswith("k5_") and label != "k5_featup"
                for k, v in timing[label].items() if k not in ("library_ms", "bound_by")},
             launches_by_route={"wide": base_launches["k5_wide"],
                                "narrow": base_launches["k5_narrow"]},
             ldgsts=ldgsts),
    ]
    kernels.append(
        # K6: no route of the program takes it, so the main path launches it
        # 0 times; phase 9's checks launch it; times at the production layer
        dict(name="gn_silu_conv_dual_fused", route="cuda",
             source="naf_torch/kernels/csrc/encoder_dual.cu",
             replaces="naf_tpu/kernels/encoder_fused.py:272", launches=launches["k6"],
             check_launches=k6_launches,
             max_abs_err=k6_err, **timing["k6"], hgmma=hgmma["encoder_dual"]))
    kernels.append(
        # the keys kernel: launches from the main path (1 per forward), error
        # and times at 448^2 (phase 23), the other main-path shapes suffixed;
        # it replaces no TPU kernel (the JAX package's keys are plain jnp)
        dict(name="rope_keys", route="cuda", source="naf_torch/kernels/csrc/rope_keys.cu",
             replaces=None, jax_counterpart="naf_tpu/models/naf.py:258 (plain jnp)",
             launches=launches["keys"], **keys["448"],
             **{f"{k}_{label}": v for label in ("448to2048", "2048")
                for k, v in keys[label].items() if k != "library_ms"}))
    kernels.append(
        # the stem kernel: launches from the main path (2 per forward), error
        # and times at 448^2 (phase 24), the other cells' shapes suffixed; it
        # replaces no TPU kernel (the JAX package's stem is plain XLA)
        dict(name="stem_conv_fused", route="cuda", source="naf_torch/kernels/csrc/encoder_fused.cu",
             replaces=None,
             jax_counterpart="naf_tpu/kernels/encoder_fused.py:683-689,715 (plain XLA "
                             "_stem_conv_matmul + _channel_sums)",
             launches=launches["stem"], **stem["448"],
             **{f"{k}_{label}": v for label in ("448_b8", "2048")
                for k, v in stem[label].items() if k != "library_ms"}))
    kernels[0]["launches_banded_encoder"] = banded["streamed_encoder"]["launches_k1"]
    # phase 17: both ranks' sharded forwards (8 K1 and 1 K2 on each rank)
    kernels[0]["launches_parallel"] = par_launches["k1"]
    kernels[1]["launches_parallel"] = par_launches["k2"]
    # phase 17: both ranks' spatially sharded train steps (per rank and step
    # 8 K1, 1 banded K2, 1 K3 and K4 in bands)
    for i, name in enumerate(("k1", "k2", "k3", "k4")):
        kernels[i]["launches_spatial_train"] = par_launches[f"train_{name}"]
    kernels[3].update({k: k34_err[k] for k in ("k4_banded_err", "k4_banded_cos",
                                               "k4_banded_split_bands")})
    # phases 18-19: the LargeImg requests and the evals' NAF forwards
    for i, name in ((0, "k1"), (1, "k2")):
        kernels[i]["launches_large_img"] = large_launches[name]
        kernels[i]["launches_evals"] = eval_launches[name]
    # phase 20: every row of the reference sweep
    for i, name in enumerate(BENCH_KERNELS):
        kernels[i]["launches_bench"] = bench_launches[name]
    # phase 21: the quality loop's training steps, panels and probes
    for i, name in enumerate(("k1", "k2", "k3", "k4")):
        kernels[i]["launches_quality"] = quality_launches[name]
    # phase 22: every call of the headline's fields (warm-up, samples, the
    # counted call)
    for i, name in enumerate(("k1", "k2", "k3", "k4", "k5", "k6")):
        kernels[i]["launches_headline"] = head_launches[name]
    kernels[1].update({"launches_banded": band_launches["k2"],
                       **{f"{k}_banded": v for k, v in k2_band.items()}})
    kernels[2].update({"launches_anyup": base_launches["k3"],
                       **{f"{k}_anyup": v for k, v in timing["k3_anyup"].items()},
                       **{f"{k}_banded": v for k, v in k3_band.items()}})
    # the denoising path (phases 13-16): launches from its 10 bf16 steps
    # (one chunked K4 call a step) and its f32 validation (K2 on fma_chunked), the chunked
    # kernels' errors and cosines at its attention, and their times
    for i, name in ((1, "k2"), (2, "k3"), (3, "k4")):
        kernels[i].update({
            "launches_denoise": den_launches[name],
            "max_abs_err_f32_chunked": den_kernels[f"{name}_err"],
            "cos_bf16_d256": den_kernels[f"{name}_cos"],
            **{f"{k}_denoise_{tag}": v for tag in ("bf16", "f32")
               for k, v in timing[f"{name}_denoise_{tag}"].items()}})
        kernels[i]["kernel_route"]["float32"] = ("fma; fma_chunked (csrc/na_fma.cuh) where no "
                                                 "tile's whole box fits shared memory")
    kernels[1]["launches_denoise_val_fma_chunked"] = den_launches["val_k2_fma_chunked"]
    kernels[3]["denoise_bands_per_step"] = den_launches["k4_bands"]
    kernels[3].update({f"{k}_with_k3_denoise_bf16": v
                       for k, v in timing["k4_k3_denoise_bf16"].items()})
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{**{k: kd[k] for k in order}, **kd} for kd in kernels]
    train_keys = ("step_ms", "peak_mib", "split", "losses", "cpu_loss", "card_loss", "grad_cos")
    print(json.dumps({"kernels": kernels, "forward_ms": {k: v[0] for k, v in stats.items()},
                      "peak_mib": {k: v[1] for k, v in stats.items()},
                      "peak_frames_2048_guide": guide_peak,
                      "forward_profile": {k: v[2] for k, v in stats.items()},
                      "train": {k: train[k] for k in train_keys},
                      "baselines": baselines, "k5_splits": k5_splits,
                      "banded": banded, "naf_dim96_cos_cpu": c96, "k2_grad": timing["k2_grad"],
                      "denoiser": denoiser, "denoise_plans": den_kernels["plans"],
                      "restorers": restorers, "parallel": parallel, "backbones": backbones,
                      "large_img": large_img, "evals": evals, "bench": bench,
                      "quality": quality, "headline": head, "card": card}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
