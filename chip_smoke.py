#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100): the quickest
proof that the port still builds, agrees with its plain versions, serves,
trains, evaluates the likelihood and computes FID, KID and IS, on the two
CIFAR-10 models and on the published layouts beyond them.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the last line is printed:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the serving paths (sm_90a), all
     sources at once, and prints each compiler report;
  3. forward: the full-width flagship (DDPM++, init_scale 0.1, batch 2) and
     UNCSN++ (FIR, residual input pyramid, init_scale 0.1, batch 2 at sigma
     labels 0.01 and 50) on the card and on a CPU copy with the same
     weights: agreement per sample, and each kernel's launches per shape
     equal to the CPU model's sites (82 fused, and for UNCSN++ 12 FIR);
  3b. published layouts: each of PUBLISHED_LAYOUTS at full width, init_scale
     0.1 (the deepest CIFAR-10 model, nf 512 with ``lsgm``; CelebA 64^2;
     CelebA-HQ 256^2; FFHQ 1024^2 at batch 1; the flagship with DDPM blocks
     and the fixed Fourier features; the flagship without auxiliary
     blocks), on the card and on a CPU copy with the same weights:
     agreement per sample within FORWARD_REL_TOL, the counts of fused sites,
     chain sites and FIR sites printed, every site's choice of kernel or
     chain held to JAX's guard (H * W * max(C, O) <= 32 * 32 * 512) with the
     kernel's plan (``ops/gn_conv.py::fits``), and each kernel's launches
     per shape equal to the sites;
  4. serve the flagship (a main path), with the launch counts set to 0 just
     before it and read just after: the port's HTTP server at batch 8
     answers /healthz and, with the flagship config as it is (init_scale
     0), /sample with method 'ode' and 'dpm_solver' (20 steps); with the
     phase-3 weights (init_scale 0.1) it answers 'dpm_solver' (5 steps),
     and that batch is held against a CPU SamplingService run from the same
     prior. Every request twice: uint8 NHWC [8, 32, 32, 3], the same bytes
     per seed, one launch per fused site per evaluation, no FIR launch,
     and (as in phase 5) no autograd.Function on the way;
  5. serve UNCSN++ (the other main path), counted the same way: with the
     config as published (init_scale 0) /healthz, then /sample with no
     method, i.e. the config's 'pc' at N = PC_SERVED_STEPS (a quarter of
     the published PC_PUBLISHED_STEPS), once, with
     its wall; 'pc' at N = 50 and 'dpm_solver' (20 steps) twice each; with
     the phase-3 weights 'pc' at N = 3, whose batch is held against a CPU
     SamplingService given the same prior and the same noise. Both kernels'
     launches per shape equal their sites x the evaluations;
  5c. serve the deepest model, counted the same way: its own 'pc'
     (Euler-Maruyama, no corrector) at N = DEEPEST_SERVE_STEPS, batch 8,
     twice, as published: the request's wall and ms per evaluation; then
     with the phase-3b weights 'pc' at N = 2, batch 2, against a CPU
     SamplingService from the same prior and noise (the SDE's scalars in
     float64 on both sides, as in phase 7b);
  5d. serve CelebA-HQ 256^2, counted the same way: its own 'pc' (reverse
     diffusion and Langevin) at sampling.batch_size 16, N = HQ_SERVE_STEPS,
     twice: uint8 [16, 256, 256, 3], the same bytes per seed, ms per
     evaluation, and the published N = 2,000 (4,001 evaluations)
     extrapolated from it and marked so; a trace of one eval forward at
     batch 16 (as in phase 5b);
  5b. trace: one eval forward and one likelihood ODE function evaluation
     (a torch.func.jvp of the drift) of each model at batch 8 with the
     phase-3 weights, each one's wall without a profiler and a
     torch.profiler trace of TRACE_FORWARDS calls: the device's busy share,
     the hand-written kernels' device time, and the top kernels and host
     ops;
  6. train step, card vs CPU: one step of each full-width model with the
     phase-3 weights at batch 2 (dropout 0, no warmup, TF32 off as
     everywhere here), the draws (t_min,
     t, z) made on the CPU and handed to both sides: per-example losses,
     per-tensor gradients (Adam's first moment) and each parameter's move
     in the update (within 0.05 lr, where the gradient is above its bar). For UNCSN++ the fir2 forward tally equals the CPU model's
     12 sites and the backward tally the 12 adjoint launches, per shape;
  6b. the same for the deepest model with its mixed loss (two forwards per
     step, one per half): 16 fir2 launches forward and 16 adjoint;
  7. train (the third main path), counted the same way: the CLI trainer
     (``soft_truncation_tpu_torch.main --mode train``) for each config as
     published, batch 128, Synthetic data, in build/chip_smoke_train/
     (removed after phase 7b), steps 0..TRAIN_ITERS with a rolling checkpoint every
     2 steps, then a resume to TRAIN_ITERS + 2
     that must start at the saved step: every logged loss finite, ms per
     step (CUDA events around each step, the steps after the first two),
     imgs/s and peak device memory; UNCSN++'s fir2 launches per shape equal
     12 forward and 12 backward per step, the flagship's none;
  7d. train the deepest model, counted the same way: the CLI trainer as
     published (batch 128 in one micro-batch, the mixed loss), steps
     0..DEEPEST_TRAIN_ITERS, no resume: finite losses, ms per step,
     imgs/s, peak memory, 16 fir2 launches forward and 16 adjoint per step,
     every one at N=64 (the network runs once per half of the batch);
  7c. FID (the fifth main path), counted the same way, in phase 7's
     flagship workdir: scipy's and Pillow's versions; random Inception
     weights (``eval.inception_v3.random_params``) and the pool_3 features
     of the Synthetic test split's first FID_SAMPLES images, written to an
     assetdir; then ``soft_truncation_tpu_torch.main --mode eval`` with
     ``eval.enable_sampling`` (dpm_solver, FID_DPM_STEPS steps, shards of
     FID_SHARD, FID_SAMPLES samples, the 'device' resize), entered with
     TF32 on, which the CLI must turn off: finite FID, KID
     and IS in the log and in report_metrics.npz, every shard, grid and
     feature cache written, the fused sites' launches per shape equal to
     the sites x the sampler's evaluations, no autograd.Function; the same
     run again must load everything, launch no kernel and report the same
     numbers bit for bit; the card's resize and Inception features against
     the CPU's (KERNEL_REL_TOL of the largest); sampling and featurising
     images/s, the Inception forward's ms per batch apart from the resize,
     the host's seconds of sqrtm and of KID, a trace of the flagship's eval
     forward at batch FID_SHARD (as in phase 5b), the phase's wall;
  7b. likelihood (the fourth main path), counted the same way: the CLI
     evaluation (``soft_truncation_tpu_torch.main --mode eval``) of each
     config as published, in phase 7's workdir (its rolling checkpoint's
     EMA weights; the workdir is removed after), the Synthetic images (the
     split the JAX package reads for a dataset it does not list, 'train'),
     batch LIKELIHOOD_BATCH, the eval loss, one NELBO and one exact-NLL
     batch at the published ODE tolerances (rtol = atol = 1e-5, 'correct'
     mode): finite eval loss, NELBO and NLL bpd, the nfe, the NLL batch's
     wall and ms per function evaluation from the log; over the NLL batch
     each fused site launches gn_silu_conv3x3 for the primal and its
     tangent mode for the tangent once per function evaluation (plus the
     residual's forward), each UNCSN++ FIR site fir2 the same way; then,
     with the phase-3 weights at batch 2, the ODE function at t in
     LIKELIHOOD_TIMES (drift and Hutchinson term) and the per-example NELBO
     and residual, card vs CPU from the same draws;
  8. kernels: each kernel against its plain PyTorch version (TF32 off) at
     every shape the serve phases launched it at (N=8), gn_silu_conv3x3 also
     at every shape the FID phase's sampler launched it at (N=FID_SHARD,
     its own row in the `kernels` line) and, for fir2, at
     every shape the train phase launched it at (at the batch phase 7
     recorded for every launch, N=128), forward and
     backward (the backward held against torch.autograd.grad of the plain
     forward), and both tangents at every shape phase 7b launched them at
     (N=8; gn_silu_conv3x3's against gn_silu_conv3x3_jvp_plain, which is
     held against torch.func.jvp of the plain chain, its library call
     torch.func.jvp of the library chain), with its time as issued from
     the host (``kernel_ms``, the
     `kernels` line's ``ms``) and on the device alone (``device_ms``,
     replayed from a CUDA graph), the plain version's, one library call's
     (issued, ``library_ms``, and on the device, ``library_device_ms``;
     gn_silu_conv3x3 and its library chain timed interleaved, A B A B, and
     fir2, its autograd Function route and its library call in three
     interleaved rounds), the
     bound (gn_silu_conv3x3: its flops once at the dense TF32 rate, with
     the kernel's 3xTF32 figure and the FP32-pipe figure of its earlier
     FMA form beside it) and the launches per forward, step or function
     evaluation measured in phases 4, 5, 7, 7c and 7b; for the published
     layouts, gn_silu_conv3x3 at every shape phases 5c (N=8), 5d (N=16)
     and 3b (N=2, FFHQ's N=1) launched it at and no other row holds, fir2
     at phase 5d's and FFHQ's shapes (``fir2_hires``) and at phase 7d's,
     forward and backward (N=64, as recorded); gn_silu_conv3x3's
     split-K grid per shape, and its agreement at shapes no model reaches
     (ragged tiles, C and O off the tile widths); one JSON line per shape,
     then the
     `kernels` line and each kernel's time beside its library call's.
  9. the legacy networks and the fp8 knob (after 7b; the legacy paths
     launch no kernel, which each of 9a-9d checks, since JAX runs their
     blocks as plain XLA), each legacy config the flagship's file with the
     values of its public config in yang-song/score_sde_pytorch
     (``LEGACY``), the zero-init convs given N(0, 0.02) weights:
  9a. forwards card vs CPU within FORWARD_REL_TOL with ms per forward:
     DDPM, NCSN and NCSNv2-64 at 32^2, batch 8; NCSNv2-128 at 128^2,
     batch 2, and NCSNv2-256 at 256^2, batch 1 (the layouts only they
     reach), and a trace of NCSNv2-256's forward (as in phase 5b);
  9b. serving, counted the same way: DDPM ('pc', ancestral sampling) at
     N=DDPM_SERVE_STEPS and NCSNv2 ('pc', annealed Langevin) at
     N=NCSNV2_SERVE_STEPS x 5 (a quarter of the published 1000 and 232), at
     batch 8, once each through the HTTP server: the wall and the network
     evaluations (a forward hook); then at N=25 (DDPM: the VP grid's betas
     pass 1 below N=21) and N=3, batch 2, twice, against a CPU
     SamplingService from the same prior and noise;
  9c. one train step of DDPM (DDPM loss) and of NCSNv2 (SMLD loss) at batch
     2 against the CPU, as phase 6 (integer labels among the draws);
  9d. the CLI trainer on DDPM as published (batch 128, discrete DDPM loss,
     steps 0..TRAIN_ITERS and a resume): ms per step, peak memory;
  9e. fp8: the e4m3 and e5m2 rounding on the card bit for bit against the
     CPU on a grid of subnormals, 447-481, 57344-61440, +-inf and NaN;
     ``fp8_conv`` (forward, dx, dw) against the CPU on the same inputs at
     UNCSN++'s conv shapes within KERNEL_REL_TOL;
  9f. fp8 on UNCSN++ (``tpu.activation_dtype='float8_e4m3'``): one train
     step against the CPU at batch 2, its losses and the gradients' L2
     within FP8_SPREAD x the CPU's own spread (a CPU copy whose weights
     differ by FP8_PERTURB: a conv input within f32 rounding of an e4m3
     boundary rounds the other way on one side, and the flip travels), 12 +
     12 fir2 launches; FP8_STEPS steps at batch 128 in f32, fp8, fp8, f32:
     ms per step (CUDA events), peak memory, fir2's launches per shape
     (their rows in the `kernels` line take phase 7's timings at the same
     shapes and batch); the flagship's fp8 eval forward at batch 8: 82
     gn_silu_conv3x3 launches at the f32 forward's shapes (unquantized, as
     in JAX), card vs CPU in L2 within the CPU's spread as above, and
     apart from f32.
  10. slice 6c (after 9f), each counted as the main paths are:
  10a. Picard on the flagship (phase-3 weights): 'picard_dpm' at the
     config's N = 50 DPM steps in one window (each sweep one network call
     at batch 400) at tol 0 against the sequential 'dpm_solver' from the
     same prior (within PICARD_FLAGSHIP_REL_TOL of max |x|), at tol
     PICARD_TOL with its sweeps, nfe, ms per sweep and wall against the
     sequential wall, then served over HTTP twice per seed at
     PICARD_SERVED_STEPS steps (the same bytes); 82 gn_silu_conv3x3 launches per network call, at batch 400 as
     at 8;
  10b. Picard on UNCSN++ (phase-3 weights): 'picard' at tol 0 on a chain
     cut to N = PICARD_UNCSNPP_STEPS (of 1,000: tol 0 costs up to W x the
     sequential evaluations), window 8, against the sequential 'pc' from
     the same prior and noise generator, within PICARD_UNCSNPP_REL_TOL of
     max |x|; launches per sweep 2 x (82 + 12);
  10c. DDP: one step of the flagship's CLI trainer at the global batch 128
     (no warmup), alone, on two gloo ranks of 64 on the card (``python -m
     torch.distributed.run --nproc_per_node 2``) and on one NCCL rank: the
     gradients and the parameters' moves held to phase 6's bars, the
     errors against DDP_REL_TOL of each tensor's largest beside them; then
     steps 0..DDP_TIMED_ITERS on the two ranks, the host's ms per step
     from the log;
  10d. the profiler: the CLI trainer on UNCSN++ (batch 128), steps 0..11
     with ``--config.tpu.profile_dir``: the trace of step 10 names 24 fir2
     launches (12 forward, 12 adjoint) and the adjoint's autograd node;
  10e. remat: the flagship's step at batch 128 with tpu.remat off, 'full'
     and 'conv_outputs' (dropout 0.1): the same losses, gradients within
     1e-5, the same generator state; ms per step and peak memory;
  10f. FFHQ 1024^2 trained by the CLI trainer with tpu.remat at batch 16
     (steps 0..3): finite losses, ms per step, peak memory, fir2 launches
     forward (the recompute's included) and adjoint per shape; then one
     step without remat, or its out-of-memory error;
     and phase 8 gains rows for gn_silu_conv3x3 at batch 400 and 64 and
     fir2 at 64 (Picard), fir2 and its adjoint at FFHQ's shapes, batch 16.
  11. slice 6d, the exported sampler (after 10f): first the operators'
     dispatch against the direct launch (host us per call, DISPATCH_CALLS
     calls of each route interleaved, at a 4x4 site of batch 8 and a fir2
     up site); then per model, the phase-3 weights (init_scale 0.1)
     written with the port's save_params_npz and ``serve/export.py``'s
     score programs exported on the card at batch EXPORT_BATCH and saved
     as one artifact (seconds, bytes); a fresh subprocess
     (``chip_smoke.py --replay-server``, with the port's ``models`` and
     ``configs`` made unimportable) loads the pair (seconds) and serves it
     over HTTP, and the live SamplingService in this process serves the
     same seeds:
  11a. the flagship: two seeds with its own 'ode' and two with 'dpm_solver'
     at EXPORT_DPM_STEPS steps;
  11b. UNCSN++ with 'pc' at N = EXPORT_PC_STEPS (of 1,000) and
     'dpm_solver', two seeds each;
     held: the same nfe for 'pc' and 'dpm_solver' (both printed for
     'ode'), samples before quantisation within EXPORT_REL_TOL of max |x|
     (EXPORT_ODE_REL_TOL for 'ode'), the served uint8 bytes apart by at
     most 1 in at most EXPORT_MAX_MOVED of the positions, and in the
     subprocess, counted inside the operators, 82 gn_silu_conv3x3 launches
     (and 12 fir2 for UNCSN++) per score evaluation at the fused (FIR)
     sites' shapes; printed and held: the host ms per evaluation and
     torch.profiler's kernels per evaluation, replay against eager
     (within EXPORT_KERNELS_REL); phase 8's lines gain the replay's
     launches (``*_replay`` entries, the timings of phase 8's batch-8
     rows at the same shapes).
Imports torch and the port only, never jax or the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "soft_truncation_tpu_torch", "configs")
FLAGSHIP = os.path.join(CONFIGS, "vp", "CIFAR10", "ddpmpp_nll_st.py")
UNCSNPP = os.path.join(CONFIGS, "ve", "CIFAR10", "uncsnpp_st.py")
DEVICE = "cuda"
SERVE_BATCH = 8
KERNELS = ("gn_silu_conv3x3", "fir2")
# the flagship shapes phase 6 must cover: (H, W, C, O)
LISTED_SHAPES = [(32, 32, 128, 128), (32, 32, 384, 128), (32, 32, 256, 256),
                 (16, 16, 384, 256), (16, 16, 512, 256), (8, 8, 256, 256),
                 (4, 4, 512, 256)]
# H100 SXM datasheet: FP32 (no tensor cores), dense TF32 and HBM3 rates
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
FUSED_SITES = 82        # fused sites of one flagship or UNCSN++ eval forward
# FIR sites of one UNCSN++ eval forward: (mode, H, W, C) -> count
UNCSNPP_FIR_SITES = {("down", 32, 32, 128): 2, ("down", 16, 16, 256): 2,
                     ("down", 8, 8, 256): 2, ("up", 4, 4, 256): 2,
                     ("up", 8, 8, 256): 2, ("up", 16, 16, 256): 2}
FIR_KERNEL = (1, 3, 3, 1)
PC_PUBLISHED_STEPS = 1000  # model.num_scales of ve/CIFAR10/uncsnpp_st.py
PC_SERVED_STEPS = 250      # phase 5: the config's 'pc' served, N cut
TRAIN_BATCH = 128        # training.batch_size of both configs
TRAIN_CHECK_BATCH = 2    # phase 6
TRAIN_ITERS = 5          # phase 7: steps 0..5, then a resume to 7
TRACE_FORWARDS = 3       # phase 5b: calls traced per model and kind
# the adjoint's launches of one UNCSN++ train step: (launched mode, H, W, C)
# of each cotangent -> count (the backward of an up site launches down)
UNCSNPP_FIR_BWD_SITES = {("up", 16, 16, 128): 2, ("up", 8, 8, 256): 2,
                         ("up", 4, 4, 256): 2, ("down", 8, 8, 256): 2,
                         ("down", 16, 16, 256): 2, ("down", 32, 32, 256): 2}
LIKELIHOOD_BATCH = 8     # phase 7b: eval.batch_size of the CLI evaluation
LIKELIHOOD_CHECK_BATCH = 2  # phase 7b: card vs CPU
LIKELIHOOD_TIMES = (1e-5, 0.5, 1.0)  # phase 7b: the ODE function's t
FID_SAMPLES = 512        # phase 7c: eval.num_samples, 4 shards
FID_SHARD = 128          # phase 7c: sampling.batch_size
FID_DPM_STEPS = 20       # phase 7c: sampling.dpm_steps
FID_CHECK_IMAGES = 8     # phase 7c: card vs CPU, resize and Inception
INCEPTION_BATCH = 128    # the extractor's batch
KERNEL_REL_TOL = 1e-4   # gn_silu_conv3x3: reordered f32 sums, K <= 9*512
FIR_REL_TOL = 1e-5      # fir2: <= 16 f32 products, summed in another order
FORWARD_REL_TOL = 1e-3  # card vs CPU, the whole network or sampler
# the published layouts (phases 3b, 5c, 5d, 6b, 7d)
DEEPEST = os.path.join(CONFIGS, "vp", "CIFAR10", "ddpmpp_fid_st_deepest.py")
CELEBA64 = os.path.join(CONFIGS, "vp", "CELEBA", "uddpmpp_nll_st.py")
CELEBAHQ = os.path.join(CONFIGS, "ve", "celebahq_256_uncsn.py")
FFHQ1024 = os.path.join(CONFIGS, "ve", "ffhq_1024_uncsn.py")
GN_CONV_MAX_HWC = 32 * 32 * 512  # JAX's bound on a fused site's H*W*max(C,O)
CHECK_BATCH = 2             # card vs CPU at full width
DEEPEST_SERVE_STEPS = 50    # phase 5c: 'pc' N
HQ_SERVE_STEPS = 5          # phase 5d: 'pc' N
HQ_PUBLISHED_STEPS = 2000   # model.num_scales of ve/celebahq_256_uncsn.py
# phase 3b: (name, config, model overrides, labels): VP labels t * 999,
# CelebA 64^2's unbounded ones as they come, VE / RVE labels sigmas
PUBLISHED_LAYOUTS = (
    ("deepest", DEEPEST, {}, [0.01 * 999.0, 0.6 * 999.0]),
    ("celeba_64", CELEBA64, {}, [3.0, 700.0]),
    ("celebahq_256", CELEBAHQ, {}, [0.01, 300.0]),
    ("ffhq_1024", FFHQ1024, {}, [50.0]),
    ("ddpm_blocks", FLAGSHIP, {"resblock_type": "ddpm",
                               "fourier_feature": True},
     [0.01 * 999.0, 0.6 * 999.0]),
    ("no_auxiliary", FLAGSHIP, {"auxiliary_resblock": False},
     [0.01 * 999.0, 0.6 * 999.0]))
DEEPEST_TRAIN_ITERS = 3     # phase 7d: steps 0..3
# phase 7d: batch 128 in one micro-batch, as published, fits the card's
# 80 GB with little to spare (PERF.md): the phase frees the cache first
PARAM_MOVE_TOL = 0.05   # card vs CPU, a parameter's move in one step, x lr
# served uint8 vs the CPU run: a float difference within FORWARD_REL_TOL
# of samples in [0, 1] moves a pixel across at most one quantisation step,
# and few of them; a sampler that leaves [0, 1] far behind (the legacy
# networks' random weights blow DDPM's ancestral samples up to ~4500) has
# an absolute difference err of its own, which may move a pixel by
# another floor(255 err) steps
SERVED_MAX_STEP, SERVED_MAX_MOVED = 1, 0.01
# phases 9a-9f, the legacy networks: the public configs' values
# (yang-song/score_sde_pytorch configs/vp/ddpm/cifar10.py,
# configs/ve/ncsnv2/cifar10.py, configs/ve/ncsn/cifar10.py) over the
# flagship's config file
_DISCRETE = dict(continuous=False, likelihood_weighting=False, st=False)
LEGACY = {
    "ddpm": {
        "training": dict(_DISCRETE, sde="vpsde", reduce_mean=True),
        "sampling": dict(method="pc", predictor="ancestral_sampling",
                         corrector="none", n_steps_each=1, snr=0.16),
        "data": dict(centered=True),
        "model": dict(name="ddpm", nf=128, ch_mult=(1, 2, 2, 2),
                      num_res_blocks=2, attn_resolutions=(16,), dropout=0.1,
                      resamp_with_conv=True, conditional=True,
                      scale_by_sigma=False, ema_rate=0.9999,
                      normalization="GroupNorm", nonlinearity="swish",
                      num_scales=1000)},
    "ncsnv2_64": {
        "training": dict(_DISCRETE, sde="vesde", reduce_mean=False),
        "sampling": dict(method="pc", predictor="none", corrector="ald",
                         n_steps_each=5, snr=0.176),
        "data": dict(centered=False),
        "model": dict(name="ncsnv2_64", nf=128, scale_by_sigma=True,
                      num_scales=232, sigma_min=0.01, sigma_max=50.0,
                      ema_rate=0.999, normalization="InstanceNorm++",
                      nonlinearity="elu"),
        "optim": dict(lr=1e-4, warmup=0, grad_clip=-1.0)},
    "ncsn": {
        "training": dict(_DISCRETE, sde="vesde", reduce_mean=False),
        "sampling": dict(method="pc", predictor="none", corrector="ald",
                         n_steps_each=100, snr=0.316),
        "data": dict(centered=False),
        "model": dict(name="ncsn", nf=128, scale_by_sigma=False,
                      num_scales=10, sigma_min=0.01, sigma_max=1.0,
                      ema_rate=0.0, normalization="InstanceNorm++",
                      nonlinearity="elu"),
        "optim": dict(lr=1e-3, warmup=0, grad_clip=-1.0)},
}
LEGACY_BATCH = 8            # phases 9a, 9b: the 32^2 forwards and serving
# phase 9a at batch 2: the layouts only the high-resolution v2 nets reach
LEGACY_HIRES = (("ncsnv2_128", 128), ("ncsnv2_256", 256))
# phase 9b: N cut to a quarter of the published 1000 and 232 (for the time
# of phase 10; the wall per evaluation is what the phase reads)
DDPM_SERVE_STEPS = 250
NCSNV2_SERVE_STEPS = 58
# card vs CPU: NCSNv2 at N=3; ancestral sampling on the VP grid needs
# beta_max / N < 1 (sqrt(1 - beta)), so DDPM at the least N above 20
DDPM_CHECK_STEPS, NCSNV2_CHECK_STEPS = 25, 3
# phase 9e: fp8_conv card vs CPU at UNCSN++'s conv shapes: (N, H, C, O,
# kernel, stride)
FP8_CONV_SHAPES = ((2, 32, 128, 128, 3, 1), (2, 16, 256, 256, 3, 1),
                   (2, 32, 128, 256, 1, 1), (2, 8, 256, 256, 3, 2))
FP8_STEPS = 5               # phase 9f: timed steps per run at batch 128
# fp8 card vs CPU, whole network: a conv input within f32 rounding of an
# e4m3 boundary rounds the other way on one side, and the flip travels:
# two fp8 runs whose f32 sums differ in the last bits part about as far as
# fp8 parts from f32, by an amount that depends on the inputs and draws.
# So the card is held to the CPU's own spread on the same inputs: a CPU
# run whose weights differ by FP8_PERTURB relative (~the card's f32
# differences, phase 6), times FP8_SPREAD, plus FP8_FLOOR relative for f32
# rounding
FP8_PERTURB = 1e-6
FP8_SPREAD = 3.0
FP8_FLOOR = 1e-5
# slice 6c (phases 10a-10f)
PICARD_TOL = 1e-3           # 10a: the base config's sampling.picard_tol
PICARD_FLAGSHIP_REL_TOL = 1e-4  # 10a: tol = 0 vs sequential, of max |x|
PICARD_SERVED_STEPS = 10    # 10a: the served request's dpm_steps
# 10b: UNCSN++ 'picard' at tol = 0 on a chain cut from N = 1000 to 32 steps
# (tol = 0 costs up to W x the sequential evaluations), window 8
PICARD_UNCSNPP_STEPS, PICARD_UNCSNPP_WINDOW = 32, 8
PICARD_UNCSNPP_REL_TOL = 1e-3
# 10c: the flagship's CLI trainer at the global batch 128, one step alone,
# on two gloo ranks (64 each) and on one NCCL rank, held to phase 6's bars
# (phase_ddp says why), the errors against DDP_REL_TOL of each tensor's
# largest reported beside them; then steps 0..DDP_TIMED_ITERS on the ranks
DDP_TIMED_ITERS = 3
DDP_REL_TOL = 1e-5
PROFILE_ITERS = 11          # 10d: steps 0..11, the eleventh (10) traced
EXPORT_BATCH = 8            # 11: the artifact's batch
EXPORT_DPM_STEPS = 50       # 11: 'dpm_solver' steps served
EXPORT_PC_STEPS = 32        # 11b: UNCSN++'s 'pc' N, cut from 1,000
EXPORT_SEEDS = (0, 1)
EXPORT_REL_TOL = 1e-5       # 11: replay vs live, of max |x|
EXPORT_ODE_REL_TOL = 1e-3   # 11: 'ode' (adaptive steps follow the rounding)
EXPORT_MAX_MOVED = 1e-3     # 11: uint8 positions that may differ (by 1)
EXPORT_KERNELS_REL = 0.05   # 11: profiler kernels per evaluation
EXPORT_PROFILE_EVALS = 3    # 11: evaluations timed and traced per side
DISPATCH_CALLS = 1000       # 11: calls per route
DISPATCH_RULE_US = 10       # 11: the operator's cost the eager route takes
FFHQ = os.path.join(CONFIGS, "ve", "ffhq_1024_uncsn.py")
FFHQ_BATCH = 16             # 10f: training.batch_size of ffhq_1024_uncsn.py
FFHQ_TRAIN_ITERS = 3        # 10f: steps 0..3 with tpu.remat
REMAT_STEPS = 3             # 10e: steps per policy, the first compared


def log(msg):
  print(msg, flush=True)


def emit(obj):
  print(json.dumps(obj), flush=True)


def device_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True).stdout.strip()
  return f"device: {out}"


def time_ms(fn, iters=20, warmup=3):
  """Mean ms per call on the card, with CUDA events around ``iters`` calls."""
  import torch
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
  """Mean device ms per call of ``fn`` replayed from a CUDA graph of
  ``iters`` calls: the device's share of a call, without the host's cost
  of issuing it (which ``time_ms`` includes)."""
  import torch
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(iters):
      fn()
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def _bound(flops, bytes_, peak=PEAK_FP32_FLOPS):
  """Least time (ms) for ``flops`` at ``peak`` and ``bytes_`` at the HBM
  rate, and which of the two bounds it."""
  t_ops, t_bytes = flops / peak, bytes_ / PEAK_BYTES
  return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                     else "bytes")


def gn_conv_bound(n, h, w, c, o, groups):
  """Every input read once, the output written once, 2*9*C flops per
  output element at the dense TF32 peak (the card's tensor-core rate for
  f32 inputs): ``(bound_ms, bound_by)``. Beside it the same with the flops
  taken three times, the kernel's own 3xTF32 scheme, and the flops once on
  the FP32 pipe, the bound of the kernel's earlier FMA form."""
  flops = 2 * n * h * w * c * o * 9
  bytes_ = 4 * (n * h * w * (c + o) + 9 * c * o + o + 2 * c + 2 * n * groups)
  bound, bound_by = _bound(flops, bytes_, PEAK_TF32_FLOPS)
  return (bound, bound_by, _bound(3 * flops, bytes_, PEAK_TF32_FLOPS)[0],
          _bound(flops, bytes_)[0])


def fir_bound(mode, n, h, w, c, taps):
  """The input read once, the output written once, (T/2)^2 (up) or T^2
  (down) multiply-adds per output element."""
  oh, ow = (2 * h, 2 * w) if mode == "up" else (h // 2, w // 2)
  macs = (taps // 2) ** 2 if mode == "up" else taps ** 2
  return _bound(2 * macs * n * oh * ow * c,
                4 * (n * c * (h * w + oh * ow) + taps))


def load_config(path, **model_overrides):
  from soft_truncation_tpu_torch.configs.base import load_config as load
  config = load(path)
  config.model.update(model_overrides)
  return config


def _launch_counts():
  """Each kernel's launches per shape so far: gn_silu_conv3x3 per
  (H, W, C, O), fir2 per (mode, H, W, C)."""
  from soft_truncation_tpu_torch.ops import fir, gn_conv
  firs = {("up",) + s: k for s, k in fir.fir_upsample2.launches_by_shape
          .items()}
  firs.update({("down",) + s: k for s, k in
               fir.fir_downsample2.launches_by_shape.items()})
  return dict(gn_conv.gn_silu_conv3x3.launches_by_shape), firs


def _backward_launch_counts():
  """fir2's launches by the adjoint, per (launched mode, H, W, C) of the
  cotangent."""
  from soft_truncation_tpu_torch.ops import fir
  firs = {("down",) + s: k for s, k in
          fir.fir_upsample2.backward_launches_by_shape.items()}
  firs.update({("up",) + s: k for s, k in
               fir.fir_downsample2.backward_launches_by_shape.items()})
  return firs


def _jvp_launch_counts():
  """The tangent launches per shape so far: gn_silu_conv3x3's per (H, W,
  C, O), fir2's per (mode, H, W, C)."""
  from soft_truncation_tpu_torch.ops import fir, gn_conv
  firs = {("up",) + s: k for s, k in
          fir.fir_upsample2.jvp_launches_by_shape.items()}
  firs.update({("down",) + s: k for s, k in
               fir.fir_downsample2.jvp_launches_by_shape.items()})
  return dict(gn_conv.gn_silu_conv3x3.jvp_launches_by_shape), firs


def _all_launch_counts():
  """Primal and tangent launches per shape so far, as Counters:
  (gn_silu_conv3x3, fir2, gn_silu_conv3x3 tangent, fir2 tangent)."""
  return tuple(collections.Counter(c)
               for c in _launch_counts() + _jvp_launch_counts())


class _FunctionApplies:
  """Counts the kernels' autograd.Function applications while it is
  entered: serving must call the kernels directly."""

  def __enter__(self):
    from soft_truncation_tpu_torch.ops import fir, gn_conv
    self.classes = (gn_conv._GnSiluConv3x3, fir._Fir2)
    self.count = 0

    def counted(orig):
      def apply(*args, **kwargs):
        self.count += 1
        return orig(*args, **kwargs)
      return apply

    for cls in self.classes:
      cls.apply = counted(cls.apply)
    return self

  def __exit__(self, *exc):
    for cls in self.classes:
      del cls.apply  # the inherited classmethod again


def _reset_launch_counts():
  from soft_truncation_tpu_torch.ops import fir, gn_conv
  gn_conv.reset_launch_counts()
  fir.reset_launch_counts()


def phase_build():
  """Start nvcc for every kernel source at once; print each report."""
  from soft_truncation_tpu_torch.ops import _build

  def build(name):
    t0 = time.perf_counter()
    _build.load_library(name)
    return time.perf_counter() - t0

  with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
    seconds = dict(zip(KERNELS, pool.map(build, KERNELS)))
  for name in KERNELS:
    log(f"build: {name} in {seconds[name]:.1f} s")
    log(_build.library_path(name).with_suffix(".log").read_text().strip())


def phase_forward(name, config, labels, want_fir):
  """Full-width eval forward, card (kernels) vs CPU (plain versions).

  Returns the CPU model's fused sites per (H, W, C, O), its FIR sites per
  (mode, H, W, C) and its weights."""
  import torch
  from soft_truncation_tpu_torch.models import create_model

  cpu_model = create_model(config, "cpu", seed=0)
  gpu_model = create_model(config, DEVICE, seed=0)
  gen = torch.Generator("cpu").manual_seed(1)
  x = torch.randn(len(labels), 32, 32, 3, generator=gen)
  labels = torch.tensor(labels)
  with torch.inference_mode():
    want = cpu_model(x, labels)
    sites = collections.Counter(cpu_model.fused_sites())
    fir_sites = collections.Counter(cpu_model.fir_sites())
    _reset_launch_counts()
    got = gpu_model(x.to(DEVICE), labels.to(DEVICE))
    torch.cuda.synchronize()
    launched, fir_launched = _launch_counts()
  err = (got.cpu() - want).abs().flatten(1).amax(1)
  scale = want.abs().flatten(1).amax(1)
  log(f"forward {name}: per sample max_abs_diff {err.tolist()} max|out| "
      f"{scale.tolist()}; fused sites {sum(sites.values())}, launches "
      f"{sum(launched.values())}; FIR sites {sum(fir_sites.values())}, "
      f"launches {sum(fir_launched.values())}")
  if not (torch.isfinite(got).all() and (err <= FORWARD_REL_TOL
                                         * scale).all()):
    raise AssertionError(f"{name}: card forward disagrees with CPU: "
                         f"{err.tolist()} vs {scale.tolist()}")
  if launched != dict(sites) or sum(sites.values()) != FUSED_SITES:
    raise AssertionError(f"{name}: expected {FUSED_SITES} fused sites each "
                         f"launching the kernel once; sites {dict(sites)}, "
                         f"launches {launched}")
  if fir_launched != dict(fir_sites) or dict(fir_sites) != want_fir:
    raise AssertionError(f"{name}: expected FIR sites {want_fir}, each "
                         f"launching the kernel once; sites "
                         f"{dict(fir_sites)}, launches {fir_launched}")
  return dict(sites), dict(fir_sites), cpu_model.state_dict()


def _post(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=900) as r:
    return r.read()


def _serve_requests(url, requests, config, repeat=2, batch=SERVE_BATCH):
  """POST each request ``repeat`` times; check shape ([batch, size, size,
  3] at the config's image size), dtype and determinism. Returns the
  network evaluations run, the first answer of each request and each
  request's walls."""
  import numpy as np
  size = config.data.image_size
  evals, answers, walls = 0, [], []
  for req in requests:
    method = req.get("method", config.sampling.method)
    bodies, times = [], []
    for _ in range(repeat):
      t0 = time.perf_counter()
      bodies.append(_post(url + "/sample", req))
      times.append(time.perf_counter() - t0)
      with np.load(io.BytesIO(bodies[-1])) as f:
        samples, nfe = f["samples"], int(f["nfe"])
      # the ode and pc samplers' nfe, as in the JAX package, leave out
      # their final denoising evaluation, and pc's counts a corrector
      # evaluation per step even where the corrector is 'none'
      if method == "pc" and config.sampling.corrector == "none":
        nfe_run = nfe // (config.sampling.n_steps_each + 1)
      else:
        nfe_run = nfe
      evals += nfe_run + (1 if method == "pc" or (
          method == "ode" and config.sampling.noise_removal) else 0)
      inside = float(((samples > 0) & (samples < 255)).mean())
      log(f"serve: {json.dumps(req)} nfe {nfe} wall_s {times[-1]:.3f} "
          f"mean {samples.mean():.3f} std {samples.std():.3f} "
          f"unsaturated {inside:.4f}")
      if (samples.shape != (batch, size, size, 3)
          or samples.dtype != np.uint8):
        raise AssertionError(f"bad samples {samples.shape} {samples.dtype}")
      if samples.std() == 0:
        raise AssertionError("samples are constant")
    if any(b != bodies[0] for b in bodies):
      raise AssertionError(f"same seed, different bytes: {req}")
    with np.load(io.BytesIO(bodies[0])) as f:
      answers.append(f["samples"])
    walls.append(times)
  return evals, answers, walls


def _serving(service, fn):
  """Run ``fn(url)`` against ``service`` behind the port's HTTP server."""
  from soft_truncation_tpu_torch.serve.server import make_server
  srv = make_server(service, host="127.0.0.1", port=0)
  thread = threading.Thread(target=srv.serve_forever, daemon=True)
  thread.start()
  try:
    return fn(f"http://127.0.0.1:{srv.server_address[1]}")
  finally:
    srv.shutdown()
    thread.join(timeout=60)
    srv.server_close()


def _healthz(url):
  with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
    health = json.loads(r.read())
  if health["status"] != "ok":
    raise AssertionError(f"/healthz: {health}")
  log(f"serve: /healthz meta {json.dumps(health['meta'])}")
  return health["meta"]


def _check_against_cpu(service, params, served, seed, method, steps,
                       batch=SERVE_BATCH, sde_wrap=None):
  """Hold one served batch against a CPU SamplingService on the same
  weights, run from the same prior (round 0 of ``seed``); a 'pc' run also
  gets the card's noise, drawn once from the round's noise generator as
  the served run drew it."""
  import numpy as np
  import torch
  from soft_truncation_tpu_torch.eval.sampling_io import _to_uint8
  from soft_truncation_tpu_torch.serve.server import SamplingService

  prior = service.prior(seed, 0)
  card_kw, ref_kw = {}, {}
  if method == "pc":
    gen, drawn = service.noise(seed, 0), []

    def record(like):
      z = torch.randn(like.shape, generator=gen, device=like.device,
                      dtype=like.dtype)
      drawn.append(z)
      return z

    replay = iter(drawn)
    card_kw = dict(draw=record)
    ref_kw = dict(draw=lambda like: next(replay).to(like.device))
  card, _ = service.sampler(method, steps)(service.model, x=prior, **card_kw)
  ref_service = SamplingService(service.config, params, batch=batch,
                                device="cpu")
  if sde_wrap is not None:  # as the card's service was given
    ref_service.sde = sde_wrap(ref_service.sde)
  ref, _ = ref_service.sampler(method, steps)(ref_service.model,
                                              x=prior.cpu(), **ref_kw)
  err = (card.cpu() - ref).abs().max().item()
  scale = ref.abs().max().item()
  step = np.abs(served.astype(np.int16)
                - _to_uint8(ref).numpy().astype(np.int16))
  moved = float((step > 0).mean())
  log(f"serve: {method} {steps} steps vs CPU: max_abs_diff {err} "
      f"max|ref| {scale} served uint8 max step {int(step.max())} "
      f"moved {moved:.6f}")
  if not (torch.isfinite(card).all() and err <= FORWARD_REL_TOL * scale):
    raise AssertionError(f"card sampler disagrees with CPU: {err} vs "
                         f"{scale}")
  if (step.max() > SERVED_MAX_STEP + math.floor(255 * err)
      or moved > SERVED_MAX_MOVED):
    raise AssertionError(f"served samples disagree with CPU: max step "
                         f"{step.max()}, {moved} of the pixels moved")


def _check_tallies(name, evals, launched, sites, fir_launched, fir_sites):
  want = {s: k * evals for s, k in sites.items()}
  want_fir = {s: k * evals for s, k in fir_sites.items()}
  log(f"serve {name}: {evals} network evaluations, "
      f"{sum(launched.values())} gn_silu_conv3x3 launches, "
      f"{sum(fir_launched.values())} fir2 launches")
  if launched != want:
    raise AssertionError(f"{name}: gn_silu_conv3x3 launches per shape "
                         f"{launched} are not the fused sites x {evals} "
                         f"evaluations: {want}")
  if fir_launched != want_fir:
    raise AssertionError(f"{name}: fir2 launches per shape {fir_launched} "
                         f"are not the FIR sites x {evals} evaluations: "
                         f"{want_fir}")


def phase_serve_flagship(sites, params):
  """A main path: the port's server answering flagship requests.

  ``sites``: the CPU model's fused sites per (H, W, C, O) in one forward;
  ``params``: the weights of phase 3 (init_scale 0.1). Returns the
  kernel's launches per shape in this phase and the evaluations run."""
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.serve.server import SamplingService

  config = load_config(FLAGSHIP)  # as published: init_scale 0
  service = SamplingService(
      config, create_model(config, "cpu", seed=1).state_dict(),
      batch=SERVE_BATCH, device=DEVICE)
  config01 = load_config(FLAGSHIP, init_scale=0.1)
  service01 = SamplingService(config01, params, batch=SERVE_BATCH,
                              device=DEVICE)
  dpm01 = {"num": SERVE_BATCH, "seed": 3, "method": "dpm_solver",
           "dpm_steps": 5}

  def as_published(url):
    _healthz(url)
    return _serve_requests(
        url, [{"num": SERVE_BATCH, "seed": 0},
              {"num": SERVE_BATCH, "seed": 0, "method": "dpm_solver",
               "dpm_steps": 20}], config)[0]

  _reset_launch_counts()
  evals = _serving(service, as_published)
  evals01, (served01,), _ = _serving(
      service01, lambda url: _serve_requests(url, [dpm01], config01))
  launched, fir_launched = _launch_counts()
  evals += evals01
  _check_tallies("flagship", evals, launched, sites, fir_launched, {})
  _check_against_cpu(service01, params, served01, dpm01["seed"],
                     dpm01["method"], dpm01["dpm_steps"])
  return launched, evals


def phase_serve_uncsnpp(sites, fir_sites, params):
  """The other main path: the port's server answering UNCSN++ requests,
  the config's own 'pc' first. Returns both kernels' launches per shape
  in this phase, the evaluations run and the published request's wall."""
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.serve.server import SamplingService

  config = load_config(UNCSNPP, num_scales=PC_SERVED_STEPS)
  weights = create_model(config, "cpu", seed=1).state_dict()
  service = SamplingService(config, weights, batch=SERVE_BATCH,
                            device=DEVICE)
  config50 = load_config(UNCSNPP, num_scales=50)
  service50 = SamplingService(config50, weights, batch=SERVE_BATCH,
                              device=DEVICE)
  config01 = load_config(UNCSNPP, init_scale=0.1, num_scales=3)
  service01 = SamplingService(config01, params, batch=SERVE_BATCH,
                              device=DEVICE)
  pc01 = {"num": SERVE_BATCH, "seed": 3, "method": "pc"}
  out = {}

  def as_published(url):
    meta = _healthz(url)
    if (meta["sde"], meta["sampling_method"]) != ("reciprocal_vesde", "pc"):
      raise AssertionError(f"/healthz names {meta['sde']} and "
                           f"{meta['sampling_method']}")
    evals, _, walls = _serve_requests(url, [{"num": SERVE_BATCH, "seed": 0}],
                                      config, repeat=1)
    out["pc_wall_s"], out["pc_evals"] = walls[0][0], evals
    evals += _serve_requests(
        url, [{"num": SERVE_BATCH, "seed": 0, "method": "dpm_solver",
               "dpm_steps": 20}], config)[0]
    return evals

  _reset_launch_counts()
  evals = _serving(service, as_published)
  evals += _serving(service50, lambda url: _serve_requests(
      url, [{"num": SERVE_BATCH, "seed": 1, "method": "pc"}], config50)[0])
  evals01, (served01,), _ = _serving(
      service01, lambda url: _serve_requests(url, [pc01], config01))
  launched, fir_launched = _launch_counts()
  evals += evals01
  _check_tallies("uncsnpp", evals, launched, sites, fir_launched, fir_sites)
  _check_against_cpu(service01, params, served01, pc01["seed"], "pc",
                     config01.model.num_scales)
  log(f"serve uncsnpp: pc, N={PC_SERVED_STEPS} of {PC_PUBLISHED_STEPS}: "
      f"{out['pc_evals']} evaluations in {out['pc_wall_s']:.3f} s, "
      f"{out['pc_wall_s'] / out['pc_evals'] * 1e3:.3f} ms per evaluation")
  return launched, fir_launched, evals


def _traced(name, fn, batch=SERVE_BATCH):
  """``fn``'s wall per call without a profiler (host clock, synchronised),
  then a torch.profiler trace of TRACE_FORWARDS calls: the device's busy
  time (the kernels' self time, summed) against the traced wall, the
  kernels taking the most device time and the ops taking the most host
  time. Emits and returns the row, per call."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  def calls(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3

  calls(3)
  wall_ms = calls(TRACE_FORWARDS)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    traced_ms = calls(TRACE_FORWARDS)
  events = prof.key_averages()

  def device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))

  # the kernels themselves: the ops that launch them carry the same device
  # time as their own
  kernels = [e for e in events
             if e.device_type == DeviceType.CUDA and device_us(e) > 0]
  busy_ms = sum(device_us(e) for e in kernels) / 1e3 / TRACE_FORWARDS
  ours = sum(device_us(e) for e in kernels if any(
      k in e.key for k in ("gn_silu_conv3x3", "splitk_reduce", "fir2")))
  top_device = sorted(kernels, key=device_us, reverse=True)[:8]
  top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]
  row = {"trace": name, "batch": batch, "calls": TRACE_FORWARDS,
         "wall_ms_per_call": wall_ms, "traced_wall_ms_per_call": traced_ms,
         "device_busy_ms_per_call": busy_ms if kernels else None,
         "device_busy_share": busy_ms / traced_ms if kernels else None,
         "hand_written_kernels_ms_per_call":
             ours / 1e3 / TRACE_FORWARDS if kernels else None,
         "top_device_ms_per_call": [
             [e.key[:60], e.count / TRACE_FORWARDS,
              device_us(e) / 1e3 / TRACE_FORWARDS] for e in top_device],
         "top_host_ms_per_call": [
             [e.key[:60], e.count / TRACE_FORWARDS,
              e.self_cpu_time_total / 1e3 / TRACE_FORWARDS]
             for e in top_host]}
  emit(row)
  if not kernels:
    log(f"trace {name}: the profiler recorded no device time: device busy "
        f"share not measured")
  return row


def phase_trace(name, config, params, label):
  """Where the time goes at the serving batch (``_traced``): one eval
  forward, under inference_mode, and one function evaluation of the
  likelihood's ODE (a ``torch.func.jvp`` of the drift at t = 0.5: the
  primal and the tangent of every site), under no_grad."""
  import torch
  from soft_truncation_tpu_torch.likelihood import get_ode_fn
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.sde import get_sde

  model = create_model(config, DEVICE, seed=0)
  model.load_state_dict(params)
  x = torch.randn(SERVE_BATCH, 32, 32, 3, device=DEVICE)
  labels = torch.full((SERVE_BATCH,), label, device=DEVICE)
  with torch.inference_mode():
    _traced(f"{name} eval forward", lambda: model(x, labels))
  eps = torch.randint(0, 2, x.shape, device=DEVICE).float() * 2.0 - 1.0
  ode_fn = get_ode_fn(config, get_sde(config), model, eps)
  flat = torch.cat([x.reshape(-1), x.new_zeros(SERVE_BATCH)])
  with torch.no_grad():
    _traced(f"{name} ODE function evaluation", lambda: ode_fn(0.5, flat))


def _recorded_draws(gen):
  """A ``draw`` that records what it draws on the CPU from ``gen``, and
  ``replay(device)``, a ``draw`` that replays those numbers on ``device``
  in the same order."""
  from soft_truncation_tpu_torch.losses import make_draw

  draws, cpu_draw = [], make_draw(gen, "cpu")

  def record(kind, shape, high=None):
    value = cpu_draw(kind, shape, high)
    draws.append((kind, high, value))
    return value

  def replay(device):
    left = iter(draws)

    def replayed(kind, shape, high=None):
      want_kind, want_high, value = next(left)
      if (kind, tuple(shape), high) != (want_kind, tuple(value.shape),
                                        want_high):
        raise AssertionError(f"draw {kind} {shape} {high} where the CPU "
                             f"drew {want_kind} {tuple(value.shape)} "
                             f"{want_high}")
      return value.to(device)

    return replayed

  return record, replay


def _fir_sites(model):
  """The FIR sites of ``model``'s last forward (none for a legacy network)."""
  return collections.Counter(getattr(model, "fir_sites", list)())


def phase_train_step(name, config, want_fir, want_bwd, forwards=1,
                     weights=None):
  """One train step at full width and batch 2 on the card and on a CPU copy
  with the same weights and draws. ``want_fir`` / ``want_bwd``: fir2's
  forward and adjoint launches per shape in one step (UNCSN++, the
  deepest model) or {}; ``forwards``: the network's forwards per step (2
  for the mixed loss, one per half), each with the last one's FIR
  sites; ``weights``: a state_dict for both (the seed's otherwise)."""
  import torch
  from soft_truncation_tpu_torch.data import get_data_scaler
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.sde import get_sde
  from soft_truncation_tpu_torch.train import init_train_state, make_train_step

  config.model.dropout, config.optim.warmup = 0.0, 0
  step = make_train_step(config, get_sde(config))
  gen = torch.Generator().manual_seed(2)
  size = config.data.image_size
  batch = get_data_scaler(config)(torch.rand(TRAIN_CHECK_BATCH, size, size,
                                             3, generator=gen))
  record, replay = _recorded_draws(gen)
  cpu_model = create_model(config, "cpu", seed=0)
  gpu_model = create_model(config, DEVICE, seed=0)
  if weights is not None:
    cpu_model.load_state_dict(weights)
    gpu_model.load_state_dict(weights)
  cpu_state = init_train_state(config, cpu_model)
  gpu_state = init_train_state(config, gpu_model)
  start = [p.detach().clone() for p in cpu_state.optimizer.params]
  want = step(cpu_state, batch, torch.Generator(), record)
  fir_sites = {s: k * forwards for s, k in _fir_sites(cpu_model).items()}
  _reset_launch_counts()
  got = step(gpu_state, batch.to(DEVICE), torch.Generator(DEVICE),
             replay(DEVICE))
  torch.cuda.synchronize()
  launched, fir_fwd = _launch_counts()
  fir_bwd = _backward_launch_counts()

  loss_err = (got.cpu() - want).abs().max().item()
  loss_scale = want.abs().max().item()
  floor = 1e-6 * max(m.abs().max().item() for m in cpu_state.optimizer.mu)
  grad_err, param_err, moves = 0.0, 0.0, []
  for m_gpu, m_cpu, p_gpu, p_cpu, p0 in zip(
      gpu_state.optimizer.mu, cpu_state.optimizer.mu,
      gpu_state.optimizer.params, cpu_state.optimizer.params, start):
    scale = max(m_cpu.abs().max().item(), floor)
    grad_err = max(grad_err, (m_gpu.cpu() - m_cpu).abs().max().item() / scale)
    # each element's move from the shared start, where the gradient is
    # above the bar its card and CPU values are held to (so its sign, and
    # Adam's first step of ~lr times that sign, agree)
    keep = m_cpu.abs() > FORWARD_REL_TOL * scale
    moved = p_cpu.detach() - p0
    param_err = max(param_err, ((p_gpu.detach().cpu() - p0) - moved)[keep]
                    .abs().max().item() if keep.any() else 0.0)
    moves.append(moved[keep].abs())
  moves = torch.cat(moves)
  lr = config.optim.lr
  log(f"train step {name}: losses {want.tolist()} max_abs_diff {loss_err}; "
      f"gradients max error {grad_err:.3e} of each tensor's max |g|; "
      f"parameters' moves max_abs_diff {param_err:.3e} over "
      f"{moves.numel()} of {sum(p.numel() for p in start)} elements, median "
      f"move {moves.median().item():.3e} (lr {lr}); fir2 launches forward "
      f"{sum(fir_fwd.values())} backward "
      f"{sum(fir_bwd.values())}")
  if not (torch.isfinite(got).all() and loss_err <= FORWARD_REL_TOL
          * loss_scale):
    raise AssertionError(f"{name}: card losses disagree with CPU: "
                         f"{got.tolist()} vs {want.tolist()}")
  if grad_err > FORWARD_REL_TOL:
    raise AssertionError(f"{name}: card gradients disagree with CPU by "
                         f"{grad_err} of a tensor's max |g|")
  # Adam's first step moves each element by ~lr: a bar of 0.05 lr fails a
  # missing, halved or sign-flipped update
  if param_err > PARAM_MOVE_TOL * lr or moves.median().item() < 0.5 * lr:
    raise AssertionError(f"{name}: the parameters' moves differ by "
                         f"{param_err} > {PARAM_MOVE_TOL} lr, or the median "
                         f"move {moves.median().item()} is under lr / 2")
  if launched or fir_fwd != dict(fir_sites) or dict(fir_sites) != want_fir:
    raise AssertionError(f"{name}: expected FIR sites {want_fir} each "
                         f"launching the kernel once and no fused site; "
                         f"sites {dict(fir_sites)}, launches {fir_fwd}, "
                         f"gn_silu_conv3x3 {launched}")
  if fir_bwd != want_bwd:
    raise AssertionError(f"{name}: expected the adjoint's launches "
                         f"{want_bwd}, got {fir_bwd}")


def _timed_steps(make_train_step, events):
  """``make_train_step`` whose steps record CUDA events around each call."""
  import torch

  def make(config, sde):
    step = make_train_step(config, sde)

    def timed(*args, **kwargs):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      losses = step(*args, **kwargs)
      end.record()
      events.append((start, end))
      return losses

    return timed

  return make


def phase_train(name, path, fir_per_step, fir_bwd_per_step,
                iters=TRAIN_ITERS, resume=True, flags=(), batch=TRAIN_BATCH):
  """The third main path: the CLI trainer on a published config, batch 128,
  Synthetic data, steps 0..``iters``, then (``resume``) a resume. ``flags``:
  more ``--config.*`` arguments; ``batch``: the config's training batch,
  for imgs/s. Returns the steps run, the fir2 launches
  per shape (forward and backward), the batch every one of them ran at
  (the mixed loss runs the network once per half of a micro-batch) and
  the workdir, which the likelihood phase evaluates and then removes."""
  import torch
  from soft_truncation_tpu_torch import main as port_main
  from soft_truncation_tpu_torch import run_lib
  from soft_truncation_tpu_torch.ops import fir

  line = re.compile(r"step: (\d+), training loss mean: (\S+), training "
                    r"loss std: (\S+) \((\S+) steps/s, (\S+) imgs/s\)")
  workdir = os.path.join(REPO, "build", "chip_smoke_train", name)
  shutil.rmtree(workdir, ignore_errors=True)
  argv = ["--config", path, "--workdir", workdir, "--mode", "train",
          "--config.data.dataset", "Synthetic",
          "--config.training.log_freq", "1",
          "--config.training.snapshot_freq_for_preemption", "2",
          "--config.training.snapshot_freq", "1000000", *flags]
  if DEVICE == "cpu":  # a run on the host, without the card
    argv.append("--cpu")
  events, make = [], run_lib.make_train_step
  run_lib.make_train_step = _timed_steps(make, events)
  # the batch of every resample the wrappers launch (and count)
  batches, resample = collections.Counter(), fir._resample

  def batch_counted(x, *args, **kwargs):
    batches[x.shape[0]] += 1
    return resample(x, *args, **kwargs)

  fir._resample = batch_counted
  try:
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    port_main.main(argv + ["--config.training.n_iters", str(iters)])
    first_run = len(events)
    if resume:
      port_main.main(argv + ["--config.training.n_iters", str(iters + 2)])
    torch.cuda.synchronize()
    launched, fir_fwd = _launch_counts()
    fir_bwd = _backward_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(workdir, "stdout.txt")) as f:
      logged = [m.groups() for m in map(line.search, f) if m]
  finally:
    run_lib.make_train_step = make
    fir._resample = resample
  steps = len(events)
  ms = [a.elapsed_time(b) for a, b in events]
  timed = ms[2:first_run]
  ms_step = sum(timed) / len(timed)
  for groups in logged:
    log(f"train {name}: step {groups[0]} loss mean {groups[1]} std "
        f"{groups[2]} ({groups[3]} steps/s, {groups[4]} imgs/s)")
  summary = {"train": name, "batch": batch, "flags": list(flags),
             "steps": steps,
             "ms_per_step": ms_step, "imgs_per_s": batch / ms_step * 1e3,
             "ms_each_step": ms, "peak_memory_bytes": peak,
             "fir2_forward_launches": sum(fir_fwd.values()),
             "fir2_backward_launches": sum(fir_bwd.values()),
             "fir2_launches_by_batch": dict(batches)}
  emit(summary)
  labels = [int(g[0]) for g in logged]
  # the rolling checkpoint of step label 4 holds 5 steps: resume at 5
  want_labels = list(range(iters + 1)) + (
      list(range(iters, iters + 3)) if resume else [])
  if labels != want_labels or steps != len(want_labels):
    raise AssertionError(f"{name}: logged steps {labels}, expected "
                         f"{want_labels} (a resume at the saved step)")
  if not all(math.isfinite(float(g[1])) and math.isfinite(float(g[2]))
             for g in logged):
    raise AssertionError(f"{name}: a training loss is not finite")
  want_fwd = {s: k * steps for s, k in fir_per_step.items()}
  want_bwd = {s: k * steps for s, k in fir_bwd_per_step.items()}
  if launched or fir_fwd != want_fwd or fir_bwd != want_bwd:
    raise AssertionError(f"{name}: fir2 launches per shape forward {fir_fwd}"
                         f" and backward {fir_bwd}, expected {want_fwd} and "
                         f"{want_bwd} ({steps} steps); gn_silu_conv3x3 "
                         f"{launched}, expected none")
  if len(batches) > 1 or sum(batches.values()) != sum(
      fir_fwd.values()) + sum(fir_bwd.values()):
    raise AssertionError(f"{name}: fir2 launches by batch {dict(batches)}: "
                         "expected every launch of the tally at one batch")
  return steps, fir_fwd, fir_bwd, next(iter(batches), None), workdir

# --- the published layouts (phases 3b, 5c, 5d, 6b, 7d) ----------------------


def _jax_guard_fused(n, h, w, c, o):
  """Whether a norm -> SiLU -> conv site fuses: JAX's guard
  (``soft_truncation_tpu/models/layerspp.py::_gn_conv_eligible``: C a
  multiple of 4 and of its groups, H * W * max(C, O) <= 32 * 32 * 512)
  and the kernel's plan (``ops/gn_conv.py::fits``)."""
  from soft_truncation_tpu_torch.ops import gn_conv
  g = min(c // 4, 32)
  return (c % 4 == 0 and c % g == 0 and h * w * max(c, o) <= GN_CONV_MAX_HWC
          and gn_conv.fits(n, h, w, c, o, g))


def phase_published_forward(name, config, labels):
  """A published layout at full width, init_scale 0.1, on the card and on a
  CPU copy with the same weights: agreement per sample, every site's
  choice of kernel or chain held to JAX's guard, each kernel's launches
  per shape equal to the CPU model's fused and FIR sites. Returns the
  fused sites, the FIR sites and the CPU model's weights."""
  import torch
  from soft_truncation_tpu_torch.models import create_model, layerspp

  size = config.data.image_size
  cpu_model = create_model(config, "cpu", seed=0)
  gen = torch.Generator("cpu").manual_seed(1)
  x = torch.randn(len(labels), size, size, 3, generator=gen)
  labels = torch.tensor(labels, dtype=torch.float32)
  decisions = []
  eligible = layerspp._gn_conv_eligible

  def record(block, h, out_ch, train):
    ok = eligible(block, h, out_ch, train)
    decisions.append((tuple(h.shape), out_ch, ok))
    return ok

  layerspp._gn_conv_eligible = record
  try:
    with torch.inference_mode():
      want = cpu_model(x, labels)
  finally:
    layerspp._gn_conv_eligible = eligible
  sites = collections.Counter(cpu_model.fused_sites())
  fir_sites = collections.Counter(cpu_model.fir_sites())
  gpu_model = create_model(config, DEVICE, seed=0)
  with torch.inference_mode():
    _reset_launch_counts()
    t0 = time.perf_counter()
    got = gpu_model(x.to(DEVICE), labels.to(DEVICE))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, fir_launched = _launch_counts()
  del gpu_model
  err = (got.cpu() - want).abs().flatten(1).amax(1)
  scale = want.abs().flatten(1).amax(1)
  chain = [(s[1:], o) for s, o, ok in decisions if not ok]
  wrong = [(s, o, ok) for s, o, ok in decisions
           if ok != _jax_guard_fused(*s, o)]
  params = sum(p.numel() for p in cpu_model.parameters())
  row = {"published_forward": name, "batch": len(labels), "size": size,
         "parameters": params, "fused_sites": sum(sites.values()),
         "chain_sites": len(chain), "fir_sites": sum(fir_sites.values()),
         "max_abs_diff": err.tolist(), "max_abs_out": scale.tolist(),
         "first_call_wall_s": wall,
         "chain_shapes": sorted(set(map(str, chain)))}
  emit(row)
  log(f"forward {name}: {params} parameters, {row['fused_sites']} fused "
      f"sites, {len(chain)} on the chain, {row['fir_sites']} FIR sites; "
      f"per sample max_abs_diff {err.tolist()} max|out| {scale.tolist()}")
  if not (torch.isfinite(got).all() and (err <= FORWARD_REL_TOL
                                         * scale).all()):
    raise AssertionError(f"{name}: card forward disagrees with CPU: "
                         f"{err.tolist()} vs {scale.tolist()}")
  if wrong or sum(sites.values()) + len(chain) != len(decisions):
    raise AssertionError(f"{name}: sites whose kernel-or-chain choice is "
                         f"not JAX's guard and the kernel's plan: {wrong}")
  if launched != dict(sites) or fir_launched != dict(fir_sites):
    raise AssertionError(f"{name}: launches per shape {launched} / "
                         f"{fir_launched} are not the sites {dict(sites)} / "
                         f"{dict(fir_sites)}")
  return dict(sites), dict(fir_sites), cpu_model.state_dict()


def _serve_published(name, path, steps, batch, want_pair, sites, fir_sites,
                     published_steps=None):
  """A published config behind the HTTP server at ``batch``, as published
  (init_scale 0), its own 'pc' at N = ``steps`` (``want_pair``: the
  predictor and corrector /healthz must name), the same request twice:
  uint8 samples, the same bytes per seed, both kernels' launches per shape
  equal to the sites x the evaluations; ms per evaluation and, with
  ``published_steps``, the published request extrapolated from it.
  Returns the service, the launches per shape and the evaluations."""
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.serve.server import SamplingService

  config = load_config(path, num_scales=steps)
  service = SamplingService(
      config, create_model(config, "cpu", seed=1).state_dict(), batch=batch,
      device=DEVICE)
  walls = []

  def as_published(url):
    meta = _healthz(url)
    if (meta["predictor"], meta["corrector"]) != want_pair:
      raise AssertionError(f"/healthz names {meta}")
    evals, _, (times,) = _serve_requests(
        url, [{"num": batch, "seed": 0}], config, batch=batch)
    walls.extend(times)
    return evals

  _reset_launch_counts()
  evals = _serving(service, as_published)
  launched, fir_launched = _launch_counts()
  _check_tallies(name, evals, launched, sites, fir_launched, fir_sites)
  per_request = evals // 2
  ms_eval = min(walls) / per_request * 1e3
  row = {"serve": name, "batch": batch, "method": "pc", "steps": steps,
         "evaluations_per_request": per_request, "request_walls_s": walls,
         "ms_per_evaluation": ms_eval}
  msg = (f"serve {name}: pc N={steps} at batch {batch}: {per_request} "
         f"evaluations in {min(walls):.3f} s, {ms_eval:.3f} ms per "
         "evaluation")
  if published_steps:
    # 'pc' with a corrector: a predictor and a corrector evaluation per
    # step, and the final denoising one
    published = 2 * published_steps + 1
    row.update(extrapolated_published_request_s=published * ms_eval / 1e3,
               extrapolated_from=f"{published} evaluations (N="
                                 f"{published_steps}) x this ms per "
                                 "evaluation; not run")
    msg += (f"; the published N={published_steps} ({published} "
            f"evaluations) would take about {published * ms_eval / 1e3:.1f}"
            " s (an extrapolation, not run)")
  emit(row)
  log(msg)
  return service, launched, fir_launched, evals


def phase_serve_deepest(sites, fir_sites, params):
  """The deepest model (nf 512, 373.9M parameters) served at batch 8 with
  its own 'pc' (Euler-Maruyama, no corrector) at N = DEEPEST_SERVE_STEPS;
  then with the phase-3b weights 'pc' at N = 2 at batch 2, the SDE's
  scalars in float64, held against a CPU SamplingService from the same
  prior and noise. Returns both kernels' launches per shape and the
  evaluations (batch 8 only)."""
  from soft_truncation_tpu_torch.serve.server import SamplingService

  service, launched, fir_launched, evals = _serve_published(
      "deepest", DEEPEST, DEEPEST_SERVE_STEPS, SERVE_BATCH,
      ("euler_maruyama", "none"), sites, fir_sites)
  del service
  # the last step runs at t = 1e-5, where the f32 VP std differs by ~3 %
  # between the card's exp and the CPU's (phase 7b): both services take
  # the SDE's scalars in float64
  config01 = load_config(DEEPEST, init_scale=0.1, num_scales=2)
  service01 = SamplingService(config01, params, batch=CHECK_BATCH,
                              device=DEVICE)
  service01.sde = _scalars_in_float64(service01.sde)
  req = {"num": CHECK_BATCH, "seed": 3}
  _, (served01,), _ = _serving(service01, lambda url: _serve_requests(
      url, [req], config01, batch=CHECK_BATCH))
  _check_against_cpu(service01, params, served01, req["seed"], "pc", 2,
                     batch=CHECK_BATCH, sde_wrap=_scalars_in_float64)
  return launched, fir_launched, evals


def phase_serve_hq(sites, fir_sites):
  """CelebA-HQ 256^2 (UNCSN++, reciprocal VE) served at its own
  sampling.batch_size with 'pc' as configured (reverse diffusion and
  Langevin) at N = HQ_SERVE_STEPS, the published N = HQ_PUBLISHED_STEPS
  extrapolated; then a trace of one eval forward at that batch (as in
  phase 5b). Returns the launches per shape and the evaluations."""
  import torch
  batch = load_config(CELEBAHQ).sampling.batch_size
  service, launched, fir_launched, evals = _serve_published(
      "celebahq_256", CELEBAHQ, HQ_SERVE_STEPS, batch,
      ("reverse_diffusion", "langevin"), sites, fir_sites,
      HQ_PUBLISHED_STEPS)
  # where an evaluation's time goes: 34 of its 86 sites take the chain
  x = torch.randn(batch, 256, 256, 3, device=DEVICE)
  labels = torch.full((batch,), 50.0, device=DEVICE)
  with torch.inference_mode():
    _traced("celebahq_256 eval forward", lambda: service.model(x, labels),
            batch)
  return launched, fir_launched, evals


def adjoint_sites(fir_sites):
  """fir2's adjoint launches for forward FIR sites: (launched mode, H, W,
  C) of each cotangent -> count."""
  out = collections.Counter()
  for (mode, h, w, c), k in fir_sites.items():
    out[("up", h // 2, w // 2, c) if mode == "down"
        else ("down", 2 * h, 2 * w, c)] += k
  return dict(out)


def _scalars_in_float64(sde):
  """``sde`` with its time-dependent methods run in float64 and their
  results cast to f32, so that the card and the CPU get the same SDE
  scalars. In f32, ``1 - exp(2 lmc)`` of the VP std at t = 1e-5 cancels to
  ~17 ulps of 1, and the card's and the CPU's exp round one ulp apart: a
  ~3 % difference in std that the drift, the divergence, the NELBO's Z and
  the residual inherit (the JAX formula; logged by the caller)."""
  import dataclasses

  import torch

  def in_float64(method):
    def run(self, *args):
      out = method(self, *(a.double() if torch.is_tensor(a) else a
                           for a in args))
      if isinstance(out, tuple):
        return tuple(o.float() for o in out)
      return out.float()
    return run

  cls = type(sde)
  sub = type(cls.__name__, (cls,), {
      m: in_float64(getattr(cls, m))
      for m in ("marginal_prob", "sde", "sample_diffusion_time")})
  return sub(**{f.name: getattr(sde, f.name)
                for f in dataclasses.fields(sde)})


def _ode_and_elbo_card_vs_cpu(name, config, params):
  """The likelihood's functions at full width, batch 2, card vs CPU from the
  same weights (phase 3's, init_scale 0.1), the same draws and the same SDE
  scalars (``_scalars_in_float64``): the ODE function at each of
  LIKELIHOOD_TIMES (drift and Hutchinson term, each within FORWARD_REL_TOL
  of its own max) and the per-example NELBO and residual (within
  FORWARD_REL_TOL of the largest). Logs the f32 marginal std at the
  smallest time on both."""
  import torch
  from soft_truncation_tpu_torch.data import get_data_inverse_scaler
  from soft_truncation_tpu_torch.likelihood import get_elbo_fn, get_ode_fn
  from soft_truncation_tpu_torch.losses import make_draw
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.sde import get_sde

  sde32 = get_sde(config)
  t_min = torch.full((1,), min(LIKELIHOOD_TIMES))
  stds = [sde32.marginal_std(t_min.to(d)).item() for d in (DEVICE, "cpu")]
  log(f"likelihood {name}: f32 marginal std at t={t_min.item()}: card "
      f"{stds[0]!r} cpu {stds[1]!r} (relative difference "
      f"{abs(stds[0] - stds[1]) / stds[1]:.3e})")
  sde = _scalars_in_float64(sde32)
  models = {}
  for device in ("cpu", DEVICE):
    models[device] = create_model(config, device).requires_grad_(False)
    models[device].load_state_dict(params)
  gen = torch.Generator().manual_seed(5)
  shape = (LIKELIHOOD_CHECK_BATCH, 32, 32, 3)
  x = torch.randn(shape, generator=gen)
  eps = torch.randint(0, 2, shape, generator=gen).float() * 2.0 - 1.0
  flat = torch.cat([x.reshape(-1), torch.zeros(shape[0])])
  n = x.numel()
  worst = 0.0
  with torch.no_grad():
    for t in LIKELIHOOD_TIMES:
      got, want = (get_ode_fn(config, sde, models[d], eps.to(d))(
          t, flat.to(d)).cpu() for d in (DEVICE, "cpu"))
      for part, sl in (("drift", slice(0, n)), ("logp", slice(n, None))):
        err = (got[sl] - want[sl]).abs().max().item()
        scale = want[sl].abs().max().item()
        worst = max(worst, err / scale)
        log(f"likelihood {name}: ODE function at t={t} {part}: max_abs_diff "
            f"{err} max|cpu| {scale}")
        if not (torch.isfinite(got[sl]).all()
                and err <= FORWARD_REL_TOL * scale):
          raise AssertionError(f"{name}: the ODE function's {part} at t={t}"
                               f" disagrees with the CPU: {err} vs {scale}")
  draws, cpu_draw = [], make_draw(gen, "cpu")

  def record(kind, shape):
    draws.append(cpu_draw(kind, shape))
    return draws[-1]

  replay = iter(draws)
  elbo_fn = get_elbo_fn(config, sde, get_data_inverse_scaler(config))
  batch = x.clamp(-1.0, 1.0) if config.data.centered else x.sigmoid()
  want = elbo_fn(models["cpu"], batch, draw=record)
  got = elbo_fn(models[DEVICE], batch.to(DEVICE),
                draw=lambda kind, shape: next(replay).to(DEVICE))
  for part, g, w in zip(("NELBO", "residual"), got, want):
    err = (g.cpu() - w).abs().max().item()
    scale = w.abs().max().item()
    worst = max(worst, err / scale)
    log(f"likelihood {name}: {part} bpd card {g.tolist()} cpu {w.tolist()}")
    if not (torch.isfinite(g).all() and err <= FORWARD_REL_TOL * scale):
      raise AssertionError(f"{name}: the {part} disagrees with the CPU: "
                           f"{err} vs {scale}")
  return worst


def phase_likelihood(name, path, workdir, sites, fir_sites, config01,
                     params):
  """The fourth main path: ``soft_truncation_tpu_torch.main --mode eval``
  on a published config in the train phase's workdir (its rolling
  checkpoint's EMA weights), the Synthetic images, batch
  LIKELIHOOD_BATCH, one NELBO and one exact-NLL batch at the published ODE
  tolerances (rtol = atol = 1e-5, 'correct' mode with the residual). The
  log's eval loss, NELBO and NLL bpd must be finite. Over the NLL batch
  (the counts read before and after it) every fused site launches the
  kernel for the primal and its tangent mode for the tangent once per
  function evaluation, plus the residual's forward once; every FIR site
  fir2 the same way. Then the card-vs-CPU check of the likelihood's
  functions with phase 3's weights. Removes the workdir. Returns the
  whole run's tangent launches per shape, the function evaluations (the
  NLL's nfe plus the NELBO's one jvp) and a summary."""
  import re
  import shutil

  import torch
  from soft_truncation_tpu_torch import main as port_main
  from soft_truncation_tpu_torch import run_lib

  argv = ["--config", path, "--workdir", workdir, "--mode", "eval",
          "--config.data.dataset", "Synthetic",
          "--config.eval.enable_bpd=True", "--config.eval.nelbo_iter", "1",
          "--config.eval.nll_iter", "1",
          "--config.eval.batch_size", str(LIKELIHOOD_BATCH)]
  if DEVICE == "cpu":  # a run on the host, without the card
    argv.append("--cpu")
  windows, get = [], run_lib.get_likelihood_fn

  def counted(*args, **kwargs):
    nll_fn = get(*args, **kwargs)

    def run(*a, **k):
      torch.cuda.synchronize()
      before = _all_launch_counts()
      out = nll_fn(*a, **k)
      torch.cuda.synchronize()
      windows.append((out[2], [after - b for after, b in
                               zip(_all_launch_counts(), before)]))
      return out

    return run

  run_lib.get_likelihood_fn = counted
  try:
    _reset_launch_counts()
    t0 = time.perf_counter()
    port_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gn_all, fir_all, gn_jvp_all, fir_jvp_all = _all_launch_counts()
    with open(os.path.join(workdir, "evaluation_history.txt")) as f:
      text = f.read()
  finally:
    run_lib.get_likelihood_fn = get
    shutil.rmtree(workdir, ignore_errors=True)
  loss = re.search(r"eval loss: mean (\S+) std (\S+) over (\d+)", text)
  nelbo = re.search(r"nelbo batch 0: mean (\S+) std (\S+)", text)
  nll = re.search(r"nll batch 0: mean (\S+) std (\S+) \(nfe (\d+), (\S+) "
                  r"s, (\S+) ms per function evaluation\)", text)
  if not (loss and nelbo and nll):
    raise AssertionError(f"{name}: the evaluation log lacks the eval loss, "
                         f"NELBO or NLL line:\n{text[-3000:]}")
  values = [float(v) for v in loss.groups()[:2] + nelbo.groups()
            + nll.groups()[:2]]
  if not all(math.isfinite(v) for v in values):
    raise AssertionError(f"{name}: a non-finite eval loss or bpd: {values}")
  if len(windows) != 1:
    raise AssertionError(f"{name}: {len(windows)} NLL batches, expected 1")
  nfe, (gn, fir_fwd, gn_jvp, fir_jvp) = windows[0]
  want = {s: k * (nfe + 1) for s, k in sites.items()}
  want_jvp = {s: k * nfe for s, k in sites.items()}
  want_fir = {s: k * (nfe + 1) for s, k in fir_sites.items()}
  want_fir_jvp = {s: k * nfe for s, k in fir_sites.items()}
  for what, got, expected in (("gn_silu_conv3x3", gn, want),
                              ("gn_silu_conv3x3 tangent", gn_jvp, want_jvp),
                              ("fir2", fir_fwd, want_fir),
                              ("fir2 tangent", fir_jvp, want_fir_jvp)):
    if dict(+got) != expected:
      raise AssertionError(f"{name}: {what} launches per shape over the NLL "
                           f"batch (nfe {nfe}) {dict(got)}, expected "
                           f"{expected}: sites x function evaluations (+1 "
                           f"for the residual's forward)")
  worst = _ode_and_elbo_card_vs_cpu(name, config01, params)
  nll_wall = float(nll.group(4))
  summary = {"likelihood": name, "batch": LIKELIHOOD_BATCH, "nfe": nfe,
             "nll_bpd_mean": values[4], "nll_bpd_std": values[5],
             "nelbo_bpd_mean": values[2], "eval_loss_mean": values[0],
             "nll_wall_s": nll_wall,
             "ms_per_function_evaluation": float(nll.group(5)),
             "cli_wall_s": wall,
             "launches": {"gn_silu_conv3x3": sum(gn_all.values()),
                          "gn_silu_conv3x3_jvp": sum(gn_jvp_all.values()),
                          "fir2": sum(fir_all.values()),
                          "fir2_jvp": sum(fir_jvp_all.values())},
             "card_vs_cpu_worst_rel": worst}
  emit(summary)
  # the NELBO's jvp is one function evaluation more
  return dict(gn_jvp_all), dict(fir_jvp_all), nfe + 1, summary


def _fid_log_metrics(text):
  """The metrics of the evaluation log's last ``ckpt-<step> metrics`` line."""
  import ast
  import re
  found = re.findall(r"ckpt-\d+ metrics: (\{.*\})", text)
  if not found:
    raise AssertionError(f"the evaluation log has no metrics line:\n"
                         f"{text[-3000:]}")
  return ast.literal_eval(found[-1])


def phase_fid(workdir, sites):
  """The fifth main path: FID, KID and IS of the flagship's EMA weights in
  phase 7's workdir through ``soft_truncation_tpu_torch.main --mode eval``
  (``eval.enable_sampling``, dpm_solver with FID_DPM_STEPS steps, shards of
  FID_SHARD, FID_SAMPLES samples, the Inception on the card with the
  'device' resize), against an assetdir written here: random Inception
  weights (``random_params``) and the pool_3 of the Synthetic test split's
  first FID_SAMPLES images. Checks finite metrics in the log and the
  report, the shards, caches and grids, the fused sites' launches per
  shape (sites x the sampler's evaluations) and no autograd.Function; a
  second run in the same directory loads everything, launches no kernel
  and reports the same metrics bit for bit; then the card's resize and
  Inception against the CPU's on FID_CHECK_IMAGES samples. Returns the
  kernel's launches per shape, the sampler's evaluations and a summary."""
  import glob
  import importlib

  import numpy as np
  import scipy
  import torch
  from soft_truncation_tpu_torch import main as port_main
  from soft_truncation_tpu_torch import run_lib
  from soft_truncation_tpu_torch.data import datasets
  from soft_truncation_tpu_torch.eval import evaluation, inception, inception_v3

  t_phase = time.perf_counter()
  try:
    pil = importlib.import_module("PIL").__version__
  except ImportError:
    pil = "not installed (PNG grids and the 'host' resize need it)"
  log(f"fid: scipy {scipy.__version__}, Pillow {pil}")
  assetdir = os.path.join(workdir, "fid_assets")
  os.makedirs(assetdir, exist_ok=True)
  weights = os.path.join(assetdir, inception.WEIGHTS_FILE)
  inception_v3.save_params_npz(inception_v3.random_params(seed=0), weights)
  config = load_config(FLAGSHIP)
  real = datasets.synthetic_array(config, "test")[:FID_SAMPLES]
  extractor = inception.InceptionExtractor(weights, INCEPTION_BATCH,
                                           resize_mode="device",
                                           device=DEVICE)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  real_feats, _ = extractor(real)
  featurise_s = time.perf_counter() - t0
  np.savez(os.path.join(assetdir, "cifar10_stats.npz"), pool_3=real_feats)

  argv = ["--config", FLAGSHIP, "--workdir", workdir, "--mode", "eval",
          "--assetdir", assetdir, "--eval_folder", "fid",
          "--config.eval.enable_sampling=True",
          "--config.eval.enable_bpd=False", "--config.eval.enable_loss=False",
          "--config.sampling.method", "dpm_solver",
          "--config.sampling.dpm_steps", str(FID_DPM_STEPS),
          "--config.sampling.batch_size", str(FID_SHARD),
          "--config.eval.num_samples", str(FID_SAMPLES),
          "--config.tpu.fid_resize", "device"]
  if DEVICE == "cpu":  # a run on the host, without the card
    argv.append("--cpu")
  shards, host_s = [], {}
  get_sampling_fn = run_lib.get_sampling_fn

  def counted(*args, **kwargs):
    sampler = get_sampling_fn(*args, **kwargs)

    def run(*a, **k):  # CUDA events around each shard's sampling
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      out = sampler(*a, **k)
      end.record()
      shards.append((out[1], start, end))
      return out

    return run

  def host_timed(name, fn):
    def run(*a, **k):
      t0 = time.perf_counter()
      out = fn(*a, **k)
      host_s[name] = host_s.get(name, 0.0) + time.perf_counter() - t0
      return out
    return run

  patched = {"frechet_distance": evaluation.frechet_distance,
             "kernel_distance": evaluation.kernel_distance}
  history = os.path.join(workdir, "evaluation_history.txt")
  reports = []
  try:
    run_lib.get_sampling_fn = counted
    for name, fn in patched.items():
      setattr(evaluation, name, host_timed(name, fn))
    walls = []
    for attempt in range(2):
      # TF32 on, not this script's setting: the CLI must set its own
      torch.backends.cudnn.allow_tf32 = True
      torch.backends.cuda.matmul.allow_tf32 = True
      _reset_launch_counts()
      with _FunctionApplies() as applies:
        t0 = time.perf_counter()
        port_main.main(argv)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
      if (torch.backends.cudnn.allow_tf32
          or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the eval CLI left TF32 on: its Inception and "
                             "convolutions must run in float32")
      launched, fir_launched = _launch_counts()
      with open(history) as f:
        logged = _fid_log_metrics(f.read())
      (shard_dir,) = glob.glob(os.path.join(workdir, "fid", "ckpt_*"))
      with np.load(os.path.join(shard_dir, "report_metrics.npz")) as f:
        reports.append({k: float(f[k]) for k in f.files})
      if attempt == 0:
        first = (dict(launched), fir_launched, applies.count, dict(host_s))
  finally:
    run_lib.get_sampling_fn = get_sampling_fn
    for name, fn in patched.items():
      setattr(evaluation, name, fn)

  launched, fir_launched, applies, host_s = first
  rounds = -(-FID_SAMPLES // FID_SHARD)
  evals = sum(nfe for nfe, _, _ in shards)
  files = sorted(os.listdir(shard_dir))
  want_files = sorted([f"samples_{r}.npz" for r in range(rounds)]
                      + [f"samples_{r}.png" for r in range(rounds)]
                      + [f"statistics_{r}.npz" for r in range(rounds)]
                      + ["report_metrics.npz"])
  log(f"fid: {shard_dir}: {files}; first run {reports[0]}, second run "
      f"{reports[1]}, log {logged}")
  if set(reports[0]) != {"fid", "kid", "inception_score"} or not all(
      math.isfinite(v) for v in reports[0].values()):
    raise AssertionError(f"FID, KID and IS must all be finite: "
                         f"{reports[0]}")
  if logged != reports[1] or reports[1] != reports[0]:
    raise AssertionError(f"the resumed run's metrics {reports[1]} (log "
                         f"{logged}) differ from the first run's "
                         f"{reports[0]}")
  if files != want_files:
    raise AssertionError(f"shard directory holds {files}, expected "
                         f"{want_files}")
  if len(shards) != rounds or evals != rounds * (FID_DPM_STEPS + 1):
    raise AssertionError(f"{len(shards)} shards sampled with {evals} "
                         f"evaluations, expected {rounds} x "
                         f"{FID_DPM_STEPS + 1}")
  want = {s: k * evals for s, k in sites.items()}
  if launched != want or fir_launched or applies:
    raise AssertionError(f"gn_silu_conv3x3 launches per shape {launched}, "
                         f"expected {want} (sites x {evals} evaluations); "
                         f"fir2 {fir_launched}; {applies} autograd.Function "
                         f"applications")
  second, second_fir = _launch_counts()
  if second or second_fir:
    raise AssertionError(f"the resumed run launched {second} {second_fir}")

  # card vs CPU on the first shard's images: the resize, then the network
  with np.load(os.path.join(shard_dir, "samples_0.npz")) as f:
    images = torch.from_numpy(f["samples"][:FID_CHECK_IMAGES])
  size = inception.INCEPTION_DEFAULT_IMAGE_SIZE
  x = images.permute(0, 3, 1, 2).float()
  cpu_x = inception.resize(x, size, size, "cubic")
  card_x = inception.resize(x.to(DEVICE), size, size, "cubic")
  resize_err, resize_scale = _held("the cubic resize", tuple(x.shape),
                                   card_x.cpu(), cpu_x, KERNEL_REL_TOL)
  cpu_model = inception_v3.load_params_npz(weights)
  worst = {}
  with torch.inference_mode():
    for part, got, want_ in zip(("pool3", "probs"), extractor.model(
        cpu_x.to(DEVICE)), cpu_model(cpu_x)):
      err, scale = _held(f"the Inception's {part}", tuple(cpu_x.shape),
                         got.cpu(), want_, KERNEL_REL_TOL)
      worst[part] = err / scale

    # throughput: the forward at INCEPTION_BATCH apart from the resize
    u8 = torch.randint(0, 256, (INCEPTION_BATCH, 3, 32, 32),
                       dtype=torch.uint8, device=DEVICE)
    x299 = inception.resize(u8.float(), size, size, "cubic")
    forward_ms = time_ms(lambda: extractor.model(x299), iters=5, warmup=2)
    resize_ms = time_ms(lambda: inception.resize(u8.float(), size, size,
                                                 "cubic"), iters=5, warmup=2)
  sample_ms = [a.elapsed_time(b) for _, a, b in shards]
  # where one of the sampler's evaluations spends its time at the shard's
  # batch: the score network's eval forward, traced
  from soft_truncation_tpu_torch.models import create_model
  model = create_model(load_config(FLAGSHIP, init_scale=0.1), DEVICE, seed=0)
  xs = torch.randn(FID_SHARD, 32, 32, 3, device=DEVICE)
  labels = torch.full((FID_SHARD,), 0.5 * 999.0, device=DEVICE)
  with torch.inference_mode():
    trace = _traced(f"flagship eval forward at batch {FID_SHARD}",
                    lambda: model(xs, labels), FID_SHARD)
  del model
  summary = {"fid_eval": "flagship", "samples": FID_SAMPLES,
             "shard": FID_SHARD, "dpm_steps": FID_DPM_STEPS,
             "evaluations": evals, "metrics": reports[0],
             "sampling_ms_per_shard": sample_ms,
             "sampling_imgs_per_s": FID_SAMPLES / sum(sample_ms) * 1e3,
             "sampling_ms_per_evaluation": sum(sample_ms) / evals,
             "traced_forward_wall_ms": trace["wall_ms_per_call"],
             "traced_forward_device_busy_share":
                 trace["device_busy_share"],
             "featurise_imgs_per_s": FID_SAMPLES / featurise_s,
             "inception_forward_ms_per_batch": forward_ms,
             "resize_ms_per_batch": resize_ms,
             "inception_batch": INCEPTION_BATCH,
             "sqrtm_fid_host_s": host_s.get("frechet_distance"),
             "kid_host_s": host_s.get("kernel_distance"),
             "cli_wall_s": walls, "phase_wall_s": time.perf_counter()
             - t_phase, "card_vs_cpu_rel": dict(worst, resize=resize_err
                                                / resize_scale),
             "launches": {"gn_silu_conv3x3": sum(launched.values())}}
  emit(summary)
  log(f"fid: {device_line()}")
  return launched, evals, summary


# --- the legacy networks and the fp8 knob (phases 9a-9f) ---------------------


def legacy_config(key, size=None, **model_overrides):
  """A legacy configuration at the widths of its public config in
  yang-song/score_sde_pytorch (no such file is in either package): the
  flagship's config file with LEGACY[key]'s values over it, then ``size``
  (data.image_size) and ``model_overrides``."""
  config = load_config(FLAGSHIP)
  for section, values in LEGACY[key].items():
    config[section].update(values)
  config.model.update(model_overrides)
  if size is not None:
    config.data.image_size = size
  return config


def legacy_flags(name):
  """LEGACY[name] as the CLI's ``--config.<section>.<key>=<value>``."""
  return [f"--config.{section}.{key}="
          + (value if isinstance(value, str) else repr(value))
          for section, values in LEGACY[name].items()
          for key, value in values.items()]


def _with_signal(model, seed=5):
  """Give the zero-init convs (``init_scale`` 0: 1e-10 weights) N(0, 0.02)
  weights, so that every layer carries signal; returns the state_dict."""
  import torch
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for p in model.parameters():
      if p.dim() > 1 and p.abs().max() < 1e-6:
        p.normal_(0.0, 0.02, generator=gen)
  return model.state_dict()


def _no_launches(name):
  """The legacy networks run no fused site and no FIR resample: JAX runs
  their blocks as plain XLA. Fails if either kernel was launched."""
  launched, fir_launched = _launch_counts()
  if launched or fir_launched or _backward_launch_counts():
    raise AssertionError(f"{name}: a legacy path launched a kernel: "
                         f"{launched} {fir_launched}")


def phase_legacy_forward(name, config, labels, trace=False):
  """A legacy network at full width on the card and on a CPU copy with the
  same weights (every conv with signal): agreement per sample within
  FORWARD_REL_TOL, no kernel launched, ms per forward (CUDA events); with
  ``trace``, where its time goes (``_traced``). Returns the weights."""
  import torch
  from soft_truncation_tpu_torch.models import create_model

  size, batch = config.data.image_size, len(labels)
  cpu_model = create_model(config, "cpu", seed=0)
  weights = _with_signal(cpu_model)
  gpu_model = create_model(config, DEVICE, seed=0)
  gpu_model.load_state_dict(weights)
  gen = torch.Generator("cpu").manual_seed(1)
  x = torch.rand(batch, size, size, 3, generator=gen)
  labels = torch.tensor(labels)
  xd, ld = x.to(DEVICE), labels.to(DEVICE)
  with torch.inference_mode():
    want = cpu_model(x, labels)
    _reset_launch_counts()
    got = gpu_model(xd, ld)
    torch.cuda.synchronize()
    _no_launches(name)
    ms = time_ms(lambda: gpu_model(xd, ld), iters=10, warmup=2)
    if trace:
      _traced(f"{name} eval forward", lambda: gpu_model(xd, ld), batch)
  err = (got.cpu() - want).abs().flatten(1).amax(1)
  scale = want.abs().flatten(1).amax(1)
  params = sum(p.numel() for p in cpu_model.parameters())
  emit({"legacy_forward": name, "batch": batch, "size": size,
        "parameters": params, "max_abs_diff": err.tolist(),
        "max_abs_out": scale.tolist(), "ms_per_forward": ms})
  log(f"forward {name} ({params} parameters) at {batch}x{size}^2: "
      f"{ms:.3f} ms per forward; per sample max_abs_diff {err.tolist()} "
      f"max|out| {scale.tolist()}")
  if not (torch.isfinite(got).all() and (err <= FORWARD_REL_TOL
                                         * scale).all()):
    raise AssertionError(f"{name}: card forward disagrees with CPU: "
                         f"{err.tolist()} vs {scale.tolist()}")
  return weights


def phase_serve_legacy(name, weights, steps, check_steps):
  """A legacy main path: the port's HTTP server answering the config's own
  'pc' (DDPM: ancestral sampling; NCSNv2: annealed Langevin) at N =
  ``steps`` at batch 8, once, with its wall and network evaluations (a
  hook counts them); no kernel launched. Then at N = ``check_steps``,
  batch 2, the same request twice, held against a CPU SamplingService
  from the same prior and noise."""
  from soft_truncation_tpu_torch.serve.server import SamplingService

  config = legacy_config(name, num_scales=steps)
  service = SamplingService(config, weights, batch=LEGACY_BATCH,
                            device=DEVICE)
  evals = [0]
  service.model.register_forward_pre_hook(
      lambda *_: evals.__setitem__(0, evals[0] + 1))
  walls = []

  def published(url):
    meta = _healthz(url)
    want = (config.sampling.predictor, config.sampling.corrector)
    if (meta["predictor"], meta["corrector"]) != want:
      raise AssertionError(f"/healthz names {meta}, not {want}")
    walls.extend(_serve_requests(url, [{"num": LEGACY_BATCH, "seed": 0}],
                                 config, repeat=1, batch=LEGACY_BATCH)[2][0])

  _reset_launch_counts()
  _serving(service, published)
  _no_launches(name)
  ms_eval = walls[0] / evals[0] * 1e3
  row = {"serve": name, "batch": LEGACY_BATCH, "method": "pc",
         "predictor": config.sampling.predictor,
         "corrector": config.sampling.corrector,
         "n_steps_each": config.sampling.n_steps_each, "steps": steps,
         "evaluations": evals[0], "request_wall_s": walls[0],
         "ms_per_evaluation": ms_eval}
  emit(row)
  log(f"serve {name}: pc N={steps} ({row['predictor']}, "
      f"{row['corrector']}) at batch {LEGACY_BATCH}: {evals[0]} evaluations "
      f"in {walls[0]:.3f} s, {ms_eval:.3f} ms per evaluation")
  check = legacy_config(name, num_scales=check_steps)
  service = SamplingService(check, weights, batch=CHECK_BATCH, device=DEVICE)
  req = {"num": CHECK_BATCH, "seed": 3}
  _reset_launch_counts()
  _, (served,), _ = _serving(service, lambda url: _serve_requests(
      url, [req], check, batch=CHECK_BATCH))
  _no_launches(name)
  _check_against_cpu(service, weights, served, req["seed"], "pc",
                     check_steps, batch=CHECK_BATCH)
  return row


def _cast_grid():
  """The values where float8 formats part: subnormals and their ties,
  447-481 (e4m3's 448, NaN past 464), e5m2's 57344-61440 (inf from 61440),
  f32 subnormals, +-inf, NaN, and a spread of magnitudes."""
  import numpy as np
  rng = np.random.default_rng(0)
  finite = np.concatenate([
      np.arange(0, 17) * 2.0 ** -10, np.arange(0, 17) * 2.0 ** -17,
      np.arange(447.0, 481.5, 0.25),
      [463.99, 464.01, 479.99, 1e4, 3e38, 1e-40, 2.0 ** -126],
      np.arange(57344.0, 61441.0, 128.0), [61439.99, 61440.01, 1e6],
      rng.standard_normal(4096) * 10.0 ** rng.uniform(-8, 5, 4096)])
  return np.concatenate([finite, -finite, [np.inf, -np.inf, np.nan]]).astype(
      np.float32)


def phase_fp8_casts():
  """fp8 (1): the e4m3 and e5m2 rounding on the card bit for bit against the
  CPU on ``_cast_grid`` (NaN's bits included); then ``fp8_conv`` (the
  quantized conv and its custom backward) on the card against the CPU on
  the same inputs at the full-width UNCSN++ conv shapes: the same values
  are rounded the same way, so the output, dx and dw agree to f32 sums
  (KERNEL_REL_TOL)."""
  import numpy as np
  import torch
  from soft_truncation_tpu_torch.ops import quant

  x = torch.from_numpy(_cast_grid())
  for name, fn in (("e4m3", quant.round_e4m3), ("e5m2", quant.round_e5m2)):
    want = fn(x).view(torch.int32).numpy()
    got = fn(x.to(DEVICE)).view(torch.int32).cpu().numpy()
    bad = np.flatnonzero(got != want)
    log(f"fp8 cast {name} on the card: {bad.size} of {x.numel()} values "
        f"differ from the CPU in their bits")
    if bad.size:
      raise AssertionError(f"{name}: card rounds {x[bad[:8]].tolist()} to "
                           f"bits {got[bad[:8]].tolist()}, the CPU "
                           f"{want[bad[:8]].tolist()}")
  gen = torch.Generator().manual_seed(3)
  for (n, h, c, o, k, stride) in FP8_CONV_SHAPES:
    xs = torch.randn(n, h, h, c, generator=gen) * 2.0
    w = torch.randn(o, c, k, k, generator=gen) / math.sqrt(c * k * k)
    padding = ((0, 1), (0, 1)) if stride == 2 else "SAME"
    outs = []
    for dev in ("cpu", DEVICE):
      xd = xs.detach().to(dev).requires_grad_()
      wd = w.detach().to(dev).requires_grad_()
      y = quant.fp8_conv(xd, wd, stride, padding)
      g = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
      y.backward(g.to(dev))
      outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    errs = []
    for part, got, want in zip(("y", "dx", "dw"), outs[1], outs[0]):
      err = (got - want).abs().max().item()
      scale = want.abs().max().item()
      errs.append(err / scale)
      if not (torch.isfinite(got).all() and err <= KERNEL_REL_TOL * scale):
        raise AssertionError(f"fp8_conv {part} at {(n, h, c, o, k, stride)}"
                             f": card {err} from the CPU, max {scale}")
    log(f"fp8_conv {(n, h, h, c)} -> {o}, {k}x{k} stride {stride}: card vs "
        f"CPU y / dx / dw within {errs} of their max")


def _global_grads(state):
  import torch
  return torch.cat([m.reshape(-1).cpu() for m in state.optimizer.mu])


def _perturbed(model, rel=FP8_PERTURB, seed=9):
  """``model`` with every parameter scaled by (1 + ``rel`` N(0, 1))."""
  import torch
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for p in model.parameters():
      p.mul_(1.0 + rel * torch.randn(p.shape, generator=gen).to(p.device))
  return model


def _within_spread(name, err, spread, scale):
  """fp8 card vs CPU: ``err`` within FP8_SPREAD x the CPU's own ``spread``
  plus FP8_FLOOR x ``scale``."""
  bound = FP8_SPREAD * spread + FP8_FLOOR * scale
  log(f"{name}: card vs CPU {err:.4g}, the CPU's spread {spread:.4g} (bound "
      f"{bound:.4g})")
  if not err <= bound:
    raise AssertionError(f"{name}: card vs CPU {err} beyond {FP8_SPREAD} x "
                         f"the CPU's spread {spread} + {FP8_FLOOR} x {scale}")


def phase_fp8_step(config):
  """fp8 (2, 3): one UNCSN++ train step with ``activation_dtype`` e4m3 at
  batch 2 on the card, on a CPU copy from the same weights and draws, and
  on a CPU copy whose weights differ by FP8_PERTURB: the card's losses and
  gradients (Adam's first moment, all tensors as one vector, in L2) within
  the CPU's own spread (``_within_spread``); fir2 12 forward and 12
  adjoint launches. Then FP8_STEPS timed steps at batch 128 in f32, fp8,
  fp8, f32 (CUDA events, after a warm-up step each): ms per step and peak
  memory, and fir2's launches per shape, 12 + 12 per step. Returns those
  launches, the steps and the batch."""
  import torch
  from soft_truncation_tpu_torch.data import get_data_scaler
  from soft_truncation_tpu_torch.losses import make_draw
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.sde import get_sde
  from soft_truncation_tpu_torch.train import init_train_state, make_train_step

  config.model.dropout, config.optim.warmup = 0.0, 0
  sde = get_sde(config)
  gen = torch.Generator().manual_seed(2)
  batch = get_data_scaler(config)(torch.rand(TRAIN_CHECK_BATCH, 32, 32, 3,
                                             generator=gen))
  record, replay = _recorded_draws(gen)
  step = make_train_step(config, sde)
  cpu_state = init_train_state(config, create_model(config, "cpu", seed=0))
  spread_state = init_train_state(
      config, _perturbed(create_model(config, "cpu", seed=0)))
  gpu_state = init_train_state(config, create_model(config, DEVICE, seed=0))
  want = step(cpu_state, batch, torch.Generator(), record)
  spread = step(spread_state, batch, torch.Generator(), replay("cpu"))
  _reset_launch_counts()
  got = step(gpu_state, batch.to(DEVICE), torch.Generator(DEVICE),
             replay(DEVICE))
  torch.cuda.synchronize()
  _, fir_fwd = _launch_counts()
  fir_bwd = _backward_launch_counts()
  g_cpu = _global_grads(cpu_state)
  log(f"fp8 train step uncsnpp: losses {want.tolist()}, card "
      f"{got.tolist()}, perturbed CPU {spread.tolist()}")
  if not torch.isfinite(got).all():
    raise AssertionError(f"fp8 step: card losses {got.tolist()}")
  scale = want.abs().max().item()
  _within_spread("fp8 step losses", (got.cpu() - want).abs().max().item(),
                 (spread - want).abs().max().item(), scale)
  _within_spread("fp8 step gradients (L2, relative)",
                 ((_global_grads(gpu_state) - g_cpu).norm()
                  / g_cpu.norm()).item(),
                 ((_global_grads(spread_state) - g_cpu).norm()
                  / g_cpu.norm()).item(), 1.0)
  if fir_fwd != UNCSNPP_FIR_SITES or fir_bwd != UNCSNPP_FIR_BWD_SITES:
    raise AssertionError(f"fp8 step: fir2 launches {fir_fwd} / {fir_bwd}")
  del cpu_state, spread_state, gpu_state

  scaler = get_data_scaler(config)
  big = scaler(torch.rand(TRAIN_BATCH, 32, 32, 3, generator=gen)).to(DEVICE)
  runs, fwd_total, bwd_total = [], collections.Counter(), collections.Counter()
  for dtype in ("", "float8_e4m3", "float8_e4m3", ""):
    config.tpu.activation_dtype = dtype
    state = init_train_state(config, create_model(config, DEVICE, seed=0))
    train_step = make_train_step(config, sde)
    dgen = torch.Generator(DEVICE).manual_seed(0)
    draw = make_draw(dgen, DEVICE)
    train_step(state, big, dgen, draw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    events = []
    for _ in range(FP8_STEPS):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      losses = train_step(state, big, dgen, draw)
      end.record()
      events.append((start, end))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated()
    _, fwd = _launch_counts()
    bwd = _backward_launch_counts()
    if not torch.isfinite(losses).all():
      raise AssertionError(f"{dtype or 'f32'} steps: a loss is not finite")
    want_fwd = {s: k * FP8_STEPS for s, k in UNCSNPP_FIR_SITES.items()}
    want_bwd = {s: k * FP8_STEPS for s, k in UNCSNPP_FIR_BWD_SITES.items()}
    if fwd != want_fwd or bwd != want_bwd:
      raise AssertionError(f"{dtype or 'f32'} steps: fir2 launches {fwd} / "
                           f"{bwd}, expected {want_fwd} / {want_bwd}")
    if dtype:
      fwd_total.update(fwd)
      bwd_total.update(bwd)
    runs.append({"activation_dtype": dtype or "float32",
                 "ms_per_step": sum(ms) / len(ms), "ms_each_step": ms,
                 "peak_memory_bytes": peak})
    del state, train_step, losses
    gc.collect()
    torch.cuda.empty_cache()
  config.tpu.activation_dtype = "float8_e4m3"
  emit({"fp8_train": "uncsnpp", "batch": TRAIN_BATCH, "steps": FP8_STEPS,
        "runs": runs})
  for r in runs:
    log(f"train uncsnpp {r['activation_dtype']}: {r['ms_per_step']:.1f} ms "
        f"per step at batch {TRAIN_BATCH}, peak {r['peak_memory_bytes']} "
        "bytes")
  return dict(fwd_total), dict(bwd_total), 2 * FP8_STEPS


def phase_fp8_forward(sites):
  """fp8 (4): the flagship's eval forward at batch 8 with ``activation_dtype``
  e4m3 on the card and on a CPU copy: gn_silu_conv3x3 launched once at
  each of the f32 forward's 82 fused sites (they run unquantized, as in
  JAX); the card's output within the CPU's own spread of the CPU's in L2
  (``_within_spread``, against a CPU copy whose weights differ by
  FP8_PERTURB); and quantized: over 1 % in L2 from the card's f32 forward
  of the same weights. Returns the launches per shape."""
  import torch
  from soft_truncation_tpu_torch.models import create_model

  config = load_config(FLAGSHIP, init_scale=0.1)
  config.tpu.activation_dtype = "float8_e4m3"
  cpu_model = create_model(config, "cpu", seed=0)
  spread_model = _perturbed(create_model(config, "cpu", seed=0))
  gpu_model = create_model(config, DEVICE, seed=0)
  f32_model = create_model(load_config(FLAGSHIP, init_scale=0.1), DEVICE,
                           seed=0)
  gen = torch.Generator("cpu").manual_seed(1)
  x = torch.randn(SERVE_BATCH, 32, 32, 3, generator=gen)
  labels = torch.linspace(0.01, 0.99, SERVE_BATCH) * 999.0
  with torch.inference_mode():
    want = cpu_model(x, labels)
    spread = spread_model(x, labels)
    _reset_launch_counts()
    got = gpu_model(x.to(DEVICE), labels.to(DEVICE))
    torch.cuda.synchronize()
    launched, fir_launched = _launch_counts()
    f32 = f32_model(x.to(DEVICE), labels.to(DEVICE)).cpu()
  got = got.cpu()

  def l2(a, b):
    return ((a - b).norm() / b.norm()).item()

  err, quantized = l2(got, want), l2(got, f32)
  emit({"fp8_forward": "flagship", "batch": SERVE_BATCH,
        "fused_launches": sum(launched.values()),
        "l2_rel_card_vs_cpu": err, "l2_rel_cpu_spread": l2(spread, want),
        "l2_rel_fp8_vs_f32": quantized})
  log(f"fp8 forward flagship: {sum(launched.values())} gn_silu_conv3x3 "
      f"launches; fp8 vs f32 {quantized:.4g} in L2")
  if launched != sites or fir_launched:
    raise AssertionError(f"fp8 forward: launches per shape {launched}, "
                         f"expected the f32 forward's {sites}")
  if not torch.isfinite(got).all():
    raise AssertionError("fp8 forward: the card's output is not finite")
  _within_spread("fp8 forward (L2, relative)", err, l2(spread, want), 1.0)
  if not quantized > 0.01:
    raise AssertionError(f"fp8 forward: not apart from f32: "
                         f"{quantized.tolist()}")
  return launched


# --- slice 6c: Picard, DDP, the profiler, remat, FFHQ 1024^2 (phase 10) ------


def _timed_call(fn):
  """``fn()`` and its wall in seconds, between two synchronisations."""
  import torch
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, time.perf_counter() - t0


def _check_launches(name, calls, sites, fir_sites):
  """Each kernel launched once per site per network call, every call at
  its shapes: the fused sites of the batch-8 forward fuse at W*B too."""
  launched, fir_launched = _launch_counts()
  want = {s: k * calls for s, k in sites.items()}
  want_fir = {s: k * calls for s, k in fir_sites.items()}
  if launched != want or fir_launched != want_fir:
    raise AssertionError(f"{name}: launches per shape gn_silu_conv3x3 "
                         f"{launched}, fir2 {fir_launched}; expected the "
                         f"sites x {calls} network calls: {want}, "
                         f"{want_fir}")
  return launched, fir_launched


def phase_picard_flagship(sites, params):
  """10a: 'picard_dpm' on the flagship (phase-3 weights) at its DPM steps
  N, window N (one block): each sweep one network call at batch N * 8.
  tol = 0 against the sequential 'dpm_solver' from the same prior; tol =
  PICARD_TOL with its sweeps, nfe and wall against the sequential wall;
  then served over HTTP twice per seed (PICARD_SERVED_STEPS steps). Returns the fused launches made at
  batch N * 8 and the network calls that made them, and N * 8."""
  import copy

  import torch
  from soft_truncation_tpu_torch.data import get_data_inverse_scaler
  from soft_truncation_tpu_torch.sample import get_sampling_fn
  from soft_truncation_tpu_torch.serve.server import SamplingService

  config = load_config(FLAGSHIP, init_scale=0.1)
  config.sampling.picard_window = 0  # one block, served too
  service = SamplingService(config, params, batch=SERVE_BATCH, device=DEVICE)
  steps = config.sampling.dpm_steps
  prior = service.prior(0, 0)
  sequential = service.sampler("dpm_solver", steps)

  def picard(tol, max_sweeps=0):
    c = copy.deepcopy(config)
    c.sampling.update(method="picard_dpm", picard_tol=tol, picard_window=0,
                      picard_max_sweeps=max_sweeps)
    return get_sampling_fn(c, service.sde, service.shape,
                           get_data_inverse_scaler(c),
                           c.sampling.truncation_time)

  sequential(service.model, x=prior)  # warm-up
  (want, seq_nfe), seq_wall = _timed_call(
      lambda: sequential(service.model, x=prior))
  exact, fast = picard(0.0), picard(PICARD_TOL)
  picard(0.0, max_sweeps=1)(service.model, x=prior)  # warm-up at N * 8
  rows = {}
  for tol, fn in ((0.0, exact), (PICARD_TOL, fast)):
    _reset_launch_counts()
    (got, nfe), wall = _timed_call(lambda: fn(service.model, x=prior))
    sweeps = fn.last_sweeps
    _check_launches(f"picard_dpm tol {tol}", sweeps + 1, sites, {})
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    row = {"picard": "flagship", "method": "picard_dpm", "tol": tol,
           "steps": steps, "window": steps, "batch": SERVE_BATCH,
           "network_batch": steps * SERVE_BATCH, "sweeps": sweeps, "nfe": nfe,
           "wall_s": wall, "ms_per_sweep": wall / sweeps * 1e3,
           "sequential_nfe": seq_nfe, "sequential_wall_s": seq_wall,
           "speedup_over_sequential": seq_wall / wall,
           "max_abs_diff_vs_sequential": err, "max_abs_sequential": scale}
    emit(row)
    rows[tol] = row
    if not torch.isfinite(got).all():
      raise AssertionError(f"picard_dpm tol {tol}: samples not finite")
  if not (rows[0.0]["max_abs_diff_vs_sequential"]
          <= PICARD_FLAGSHIP_REL_TOL * rows[0.0]["max_abs_sequential"]):
    raise AssertionError(f"picard_dpm at tol 0 is not the sequential "
                         f"sample: {rows[0.0]}")
  if rows[0.0]["nfe"] != rows[0.0]["sweeps"] * steps + 1:
    raise AssertionError(f"picard_dpm nfe {rows[0.0]['nfe']} is not sweeps "
                         f"x N + 1")
  _reset_launch_counts()
  req = {"num": SERVE_BATCH, "seed": 5, "method": "picard_dpm",
         "dpm_steps": PICARD_SERVED_STEPS}
  _serving(service, lambda url: _serve_requests(url, [req], config))
  served_sweeps = service.sampler("picard_dpm",
                                  PICARD_SERVED_STEPS).last_sweeps
  _check_launches("picard_dpm served", 2 * (served_sweeps + 1), sites, {})
  calls = rows[0.0]["sweeps"] + rows[PICARD_TOL]["sweeps"]
  return {s: k * calls for s, k in sites.items()}, calls, steps * SERVE_BATCH


def phase_picard_uncsnpp(sites, fir_sites, params):
  """10b: 'picard' on UNCSN++ (phase-3 weights; reverse diffusion and
  Langevin, RVE) at tol = 0 on a chain cut to N = PICARD_UNCSNPP_STEPS,
  window PICARD_UNCSNPP_WINDOW, against the sequential 'pc' from the same
  prior and noise generator: each sweep two network calls at batch W * 8,
  each launching gn_silu_conv3x3 at every fused site and fir2 at every FIR
  site. Returns both kernels' launches at batch W * 8, the calls and W * 8."""
  import torch
  from soft_truncation_tpu_torch.serve.server import SamplingService

  config = load_config(UNCSNPP, init_scale=0.1,
                       num_scales=PICARD_UNCSNPP_STEPS)
  config.sampling.update(picard_window=PICARD_UNCSNPP_WINDOW, picard_tol=0.0)
  service = SamplingService(config, params, batch=SERVE_BATCH, device=DEVICE)
  prior = service.prior(0, 0)
  sequential = service.sampler("pc", None)
  picard = service.sampler("picard", None)
  (want, seq_nfe), seq_wall = _timed_call(
      lambda: sequential(service.model, service.noise(0, 0), x=prior))
  _reset_launch_counts()
  (got, nfe), wall = _timed_call(
      lambda: picard(service.model, service.noise(0, 0), x=prior))
  sweeps = picard.last_sweeps
  calls = 2 * sweeps  # the corrector's and the predictor's evaluation
  launched, fir_launched = _check_launches("picard uncsnpp", calls + 1,
                                           sites, fir_sites)
  err = (got - want).abs().max().item()
  scale = want.abs().max().item()
  row = {"picard": "uncsnpp", "method": "picard", "tol": 0.0,
         "steps": PICARD_UNCSNPP_STEPS, "published_steps": PC_PUBLISHED_STEPS,
         "window": PICARD_UNCSNPP_WINDOW, "batch": SERVE_BATCH,
         "network_batch": PICARD_UNCSNPP_WINDOW * SERVE_BATCH,
         "sweeps": sweeps, "nfe": nfe, "wall_s": wall,
         "ms_per_sweep": wall / sweeps * 1e3, "sequential_nfe": seq_nfe,
         "sequential_wall_s": seq_wall,
         "gn_silu_conv3x3_launches_per_sweep":
             2 * sum(sites.values()),
         "fir2_launches_per_sweep": 2 * sum(fir_sites.values()),
         "fused_sites": sum(sites.values()),
         "fir_sites": sum(fir_sites.values()),
         "max_abs_diff_vs_sequential": err, "max_abs_sequential": scale}
  emit(row)
  if not (torch.isfinite(got).all() and err <= PICARD_UNCSNPP_REL_TOL * scale):
    raise AssertionError(f"picard at tol 0 is not the sequential 'pc' "
                         f"sample: {err} vs {scale}")
  if nfe != sweeps * PICARD_UNCSNPP_WINDOW * 2:
    raise AssertionError(f"picard nfe {nfe} is not sweeps x W x 2")
  return ({s: k * calls for s, k in sites.items()},
          {s: k * calls for s, k in fir_sites.items()}, calls,
          PICARD_UNCSNPP_WINDOW * SERVE_BATCH)


def _ddp_runs(specs):
  """The flagship's CLI trainer under each ``(name, launcher, flags)`` of
  ``specs`` (a command prefix and its ``--config.*`` arguments), each in
  its own workdir, all at once; returns name -> (workdir, wall, output).
  The processes are waited for, and killed if they outlive the phase."""
  env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
             + os.environ.get("PYTHONPATH", ""))
  procs = {}
  try:
    for name, launcher, flags in specs:
      workdir = os.path.join(REPO, "build", "chip_smoke_ddp", name)
      shutil.rmtree(workdir, ignore_errors=True)
      cmd = launcher + ["soft_truncation_tpu_torch.main", "--config",
                        FLAGSHIP, "--workdir", workdir, "--mode", "train",
                        *flags]
      procs[name] = (workdir, time.perf_counter(), subprocess.Popen(
          cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
          stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (workdir, t0, proc) in procs.items():
      output = proc.communicate(timeout=900)[0]
      out[name] = (workdir, time.perf_counter() - t0, output)
      if proc.returncode != 0:
        raise AssertionError(f"ddp {name}: exit {proc.returncode}\n"
                             f"{output[-3000:]}")
    return out
  finally:
    for _, _, proc in procs.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()


def phase_ddp(extra_flags=()):
  """10c: data parallelism. The flagship's CLI trainer (as published but
  for no warmup, so that the step moves the parameters, and init_scale
  0.1, so that every conv carries signal, as in phase 6) at the global
  batch 128 on Synthetic data, one step: alone; on two gloo ranks of 64 on
  the one card (``torch.distributed.run --nproc_per_node 2``; NCCL refuses
  two ranks on one device, so the port picks gloo); on one NCCL rank
  (world size 1). Each launched run's step against the lone run's, held
  to phase 6's bars for the same step in another reduction order (the
  ranks' batch sums are reassociated, and cuDNN picks its algorithms by
  batch): the gradients (Adam's first moment) within FORWARD_REL_TOL of
  each tensor's largest, and each parameter's move (and the EMA's) within
  PARAM_MOVE_TOL x lr where the gradient is above FORWARD_REL_TOL of that
  largest (Adam's first update lr * g / (|g| + eps) turns a near-zero
  gradient's rounding into a move of up to lr). Beside them the row gives
  the errors against DDP_REL_TOL of each tensor's largest, the bar asked
  for first (not met on the card: ``PERF.md``). Then the two gloo ranks
  for steps 0..DDP_TIMED_ITERS: the host's ms per step after the first,
  from the  log. ``extra_flags``: more ``--config.*`` arguments (a rehearsal's
  cuts)."""
  import torch

  flags = ["--config.data.dataset", "Synthetic", *extra_flags,
           "--config.model.init_scale", "0.1",
           "--config.training.log_freq", "1",
           "--config.training.snapshot_freq", "1000000",
           "--config.training.snapshot_freq_for_preemption", "1000000",
           "--config.optim.warmup", "0"]
  if DEVICE == "cpu":  # a run on the host, without the card
    flags.append("--cpu")
  one_step = flags + ["--config.training.n_iters", "0"]
  run = [sys.executable, "-m"]
  torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
  gloo_2 = torchrun + ["--nproc_per_node", "2", "-m"]
  # the three one-step runs side by side (~35 GB of the card), then the
  # timed run alone
  runs = _ddp_runs([("alone", run, one_step), ("gloo_2", gloo_2, one_step),
                    ("nccl_1", torchrun + ["--nproc_per_node", "1", "-m"],
                     one_step)])
  runs.update(_ddp_runs([("gloo_2_timed", gloo_2, flags + [
      "--config.training.n_iters", str(DDP_TIMED_ITERS)])]))
  line = re.compile(r"step: (\d+), training loss mean: (\S+), .*\((\S+) "
                    r"steps/s")

  def logged(name):
    with open(os.path.join(runs[name][0], "stdout.txt")) as f:
      return [m.groups() for m in map(line.search, f) if m]

  def state(name):
    path = os.path.join(runs[name][0], "checkpoints", "checkpoint_0")
    return torch.load(path, map_location="cpu", weights_only=True)

  want = state("alone")
  want_mu = want["optimizer"]["mu"]
  floor = 1e-6 * max(m.abs().max().item() for m in want_mu)
  names = list(want["model"])
  lr = load_config(FLAGSHIP).optim.lr
  # on the host (a rehearsal) every process group is gloo's
  for name, backend in (("gloo_2", "gloo"),
                        ("nccl_1", "nccl" if DEVICE == "cuda" else "gloo")):
    got = state(name)
    output = runs[name][2]
    if f"process group: {backend}" not in output:
      raise AssertionError(f"ddp {name}: no '{backend}' process group in "
                           f"its log:\n{output[-2000:]}")
    grad_err = move_err = param_rel_err = 0.0
    kept = 0
    for i, (m_got, m_want) in enumerate(zip(got["optimizer"]["mu"], want_mu)):
      # each tensor's largest gradient, floored at 1e-6 of the largest of
      # all (the attention's key biases take none: theirs is rounding)
      g_scale = max(m_want.abs().max().item(), floor)
      grad_err = max(grad_err, (m_got - m_want).abs().max().item() / g_scale)
      keep = m_want.abs() > FORWARD_REL_TOL * g_scale
      kept += int(keep.sum())
      for part in ("model", "ema"):
        w, g = want[part][names[i]], got[part][names[i]]
        if keep.any():
          diff = (g - w)[keep].abs().max().item()
          move_err = max(move_err, diff)
          param_rel_err = max(param_rel_err,
                              diff / max(w.abs().max().item(), 1e-30))
    row = {"ddp": name, "backend": backend, "global_batch": TRAIN_BATCH,
           "ranks": 2 if name == "gloo_2" else 1, "steps": 1,
           "grad_max_rel_err": grad_err, "move_max_abs_err": move_err,
           "move_max_err_in_lr": move_err / lr,
           "param_max_rel_err": param_rel_err, "first_bar": DDP_REL_TOL,
           "params_held": kept,
           "params": sum(m.numel() for m in want_mu),
           "loss_vs_alone": [float(logged(name)[0][1]),
                             float(logged("alone")[0][1])],
           "run_wall_s": runs[name][1], "alone_run_wall_s": runs["alone"][1]}
    emit(row)
    if (got["step"] != want["step"] or not grad_err <= FORWARD_REL_TOL
        or not move_err <= PARAM_MOVE_TOL * lr):
      raise AssertionError(f"ddp {name}: step {got['step']} vs "
                           f"{want['step']}, gradients within {grad_err} of "
                           f"each tensor's max (bar {FORWARD_REL_TOL}), "
                           f"moves within {move_err / lr} lr (bar "
                           f"{PARAM_MOVE_TOL} lr)")
  # the log's steps/s: the host's clock per step (each log line gathers
  # the ranks' losses and reads them back, a synchronisation)
  timed = logged("gloo_2_timed")
  emit({"ddp": "gloo_2_timed", "backend": "gloo", "ranks": 2,
        "global_batch": TRAIN_BATCH, "steps": len(timed),
        "host_ms_per_step_after_the_first":
            [1e3 / float(g[2]) for g in timed[1:]],
        "run_wall_s": runs["gloo_2_timed"][1]})
  if len(timed) != DDP_TIMED_ITERS + 1 or not all(
      math.isfinite(float(g[1])) for g in timed):
    raise AssertionError(f"ddp gloo_2_timed: logged {timed}")
  shutil.rmtree(os.path.join(REPO, "build", "chip_smoke_ddp"),
                ignore_errors=True)


def phase_profile():
  """10d: the CLI trainer on UNCSN++ as published (batch 128), steps
  0..PROFILE_ITERS with ``--config.tpu.profile_dir``: the trace of the
  eleventh step is written and names fir2's kernels, forward and adjoint
  (12 + 12 launches in the step), and the adjoint's autograd node.
  Training runs no fused site (eval only)."""
  trace_dir = os.path.join(REPO, "build", "chip_smoke_trace")
  shutil.rmtree(trace_dir, ignore_errors=True)
  steps, fwd, bwd, batch, workdir = phase_train(
      "uncsnpp_profiled", UNCSNPP, UNCSNPP_FIR_SITES, UNCSNPP_FIR_BWD_SITES,
      PROFILE_ITERS, False, ("--config.tpu.profile_dir", trace_dir))
  shutil.rmtree(workdir, ignore_errors=True)
  path = os.path.join(trace_dir, "trace.json")
  with open(path) as f:
    events = json.load(f)["traceEvents"]
  kernels = collections.Counter(
      e["name"] for e in events if e.get("cat") == "kernel"
      and any(k in e.get("name", "") for k in ("fir2_", "gn_silu_conv3x3",
                                               "splitk_reduce")))
  nodes = sum(1 for e in events if "_Fir2Backward" in e.get("name", ""))
  fir_events = sum(k for n, k in kernels.items() if "fir2_" in n)
  want = sum(UNCSNPP_FIR_SITES.values()) + sum(
      UNCSNPP_FIR_BWD_SITES.values())
  emit({"profile": "uncsnpp train", "trace": os.path.relpath(path, REPO),
        "trace_bytes": os.path.getsize(path), "traced_steps": 1,
        "hand_written_kernel_events": dict(kernels),
        "fir2_backward_nodes": nodes})
  shutil.rmtree(trace_dir, ignore_errors=True)
  if fir_events != want or nodes < sum(UNCSNPP_FIR_BWD_SITES.values()):
    raise AssertionError(f"profile: the trace names {dict(kernels)} and "
                         f"{nodes} _Fir2Backward nodes; expected {want} fir2 "
                         f"launches (12 forward, 12 adjoint) and 12 nodes")
  if any("gn_silu" in n or "splitk" in n for n in kernels):
    raise AssertionError("profile: a fused site ran in training")


def phase_remat():
  """10e: the flagship's train step (published dropout 0.1, init_scale 0.1,
  no warmup) at batch 128 with tpu.remat off, 'full' and 'conv_outputs',
  each from the same weights, batch and generator: the first step's losses
  and gradients (Adam's first moment) within 1e-5 of each tensor's largest,
  the generator left in the same state; ms per step (CUDA events, the
  steps after the first) and peak memory of each."""
  import torch
  from soft_truncation_tpu_torch.data import get_data_scaler
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.sde import get_sde
  from soft_truncation_tpu_torch.train import init_train_state, make_train_step

  results = {}
  for policy in (None, "full", "conv_outputs"):
    config = load_config(FLAGSHIP, init_scale=0.1)
    config.optim.warmup = 0
    config.tpu.update(remat=policy is not None, remat_policy=policy or "full")
    model = create_model(config, DEVICE, seed=0).train()
    state = init_train_state(config, model)
    step = make_train_step(config, get_sde(config))
    gen = torch.Generator(DEVICE).manual_seed(5)
    batch = get_data_scaler(config)(torch.rand(
        TRAIN_BATCH, 32, 32, 3, generator=torch.Generator(DEVICE).manual_seed(
            6), device=DEVICE))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = step(state, batch, gen)
    first = (losses.cpu(), [m.detach().cpu() for m in state.optimizer.mu],
             gen.get_state())
    events = []
    for _ in range(REMAT_STEPS - 1):
      events.append((torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True)))
      events[-1][0].record()
      step(state, batch, gen)
      events[-1][1].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    results[policy] = first + (sum(ms) / len(ms),
                               torch.cuda.max_memory_allocated())
    del model, state, step
  base = results[None]
  for policy, (losses, mu, gen_state, ms, peak) in results.items():
    loss_err = (losses - base[0]).abs().max().item()
    grad_err = max((m - b).abs().max().item() / max(b.abs().max().item(),
                                                     1e-30)
                   for m, b in zip(mu, base[1]))
    row = {"remat": policy or "off", "batch": TRAIN_BATCH,
           "ms_per_step": ms, "peak_memory_bytes": peak,
           "loss_max_abs_diff": loss_err, "grad_max_rel_err": grad_err,
           "same_generator_state": bool(torch.equal(gen_state, base[2]))}
    emit(row)
    if not (loss_err <= 1e-5 * base[0].abs().max().item()
            and grad_err <= 1e-5 and row["same_generator_state"]):
      raise AssertionError(f"remat {policy}: {row}")
  gc.collect()
  torch.cuda.empty_cache()


def _fir_sites_of(model, modules):
  """FIR sites of the last forward, per (mode, H, W, C), of the modules
  for which ``modules(name, module)`` holds."""
  out = collections.Counter()
  for name, m in model.named_modules():
    if modules(name, m):
      out.update(getattr(m, "last_fir_sites", ()))
  return out


def phase_ffhq_train():
  """10f: FFHQ 1024^2 (``ve/ffhq_1024_uncsn.py`` as published: nf 16,
  ch_mult (1,2,4,8,16,32,32,32), FIR, RVE, batch 16) trained on the card
  by the CLI trainer with ``tpu.remat`` on Synthetic 1024^2 images, steps
  0..FFHQ_TRAIN_ITERS: finite losses, ms per step, peak memory; fir2's
  launches per shape forward (the sites, plus the res-blocks' sites again
  in the recompute) and adjoint (none for the input pyramid's downsampling
  of the images). Then one step of the same config without
  remat: its ms and peak, or its out-of-memory error. Returns the fir2
  launches forward and backward, the steps and the batch."""
  import torch
  from soft_truncation_tpu_torch import main as port_main
  from soft_truncation_tpu_torch.models import create_model

  config = load_config(FFHQ)
  size = config.data.image_size
  model = create_model(config, DEVICE, seed=0)
  with torch.no_grad():
    model(torch.rand(1, size, size, 3, device=DEVICE),
          torch.full((1,), 10.0, device=DEVICE), train=True,
          generator=torch.Generator(DEVICE).manual_seed(0))
  sites = _fir_sites(model)
  # remat recomputes the res-blocks' resamples; the input pyramid's
  # (of the images, which take no gradient) have no adjoint
  recomputed = _fir_sites_of(model, lambda name, m: hasattr(m, "conv0"))
  adjoint = adjoint_sites(_fir_sites_of(
      model, lambda name, m: not name.startswith("pyr_ds_")))
  del model
  gc.collect()
  torch.cuda.empty_cache()
  fwd_per_step = dict(sites + recomputed)
  steps, fwd, bwd, batch, workdir = phase_train(
      "ffhq_1024_remat", FFHQ, fwd_per_step, adjoint,
      FFHQ_TRAIN_ITERS, False, ("--config.tpu.remat=True",
                                "--config.training.snapshot_sampling=False"),
      batch=FFHQ_BATCH)
  shutil.rmtree(workdir, ignore_errors=True)
  log(f"train ffhq_1024: {sum(sites.values())} FIR sites per forward, "
      f"{sum(recomputed.values())} of them recomputed per step under remat")
  # without remat
  workdir = os.path.join(REPO, "build", "chip_smoke_train", "ffhq_1024")
  shutil.rmtree(workdir, ignore_errors=True)
  argv = ["--config", FFHQ, "--workdir", workdir, "--mode", "train",
          "--config.data.dataset", "Synthetic",
          "--config.training.n_iters", "0",
          "--config.training.snapshot_freq", "1000000",
          "--config.training.snapshot_sampling=False"]
  if DEVICE == "cpu":
    argv.append("--cpu")
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  row = {"train": "ffhq_1024", "remat": "off", "batch": FFHQ_BATCH}
  try:
    port_main.main(argv)
    torch.cuda.synchronize()
    row.update(oom=None, run_wall_s=time.perf_counter() - t0,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
  except RuntimeError as e:  # torch's OutOfMemoryError, or a library's
    if not any(k in str(e) for k in ("out of memory", "ALLOC_FAILED")):
      raise
    row.update(oom=str(e).split("\n")[0][:300],
               peak_memory_bytes=torch.cuda.max_memory_allocated())
  gc.collect()
  torch.cuda.empty_cache()
  shutil.rmtree(workdir, ignore_errors=True)
  emit(row)
  return steps, fwd, bwd, batch


def phase_dispatch():
  """Host microseconds per call of each kernel's operator (the route every
  call takes, eager or traced) against a direct call of its launch
  function, at one shape each: DISPATCH_CALLS calls per route in four
  interleaved rounds, each call timed alone on the host clock (the device
  synchronised every 32 calls, so the launch queue never blocks), the
  medians. Both routes launch and count; the counts are reset after."""
  import statistics
  import torch
  from soft_truncation_tpu_torch.ops import fir, gn_conv

  gen = torch.Generator(DEVICE).manual_seed(0)

  def randn(*shape):
    return torch.randn(*shape, device=DEVICE, generator=gen)

  n, h, w, c, o, g = SERVE_BATCH, 4, 4, 256, 256, 32
  x = randn(n, h, w, c)
  mean, rsqrt = gn_conv.gn_stats(x, g)
  gamma, beta, wt, b = randn(c), randn(c), randn(3, 3, c, o) * 0.05, randn(o)
  hi, lo = gn_conv.weight_operand(wt)
  xf = randn(n, 8, 8, 256)
  taps = [float(v) for v in FIR_KERNEL]
  routes = {
      f"gn_silu_conv3x3 {n}x{h}x{w}x{c}->{o}": (
          lambda: gn_conv._OP(x, mean, rsqrt, gamma, beta, wt, b, g, hi, lo),
          lambda: gn_conv._primal_cuda(x, mean, rsqrt, gamma, beta, wt, b, g,
                                       (hi, lo))),
      f"fir2 up {n}x8x8x256": (
          lambda: fir._OP(xf, taps, 1.0, "up", None, "up:forward"),
          lambda: fir._resample_cuda(xf, tuple(taps), 1.0, "up",
                                     fir.fir_upsample2, "forward"))}
  rows = []
  with torch.inference_mode():
    for name, (op, direct) in routes.items():
      times = {"op": [], "direct": []}
      for fn in (op, direct):
        for _ in range(10):
          fn()
      for _ in range(4):
        for route, fn in (("op", op), ("direct", direct)):
          torch.cuda.synchronize()
          for i in range(DISPATCH_CALLS // 4):
            t0 = time.perf_counter()
            fn()
            times[route].append(time.perf_counter() - t0)
            if i % 32 == 31:
              torch.cuda.synchronize()
      torch.cuda.synchronize()
      op_us, direct_us = (statistics.median(times[r]) * 1e6
                          for r in ("op", "direct"))
      row = {"dispatch": name, "calls_per_route": len(times["op"]),
             "op_us_per_call": op_us, "direct_us_per_call": direct_us,
             "op_adds_us": op_us - direct_us}
      emit(row)
      rows.append(row)
  _reset_launch_counts()
  worst = max(r["op_adds_us"] for r in rows)
  over = (" (over it: measure again before choosing the route)"
          if worst > DISPATCH_RULE_US else "")
  log(f"dispatch: the operator adds at most {worst:.2f} us per call over "
      f"the launch function; every call goes through the operator, as the "
      f"design allows up to {DISPATCH_RULE_US} us{over}")
  return rows


def _stash_floats(service):
  """Record each of ``service``'s sampler runs (samples before
  quantisation, nfe) in the list returned."""
  runs, sampler = [], service.sampler

  def recording(method, steps):
    fn = sampler(method, steps)

    def run(*args, **kwargs):
      out, nfe = fn(*args, **kwargs)
      runs.append((out.float().cpu().numpy(), int(nfe)))
      return out, nfe
    return run

  service.sampler = recording
  return runs


def _count_evaluations(service):
  """A one-item list counting ``service``'s score evaluations: the
  network's forwards, or the replay's program calls."""
  count, model = [0], service.model
  if hasattr(model, "score_fn"):
    score_fn = model.score_fn

    def counted(continuous):
      fn = score_fn(continuous)

      def score(x, t):
        count[0] += 1
        return fn(x, t)
      return score

    model.score_fn = counted
  else:
    model.register_forward_hook(lambda *_: count.__setitem__(0, count[0] + 1))
  return count


def _eval_profile(score_fn, x, t):
  """The synchronised host wall per score evaluation over
  EXPORT_PROFILE_EVALS calls, and the kernels per evaluation in a
  torch.profiler trace of as many (memcpy and memset left out)."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  def calls(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
      score_fn(x, t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3

  with torch.inference_mode():
    calls(2)
    wall_ms = calls(EXPORT_PROFILE_EVALS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      calls(EXPORT_PROFILE_EVALS)
  kernels = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset")))
  return {"wall_ms_per_eval": wall_ms,
          "kernels_per_eval": kernels / EXPORT_PROFILE_EVALS}


def _shape_counts(counts):
  return [[list(k), v] for k, v in counts.items()]


def replay_server(artifact, params) -> int:
  """Phase 11's subprocess: load the pair with the port's model and config
  packages made unimportable, serve it over HTTP on a free port (printed
  as the first JSON line with the load's seconds), and answer JSON
  commands on stdin: 'counts' (the score evaluations and both kernels'
  launches per shape since the last 'counts', counted inside the
  operators, and the sampler runs' samples before quantisation, written
  beside the artifact), 'profile' (``_eval_profile`` at round 0 of seed
  0's prior, t = 0.5) and 'quit'."""
  for name in ("soft_truncation_tpu_torch.models",
               "soft_truncation_tpu_torch.configs"):
    sys.modules[name] = None
  sys.path.insert(0, REPO)
  import numpy as np
  import torch
  from soft_truncation_tpu_torch.serve.server import (SamplingService,
                                                      make_server)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.deterministic = True
  t0 = time.perf_counter()
  service = SamplingService.from_artifact(artifact, params)
  torch.cuda.synchronize()
  load_s = time.perf_counter() - t0
  runs, evals = _stash_floats(service), _count_evaluations(service)
  _reset_launch_counts()
  srv = make_server(service, host="127.0.0.1", port=0)
  thread = threading.Thread(target=srv.serve_forever, daemon=True)
  thread.start()
  emit({"port": srv.server_address[1], "load_s": load_s})
  try:
    for line in sys.stdin:
      cmd = json.loads(line)["cmd"]
      if cmd == "counts":
        gn, firs = _launch_counts()
        path = artifact + ".replay_floats.npz"
        np.savez(path, *[r[0] for r in runs],
                 nfe=np.asarray([r[1] for r in runs]))
        emit({"evals": evals[0], "gn": _shape_counts(gn),
              "fir": _shape_counts(firs), "floats": path})
        runs.clear()
        evals[0] = 0
        _reset_launch_counts()
      elif cmd == "profile":
        t = torch.full((service.batch,), 0.5, device=service.device)
        emit(_eval_profile(service.model.score_fn(True),
                           service.prior(0, 0), t))
      elif cmd == "quit":
        break
  finally:
    srv.shutdown()
    thread.join(timeout=60)
    srv.server_close()
  return 0


def _ask(child, cmd=None):
  """Send ``cmd`` to the replay subprocess (if any) and read its next JSON
  line."""
  if cmd is not None:
    child.stdin.write(json.dumps(cmd) + "\n")
    child.stdin.flush()
  while True:
    line = child.stdout.readline()
    if not line:
      raise AssertionError(f"the replay subprocess ended (rc "
                           f"{child.poll()})")
    if line.startswith("{"):
      return json.loads(line)


def phase_export(name, config, params, requests, sites, fir_sites,
                 workdir):
  """11a / 11b (module docstring): export on the card, replay in a fresh
  subprocess over HTTP, hold it against the live service. Returns the
  replay's launches per shape of both kernels and its score
  evaluations."""
  import numpy as np
  import torch
  from soft_truncation_tpu_torch.sample.sampling import score_of
  from soft_truncation_tpu_torch.serve import export
  from soft_truncation_tpu_torch.serve.server import SamplingService

  artifact = os.path.join(workdir, name + export.EXTENSION)
  npz = os.path.join(workdir, name + ".params.npz")
  t0 = time.perf_counter()
  exported, shape = export.export_sampler(config, params, EXPORT_BATCH,
                                          DEVICE)
  export_s = time.perf_counter() - t0
  nodes = collections.Counter(
      str(n.target) for p in exported.programs.values()
      for n in p.graph.nodes if n.op == "call_function")
  export.save_artifact(exported, export.artifact_meta(config, shape,
                                                      exported), artifact)
  export.save_params_npz(params, npz)
  log(f"export {name}: {export_s:.2f} s, programs "
      f"{[p.name for p in exported.specs]}, artifact "
      f"{os.path.getsize(artifact)} bytes, params npz "
      f"{os.path.getsize(npz)} bytes")
  del exported
  child = subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), "--replay-server",
       artifact, npz], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
      text=True, cwd=REPO)
  try:
    hello = _ask(child)
    url = f"http://127.0.0.1:{hello['port']}"
    meta = _healthz(url)
    if "artifact" not in meta:
      raise AssertionError(f"/healthz of the replay names no artifact: "
                           f"{meta}")
    replayed = []
    for req in requests:
      t0 = time.perf_counter()
      with np.load(io.BytesIO(_post(url + "/sample", req))) as f:
        replayed.append((f["samples"], int(f["nfe"])))
      log(f"replay {name}: {json.dumps(req)} nfe {replayed[-1][1]} wall_s "
          f"{time.perf_counter() - t0:.3f}")
    counts = _ask(child, {"cmd": "counts"})
    replay_profile = _ask(child, {"cmd": "profile"})
    child.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
    child.stdin.flush()
    child.wait(timeout=120)
  finally:
    if child.poll() is None:
      child.kill()
      child.wait()
  if child.returncode != 0:
    raise AssertionError(f"replay subprocess exited {child.returncode}")
  with np.load(counts["floats"]) as f:
    replay_floats = [f[f"arr_{i}"] for i in range(len(requests))]

  live = SamplingService(config, params, batch=EXPORT_BATCH, device=DEVICE)
  live_runs = _stash_floats(live)
  live_served = [live.sample(r["num"], r["seed"], r.get("method"),
                             r.get("dpm_steps")) for r in requests]
  t = torch.full((EXPORT_BATCH,), 0.5, device=DEVICE)
  eager_profile = _eval_profile(score_of(config, live.sde, live.model, True),
                                live.prior(0, 0), t)
  for req, (r8, r_nfe), (l8, l_nfe), rf, (lf, _) in zip(
      requests, replayed, live_served, replay_floats, live_runs):
    method = req.get("method", config.sampling.method)
    err = float(np.abs(rf - lf).max())
    scale = float(np.abs(lf).max())
    step = np.abs(r8.astype(np.int16) - l8.astype(np.int16))
    moved = float((step > 0).mean())
    tol = EXPORT_ODE_REL_TOL if method == "ode" else EXPORT_REL_TOL
    log(f"replay {name} vs live: {json.dumps(req)} nfe {r_nfe} vs {l_nfe}, "
        f"max_abs_diff {err} max|x| {scale}, uint8 max step "
        f"{int(step.max())} moved {moved}")
    if method != "ode" and r_nfe != l_nfe:
      raise AssertionError(f"{name} {method}: nfe {r_nfe} replayed, "
                           f"{l_nfe} live")
    if not (np.isfinite(rf).all() and err <= tol * scale):
      raise AssertionError(f"{name} {method}: replay {err} from live, max "
                           f"|x| {scale}")
    if step.max() > 1 or moved > EXPORT_MAX_MOVED:
      raise AssertionError(f"{name} {method}: served bytes differ by up to "
                           f"{step.max()} in {moved} of the positions")
  evals = counts["evals"]
  gn = {tuple(k): v for k, v in counts["gn"]}
  firs = {tuple(k): v for k, v in counts["fir"]}
  want_gn = {s: k * evals for s, k in sites.items()}
  want_fir = {s: k * evals for s, k in fir_sites.items()}
  log(f"replay {name}: {evals} score evaluations, "
      f"{sum(gn.values()) / max(evals, 1):g} gn_silu_conv3x3 and "
      f"{sum(firs.values()) / max(evals, 1):g} fir2 launches per "
      f"evaluation; load {hello['load_s']:.2f} s")
  if not evals or gn != want_gn or firs != want_fir:
    raise AssertionError(f"{name}: the replay's launches per shape {gn}, "
                         f"{firs} are not the sites x {evals} evaluations: "
                         f"{want_gn}, {want_fir}")
  row = {"export": name, "batch": EXPORT_BATCH, "export_s": export_s,
         "graph_nodes": sum(nodes.values()),
         "graph_dtype_assert_and_cast_nodes": (
             nodes["aten._assert_tensor_metadata.default"]
             + nodes["aten.to.dtype"]),
         "artifact_bytes": os.path.getsize(artifact),
         "load_s": hello["load_s"], "evals": evals,
         "gn_silu_conv3x3_per_eval": sum(gn.values()) / evals,
         "fir2_per_eval": sum(firs.values()) / evals,
         "replay": replay_profile, "eager": eager_profile}
  emit(row)
  rk, ek = replay_profile["kernels_per_eval"], eager_profile[
      "kernels_per_eval"]
  if abs(rk - ek) > EXPORT_KERNELS_REL * ek:
    raise AssertionError(f"{name}: {rk} kernels per evaluation replayed, "
                         f"{ek} eager")
  return gn, firs, evals


def _relaunched(rows, launched, units, per_key, shape_of):
  """The rows of another path measured at the same shapes and batch, with
  the launches of this path: (shape -> launches over ``units`` forwards or
  steps). Fails where this path launched at a shape no row holds."""
  by_shape = {shape_of(r): r for r in rows}
  missing = set(launched) - set(by_shape)
  if missing:
    raise AssertionError(f"no kernel row holds the shapes {missing}")
  return [dict(by_shape[s], launches=k, **{per_key: k / units})
          for s, k in launched.items()]


def _held(name, shape, got, want, tol):
  import torch
  torch.cuda.synchronize()
  err = (got - want).abs().max().item()
  scale = want.abs().max().item()
  if not (torch.isfinite(got).all() and err <= tol * scale):
    raise AssertionError(f"{name} disagrees at {shape}: max_abs_err {err} "
                         f"vs max|reference| {scale}")
  return err, scale


def kernels_gn(launches_by_shape, evals, n, listed=()):
  """gn_silu_conv3x3 vs plain vs library at every shape a main path
  launched it at (and the ``listed`` shapes), at that path's batch ``n``:
  N=8 for the serve phases, N=128 for the FID phase's sampler. The caller
  runs it under inference_mode, where the wrapper calls the kernel
  directly."""
  import torch
  import torch.nn.functional as F
  from soft_truncation_tpu_torch.ops import gn_conv

  shapes = sorted(set(launches_by_shape) | set(listed), reverse=True)
  gen = torch.Generator(DEVICE).manual_seed(0)
  rows = []
  for (h, w, c, o) in shapes:
    groups = min(c // 4, 32)
    x = torch.randn(n, h, w, c, generator=gen, device=DEVICE)
    gamma = torch.randn(c, generator=gen, device=DEVICE)
    beta = torch.randn(c, generator=gen, device=DEVICE)
    wgt = torch.randn(3, 3, c, o, generator=gen, device=DEVICE)
    b = torch.randn(o, generator=gen, device=DEVICE)
    w_oihw = wgt.permute(3, 2, 0, 1).contiguous()
    mean, rsqrt = gn_conv.gn_stats(x, groups)
    args = (x, mean, rsqrt, gamma, beta, wgt, b, groups)
    # split once per weight value, as the model's DDPMConv keeps it
    split = gn_conv.weight_operand(wgt)
    err, scale = _held("gn_silu_conv3x3", (n, h, w, c, o),
                       gn_conv.gn_silu_conv3x3(*args, w_split=split),
                       gn_conv.gn_silu_conv3x3_plain(*args), KERNEL_REL_TOL)

    def library():
      return F.conv2d(F.silu(F.group_norm(x.permute(0, 3, 1, 2), groups,
                                          gamma, beta, 1e-6)),
                      w_oihw, b, padding=1)

    def kernel():
      return gn_conv.gn_silu_conv3x3(*args, w_split=split)

    bound, bound_by, bound_3x, bound_fp32 = gn_conv_bound(n, h, w, c, o,
                                                         groups)
    launches = launches_by_shape.get((h, w, c, o), 0)
    plan = gn_conv.launch_plan(n, h, w, c, o, groups, gn_conv._sms(x.device))
    # kernel and library interleaved, issued (A, B, A, B) then on the device
    ab = [time_ms(f) for f in (kernel, library) * 2]
    ab_dev = [graph_ms(f) for f in (kernel, library) * 2]
    row = {"kernel": "gn_silu_conv3x3", "shape_nhwc_o": [n, h, w, c, o],
           "groups": groups, "grid": list(plan.grid), "splits": plan.splits,
           "max_abs_err": err, "max_abs_plain": scale,
           "kernel_ms": (ab[0] + ab[2]) / 2,
           "device_ms": (ab_dev[0] + ab_dev[2]) / 2,
           "plain_ms": time_ms(lambda: gn_conv.gn_silu_conv3x3_plain(*args)),
           "library_ms": (ab[1] + ab[3]) / 2,
           "library_device_ms": (ab_dev[1] + ab_dev[3]) / 2,
           "ab_kernel_ms": [ab[0], ab[2]], "ab_library_ms": [ab[1], ab[3]],
           "ab_kernel_device_ms": [ab_dev[0], ab_dev[2]],
           "ab_library_device_ms": [ab_dev[1], ab_dev[3]],
           "bound_ms": bound, "bound_by": bound_by,
           "bound_3xtf32_ms": bound_3x, "bound_fp32_pipe_ms": bound_fp32,
           "launches": launches,
           "launches_per_forward": launches / evals}
    log(f"gn_silu_conv3x3 {(n, h, w, c, o)}: grid {plan.grid} (O tiles, M "
        f"tiles, split-K {plan.splits}), {plan.smem} B shared memory")
    emit(row)
    rows.append(row)
  return rows


def kernels_gn_ragged():
  """gn_silu_conv3x3 vs plain at shapes no model reaches: ragged tiles,
  images straddling a tile, C and O off the tile widths, groups of 3 and 4
  channels."""
  import torch
  from soft_truncation_tpu_torch.ops import gn_conv

  gen = torch.Generator(DEVICE).manual_seed(1)
  for (n, h, w, c, o, groups) in ((3, 5, 7, 36, 20, 12), (2, 4, 4, 16, 16, 4),
                                  (1, 32, 32, 128, 128, 32)):
    x = torch.randn(n, h, w, c, generator=gen, device=DEVICE)
    args = (x, *gn_conv.gn_stats(x, groups),
            *(torch.randn(s, generator=gen, device=DEVICE)
              for s in ((c,), (c,), (3, 3, c, o), (o,))), groups)
    err, scale = _held("gn_silu_conv3x3", (n, h, w, c, o),
                       gn_conv.gn_silu_conv3x3(*args),
                       gn_conv.gn_silu_conv3x3_plain(*args), KERNEL_REL_TOL)
    log(f"gn_silu_conv3x3 {(n, h, w, c, o)} groups {groups}: max_abs_err "
        f"{err} max|plain| {scale}")


def _fir_library(mode, x, k, gain=1.0):
  """One PyTorch call computing the same resample on the channels-last view
  of ``x``: a depthwise strided conv (down) or transposed conv (up)."""
  import torch
  import torch.nn.functional as F
  from soft_truncation_tpu_torch.ops import fir

  c = x.shape[-1]
  taps = torch.tensor(fir.fir2_taps(k, gain, mode), dtype=torch.float32,
                      device=x.device)
  T = taps.shape[0]
  pad0, pad1 = fir.fir2_pads(T, mode)
  xc = x.permute(0, 3, 1, 2)
  if mode == "down":
    if pad0 != pad1:
      raise ValueError(f"one conv2d call takes symmetric pads, not "
                       f"{(pad0, pad1)}")
    w = torch.outer(taps.flip(0), taps.flip(0)).expand(c, 1, T, T)
    w = w.contiguous()
    return lambda: F.conv2d(xc, w, stride=2, padding=pad0, groups=c)
  w = torch.outer(taps, taps).expand(c, 1, T, T).contiguous()
  return lambda: F.conv_transpose2d(xc, w, stride=2, padding=T - 1 - pad0,
                                    groups=c)


def kernels_fir(fir_launched, units, batch, per_key):
  """fir2 (up and down) vs plain vs library at every shape of
  ``fir_launched`` ((mode, H, W, C) -> launches over ``units`` forwards or
  steps), at ``batch``, T=4."""
  import torch
  from soft_truncation_tpu_torch.ops import fir

  gen = torch.Generator(DEVICE).manual_seed(0)
  rows = []
  for (mode, h, w, c) in sorted(fir_launched):
    x = torch.randn(batch, h, w, c, generator=gen, device=DEVICE)
    wrapper, plain = ((fir.fir_upsample2, fir.fir_upsample2_plain)
                      if mode == "up" else
                      (fir.fir_downsample2, fir.fir_downsample2_plain))
    shape = (mode, batch, h, w, c)
    with torch.inference_mode():
      want = plain(x, FIR_KERNEL)
      err, scale = _held(f"fir_{mode}sample2", shape,
                         wrapper(x, FIR_KERNEL), want, FIR_REL_TOL)
      library = _fir_library(mode, x, FIR_KERNEL)
      _held(f"the library {mode}sample", shape,
            library().permute(0, 2, 3, 1), want, FIR_REL_TOL)
      bound, bound_by = fir_bound(mode, batch, h, w, c, len(FIR_KERNEL))
      launches = fir_launched[(mode, h, w, c)]
      # interleaved, three rounds: the wrapper (which calls the kernel
      # directly where autograd records nothing), the same call through the
      # autograd Function that training takes, and the library call; the
      # host's pace drifts within a run, so issued times compare only in
      # turns
      def through_function():
        return fir._Fir2.apply(x, FIR_KERNEL, 1.0, mode, wrapper, "forward",
                               None)

      ab = [time_ms(f) for f in (lambda: wrapper(x, FIR_KERNEL),
                                 through_function, library) * 3]
      row = {"kernel": f"fir_{mode}sample2", "shape_nhwc": [batch, h, w, c],
             "taps": len(FIR_KERNEL), "max_abs_err": err,
             "max_abs_plain": scale, "kernel_ms": sum(ab[0::3]) / 3,
             "device_ms": graph_ms(lambda: wrapper(x, FIR_KERNEL)),
             "plain_ms": time_ms(lambda: plain(x, FIR_KERNEL)),
             "library_ms": sum(ab[2::3]) / 3,
             "library_device_ms": graph_ms(library), "bound_ms": bound,
             "bound_by": bound_by, "launches": launches,
             "ab_direct_ms": ab[0::3], "ab_function_ms": ab[1::3],
             "ab_library_ms": ab[2::3], per_key: launches / units}
    emit(row)
    rows.append(row)
  direct, function = (sum(sum(r[key]) / len(r[key]) * r[per_key]
                          for r in rows)
                      for key in ("ab_direct_ms", "ab_function_ms"))
  log(f"fir2 issued per {per_key[len('launches_per_'):]} at batch {batch}: "
      f"{direct:.4f} ms called directly, {function:.4f} ms through the "
      f"autograd Function")
  return rows


def kernels_fir_backward(bwd_launched, steps, batch):
  """The adjoint (``fir2_backward``: fir2 in the other mode, taps reversed)
  at every cotangent shape the train phase launched it at, at the
  ``batch`` it launched it at, held
  against torch.autograd.grad of the plain forward; its plain version is
  the plain resample in the launched mode, its library call the one
  PyTorch call of that resample."""
  import torch
  from soft_truncation_tpu_torch.ops import fir

  gen = torch.Generator(DEVICE).manual_seed(1)
  k_rev = tuple(reversed(FIR_KERNEL))
  rows = []
  for (mode, h, w, c) in sorted(bwd_launched):
    # the forward this adjoint belongs to, and its input's shape
    fwd, gain = ("down", 1.0 / 4.0) if mode == "up" else ("up", 4.0)
    x_shape = ((batch, 2 * h, 2 * w, c) if mode == "up"
               else (batch, h // 2, w // 2, c))
    fwd_plain = (fir.fir_upsample2_plain if fwd == "up"
                 else fir.fir_downsample2_plain)
    x = torch.randn(x_shape, generator=gen, device=DEVICE,
                    requires_grad=True)
    ybar = torch.randn(batch, h, w, c, generator=gen, device=DEVICE)
    (want,) = torch.autograd.grad(fwd_plain(x, FIR_KERNEL), x, ybar)
    shape = (mode, batch, h, w, c)
    with torch.inference_mode():
      def kernel():
        return fir.fir2_backward(ybar, FIR_KERNEL, 1.0, fwd, x_shape)

      def plain():
        return fir._fir2_plain(ybar, k_rev, gain, mode)

      err, scale = _held("fir2_backward", shape, kernel(), want,
                         FIR_REL_TOL)
      library = _fir_library(mode, ybar, k_rev, gain)
      _held(f"the library adjoint of {fwd}sample", shape,
            library().permute(0, 2, 3, 1), want, FIR_REL_TOL)
      bound, bound_by = fir_bound(mode, batch, h, w, c, len(FIR_KERNEL))
      launches = bwd_launched[(mode, h, w, c)]
      row = {"kernel": "fir2_backward", "adjoint_of": f"fir_{fwd}sample2",
             "launched_mode": mode, "shape_nhwc": [batch, h, w, c],
             "taps": len(FIR_KERNEL), "max_abs_err": err,
             "max_abs_plain": scale, "kernel_ms": time_ms(kernel),
             "device_ms": graph_ms(kernel), "plain_ms": time_ms(plain),
             "library_ms": time_ms(library),
             "library_device_ms": graph_ms(library), "bound_ms": bound,
             "bound_by": bound_by, "launches": launches,
             "launches_per_step": launches / steps}
    emit(row)
    rows.append(row)
  # no config downsamples an odd size; its adjoint launches the upsample
  # sized one row and column past 2x the cotangent
  x = torch.randn(8, 33, 31, 64, generator=gen, device=DEVICE,
                  requires_grad=True)
  ybar = torch.randn(8, 16, 15, 64, generator=gen, device=DEVICE)
  (want,) = torch.autograd.grad(fir.fir_downsample2_plain(x, FIR_KERNEL), x,
                                ybar)
  (got,) = torch.autograd.grad(fir.fir_downsample2(x, FIR_KERNEL), x, ybar)
  err, scale = _held("fir2_backward of an odd-sized downsample",
                     tuple(x.shape), got, want, FIR_REL_TOL)
  log(f"fir2_backward of the downsample of {tuple(x.shape)}: max_abs_err "
      f"{err} max|autograd of plain| {scale}")
  return rows


def gn_jvp_bound(n, h, w, c, o, groups):
  """The tangent's bound: the primal's flops once at the dense TF32 rate,
  or its bytes (x and dx, the stats and their tangents, gamma, beta, w in,
  the tangent out), whichever is longer."""
  flops = 2 * n * h * w * c * o * 9
  bytes_ = 4 * (n * h * w * (2 * c + o) + 9 * c * o + 2 * c + 4 * n * groups)
  return _bound(flops, bytes_, PEAK_TF32_FLOPS)


def kernels_gn_jvp(jvp_launched, evals):
  """gn_silu_conv3x3's tangent kernel at every shape the likelihood phases
  launched it at, batch LIKELIHOOD_BATCH: against gn_silu_conv3x3_jvp_plain,
  which is held against torch.func.jvp of the plain chain; timed beside
  that plain version and one library call, torch.func.jvp of GroupNorm ->
  SiLU -> cuDNN conv (TF32 off; it computes the primal too), kernel and
  library interleaved A B A B, issued and on the device."""
  import torch
  import torch.nn.functional as F
  from soft_truncation_tpu_torch.ops import gn_conv

  gen = torch.Generator(DEVICE).manual_seed(3)
  rows = []
  for (h, w, c, o) in sorted(jvp_launched, reverse=True):
    n, groups = LIKELIHOOD_BATCH, min(c // 4, 32)
    x, dx = (torch.randn(n, h, w, c, generator=gen, device=DEVICE)
             for _ in range(2))
    gamma, beta = (torch.randn(c, generator=gen, device=DEVICE)
                   for _ in range(2))
    wgt = torch.randn(3, 3, c, o, generator=gen, device=DEVICE)
    b = torch.randn(o, generator=gen, device=DEVICE)
    (mean, rsqrt), (dmean, drsqrt) = torch.func.jvp(
        lambda v: gn_conv.gn_stats(v, groups), (x,), (dx,))
    args = (x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt, groups)
    split = gn_conv.weight_operand(wgt)
    plain = gn_conv.gn_silu_conv3x3_jvp_plain(*args)
    shape = (n, h, w, c, o)
    _, chain = torch.func.jvp(
        lambda v: gn_conv.gn_silu_conv3x3_plain(
            v, *gn_conv.gn_stats(v, groups), gamma, beta, wgt, b, groups),
        (x,), (dx,))
    _held("gn_silu_conv3x3_jvp_plain vs torch.func.jvp of the plain chain",
          shape, plain, chain, KERNEL_REL_TOL)
    err, scale = _held("gn_silu_conv3x3 tangent", shape,
                       gn_conv.gn_silu_conv3x3_jvp(*args, w_split=split),
                       plain, KERNEL_REL_TOL)
    w_oihw = wgt.permute(3, 2, 0, 1).contiguous()
    xc, dxc = (t.permute(0, 3, 1, 2).contiguous() for t in (x, dx))

    def library():
      return torch.func.jvp(
          lambda v: F.conv2d(F.silu(F.group_norm(v, groups, gamma, beta,
                                                 1e-6)), w_oihw, b,
                             padding=1), (xc,), (dxc,))

    _held("the library jvp", shape, library()[1].permute(0, 2, 3, 1),
          plain, KERNEL_REL_TOL)

    def kernel():
      return gn_conv.gn_silu_conv3x3_jvp(*args, w_split=split)

    bound, bound_by = gn_jvp_bound(n, h, w, c, o, groups)
    plan = gn_conv.launch_plan(n, h, w, c, o, groups, gn_conv._sms(x.device),
                               tangent=True)
    ab = [time_ms(f) for f in (kernel, library) * 2]
    ab_dev = [graph_ms(f) for f in (kernel, library) * 2]
    launches = jvp_launched[(h, w, c, o)]
    row = {"kernel": "gn_silu_conv3x3_jvp", "shape_nhwc_o": list(shape),
           "groups": groups, "grid": list(plan.grid), "splits": plan.splits,
           "smem": plan.smem, "max_abs_err": err, "max_abs_plain": scale,
           "kernel_ms": (ab[0] + ab[2]) / 2,
           "device_ms": (ab_dev[0] + ab_dev[2]) / 2,
           "plain_ms": time_ms(
               lambda: gn_conv.gn_silu_conv3x3_jvp_plain(*args)),
           "library_ms": (ab[1] + ab[3]) / 2,
           "library_device_ms": (ab_dev[1] + ab_dev[3]) / 2,
           "ab_kernel_device_ms": [ab_dev[0], ab_dev[2]],
           "ab_library_device_ms": [ab_dev[1], ab_dev[3]],
           "bound_ms": bound, "bound_by": bound_by, "launches": launches,
           "launches_per_evaluation": launches / evals}
    emit(row)
    rows.append(row)
  return rows


def kernels_fir_jvp(jvp_launched, evals):
  """fir2's tangent (its jvp rule: the same resample of the tangent, one
  more launch) at every shape the UNCSN++ likelihood phase launched it at,
  batch LIKELIHOOD_BATCH: the launch the rule makes, held against
  torch.func.jvp of the plain version and timed beside it and the library
  call on the tangent."""
  import torch
  from soft_truncation_tpu_torch.ops import fir

  gen = torch.Generator(DEVICE).manual_seed(4)
  rows = []
  for (mode, h, w, c) in sorted(jvp_launched):
    x, dx = (torch.randn(LIKELIHOOD_BATCH, h, w, c, generator=gen,
                         device=DEVICE) for _ in range(2))
    wrapper, plain = ((fir.fir_upsample2, fir.fir_upsample2_plain)
                      if mode == "up" else
                      (fir.fir_downsample2, fir.fir_downsample2_plain))
    shape = (mode, LIKELIHOOD_BATCH, h, w, c)
    _, want = torch.func.jvp(lambda v: plain(v, FIR_KERNEL), (x,), (dx,))
    _, got = torch.func.jvp(lambda v: wrapper(v, FIR_KERNEL), (x,), (dx,))
    err, scale = _held(f"fir_{mode}sample2 tangent", shape, got, want,
                       FIR_REL_TOL)

    def kernel():  # the launch the jvp rule makes
      return fir._resample(dx, FIR_KERNEL, 1.0, mode, wrapper, "jvp")

    library = _fir_library(mode, dx, FIR_KERNEL)
    bound, bound_by = fir_bound(mode, LIKELIHOOD_BATCH, h, w, c,
                                len(FIR_KERNEL))
    ab = [time_ms(f) for f in (kernel, library) * 2]
    launches = jvp_launched[(mode, h, w, c)]
    row = {"kernel": f"fir_{mode}sample2_jvp",
           "shape_nhwc": [LIKELIHOOD_BATCH, h, w, c], "taps": len(FIR_KERNEL),
           "max_abs_err": err, "max_abs_plain": scale,
           "kernel_ms": (ab[0] + ab[2]) / 2, "device_ms": graph_ms(kernel),
           "plain_ms": time_ms(lambda: plain(dx, FIR_KERNEL)),
           "library_ms": (ab[1] + ab[3]) / 2,
           "library_device_ms": graph_ms(library), "bound_ms": bound,
           "bound_by": bound_by, "launches": launches,
           "launches_per_evaluation": launches / evals}
    emit(row)
    rows.append(row)
  return rows


def _kernel_entry(name, source, replaces, rows, per, per_key):
  """One entry of the ``kernels`` line: launches of its main path, times
  summed over the shapes weighted by their launches per forward or step.
  A path that launched the kernel at no shape fails the run."""
  if not rows:
    raise AssertionError(f"{name}: its path launched the kernel at no shape")

  def per_unit(key):
    return sum(r[key] * r[per_key] for r in rows)

  bound_by = max(("operations", "bytes"), key=lambda k: sum(
      r["bound_ms"] * r[per_key] for r in rows if r["bound_by"] == k))
  entry = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": sum(r["launches"] for r in rows),
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": per_unit("kernel_ms"), "device_ms": per_unit("device_ms"),
           "plain_ms": per_unit("plain_ms"), "bound_ms": per_unit("bound_ms"),
           "bound_by": bound_by, "library_ms": per_unit("library_ms"),
           "library_device_ms": per_unit("library_device_ms"),
           "per": f"{per}: {sum(r[per_key] for r in rows):g} launches, the "
                  "main path's per shape"}
  for key in ("bound_3xtf32_ms", "bound_fp32_pipe_ms"):
    if key in rows[0]:
      entry[key] = per_unit(key)
  return entry


def main() -> int:
  try:
    import torch
  except ImportError:
    print("chip_smoke: torch is not installed", file=sys.stderr)
    return 2
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  try:
    import soft_truncation_tpu_torch  # noqa: F401
  except ImportError as e:
    print(f"chip_smoke: the port is not beside this script: {e}",
          file=sys.stderr)
    return 2
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.deterministic = True
  kind = torch.cuda.get_device_name(0)
  t_all = time.perf_counter()
  dev = device_line()
  log(f"{dev} | torch {torch.__version__} cuda {torch.version.cuda} | "
      f"{kind} x{torch.cuda.device_count()}")

  def phase(name, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return result

  phase("build", phase_build)
  sites, _, flag_params = phase(
      "forward flagship", phase_forward, "flagship",
      load_config(FLAGSHIP, init_scale=0.1),
      [0.01 * 999.0, 0.6 * 999.0], {})
  u_sites, u_fir_sites, u_params = phase(
      "forward uncsnpp", phase_forward, "uncsnpp",
      load_config(UNCSNPP, init_scale=0.1), [0.01, 50.0], UNCSNPP_FIR_SITES)
  # phase 3b: the published layouts
  layouts = {}
  for name, path, overrides, labels in PUBLISHED_LAYOUTS:
    layouts[name] = phase(f"forward {name}", phase_published_forward, name,
                          load_config(path, init_scale=0.1, **overrides),
                          labels)
  with _FunctionApplies() as applies:
    launched, evals = phase("serve flagship", phase_serve_flagship, sites,
                            flag_params)
    u_launched, fir_launched, u_evals = phase(
        "serve uncsnpp", phase_serve_uncsnpp, u_sites, u_fir_sites, u_params)
    d_launched, d_fir_launched, d_evals = phase(
        "serve deepest", phase_serve_deepest, *layouts["deepest"])
    hq_launched, hq_fir_launched, hq_evals = phase(
        "serve celebahq 256", phase_serve_hq, *layouts["celebahq_256"][:2])
  log(f"serve: {applies.count} autograd.Function applications")
  if applies.count:
    raise AssertionError("serving went through the kernels' autograd."
                         "Function: under inference_mode the wrappers must "
                         "call the kernels directly")

  phase("trace flagship", phase_trace, "flagship",
        load_config(FLAGSHIP, init_scale=0.1), flag_params, 0.6 * 999.0)
  phase("trace uncsnpp", phase_trace, "uncsnpp",
        load_config(UNCSNPP, init_scale=0.1), u_params, 1.0)
  phase("train step flagship", phase_train_step, "flagship",
        load_config(FLAGSHIP, init_scale=0.1), {}, {})
  phase("train step uncsnpp", phase_train_step, "uncsnpp",
        load_config(UNCSNPP, init_scale=0.1), UNCSNPP_FIR_SITES,
        UNCSNPP_FIR_BWD_SITES)
  # the mixed loss runs the network once per half of each micro-batch
  d_fir = layouts["deepest"][1]

  def times(sites, k):
    return {s: n * k for s, n in sites.items()}

  phase("train step deepest", phase_train_step, "deepest",
        load_config(DEEPEST, init_scale=0.1), times(d_fir, 2),
        times(adjoint_sites(d_fir), 2), 2)
  gc.collect()
  torch.cuda.empty_cache()
  d_steps, d_fwd, d_bwd, d_batch, d_workdir = phase(
      "train deepest", phase_train, "deepest", DEEPEST, times(d_fir, 2),
      times(adjoint_sites(d_fir), 2), DEEPEST_TRAIN_ITERS, False)
  shutil.rmtree(d_workdir, ignore_errors=True)
  f_workdir = phase("train flagship", phase_train, "flagship", FLAGSHIP, {},
                    {})[-1]
  t_steps, t_fwd, t_bwd, t_batch, u_workdir = phase(
      "train uncsnpp", phase_train, "uncsnpp", UNCSNPP, UNCSNPP_FIR_SITES,
      UNCSNPP_FIR_BWD_SITES)
  fid_launched, fid_evals, _ = phase("fid flagship", phase_fid, f_workdir,
                                     sites)
  f_jvp, _, f_lik_evals, _ = phase(
      "likelihood flagship", phase_likelihood, "flagship", FLAGSHIP,
      f_workdir, sites, {}, load_config(FLAGSHIP, init_scale=0.1),
      flag_params)
  u_jvp, u_fir_jvp, u_lik_evals, _ = phase(
      "likelihood uncsnpp", phase_likelihood, "uncsnpp", UNCSNPP, u_workdir,
      u_sites, u_fir_sites, load_config(UNCSNPP, init_scale=0.1), u_params)

  # phase 9: the legacy networks and the fp8 knob
  t_legacy = time.perf_counter()
  ddpm_t = [round(t * 999.0, 3) for t in (0.01, 0.15, 0.3, 0.45, 0.6,
                                           0.75, 0.9, 0.99)]
  legacy = {
      "ddpm": phase("forward ddpm", phase_legacy_forward, "ddpm",
                    legacy_config("ddpm"), ddpm_t),
      "ncsn": phase("forward ncsn", phase_legacy_forward, "ncsn",
                    legacy_config("ncsn"), list(range(LEGACY_BATCH))),
      "ncsnv2_64": phase("forward ncsnv2_64", phase_legacy_forward,
                         "ncsnv2_64", legacy_config("ncsnv2_64"),
                         [0, 33, 66, 99, 132, 165, 198, 231])}
  for name, size in LEGACY_HIRES:
    phase(f"forward {name}", phase_legacy_forward, name,
          legacy_config("ncsnv2_64", size, name=name),
          [0, 200] if size < 256 else [200],
          size == 256)
  phase("serve ddpm", phase_serve_legacy, "ddpm", legacy["ddpm"],
        DDPM_SERVE_STEPS, DDPM_CHECK_STEPS)
  phase("serve ncsnv2_64", phase_serve_legacy, "ncsnv2_64",
        legacy["ncsnv2_64"], NCSNV2_SERVE_STEPS, NCSNV2_CHECK_STEPS)
  for name in ("ddpm", "ncsnv2_64"):
    phase(f"train step {name}", phase_train_step, name, legacy_config(name),
          {}, {}, 1, legacy[name])
  del legacy
  shutil.rmtree(phase("train ddpm", phase_train, "ddpm", FLAGSHIP, {}, {},
                      TRAIN_ITERS, True, legacy_flags("ddpm"))[-1],
                ignore_errors=True)
  phase("fp8 casts", phase_fp8_casts)
  fp8_config = load_config(UNCSNPP, init_scale=0.1)
  fp8_config.tpu.activation_dtype = "float8_e4m3"
  fp8_fwd, fp8_bwd, fp8_steps = phase("fp8 train uncsnpp", phase_fp8_step,
                                      fp8_config)
  fp8_launched = phase("fp8 forward flagship", phase_fp8_forward, sites)
  log(f"phases 9a-9f: {time.perf_counter() - t_legacy:.1f} s")

  # phase 10: Picard, DDP, the profiler, remat and FFHQ 1024^2 training
  t_10 = time.perf_counter()
  pic_launched, pic_calls, pic_batch = phase(
      "picard flagship", phase_picard_flagship, sites, flag_params)
  upic_launched, upic_fir, upic_calls, upic_batch = phase(
      "picard uncsnpp", phase_picard_uncsnpp, u_sites, u_fir_sites, u_params)
  gc.collect()
  torch.cuda.empty_cache()
  phase("ddp flagship", phase_ddp)
  phase("profile uncsnpp", phase_profile)
  phase("remat flagship", phase_remat)
  ffhq_steps, ffhq_fwd, ffhq_bwd, ffhq_batch = phase(
      "train ffhq 1024", phase_ffhq_train)
  log(f"phases 10a-10f: {time.perf_counter() - t_10:.1f} s")

  # phase 11: the exported sampler, replayed in a fresh process
  t_11 = time.perf_counter()
  phase("dispatch", phase_dispatch)
  export_dir = tempfile.mkdtemp(prefix="chip_smoke_export_")
  dpm = [{"num": EXPORT_BATCH, "seed": s, "method": "dpm_solver",
          "dpm_steps": EXPORT_DPM_STEPS} for s in EXPORT_SEEDS]
  own = [{"num": EXPORT_BATCH, "seed": s} for s in EXPORT_SEEDS]
  x_gn, x_fir, x_evals = phase(
      "export flagship", phase_export, "flagship",
      load_config(FLAGSHIP, init_scale=0.1), flag_params, own + dpm, sites,
      {}, export_dir)
  ux_gn, ux_fir, ux_evals = phase(
      "export uncsnpp", phase_export, "uncsnpp",
      load_config(UNCSNPP, init_scale=0.1, num_scales=EXPORT_PC_STEPS),
      u_params, own + dpm, u_sites, u_fir_sites, export_dir)
  shutil.rmtree(export_dir, ignore_errors=True)
  log(f"phases 11a-11b: {time.perf_counter() - t_11:.1f} s")

  gn_launched = collections.Counter(launched) + collections.Counter(
      u_launched)
  t0 = time.perf_counter()
  with torch.inference_mode():  # the direct route, as serving calls it
    gn_rows = kernels_gn(gn_launched, evals + u_evals, SERVE_BATCH,
                         LISTED_SHAPES)
    fid_gn_rows = kernels_gn(fid_launched, fid_evals, FID_SHARD)
    kernels_gn_ragged()
  fir_rows = kernels_fir(fir_launched, u_evals, SERVE_BATCH,
                         "launches_per_forward")
  train_rows = kernels_fir(t_fwd, t_steps, t_batch, "launches_per_step")
  bwd_rows = kernels_fir_backward(t_bwd, t_steps, t_batch)
  with torch.inference_mode():
    deepest_rows = kernels_gn(d_launched, d_evals, SERVE_BATCH)
    hq_rows = kernels_gn(hq_launched, hq_evals, 16)
    # the layouts only the forward phase ran, at its batch of 2 (FFHQ's 1)
    seen = set(launched) | set(u_launched) | set(d_launched) | set(
        hq_launched)
    other = collections.Counter()
    for name in ("celeba_64", "ddpm_blocks", "no_auxiliary"):
      other.update(layouts[name][0])
    other = {k: v for k, v in other.items() if k not in seen}
    # one forward of each layout: the launches summed over the layouts
    other_rows = kernels_gn(other, 1, CHECK_BATCH) + kernels_gn(
        {k: v for k, v in layouts["ffhq_1024"][0].items()
         if k not in seen and k not in other}, 1, 1)
  hires_rows = kernels_fir(hq_fir_launched, hq_evals, 16,
                           "launches_per_forward") + kernels_fir(
      layouts["ffhq_1024"][1], 1, 1, "launches_per_forward")
  d_train_rows = kernels_fir(d_fwd, d_steps, d_batch, "launches_per_step")
  d_bwd_rows = kernels_fir_backward(d_bwd, d_steps, d_batch)
  # the fp8 paths launch at shapes and batches rows above already time
  fp8_gn_rows = _relaunched(gn_rows, fp8_launched, 1, "launches_per_forward",
                            lambda r: tuple(r["shape_nhwc_o"][1:]))
  fp8_fir_rows = _relaunched(
      train_rows, fp8_fwd, fp8_steps, "launches_per_step",
      lambda r: (r["kernel"][len("fir_"):-len("sample2")],
                 *r["shape_nhwc"][1:]))
  fp8_bwd_rows = _relaunched(
      bwd_rows, fp8_bwd, fp8_steps, "launches_per_step",
      lambda r: (r["launched_mode"], *r["shape_nhwc"][1:]))
  gn_jvp_rows = kernels_gn_jvp(
      collections.Counter(f_jvp) + collections.Counter(u_jvp),
      f_lik_evals + u_lik_evals)
  fir_jvp_rows = kernels_fir_jvp(u_fir_jvp, u_lik_evals)
  with torch.inference_mode():  # Picard's network calls at batch W * 8
    pic_rows = kernels_gn(pic_launched, pic_calls, pic_batch)
    upic_rows = kernels_gn(upic_launched, upic_calls, upic_batch)
  upic_fir_rows = kernels_fir(upic_fir, upic_calls, upic_batch,
                              "launches_per_forward")
  ffhq_rows = kernels_fir(ffhq_fwd, ffhq_steps, ffhq_batch,
                          "launches_per_step")
  ffhq_bwd_rows = kernels_fir_backward(ffhq_bwd, ffhq_steps, ffhq_batch)
  # the replay launches at the serve phases' shapes and batch
  replay_gn_rows = _relaunched(
      gn_rows, collections.Counter(x_gn) + collections.Counter(ux_gn),
      x_evals + ux_evals, "launches_per_forward",
      lambda r: tuple(r["shape_nhwc_o"][1:]))
  replay_fir_rows = _relaunched(
      fir_rows, ux_fir, ux_evals, "launches_per_forward",
      lambda r: (r["kernel"][len("fir_"):-len("sample2")],
                 *r["shape_nhwc"][1:]))
  log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

  fir_src = "soft_truncation_tpu_torch/csrc/fir2.cu"
  fir_fwd = "soft_truncation_tpu/ops/pallas/fir.py:137"
  gn_src = "soft_truncation_tpu_torch/csrc/gn_silu_conv3x3.cu"
  step = (f"one UNCSN++ train step at batch {TRAIN_BATCH} (every launch at "
          f"N={t_batch})")
  d_step = (f"one deepest-model train step at batch {TRAIN_BATCH} (the mixed"
            f" loss: every launch at N={d_batch})")
  entries = [
      _kernel_entry("gn_silu_conv3x3", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74", gn_rows,
                    f"one flagship or UNCSN++ eval forward at batch "
                    f"{SERVE_BATCH}", "launches_per_forward"),
      _kernel_entry("gn_silu_conv3x3_fid", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74",
                    fid_gn_rows, f"one flagship sampler evaluation at batch "
                    f"{FID_SHARD} (FID)", "launches_per_forward"),
      *(_kernel_entry(f"fir_{mode}sample2", fir_src, fir_fwd,
                      [r for r in fir_rows
                       if r["kernel"] == f"fir_{mode}sample2"],
                      f"one UNCSN++ eval forward at batch {SERVE_BATCH}",
                      "launches_per_forward")
        for mode in ("up", "down")),
      *(_kernel_entry(f"fir_{mode}sample2_train", fir_src, fir_fwd,
                      [r for r in train_rows
                       if r["kernel"] == f"fir_{mode}sample2"],
                      step, "launches_per_step")
        for mode in ("up", "down")),
      _kernel_entry("fir2_backward", fir_src,
                    "soft_truncation_tpu/ops/pallas/fir.py:212", bwd_rows,
                    step, "launches_per_step"),
      _kernel_entry("gn_silu_conv3x3_jvp", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74",
                    gn_jvp_rows, f"one function evaluation of the NLL or "
                    f"NELBO at batch {LIKELIHOOD_BATCH}",
                    "launches_per_evaluation"),
      *(_kernel_entry(f"fir_{mode}sample2_jvp", fir_src, fir_fwd,
                      [r for r in fir_jvp_rows
                       if r["kernel"] == f"fir_{mode}sample2_jvp"],
                      f"one UNCSN++ function evaluation of the NLL or NELBO "
                      f"at batch {LIKELIHOOD_BATCH}",
                      "launches_per_evaluation")
        for mode in ("up", "down")),
      _kernel_entry("gn_silu_conv3x3_deepest", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74",
                    deepest_rows, f"one deepest-model eval forward at batch "
                    f"{SERVE_BATCH}", "launches_per_forward"),
      _kernel_entry("gn_silu_conv3x3_hq", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74", hq_rows,
                    "one CelebA-HQ 256^2 eval forward at batch 16",
                    "launches_per_forward"),
      # empty only where every other row already holds these layouts'
      # shapes
      *([_kernel_entry("gn_silu_conv3x3_published", gn_src,
                       "soft_truncation_tpu/ops/pallas/gn_conv.py:74",
                       other_rows, f"one forward each of CelebA 64^2, FFHQ "
                       f"1024^2 (batch 1), the DDPM-block and the "
                       f"no-auxiliary-block flagship at batch {CHECK_BATCH}"
                       ", the shapes no other row holds",
                       "launches_per_forward")] if other_rows else []),
      _kernel_entry("fir2_hires", fir_src, fir_fwd, hires_rows,
                    "one CelebA-HQ 256^2 eval forward at batch 16 plus one "
                    "FFHQ 1024^2 eval forward at batch 1",
                    "launches_per_forward"),
      _kernel_entry("fir2_deepest_train", fir_src, fir_fwd, d_train_rows,
                    d_step, "launches_per_step"),
      _kernel_entry("fir2_backward_deepest", fir_src,
                    "soft_truncation_tpu/ops/pallas/fir.py:212", d_bwd_rows,
                    d_step, "launches_per_step"),
      _kernel_entry("gn_silu_conv3x3_fp8", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74",
                    fp8_gn_rows, f"one flagship eval forward at batch "
                    f"{SERVE_BATCH} with tpu.activation_dtype float8_e4m3 "
                    "(the fused sites unquantized)", "launches_per_forward"),
      *(_kernel_entry(f"fir_{mode}sample2_fp8_train", fir_src, fir_fwd,
                      [r for r in fp8_fir_rows
                       if r["kernel"] == f"fir_{mode}sample2"],
                      f"one UNCSN++ float8_e4m3 train step at batch "
                      f"{TRAIN_BATCH}", "launches_per_step")
        for mode in ("up", "down")),
      _kernel_entry("fir2_backward_fp8", fir_src,
                    "soft_truncation_tpu/ops/pallas/fir.py:212", fp8_bwd_rows,
                    f"one UNCSN++ float8_e4m3 train step at batch "
                    f"{TRAIN_BATCH}", "launches_per_step"),
      _kernel_entry("gn_silu_conv3x3_picard", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74", pic_rows,
                    f"one network call of a flagship picard_dpm sweep at "
                    f"batch {pic_batch} (window {pic_batch // SERVE_BATCH} x "
                    f"{SERVE_BATCH})", "launches_per_forward"),
      _kernel_entry("gn_silu_conv3x3_picard_uncsnpp", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74", upic_rows,
                    f"one network call of a UNCSN++ picard sweep at batch "
                    f"{upic_batch}", "launches_per_forward"),
      *(_kernel_entry(f"fir_{mode}sample2_picard", fir_src, fir_fwd,
                      [r for r in upic_fir_rows
                       if r["kernel"] == f"fir_{mode}sample2"],
                      f"one network call of a UNCSN++ picard sweep at batch "
                      f"{upic_batch}", "launches_per_forward")
        for mode in ("up", "down")),
      *(_kernel_entry(f"fir_{mode}sample2_ffhq_train", fir_src, fir_fwd,
                      [r for r in ffhq_rows
                       if r["kernel"] == f"fir_{mode}sample2"],
                      f"one FFHQ 1024^2 train step at batch {ffhq_batch} "
                      "with tpu.remat (the recompute's launches included)",
                      "launches_per_step")
        for mode in ("up", "down")),
      _kernel_entry("fir2_backward_ffhq", fir_src,
                    "soft_truncation_tpu/ops/pallas/fir.py:212",
                    ffhq_bwd_rows, f"one FFHQ 1024^2 train step at batch "
                    f"{ffhq_batch} with tpu.remat", "launches_per_step"),
      _kernel_entry("gn_silu_conv3x3_replay", gn_src,
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74",
                    replay_gn_rows, f"one score evaluation of the exported "
                    f"flagship or UNCSN++ program at batch {EXPORT_BATCH}, "
                    "replayed in a fresh process (counted inside the "
                    "operator)", "launches_per_forward"),
      *(_kernel_entry(f"fir_{mode}sample2_replay", fir_src, fir_fwd,
                      [r for r in replay_fir_rows
                       if r["kernel"] == f"fir_{mode}sample2"],
                      f"one score evaluation of the exported UNCSN++ "
                      f"program at batch {EXPORT_BATCH}, replayed in a "
                      "fresh process", "launches_per_forward")
        for mode in ("up", "down"))]
  emit({"kernels": entries})
  for entry in entries:
    log(f"{entry['name']} ({entry['per']}): issued {entry['ms']:.4f} ms vs "
        f"library {entry['library_ms']:.4f} ms; device "
        f"{entry['device_ms']:.4f} ms vs library "
        f"{entry['library_device_ms']:.4f} ms; bound {entry['bound_ms']:.4f}"
        f" ms")
  log(f"total: {time.perf_counter() - t_all:.1f} s")
  log(device_line())
  emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                               "count": torch.cuda.device_count()}})
  return 0


if __name__ == "__main__":
  if sys.argv[1:2] == ["--replay-server"]:
    sys.exit(replay_server(*sys.argv[2:4]))
  sys.exit(main())
