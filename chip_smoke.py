#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100): the quickest
proof that the port still builds, agrees with its plain versions and serves.

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
  4. serve the flagship (a main path), with the launch counts set to 0 just
     before it and read just after: the port's HTTP server at batch 8
     answers /healthz and, with the flagship config as it is (init_scale
     0), /sample with method 'ode' and 'dpm_solver' (20 steps); with the
     phase-3 weights (init_scale 0.1) it answers 'dpm_solver' (5 steps),
     and that batch is held against a CPU SamplingService run from the same
     prior. Every request twice: uint8 NHWC [8, 32, 32, 3], the same bytes
     per seed, one launch per fused site per evaluation, no FIR launch;
  5. serve UNCSN++ (the other main path), counted the same way: with the
     config as published (init_scale 0) /healthz, then /sample with no
     method, i.e. the config's 'pc' at N = PC_PUBLISHED_STEPS, once, with
     its wall; 'pc' at N = 50 and 'dpm_solver' (20 steps) twice each; with
     the phase-3 weights 'pc' at N = 3, whose batch is held against a CPU
     SamplingService given the same prior and the same noise. Both kernels'
     launches per shape equal their sites x the evaluations;
  6. kernels: each kernel against its plain PyTorch version (TF32 off) at
     every shape the serve phases launched it at (N=8), with its time as
     issued from the host (``kernel_ms``, the `kernels` line's ``ms``) and
     on the device alone (``device_ms``, replayed from a CUDA graph), the
     plain version's, one library call's, the bound and the launches per
     forward measured in phases 4-5; one JSON line per shape, then the
     `kernels` line.
Imports torch and the port only, never jax or the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import io
import json
import os
import subprocess
import sys
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
# H100 SXM datasheet: FP32 (no tensor cores) and HBM3 rates
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FUSED_SITES = 82        # fused sites of one flagship or UNCSN++ eval forward
# FIR sites of one UNCSN++ eval forward: (mode, H, W, C) -> count
UNCSNPP_FIR_SITES = {("down", 32, 32, 128): 2, ("down", 16, 16, 256): 2,
                     ("down", 8, 8, 256): 2, ("up", 4, 4, 256): 2,
                     ("up", 8, 8, 256): 2, ("up", 16, 16, 256): 2}
FIR_KERNEL = (1, 3, 3, 1)
PC_PUBLISHED_STEPS = 1000  # model.num_scales of ve/CIFAR10/uncsnpp_st.py
KERNEL_REL_TOL = 1e-4   # gn_silu_conv3x3: reordered f32 sums, K <= 9*512
FIR_REL_TOL = 1e-5      # fir2: <= 16 f32 products, summed in another order
FORWARD_REL_TOL = 1e-3  # card vs CPU, the whole network or sampler
# served uint8 vs the CPU run: a float difference within FORWARD_REL_TOL
# moves a pixel across at most one quantisation step, and few of them
SERVED_MAX_STEP, SERVED_MAX_MOVED = 1, 0.01


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


def _bound(flops, bytes_):
  """Least time (ms) for ``flops`` at the FP32 peak and ``bytes_`` at the
  HBM rate, and which of the two bounds it."""
  t_ops, t_bytes = flops / PEAK_FP32_FLOPS, bytes_ / PEAK_BYTES
  return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                     else "bytes")


def gn_conv_bound(n, h, w, c, o, groups):
  """Every input read once, the output written once, 2*9*C flops per
  output element."""
  return _bound(2 * n * h * w * c * o * 9,
                4 * (n * h * w * (c + o) + 9 * c * o + o + 2 * c
                     + 2 * n * groups))


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


def _serve_requests(url, requests, config, repeat=2):
  """POST each request ``repeat`` times; check shape, dtype and
  determinism. Returns the network evaluations run, the first answer of
  each request and each request's walls."""
  import numpy as np
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
      # their final denoising evaluation
      evals += nfe + (1 if method == "pc" or (
          method == "ode" and config.sampling.noise_removal) else 0)
      inside = float(((samples > 0) & (samples < 255)).mean())
      log(f"serve: {json.dumps(req)} nfe {nfe} wall_s {times[-1]:.3f} "
          f"mean {samples.mean():.3f} std {samples.std():.3f} "
          f"unsaturated {inside:.4f}")
      if (samples.shape != (SERVE_BATCH, 32, 32, 3)
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


def _check_against_cpu(service, params, served, seed, method, steps):
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
  ref_service = SamplingService(service.config, params, batch=SERVE_BATCH,
                                device="cpu")
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
  if step.max() > SERVED_MAX_STEP or moved > SERVED_MAX_MOVED:
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

  config = load_config(UNCSNPP, num_scales=PC_PUBLISHED_STEPS)
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
  log(f"serve uncsnpp: pc as published, N={PC_PUBLISHED_STEPS}: "
      f"{out['pc_evals']} evaluations in {out['pc_wall_s']:.3f} s, "
      f"{out['pc_wall_s'] / out['pc_evals'] * 1e3:.3f} ms per evaluation")
  return launched, fir_launched, evals


def _held(name, shape, got, want, tol):
  import torch
  torch.cuda.synchronize()
  err = (got - want).abs().max().item()
  scale = want.abs().max().item()
  if not (torch.isfinite(got).all() and err <= tol * scale):
    raise AssertionError(f"{name} disagrees at {shape}: max_abs_err {err} "
                         f"vs max|reference| {scale}")
  return err, scale


def kernels_gn(launches_by_shape, evals):
  """gn_silu_conv3x3 vs plain vs library at every shape the serve phases
  launched it at (and the listed flagship shapes), N=8."""
  import torch
  import torch.nn.functional as F
  from soft_truncation_tpu_torch.ops import gn_conv

  shapes = sorted(set(launches_by_shape) | set(LISTED_SHAPES), reverse=True)
  gen = torch.Generator(DEVICE).manual_seed(0)
  rows = []
  for (h, w, c, o) in shapes:
    n, groups = SERVE_BATCH, min(c // 4, 32)
    x = torch.randn(n, h, w, c, generator=gen, device=DEVICE)
    gamma = torch.randn(c, generator=gen, device=DEVICE)
    beta = torch.randn(c, generator=gen, device=DEVICE)
    wgt = torch.randn(3, 3, c, o, generator=gen, device=DEVICE)
    b = torch.randn(o, generator=gen, device=DEVICE)
    w_oihw = wgt.permute(3, 2, 0, 1).contiguous()
    mean, rsqrt = gn_conv.gn_stats(x, groups)
    args = (x, mean, rsqrt, gamma, beta, wgt, b, groups)
    err, scale = _held("gn_silu_conv3x3", (n, h, w, c, o),
                       gn_conv.gn_silu_conv3x3(*args),
                       gn_conv.gn_silu_conv3x3_plain(*args), KERNEL_REL_TOL)

    def library():
      return F.conv2d(F.silu(F.group_norm(x.permute(0, 3, 1, 2), groups,
                                          gamma, beta, 1e-6)),
                      w_oihw, b, padding=1)

    bound, bound_by = gn_conv_bound(n, h, w, c, o, groups)
    launches = launches_by_shape.get((h, w, c, o), 0)
    row = {"kernel": "gn_silu_conv3x3", "shape_nhwc_o": [n, h, w, c, o],
           "groups": groups, "max_abs_err": err, "max_abs_plain": scale,
           "kernel_ms": time_ms(lambda: gn_conv.gn_silu_conv3x3(*args)),
           "device_ms": graph_ms(lambda: gn_conv.gn_silu_conv3x3(*args)),
           "plain_ms": time_ms(lambda: gn_conv.gn_silu_conv3x3_plain(*args)),
           "library_ms": time_ms(library), "bound_ms": bound,
           "bound_by": bound_by, "launches": launches,
           "launches_per_forward": launches / evals}
    emit(row)
    rows.append(row)
  return rows


def _fir_library(mode, x, k):
  """One PyTorch call computing the same resample on the channels-last view
  of ``x``: a depthwise strided conv (down) or transposed conv (up)."""
  import torch
  import torch.nn.functional as F
  from soft_truncation_tpu_torch.ops import fir

  c = x.shape[-1]
  taps = torch.tensor(fir.fir2_taps(k, 1.0, mode), dtype=torch.float32,
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


def kernels_fir(fir_launched, evals):
  """fir2 (up and down) vs plain vs library at every shape the UNCSN++
  serve phase launched it at, N=8, T=4."""
  import torch
  from soft_truncation_tpu_torch.ops import fir

  gen = torch.Generator(DEVICE).manual_seed(0)
  rows = []
  for (mode, h, w, c) in sorted(fir_launched):
    x = torch.randn(SERVE_BATCH, h, w, c, generator=gen, device=DEVICE)
    wrapper, plain = ((fir.fir_upsample2, fir.fir_upsample2_plain)
                      if mode == "up" else
                      (fir.fir_downsample2, fir.fir_downsample2_plain))
    shape = (mode, SERVE_BATCH, h, w, c)
    want = plain(x, FIR_KERNEL)
    err, scale = _held(f"fir_{mode}sample2", shape, wrapper(x, FIR_KERNEL),
                       want, FIR_REL_TOL)
    library = _fir_library(mode, x, FIR_KERNEL)
    _held(f"the library {mode}sample", shape,
          library().permute(0, 2, 3, 1), want, FIR_REL_TOL)
    bound, bound_by = fir_bound(mode, SERVE_BATCH, h, w, c, len(FIR_KERNEL))
    launches = fir_launched[(mode, h, w, c)]
    row = {"kernel": f"fir_{mode}sample2",
           "shape_nhwc": [SERVE_BATCH, h, w, c], "taps": len(FIR_KERNEL),
           "max_abs_err": err, "max_abs_plain": scale,
           "kernel_ms": time_ms(lambda: wrapper(x, FIR_KERNEL)),
           "device_ms": graph_ms(lambda: wrapper(x, FIR_KERNEL)),
           "plain_ms": time_ms(lambda: plain(x, FIR_KERNEL)),
           "library_ms": time_ms(library), "bound_ms": bound,
           "bound_by": bound_by, "launches": launches,
           "launches_per_forward": launches / evals}
    emit(row)
    rows.append(row)
  return rows


def _kernel_entry(name, source, replaces, rows, per):
  """One entry of the ``kernels`` line: launches of the main paths, times
  summed over the shapes weighted by their launches per forward."""

  def per_forward(key):
    return sum(r[key] * r["launches_per_forward"] for r in rows)

  bound_by = max(("operations", "bytes"), key=lambda k: sum(
      r["bound_ms"] * r["launches_per_forward"] for r in rows
      if r["bound_by"] == k))
  return {"name": name, "route": "cuda", "source": source,
          "replaces": replaces, "launches": sum(r["launches"] for r in rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows),
          "ms": per_forward("kernel_ms"),
          "device_ms": per_forward("device_ms"),
          "plain_ms": per_forward("plain_ms"),
          "bound_ms": per_forward("bound_ms"), "bound_by": bound_by,
          "library_ms": per_forward("library_ms"),
          "per": f"{per}: {sum(r['launches_per_forward'] for r in rows):g} "
                 "launches, the serve phases' per shape"}


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
  launched, evals = phase("serve flagship", phase_serve_flagship, sites,
                          flag_params)
  u_launched, fir_launched, u_evals = phase(
      "serve uncsnpp", phase_serve_uncsnpp, u_sites, u_fir_sites, u_params)

  gn_launched = collections.Counter(launched) + collections.Counter(
      u_launched)
  t0 = time.perf_counter()
  gn_rows = kernels_gn(gn_launched, evals + u_evals)
  fir_rows = kernels_fir(fir_launched, u_evals)
  log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

  emit({"kernels": [
      _kernel_entry("gn_silu_conv3x3",
                    "soft_truncation_tpu_torch/csrc/gn_silu_conv3x3.cu",
                    "soft_truncation_tpu/ops/pallas/gn_conv.py:74", gn_rows,
                    f"one flagship or UNCSN++ eval forward at batch "
                    f"{SERVE_BATCH}"),
      *(_kernel_entry(f"fir_{mode}sample2",
                      "soft_truncation_tpu_torch/csrc/fir2.cu",
                      "soft_truncation_tpu/ops/pallas/fir.py:137",
                      [r for r in fir_rows
                       if r["kernel"] == f"fir_{mode}sample2"],
                      f"one UNCSN++ eval forward at batch {SERVE_BATCH}")
        for mode in ("up", "down"))]})
  log(f"total: {time.perf_counter() - t_all:.1f} s")
  log(device_line())
  emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                               "count": torch.cuda.device_count()}})
  return 0


if __name__ == "__main__":
  sys.exit(main())
