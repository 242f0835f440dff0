#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100): the quickest
proof that the port still builds, agrees with its plain versions and serves.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the last line is printed:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the serving path (sm_90a);
  3. forward: the full-width flagship (init_scale 0.1, batch 2) on the card
     and on a CPU copy with the same weights: agreement, and the kernel's
     launches per (H, W, C, O) equal to the CPU model's fused sites;
  4. serve (the main path), with the launch counts set to 0 just before it
     and read just after: the port's HTTP server at batch 8 answers
     /healthz and, with the flagship config as it is (init_scale 0),
     /sample with method 'ode' and 'dpm_solver' (20 steps); with the
     phase-3 weights (init_scale 0.1) it answers 'dpm_solver' (5 steps),
     and that batch is held against a CPU SamplingService run from the same
     prior. Every request twice: uint8 NHWC [8, 32, 32, 3], the same bytes
     per seed, and per shape one launch per fused site per evaluation;
  5. kernels: each kernel against its plain PyTorch version (TF32 off) at
     every shape the serve phase launched it at (N=8), with its time, the
     plain version's, the library chain's, the bound and the launches per
     forward measured in phase 4; one JSON line per shape.
Imports torch and the port only, never jax or the JAX package.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "soft_truncation_tpu_torch", "configs", "vp",
                        "CIFAR10", "ddpmpp_nll_st.py")
DEVICE = "cuda"
SERVE_BATCH = 8
# the flagship shapes phase 3 must cover: (H, W, C, O)
LISTED_SHAPES = [(32, 32, 128, 128), (32, 32, 384, 128), (32, 32, 256, 256),
                 (16, 16, 384, 256), (16, 16, 512, 256), (8, 8, 256, 256),
                 (4, 4, 512, 256)]
# H100 SXM datasheet: FP32 (no tensor cores) and HBM3 rates
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLAGSHIP_SITES = 82     # fused sites of one flagship eval forward
KERNEL_REL_TOL = 1e-4   # reordered f32 sums over K <= 9*512 terms
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


def gn_conv_bound(n, h, w, c, o, groups):
  """Least time (ms) and what bounds it: every input read once, the output
  written once, 2*9*C MACs per output element at the FP32 peak."""
  flops = 2 * n * h * w * c * o * 9
  bytes_ = 4 * (n * h * w * (c + o) + 9 * c * o + o + 2 * c + 2 * n * groups)
  t_ops, t_bytes = flops / PEAK_FP32_FLOPS, bytes_ / PEAK_BYTES
  return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                     else "bytes")


def flagship_config(**model_overrides):
  from soft_truncation_tpu_torch.configs.base import load_config
  config = load_config(FLAGSHIP)
  config.model.update(model_overrides)
  return config


def phase_kernels(launches_by_shape, evals):
  """Kernel vs plain vs library at every shape the serve phase launched
  the kernel at (and the listed flagship shapes), N=8."""
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

    got = gn_conv.gn_silu_conv3x3(*args)
    want = gn_conv.gn_silu_conv3x3_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= KERNEL_REL_TOL * scale):
      raise AssertionError(f"gn_silu_conv3x3 disagrees at {(n, h, w, c, o)}:"
                           f" max_abs_err {err} vs max|plain| {scale}")

    def library():
      return F.conv2d(F.silu(F.group_norm(x.permute(0, 3, 1, 2), groups,
                                          gamma, beta, 1e-6)),
                      w_oihw, b, padding=1)

    bound, bound_by = gn_conv_bound(n, h, w, c, o, groups)
    row = {"kernel": "gn_silu_conv3x3", "shape_nhwc_o": [n, h, w, c, o],
           "groups": groups, "max_abs_err": err, "max_abs_plain": scale,
           "kernel_ms": time_ms(lambda: gn_conv.gn_silu_conv3x3(*args)),
           "plain_ms": time_ms(lambda: gn_conv.gn_silu_conv3x3_plain(*args)),
           "library_ms": time_ms(library), "bound_ms": bound,
           "bound_by": bound_by,
           "launches": launches_by_shape.get((h, w, c, o), 0),
           "launches_per_forward":
               launches_by_shape.get((h, w, c, o), 0) / evals}
    emit(row)
    rows.append(row)
  return rows


def phase_forward():
  """Full-width flagship eval forward, card (kernel) vs CPU (plain).

  Returns the CPU model's fused sites per (H, W, C, O) and its weights."""
  import collections

  import torch
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.ops import gn_conv

  config = flagship_config(init_scale=0.1)
  cpu_model = create_model(config, "cpu", seed=0)
  gpu_model = create_model(config, DEVICE, seed=0)
  gen = torch.Generator("cpu").manual_seed(1)
  x = torch.randn(2, 32, 32, 3, generator=gen)
  labels = torch.tensor([0.01, 0.6]) * 999.0
  with torch.inference_mode():
    want = cpu_model(x, labels)
    sites = collections.Counter(cpu_model.fused_sites())
    gn_conv.reset_launch_counts()
    got = gpu_model(x.to(DEVICE), labels.to(DEVICE))
    torch.cuda.synchronize()
    launched = dict(gn_conv.gn_silu_conv3x3.launches_by_shape)
  err = (got.cpu() - want).abs().max().item()
  scale = want.abs().max().item()
  log(f"forward: max_abs_diff {err} max|out| {scale} fused sites "
      f"{sum(sites.values())} kernel launches {sum(launched.values())}")
  if not (torch.isfinite(got).all() and err <= FORWARD_REL_TOL * scale):
    raise AssertionError(f"card forward disagrees with CPU: {err} vs {scale}")
  if launched != dict(sites) or sum(sites.values()) != FLAGSHIP_SITES:
    raise AssertionError(f"expected {FLAGSHIP_SITES} fused sites each "
                         f"launching the kernel once; sites {dict(sites)}, "
                         f"launches {launched}")
  return dict(sites), cpu_model.state_dict()


def _post(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=600) as r:
    return r.read()


def _serve_requests(url, requests, config):
  """POST each request twice; check shape, dtype and determinism. Returns
  the network evaluations run and the first answer of each request."""
  import numpy as np
  evals, answers = 0, []
  for req in requests:
    bodies = []
    for _ in range(2):
      t0 = time.perf_counter()
      bodies.append(_post(url + "/sample", req))
      wall = time.perf_counter() - t0
      with np.load(io.BytesIO(bodies[-1])) as f:
        samples, nfe = f["samples"], int(f["nfe"])
      # the ode sampler's nfe, as in the JAX package, leaves out its final
      # denoising evaluation
      evals += nfe + (1 if req.get("method", "ode") == "ode"
                      and config.sampling.noise_removal else 0)
      inside = float(((samples > 0) & (samples < 255)).mean())
      log(f"serve: {json.dumps(req)} nfe {nfe} wall_s {wall:.3f} "
          f"mean {samples.mean():.3f} std {samples.std():.3f} "
          f"unsaturated {inside:.4f}")
      if (samples.shape != (SERVE_BATCH, 32, 32, 3)
          or samples.dtype != np.uint8):
        raise AssertionError(f"bad samples {samples.shape} {samples.dtype}")
      if samples.std() == 0:
        raise AssertionError("samples are constant")
    if bodies[0] != bodies[1]:
      raise AssertionError(f"same seed, different bytes: {req}")
    with np.load(io.BytesIO(bodies[0])) as f:
      answers.append(f["samples"])
  return evals, answers


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


def _check_against_cpu(service, params, served, seed, method, steps):
  """Hold one served batch against a CPU SamplingService on the same
  weights, run from the same prior (round 0 of ``seed``)."""
  import numpy as np
  import torch
  from soft_truncation_tpu_torch.eval.sampling_io import _to_uint8
  from soft_truncation_tpu_torch.serve.server import SamplingService

  prior = service.prior(seed, 0)
  card, _ = service.sampler(method, steps)(service.model, x=prior)
  ref_service = SamplingService(service.config, params, batch=SERVE_BATCH,
                                device="cpu")
  ref, _ = ref_service.sampler(method, steps)(ref_service.model,
                                              x=prior.cpu())
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


def phase_serve(sites, params):
  """The main path: the port's server answering sampling requests.

  ``sites``: the CPU model's fused sites per (H, W, C, O) in one forward;
  ``params``: the weights of phase 3 (init_scale 0.1). Returns the
  kernel's launches per shape in this phase and the evaluations run."""
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.ops import gn_conv
  from soft_truncation_tpu_torch.serve.server import SamplingService

  config = flagship_config()  # as published: init_scale 0
  service = SamplingService(
      config, create_model(config, "cpu", seed=1).state_dict(),
      batch=SERVE_BATCH, device=DEVICE)
  config01 = flagship_config(init_scale=0.1)
  service01 = SamplingService(config01, params, batch=SERVE_BATCH,
                              device=DEVICE)
  dpm01 = {"num": SERVE_BATCH, "seed": 3, "method": "dpm_solver",
           "dpm_steps": 5}

  def as_published(url):
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
      health = json.loads(r.read())
    if health["status"] != "ok":
      raise AssertionError(f"/healthz: {health}")
    return _serve_requests(
        url, [{"num": SERVE_BATCH, "seed": 0},
              {"num": SERVE_BATCH, "seed": 0, "method": "dpm_solver",
               "dpm_steps": 20}], config)[0]

  gn_conv.reset_launch_counts()
  evals = _serving(service, as_published)
  evals01, (served01,) = _serving(
      service01, lambda url: _serve_requests(url, [dpm01], config01))
  launched = dict(gn_conv.gn_silu_conv3x3.launches_by_shape)
  evals += evals01

  want = {s: k * evals for s, k in sites.items()}
  log(f"serve: {evals} network evaluations, "
      f"{sum(launched.values())} kernel launches")
  if launched != want:
    raise AssertionError(f"kernel launches per shape {launched} are not "
                         f"the fused sites x {evals} evaluations: {want}")
  _check_against_cpu(service01, params, served01, dpm01["seed"],
                     dpm01["method"], dpm01["dpm_steps"])
  return launched, evals


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
    from soft_truncation_tpu_torch.ops import _build
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

  t0 = time.perf_counter()
  _build.load_library("gn_silu_conv3x3")
  log(f"build: gn_silu_conv3x3 in {time.perf_counter() - t0:.1f} s")
  log(_build.library_path("gn_silu_conv3x3").with_suffix(".log")
      .read_text().strip())

  t0 = time.perf_counter()
  sites, params = phase_forward()
  log(f"phase forward: {time.perf_counter() - t0:.1f} s")

  t0 = time.perf_counter()
  launched, evals = phase_serve(sites, params)
  log(f"phase serve: {time.perf_counter() - t0:.1f} s")

  t0 = time.perf_counter()
  rows = phase_kernels(launched, evals)
  log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

  def per_forward(key):
    return sum(r[key] * r["launches_per_forward"] for r in rows)

  bound_by = max(("operations", "bytes"), key=lambda k: sum(
      r["bound_ms"] * r["launches_per_forward"] for r in rows
      if r["bound_by"] == k))
  emit({"kernels": [{
      "name": "gn_silu_conv3x3", "route": "cuda",
      "source": "soft_truncation_tpu_torch/csrc/gn_silu_conv3x3.cu",
      "replaces": "soft_truncation_tpu/ops/pallas/gn_conv.py:74",
      "launches": sum(launched.values()),
      "max_abs_err": max(r["max_abs_err"] for r in rows),
      "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
      "bound_ms": per_forward("bound_ms"), "bound_by": bound_by,
      "library_ms": per_forward("library_ms"),
      "per": (f"one flagship eval forward at batch {SERVE_BATCH}: "
              f"{sum(launched.values()) / evals:g} launches, the serve "
              f"phase's per shape")}]})
  log(f"total: {time.perf_counter() - t_all:.1f} s")
  log(device_line())
  emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                               "count": torch.cuda.device_count()}})
  return 0


if __name__ == "__main__":
  sys.exit(main())
