"""Time the bfloat16 ``gn_silu_conv3x3`` (primal and tangent), or with
``--f32`` the float32 one, on the card at the flagship's site shapes, one
kernel name at a time.

For each of the 13 (H, W, C, O) shapes that one eval forward of the flagship
(or UNCSN++) at batch 8 fuses, with its launches per forward, this holds
the kernel against its plain version and times it three ways: device ms
per call from a CUDA graph of the calls; per kernel name from
``torch.profiler`` (the conv and, where the launch plan splits K over
launches, the reduce kernel, separately); and the library chain
(``F.group_norm`` -> ``F.silu`` -> ``F.conv2d`` in bf16, channels-last; the
tangent: ``torch.func.jvp`` of it) beside it in turns. It prints one JSON
line per (mode, shape) and, per mode, the sums per forward weighted by the
launches, with the bound (the flops at the dense bf16 rate or the bytes at
the HBM rate, whichever is larger). ``--f32``: the f32 modes (the primal,
``csrc/gn_silu_conv3x3.cu``, for reference; the tangent,
``csrc/gn_silu_conv3x3_jvp.cu``), the library chain in f32 with TF32 off,
the bound at the dense TF32 rate (and the 3xTF32 products' floor beside
it), 4-byte elements; a tangent's sum is per likelihood function
evaluation, whose fused sites are the forward's. ``--check`` only holds
the modes against their plain versions (bf16 at REL_TOL, f32 at
F32_REL_TOL), at those shapes and at ragged ones (tiles that straddle
images, a row wider than a tile, C % 8 != 0, O off the block widths and
past 256), and exits 1 if any is off: the bf16 modes and the f32 tangent,
or with ``--f32`` both f32 modes.

It imports the package it finds first on ``sys.path``, so the same file
times another checkout's kernel: ``PYTHONPATH=<checkout> python
soft_truncation_tpu_torch/ops/gn_conv_sites.py`` (``PYTHONPATH=.`` for this
checkout). Run on the card only.

  PYTHONPATH=. python soft_truncation_tpu_torch/ops/gn_conv_sites.py [--mode primal|tangent|both]
      [--f32] [--batch 8] [--reps 20] [--out FILE] [--check]

Parent and change in turns: run it from this checkout with PYTHONPATH set
to each checkout in turn (parent, change, change, parent) in one call.
"""

from __future__ import annotations

import argparse
import json
import sys

# (H, W, C, O) -> fused launches per flagship eval forward at any batch
SITES = {
    (32, 32, 128, 128): 13, (32, 32, 256, 128): 4, (32, 32, 384, 128): 1,
    (32, 32, 256, 256): 1, (16, 16, 256, 256): 13, (16, 16, 512, 256): 4,
    (16, 16, 384, 256): 1, (16, 16, 128, 256): 1, (16, 16, 128, 128): 1,
    (8, 8, 256, 256): 15, (8, 8, 512, 256): 5, (4, 4, 256, 256): 18,
    (4, 4, 512, 256): 5}
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
REL_TOL = 1e-2  # the bf16 kernels' bar against their plain versions
F32_REL_TOL = 1e-4  # the f32 kernels' (chip_smoke.py's KERNEL_REL_TOL)
# (N, H, W, C, O, groups) no model reaches (the last: one raw tile in the
# tangent)
RAGGED = ((3, 5, 7, 36, 20, 12), (2, 4, 4, 16, 16, 4), (1, 32, 32, 128, 128, 32),
          (2, 3, 100, 24, 40, 4), (1, 3, 3, 8, 300, 4), (5, 2, 2, 12, 8, 3),
          (3, 1, 1, 8, 300, 4))


def bound_ms(n, h, w, c, o, groups, tangent, f32=False, passes=1):
  """Least ms for the call: its flops (``passes`` times) at the dense bf16
  rate (``f32``: TF32), or every input read once and the output written
  once at the HBM rate."""
  flops = 2 * n * h * w * c * o * 9 * passes
  streams = 2 if tangent else 1
  es = 4 if f32 else 2
  bytes_ = es * (n * h * w * (streams * c + o) + 9 * c * o + o) + 4 * (
      2 * c + 2 * streams * n * groups)
  peak = PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS
  return max(flops / peak, bytes_ / PEAK_BYTES) * 1e3


def graph_ms(fn, reps):
  """Device ms per call, from a CUDA graph of ``reps`` calls."""
  import torch
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(reps):
      fn()
  graph.replay()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def profiled_ms(fn, reps):
  """{kernel name: device ms per call} from torch.profiler over ``reps``
  calls (empty where the profiler records no device activity)."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  out = {}
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    if us:
      out[evt.key] = out.get(evt.key, 0.0) + us / 1e3 / reps
  return out


def site_row(shape, n, tangent, reps, gen, groups=None, f32=False):
  """One shape's row; ``reps`` 0: the check against the plain version
  alone. The stats' tangents are those of x's (torch.func.jvp of
  gn_stats), or with ``groups`` given (a ragged shape) drawn at random:
  at a 1x1 image with 2 channels a group the normalised value's tangent is
  0 up to rounding, which no relative bar can read."""
  import torch
  import torch.nn.functional as F
  from soft_truncation_tpu_torch.ops import gn_conv

  h, w, c, o = shape
  dev = "cuda"
  dtype = torch.float32 if f32 else torch.bfloat16
  x, dx = (torch.randn(n, h, w, c, generator=gen, device=dev).to(dtype)
           for _ in range(2))
  gamma, beta = (torch.randn(c, generator=gen, device=dev) for _ in range(2))
  wgt = torch.randn(3, 3, c, o, generator=gen, device=dev).to(dtype)
  b = torch.randn(o, generator=gen, device=dev).to(dtype)
  split = gn_conv.weight_operand(wgt)
  w_oihw = wgt.permute(3, 2, 0, 1).contiguous()
  g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
  if tangent:
    ragged = groups is not None
    groups = groups or min(c // 4, 32)
    (mean, rsqrt), (dmean, drsqrt) = torch.func.jvp(
        lambda v: gn_conv.gn_stats(v, groups), (x,), (dx,))
    if ragged:
      dmean, drsqrt = (torch.randn(n, groups, generator=gen, device=dev)
                       for _ in range(2))
    args = (x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wgt, groups)
    # the tangent's own operand where the checkout has one (a checkout
    # before the f32 tangent's redesign takes the primal's)
    jsplit = getattr(gn_conv, "jvp_weight_operand",
                     gn_conv.weight_operand)(wgt)

    def kernel():
      return gn_conv.gn_silu_conv3x3_jvp(*args, w_split=jsplit)

    def plain():
      return gn_conv.gn_silu_conv3x3_jvp_plain(*args)

    xc, dxc = (t.permute(0, 3, 1, 2).contiguous() for t in (x, dx))

    def library():
      return torch.func.jvp(
          lambda v: F.conv2d(F.silu(F.group_norm(v, groups, g_lib, b_lib,
                                                 1e-6)), w_oihw, b,
                             padding=1), (xc,), (dxc,))
  else:
    groups = groups or min(c // 4, 32)
    mean, rsqrt = gn_conv.gn_stats(x, groups)
    args = (x, mean, rsqrt, gamma, beta, wgt, b, groups)

    def kernel():
      return gn_conv.gn_silu_conv3x3(*args, w_split=split)

    def plain():
      return gn_conv.gn_silu_conv3x3_plain(*args)

    xl = x.permute(0, 3, 1, 2)  # channels-last NCHW view
    w_cl = w_oihw.contiguous(memory_format=torch.channels_last)

    def library():
      return F.conv2d(F.silu(F.group_norm(xl, groups, g_lib, b_lib, 1e-6)),
                      w_cl, b, padding=1)

  with torch.inference_mode():
    got, want = kernel().float(), plain().float()
    again = kernel().float()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    plan = gn_conv.launch_plan(n, h, w, c, o, groups,
                               gn_conv._sms(x.device), tangent, not f32)
    tol = F32_REL_TOL if f32 else REL_TOL
    same = bool(torch.equal(got, again))
    row = {"mode": "tangent" if tangent else "primal",
           "dtype": "float32" if f32 else "bfloat16",
           "shape_nhwc_o": [n, h, w, c, o], "groups": groups,
           "grid": list(plan.grid), "splits": plan.splits, "smem": plan.smem,
           "block_n": plan.block_n, "stages": plan.stages,
           "raws": plan.raws, "max_abs_err": err, "max_abs_plain": scale,
           "same_bits": same,
           "ok": bool(err <= tol * scale and torch.isfinite(got).all()
                      and same)}
    if not reps:
      return row
    # kernel and library in turns, on the device
    turns = [graph_ms(f, reps) for f in (kernel, library, kernel, library)]
    kernels = profiled_ms(kernel, reps)
    lib_kernels = profiled_ms(library, reps)
  return dict(
      row, launches_per_forward=SITES[shape],
      device_ms=(turns[0] + turns[2]) / 2,
      library_device_ms=(turns[1] + turns[3]) / 2,
      turns_ms=turns, kernels_ms=kernels, library_kernels_ms=lib_kernels,
      bound_ms=bound_ms(n, h, w, c, o, groups, tangent, f32),
      bound_3xtf32_ms=bound_ms(n, h, w, c, o, groups, tangent, f32, 3)
      if f32 else None)


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--mode", choices=("primal", "tangent", "both"),
                 default="both")
  p.add_argument("--f32", action="store_true",
                 help="the float32 modes (the tangent: "
                      "csrc/gn_silu_conv3x3_jvp.cu), TF32 off")
  p.add_argument("--batch", type=int, default=8)
  p.add_argument("--reps", type=int, default=20)
  p.add_argument("--out", default=None, help="also append the rows here")
  p.add_argument("--check", action="store_true",
                 help="hold the kernels against their plain versions only")
  args = p.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("gn_conv_sites: no CUDA device", file=sys.stderr)
    return 2
  from soft_truncation_tpu_torch.ops import gn_conv
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator("cuda").manual_seed(0)
  modes = (False, True) if args.mode == "both" else (args.mode == "tangent",)
  rows, ok = [], True
  if args.check:
    # the chosen dtype's modes; without --f32 the f32 tangent as well
    checks = [(tangent, args.f32) for tangent in modes]
    if not args.f32:
      checks.append((True, True))
    for tangent, f32 in checks:
      cases = [((args.batch,) + shape + (None,)) for shape in SITES]
      for n, h, w, c, o, groups in cases + list(RAGGED):
        row = site_row((h, w, c, o), n, tangent, 0, gen, groups, f32)
        print(json.dumps(row), flush=True)
        ok &= row["ok"]
    return 0 if ok else 1
  for tangent in modes:
    per = {"kernel": 0.0, "library": 0.0, "bound": 0.0, "bound_3x": 0.0,
           "by_name": {}}
    for shape in SITES:
      row = site_row(shape, args.batch, tangent, args.reps, gen,
                     f32=args.f32)
      row["source"] = gn_conv.__file__
      print(json.dumps(row), flush=True)
      rows.append(row)
      ok &= row["ok"]
      k = row["launches_per_forward"]
      per["kernel"] += k * row["device_ms"]
      per["library"] += k * row["library_device_ms"]
      per["bound"] += k * row["bound_ms"]
      per["bound_3x"] += k * (row["bound_3xtf32_ms"] or 0.0)
      for name, ms in row["kernels_ms"].items():
        per["by_name"][name] = per["by_name"].get(name, 0.0) + k * ms
    summary = {"mode": "tangent" if tangent else "primal",
               "dtype": "float32" if args.f32 else "bfloat16",
               "per_forward_device_ms": per["kernel"],
               "per_forward_library_device_ms": per["library"],
               "per_forward_bound_ms": per["bound"],
               "per_forward_by_kernel_ms": per["by_name"],
               "per_forward_bound_3xtf32_ms": per["bound_3x"] or None,
               "launches_per_forward": sum(SITES.values()),
               "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    rows.append(summary)
  if args.out:
    with open(args.out, "a") as f:
      for row in rows:
        f.write(json.dumps(row) + "\n")
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
