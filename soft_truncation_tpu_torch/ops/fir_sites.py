"""Time the bfloat16 ``fir2`` (forward, adjoint and tangent) on the card at
UNCSN++'s bf16 site shapes, each route apart.

The shapes and their launches are those ``chip_smoke.py`` phase 13 counts
with every dtype knob bfloat16: per train step at batch 128, 6 up + 5 down
forward and 11 adjoint launches (the adjoint being the resample in the
other mode, taps reversed, gain 4 or 1/4, sized to the forward's input);
per eval forward, and per likelihood function evaluation's tangent, at
batch 8, 3 up + 2 down. Per shape this holds the kernel against its plain
version and times in turns, from CUDA graphs of ``--reps`` launches: the
operator's launch (``soft_truncation::fir2``, the route the plan names;
also issued eagerly, the host's cost where it exceeds the device's),
on this checkout each route forced (``tma``, ``direct``), and cuDNN's
depthwise bf16 call on the channels-last view (a strided conv down, a
transposed one up); beside them the bound, every input byte read once and
every output byte written once at 3.35 TB/s. Each graph reads the same
input every call (warm: what the earlier rows of PERF.md measured), or
with ``--cold`` copies of it in turn, too many together for L2. It prints
one JSON line per (kind, shape) and the sums per step and per forward,
weighted by the launches. ``--f32`` times the same sites in float32 (the
f32 kernel, ``csrc/fir2.cu``), against the parent's the same way.

``--check`` only holds the kernel (the plan's route and, where the plan
offers it, each route forced) against ``_fir2_plain`` at those shapes and at
ragged ones (C = 3 and 12, C past a slab, odd H and W, out_hw = 2H + 1, the
mesh's halo'd shard rows, T = 2 and 6, images that fill no band): every
element within one bf16 ulp of the plain version's, the count of those off
by one printed; exits 1 if any element is further off.

It imports the package it finds first on ``sys.path``, so the same file
times another checkout's kernel: ``PYTHONPATH=<checkout> python
soft_truncation_tpu_torch/ops/fir_sites.py`` (``PYTHONPATH=.`` for this
checkout; an earlier checkout has one route, timed through the operator).
Run on the card only.

  PYTHONPATH=. python soft_truncation_tpu_torch/ops/fir_sites.py
      [--reps 20] [--out FILE] [--check] [--cold] [--f32]
"""

from __future__ import annotations

import argparse
import json
import sys

from soft_truncation_tpu_torch.ops.gn_conv_sites import graph_ms

TAPS = (1.0, 3.0, 3.0, 1.0)
PEAK_BYTES = 3.35e12
COLD_BYTES = 128 << 20  # --cold: inputs a graph cycles through, in bytes
F32_REL_TOL = 1e-5  # --f32: <= 16 f32 products summed in another order
STEP, FORWARD = 128, 8
# (kind, launched mode, N, H, W, C) -> launches per step ('step',
# 'adjoint') or per eval forward / function evaluation ('forward',
# 'tangent'); the adjoint's shape is its cotangent's
SITES = {
    ("step", "up", STEP, 4, 4, 256): 2, ("step", "up", STEP, 8, 8, 256): 2,
    ("step", "up", STEP, 16, 16, 256): 2,
    ("step", "down", STEP, 8, 8, 256): 1,
    ("step", "down", STEP, 16, 16, 256): 2,
    ("step", "down", STEP, 32, 32, 128): 2,
    ("adjoint", "down", STEP, 8, 8, 256): 2,
    ("adjoint", "down", STEP, 16, 16, 256): 2,
    ("adjoint", "down", STEP, 32, 32, 256): 2,
    ("adjoint", "up", STEP, 4, 4, 256): 1,
    ("adjoint", "up", STEP, 8, 8, 256): 2,
    ("adjoint", "up", STEP, 16, 16, 128): 2,
    **{(kind, mode, FORWARD, h, h, c): 1 for kind in ("forward", "tangent")
       for mode, h, c in (("up", 4, 256), ("up", 8, 256), ("up", 16, 256),
                          ("down", 16, 256), ("down", 32, 128))}}
# (mode, N, H, W, C, out_hw, taps) no UNCSN++ site reaches: the direct
# route's 1- and 4-wide vectors (C = 3, 12), a slab past C (C = 72), odd
# sizes, the adjoint of a downsample of an odd size (2H + 1), the mesh's
# halo'd shard rows (H/2 + 4 down, H/2 + 2 up, at CelebA-HQ's 256^2
# levels), images that fill no band and rows cut into column tiles
RAGGED = (("up", 2, 5, 7, 3, None, TAPS), ("down", 2, 9, 7, 12, None, TAPS),
          ("up", 3, 5, 7, 72, (11, 15), TAPS),
          ("down", 5, 33, 31, 64, None, TAPS),
          ("down", 2, 68, 128, 128, None, TAPS),
          ("up", 2, 34, 64, 256, None, TAPS),
          ("up", 7, 3, 3, 8, None, (1.0, 1.0)),
          ("down", 3, 20, 150, 16, None, (1.0, 2.0, 4.0, 2.0, 1.0, 1.0)),
          ("up", 1, 6, 140, 64, (13, 281), (1.0, 2.0, 4.0, 2.0, 1.0, 1.0)),
          ("up", 128, 16, 16, 256, (33, 33), TAPS))


def bound_ms(n, h, w, c, oh, ow, es=2):
  """Every input byte read once, every output byte written once (``es``
  bytes an element)."""
  return es * n * c * (h * w + oh * ow) / PEAK_BYTES * 1e3


def issued_ms(fn, reps):
  """ms per call issued from the host, eagerly: CUDA events around
  ``reps`` calls (the host's cost per launch where it exceeds the
  device's)."""
  import torch
  for _ in range(3):
    fn()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def library(mode, x, k, gain=1.0):
  """One PyTorch call computing the same resample on the channels-last view
  of ``x`` (cuDNN's depthwise conv, in x's dtype): a strided conv (down) or
  a transposed one (up)."""
  import torch
  import torch.nn.functional as F
  from soft_truncation_tpu_torch.ops import fir
  c = x.shape[-1]
  taps = torch.tensor(fir.fir2_taps(k, gain, mode), dtype=x.dtype,
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


def ulps(got, want):
  """Per element, how many bf16 steps ``got`` lies from ``want`` (both
  bf16): their bit patterns mapped to integers in the order of the values
  they stand for (-0 and +0 both 0)."""
  import torch

  def ordered(t):
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)

  return (ordered(got) - ordered(want)).abs()


def held(x, k, gain, mode, out_hw, path=None):
  """The kernel (the plan's route, or ``path``) against the plain version:
  the largest distance in bf16 steps and how many elements are one off."""
  import torch
  from soft_truncation_tpu_torch.ops import fir
  if path is None:
    with torch.inference_mode():
      wrapper = fir.fir_upsample2 if mode == "up" else fir.fir_downsample2
      got = fir._resample(x, k, gain, mode, wrapper, "forward", out_hw)
  else:
    got, taken = fir._launch(x, k, gain, mode, out_hw, x.device, path)
    assert taken == path, (taken, path)
  want = fir._fir2_plain(x, k, gain, mode, out_hw)
  torch.cuda.synchronize()
  if x.dtype == torch.float32:  # the f32 kernel: reordered f32 sums
    err = (got - want).abs().max().item()
    return {"max_rel_err": err / want.abs().max().item(),
            "finite": bool(torch.isfinite(got).all().item())}
  d = ulps(got, want)
  return {"max_ulps": int(d.max().item()),
          "one_ulp": int((d == 1).sum().item()),
          "elements": d.numel(),
          "finite": bool(torch.isfinite(got.float()).all().item())}


def routes(fir):
  """The routes this checkout's bf16 kernel has (an earlier one: none to
  force)."""
  return ("tma", "direct") if hasattr(fir, "band_plan") else ()


def check(gen) -> bool:
  import torch
  from soft_truncation_tpu_torch.ops import fir
  from soft_truncation_tpu_torch.ops.gn_conv import _sms
  cases = [(mode, n, h, w, c, None, TAPS)
           for (_, mode, n, h, w, c) in SITES] + list(RAGGED)
  ok = True
  for mode, n, h, w, c, out_hw, k in dict.fromkeys(cases):
    x = torch.randn(n, h, w, c, generator=gen, device="cuda").bfloat16()
    gain = 1.0 if len(k) % 2 or mode == "up" else 4.0
    row = {"mode": mode, "shape_nhwc": [n, h, w, c], "out_hw": out_hw,
           "taps": len(k)}
    if hasattr(fir, "band_plan"):
      plan = fir.band_plan(mode, len(k), (n, h, w, c), out_hw or (
          fir._out_size(h, len(k), mode), fir._out_size(w, len(k), mode)),
          _sms(x.device))
      row.update(path=plan.path, band=plan.band, box=plan.box,
                 tiles=plan.tiles, grid=plan.grid, stages=plan.stages)
    row["plan"] = held(x, k, gain, mode, out_hw)
    for path in routes(fir):
      if path == "tma" and c % 8:
        continue
      row[path] = held(x, k, gain, mode, out_hw, path)
    row["ok"] = all(r["max_ulps"] <= 1 and r["finite"] for key, r in
                    row.items() if key in ("plan", "tma", "direct"))
    ok &= row["ok"]
    print(json.dumps(row), flush=True)
  return ok


def site_row(site, reps, gen, cold=False, f32=False):
  import torch
  from soft_truncation_tpu_torch.ops import fir
  kind, mode, n, h, w, c = site
  x = torch.randn(n, h, w, c, generator=gen, device="cuda").to(
      torch.float32 if f32 else torch.bfloat16)
  # cold: each call of a graph reads another copy of x, the copies past
  # COLD_BYTES together, so no call finds its input in the 50 MB L2
  ring = [x] + [x.clone() for _ in range(
      min(reps, -(-COLD_BYTES // (x.numel() * x.element_size()))) - 1)
      ] if cold else [x]
  turn = iter(range(1 << 30))

  def nxt():
    return ring[next(turn) % len(ring)]
  if kind == "adjoint":  # the other mode, taps reversed, at x's size
    k = tuple(reversed(TAPS))
    gain = 0.25 if mode == "up" else 4.0
    out_hw = (h // 2, w // 2) if mode == "down" else (2 * h, 2 * w)
  else:
    k, gain, out_hw = TAPS, 1.0, None
  wrapper = fir.fir_upsample2 if mode == "up" else fir.fir_downsample2
  tally = {"step": "forward", "forward": "forward", "tangent": "jvp",
           "adjoint": "backward"}[kind]

  def operator():
    return fir._resample(nxt(), k, gain, mode, wrapper, tally, out_hw)

  libs = [library(mode, xi, k, gain) for xi in ring]
  fns = {"kernel": operator,
         "library": lambda: libs[next(turn) % len(libs)]()}
  for path in () if f32 else routes(fir):
    fns[path] = (lambda p: lambda: fir._launch(nxt(), k, gain, mode, out_hw,
                                               x.device, p))(path)
  with torch.inference_mode():
    plan_check = held(x, k, gain, mode, out_hw)
    turns = {name: [] for name in fns}
    issued = []
    for _ in range(2):
      for name, fn in fns.items():
        turns[name].append(graph_ms(fn, reps))
      issued.append(issued_ms(operator, reps))
  oh, ow = (2 * h, 2 * w) if mode == "up" else (h // 2, w // 2)
  row = {"kind": kind, "mode": mode, "shape_nhwc": [n, h, w, c],
         "dtype": str(x.dtype).split(".")[-1],
         "launches": SITES[site], "check": plan_check, "inputs": len(ring),
         "bound_ms": bound_ms(n, h, w, c, oh, ow, x.element_size()),
         **{f"{name}_ms": sum(t) / 2 for name, t in turns.items()},
         "issued_ms": sum(issued) / 2,
         "turns_ms": turns, "source": fir.__file__}
  if hasattr(fir, "band_plan") and not f32:
    from soft_truncation_tpu_torch.ops.gn_conv import _sms
    plan = fir.band_plan(mode, 4, (n, h, w, c), (oh, ow), _sms(x.device))
    row.update(path=plan.path, band=plan.band, box=plan.box,
               tiles=plan.tiles, grid=plan.grid, stages=plan.stages)
  return row


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--reps", type=int, default=20)
  p.add_argument("--out", default=None, help="also append the rows here")
  p.add_argument("--check", action="store_true",
                 help="hold the kernel against its plain version only")
  p.add_argument("--f32", action="store_true",
                 help="the same sites in float32: the f32 kernel (fir2.cu), "
                 "beside the bf16 one")
  p.add_argument("--cold", action="store_true",
                 help="each call reads another copy of its input (COLD_BYTES"
                 " of copies), none of them left in L2 by the call before")
  args = p.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print("fir_sites: no CUDA device", file=sys.stderr)
    return 2
  gen = torch.Generator("cuda").manual_seed(0)
  if args.check:
    return 0 if check(gen) else 1
  rows, ok = [], True
  sums = {}
  for site in SITES:
    row = site_row(site, args.reps, gen, args.cold, args.f32)
    print(json.dumps(row), flush=True)
    rows.append(row)
    ok &= (row["check"]["max_rel_err"] <= F32_REL_TOL if args.f32
           else row["check"]["max_ulps"] <= 1)
    per = sums.setdefault((row["kind"], row["mode"]), {})
    for key, value in row.items():
      if key.endswith("_ms") and key != "turns_ms":
        per[key] = per.get(key, 0.0) + row["launches"] * value
  for (kind, mode), per in sums.items():
    summary = {"sum": kind, "mode": mode,
               "per": "train step at batch 128" if kind in ("step", "adjoint")
               else "eval forward or function evaluation at batch 8",
               **per, "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    rows.append(summary)
  if args.out:
    with open(args.out, "a") as f:
      for row in rows:
        f.write(json.dumps(row) + "\n")
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main())
