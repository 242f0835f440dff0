"""Look for faults in the hand-written kernels on the card.

Three checks, each a subcommand:

- ``forwards --runs N``: the flagship's full-width eval forward at batch 2
  (``chip_smoke.py`` phase 3's weights, inputs and labels), each time in a
  fresh process, against one CPU forward of the same model: a fault that
  shows only in a process's first launches (uninitialised memory, a race,
  an out-of-bounds read that depends on what ran before) shows here.
- ``sanitize``: both modes of ``gn_silu_conv3x3`` and ``fir2`` up, down
  and adjoint at the flagship's and UNCSN++'s site shapes (batch 2: split-K
  above 1 at every site, and tiles whose rows cross an image boundary at
  the 8x8 and 4x4 ones), once under each of ``compute-sanitizer``'s
  memcheck, racecheck, initcheck and synccheck;
- ``stress --repeat N``: the same launches N times each, the caching
  allocator filled with NaN before each (an output element or workspace
  row a kernel leaves unwritten comes out NaN), every result bit for bit
  the first (the kernels sum in a fixed order: a race shows as a
  difference) and within STRESS_REL_TOL of the plain version.

Run: ``python -m soft_truncation_tpu_torch.ops.fault_check forwards
--runs 30 --out DIR``, ``... sanitize --out DIR`` and ``... stress
--repeat 20 --out DIR``; each writes its
logs and a ``<subcommand>_summary.json`` under ``DIR``, prints the summary and exits 1
if a run disagreed or a tool reported an error. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
FLAGSHIP = (REPO / "soft_truncation_tpu_torch" / "configs" / "vp" / "CIFAR10"
            / "ddpmpp_nll_st.py")
LABELS = (0.01 * 999.0, 0.6 * 999.0)   # phase 3's VP labels, t * 999
FORWARD_REL_TOL = 1e-3                 # chip_smoke.py's card-vs-CPU bar
TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")
# (H, W, C, O) of the fused sites of the flagship and UNCSN++ (the same
# channel layout) and UNCSN++'s FIR sites (mode, H, W, C)
GN_SHAPES = ((32, 32, 128, 128), (32, 32, 384, 128), (32, 32, 256, 256),
             (16, 16, 384, 256), (16, 16, 512, 256), (8, 8, 256, 256),
             (4, 4, 512, 256), (16, 16, 256, 256), (4, 4, 256, 256),
             (8, 8, 512, 256))
FIR_SHAPES = (("down", 32, 32, 128), ("down", 16, 16, 256),
              ("down", 8, 8, 256), ("up", 4, 4, 256), ("up", 8, 8, 256),
              ("up", 16, 16, 256))
BATCH = 2
STRESS_REL_TOL = 1e-4  # chip_smoke.py's KERNEL_REL_TOL, the looser bar


def _flagship():
  from ..configs.base import load_config
  from ..models import create_model
  config = load_config(str(FLAGSHIP))
  config.model.init_scale = 0.1
  return config, create_model


def _inputs():
  gen = torch.Generator("cpu").manual_seed(1)
  return (torch.randn(len(LABELS), 32, 32, 3, generator=gen),
          torch.tensor(LABELS))


def forward_once(ref: str) -> dict:
  """One card forward in this process, against the saved CPU one."""
  from . import gn_conv
  config, create_model = _flagship()
  x, labels = _inputs()
  model = create_model(config, "cuda", seed=0)
  gn_conv.reset_launch_counts()
  with torch.inference_mode():
    got = model(x.cuda(), labels.cuda()).cpu()
  want = torch.load(ref)
  err = (got - want).abs().flatten(1).amax(1)
  scale = want.abs().flatten(1).amax(1)
  return {"max_abs_err": err.tolist(), "max_abs_out": scale.tolist(),
          "finite": bool(torch.isfinite(got).all()),
          "launches": gn_conv.gn_silu_conv3x3.launches,
          "ok": bool(torch.isfinite(got).all()
                     and (err <= FORWARD_REL_TOL * scale).all())}


def forwards(runs: int, out: Path) -> dict:
  from ._build import load_library
  for name in ("gn_silu_conv3x3", "fir2"):
    load_library(name)
  config, create_model = _flagship()
  x, labels = _inputs()
  t0 = time.perf_counter()
  model = create_model(config, "cpu", seed=0)
  with torch.inference_mode():
    want = model(x, labels)
  ref = out / "flagship_cpu_forward.pt"
  torch.save(want, ref)
  results = []
  for run in range(runs):
    proc = subprocess.run(
        [sys.executable, "-m", __spec__.name, "forward-once", "--ref",
         str(ref)], capture_output=True, text=True, cwd=REPO, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    result = (json.loads(lines[-1]) if proc.returncode == 0 and lines else
              {"ok": False, "rc": proc.returncode,
               "stderr": proc.stderr[-2000:]})
    result["run"] = run
    results.append(result)
    print(json.dumps(result), flush=True)
  return {"runs": runs, "failed": [r["run"] for r in results if not r["ok"]],
          "worst_rel_err": max((max(e / s for e, s in zip(
              r["max_abs_err"], r["max_abs_out"])) for r in results
              if "max_abs_err" in r), default=None),
          "seconds": time.perf_counter() - t0}


def _poison() -> None:
  """Leave the caching allocator's free blocks full of NaN, in its large
  pool (one 1 GiB block) and its small one (blocks of at most 1 MiB, 16
  MiB of them): a kernel output or workspace it hands out next starts as
  NaN, so an element the kernel never writes (or a workspace row it reads
  before a split writes it) shows."""
  held = [torch.full((1 << 28,), float("nan"), device="cuda")]
  held += [torch.full((1 << 17,), float("nan"), device="cuda")
           for _ in range(32)]
  del held


def kernels_once(repeat: int = 1, poison: bool = False) -> dict:
  """Every kernel mode at every shape on the card, each held against its
  plain version there (what a sanitizer watches): with ``repeat`` > 1 each
  launch ``repeat`` times, every result bit for bit the first (the kernels
  sum in a fixed order: a race would show as a difference), and with
  ``poison`` the allocator poisoned before each launch. Returns per shape
  the worst error relative to the plain version's largest value, and the
  launches that differed from the first."""
  from . import fir, gn_conv
  gen = torch.Generator("cpu").manual_seed(0)

  def randn(*shape):
    return torch.randn(*shape, generator=gen).cuda()

  def launched(fn):
    outs = []
    for _ in range(repeat):
      if poison:
        _poison()
      outs.append(fn())
    return outs[0], sum(not torch.equal(o, outs[0]) for o in outs[1:])

  def rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()

  worst = {}
  with torch.no_grad():  # no autograd.Function, as serving calls them
    for h, w, c, o in GN_SHAPES:
      groups = min(c // 4, 32)
      x, dx = randn(BATCH, h, w, c), randn(BATCH, h, w, c)
      mean, rsqrt = gn_conv.gn_stats(x, groups)
      dmean, drsqrt = randn(BATCH, groups), randn(BATCH, groups)
      gamma, beta = randn(c), randn(c)
      wt, b = randn(3, 3, c, o) * 0.05, randn(o)
      plan = gn_conv.launch_plan(BATCH, h, w, c, o, groups,
                                 gn_conv._sms(x.device))
      got, moved = launched(lambda: gn_conv.gn_silu_conv3x3(
          x, mean, rsqrt, gamma, beta, wt, b, groups))
      dgot, dmoved = launched(lambda: gn_conv.gn_silu_conv3x3_jvp(
          x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wt, groups))
      want = gn_conv.gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, wt,
                                           b, groups)
      dwant = gn_conv.gn_silu_conv3x3_jvp_plain(x, dx, mean, dmean, rsqrt,
                                                drsqrt, gamma, beta, wt,
                                                groups)
      worst[f"gn {h}x{w}x{c}->{o} splits {plan.splits} slots "
            f"{plan.slots}"] = [rel(got, want), rel(dgot, dwant), moved,
                                dmoved]
    for mode, h, w, c in FIR_SHAPES:
      x = randn(BATCH, h, w, c)
      f = fir.fir_upsample2 if mode == "up" else fir.fir_downsample2
      got, moved = launched(lambda: f(x, (1, 3, 3, 1)))
      want = fir._fir2_plain(x, (1, 3, 3, 1), 1.0, mode)
      ybar = randn(*got.shape)
      adj, amoved = launched(lambda: fir.fir2_backward(
          ybar, (1, 3, 3, 1), 1.0, mode, tuple(x.shape)))
      with torch.enable_grad():
        xr = x.clone().requires_grad_(True)
        (adj_want,) = torch.autograd.grad(
            fir._fir2_plain(xr, (1, 3, 3, 1), 1.0, mode), xr, ybar)
      worst[f"fir2 {mode} {h}x{w}x{c}"] = [rel(got, want),
                                           rel(adj, adj_want), moved, amoved]
  torch.cuda.synchronize()
  return worst


def stress(repeat: int, out: Path) -> dict:
  """:func:`kernels_once` with ``repeat`` launches each, the allocator
  poisoned before each: what the sanitizers would look for in global
  memory (unwritten outputs, workspace read before written) and run to run
  differences (races), without them."""
  t0 = time.perf_counter()
  worst = kernels_once(repeat, poison=True)
  return {"repeat": repeat, "per_shape": worst,
          "failed": [k for k, (e, de, m, dm) in worst.items()
                     if not (e <= STRESS_REL_TOL and de <= STRESS_REL_TOL)
                     or m or dm],
          "seconds": time.perf_counter() - t0}


def sanitize(out: Path) -> dict:
  from ._build import load_library
  for name in ("gn_silu_conv3x3", "fir2"):
    load_library(name)
  tool_bin = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/" \
      "compute-sanitizer"
  summary = {}
  for tool in TOOLS:
    t0 = time.perf_counter()
    cmd = [tool_bin, "--tool", tool, "--error-exitcode", "99",
           sys.executable, "-m", __spec__.name, "kernels-once"]
    try:
      proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                            timeout=240)
      text, rc = proc.stdout + proc.stderr, proc.returncode
    except (OSError, subprocess.TimeoutExpired) as e:
      text, rc = repr(e), None
    (out / f"{tool}.log").write_text(text)
    errors = [l for l in text.splitlines() if "ERROR SUMMARY" in l]
    summary[tool] = {"rc": rc, "error_summary": errors[-1:] or None,
                     "device_not_supported": "Device not supported" in text,
                     "seconds": time.perf_counter() - t0,
                     "tail": text.strip().splitlines()[-3:]}
    print(json.dumps({tool: summary[tool]}), flush=True)
  return summary


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  sub = p.add_subparsers(dest="cmd", required=True)
  f = sub.add_parser("forwards")
  f.add_argument("--runs", type=int, default=30)
  f.add_argument("--out", default="build/fault_check")
  s = sub.add_parser("sanitize")
  s.add_argument("--out", default="build/fault_check")
  st = sub.add_parser("stress")
  st.add_argument("--repeat", type=int, default=20)
  st.add_argument("--out", default="build/fault_check")
  o = sub.add_parser("forward-once")
  o.add_argument("--ref", required=True)
  sub.add_parser("kernels-once")
  args = p.parse_args(argv)
  if not torch.cuda.is_available():
    print("fault_check: no CUDA device", file=sys.stderr)
    return 2
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.deterministic = True
  if args.cmd == "forward-once":
    result = forward_once(args.ref)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1
  if args.cmd == "kernels-once":
    print(json.dumps(kernels_once()), flush=True)
    return 0
  out = Path(args.out)
  out.mkdir(parents=True, exist_ok=True)
  if args.cmd == "forwards":
    summary = forwards(args.runs, out)
    bad = bool(summary["failed"])
  elif args.cmd == "stress":
    summary = stress(args.repeat, out)
    bad = bool(summary["failed"])
  else:
    summary = sanitize(out)
    bad = any(v["rc"] != 0 for v in summary.values())
  (out / f"{args.cmd}_summary.json").write_text(json.dumps(summary, indent=1))
  print(json.dumps({args.cmd: summary}), flush=True)
  return 1 if bad else 0


if __name__ == "__main__":
  sys.exit(main())
