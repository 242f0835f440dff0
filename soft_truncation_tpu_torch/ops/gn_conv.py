"""Fused GroupNorm-apply + SiLU + 3x3 conv (NHWC, forward), for Hopper.

Counterpart of ``soft_truncation_tpu/ops/pallas/gn_conv.py``. The GroupNorm
statistics (:func:`gn_stats`) and the fold of stats and affine into a
per-(sample, channel) scale and shift stay plain torch ops; the rest,
``conv3x3(SiLU(x*scale + shift), zero pad) + b``, is one hand-written CUDA
kernel (``csrc/gn_silu_conv3x3.cu``), so the normalised slab never reaches
device memory.

:func:`gn_silu_conv3x3` launches the kernel for CUDA tensors and takes the
plain version, :func:`gn_silu_conv3x3_plain`, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library

_KERNEL = "gn_silu_conv3x3"


def gn_stats(x: torch.Tensor, groups: int = 32, eps: float = 1e-6):
  """Per-(sample, group) ``(mean, rsqrt)`` of an NHWC tensor, in f32."""
  n, h, w, c = x.shape
  xg = x.float().reshape(n, h * w, groups, c // groups)
  mean = xg.mean(dim=(1, 3))
  var = xg.square().mean(dim=(1, 3)) - mean.square()
  return mean, torch.rsqrt(var + eps)


def _fold(mean, rsqrt, gamma, beta, groups: int):
  """Per-(sample, channel) ``scale, shift`` with x*scale + shift == GN(x)."""
  cg = gamma.shape[0] // groups
  scale = rsqrt.repeat_interleave(cg, dim=1) * gamma[None, :]
  shift = beta[None, :] - mean.repeat_interleave(cg, dim=1) * scale
  return scale.float().contiguous(), shift.float().contiguous()


def _check(x, mean, rsqrt, gamma, beta, w, b, groups: int):
  if x.dim() != 4:
    raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
  n, _, _, c = x.shape
  if groups <= 0 or c % groups:
    raise ValueError(f"channels {c} are not divisible by groups {groups}")
  o = w.shape[-1]
  want = {"mean": (mean, (n, groups)), "rsqrt": (rsqrt, (n, groups)),
          "gamma": (gamma, (c,)), "beta": (beta, (c,)),
          "w": (w, (3, 3, c, o)), "b": (b, (o,))}
  for name, (t, shape) in want.items():
    if tuple(t.shape) != shape:
      raise ValueError(f"{name} must have shape {shape}, got "
                       f"{tuple(t.shape)}")
    if t.device != x.device:
      raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, w, b,
                          groups: int = 32) -> torch.Tensor:
  """Plain torch version: GroupNorm apply, SiLU, zero pad, conv2d.

  Same arguments and result as :func:`gn_silu_conv3x3`. The CPU path of
  the model and the reference the kernel is held against on the card."""
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  scale, shift = _fold(mean, rsqrt, gamma, beta, groups)
  act = F.silu(x.float() * scale[:, None, None, :] + shift[:, None, None, :])
  act = F.pad(act.permute(0, 3, 1, 2), (1, 1, 1, 1))  # NCHW, zeros
  out = F.conv2d(act, w.float().permute(3, 2, 0, 1), b.float())
  return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, w, b,
                    groups: int = 32) -> torch.Tensor:
  """``conv3x3(silu((x - mean_g) * rsqrt_g * gamma + beta), SAME) + b``.

  x: [N, H, W, C]; mean/rsqrt: [N, G] per-(sample, group) statistics
  (rsqrt = 1/sqrt(var + eps)); gamma/beta: [C]; w: [3, 3, C, O]; b: [O].
  Returns [N, H, W, O] in x's dtype. A CUDA tensor launches the kernel
  and counts the launch in ``gn_silu_conv3x3.launches`` and, per
  ``(H, W, C, O)``, in ``gn_silu_conv3x3.launches_by_shape``; a CPU tensor
  takes the plain version. Forward only: it refuses inputs that need a
  gradient.
  """
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (x, mean, rsqrt, gamma, beta, w, b)):
    raise RuntimeError("gn_silu_conv3x3 is forward-only: call it under "
                       "torch.no_grad() or torch.inference_mode()")
  if x.device.type == "cpu":
    return gn_silu_conv3x3_plain(x, mean, rsqrt, gamma, beta, w, b, groups)
  if x.device.type != "cuda":
    raise ValueError(f"gn_silu_conv3x3 runs on cuda or cpu, not {x.device}")
  _check(x, mean, rsqrt, gamma, beta, w, b, groups)
  for name, t in (("x", x), ("w", w), ("b", b), ("gamma", gamma),
                  ("beta", beta)):
    if t.dtype != torch.float32:
      raise NotImplementedError(
          f"gn_silu_conv3x3 kernel takes float32 only ({name} is "
          f"{t.dtype}); bfloat16 is listed in ROADMAP.md Queue 2")
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")
  n, h, wd, c = x.shape
  o = w.shape[-1]
  scale, shift = _fold(mean, rsqrt, gamma, beta, groups)
  out = torch.empty((n, h, wd, o), dtype=x.dtype, device=x.device)
  launch = _kernel_fn()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 w.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, wd, c, o,
                 stream)
  if err != 0:
    raise RuntimeError(f"gn_silu_conv3x3 launch failed: cudaError {err}")
  gn_silu_conv3x3.launches += 1
  by_shape = gn_silu_conv3x3.launches_by_shape
  by_shape[(h, wd, c, o)] = by_shape.get((h, wd, c, o), 0) + 1
  return out


def reset_launch_counts() -> None:
  """Set the kernel's launch counts (total and per shape) to zero."""
  gn_silu_conv3x3.launches = 0
  gn_silu_conv3x3.launches_by_shape = {}


reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
  fn = load_library(_KERNEL).gn_silu_conv3x3_f32
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn
