"""Adaptive Dormand-Prince 5(4) ODE integrator on torch tensors.

Counterpart of ``soft_truncation_tpu/sample/ode.py::odeint_dopri5``: the
same tableau (scipy's RK45), initial-step rule, PI step-size control and
``nfe`` bookkeeping (2 for the start, +6 per attempted step).

The state ``y`` is one flat f32 tensor on any device. The loop is a Python
loop: the scalars that steer it (t, h, the error norm) live on the host as
float32, with the same f32 arithmetic as the JAX version, and each step
reads its error norm from the device once. That one synchronisation per
step is accepted in this port; the model evaluations dominate the step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

_f32 = np.float32

_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float32)
_A = [
    np.array([], np.float32),
    np.array([1 / 5], np.float32),
    np.array([3 / 40, 9 / 40], np.float32),
    np.array([44 / 45, -56 / 15, 32 / 9], np.float32),
    np.array([19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
             np.float32),
    np.array([9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
              -5103 / 18656], np.float32),
    np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
              11 / 84], np.float32),
]
_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
               11 / 84, 0.0], np.float32)
# 4th-order embedded solution error weights (b - b_hat)
_E = np.array([71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200,
               22 / 525, -1 / 40], np.float32)

_SAFETY = _f32(0.9)
_MIN_FACTOR = _f32(0.2)
_MAX_FACTOR = _f32(10.0)
_ORDER_EXP = _f32(-1.0 / 5.0)


class ODEResult(NamedTuple):
  y: torch.Tensor
  nfe: int
  status: int  # 0 ok, 1 hit max_steps


def _rms(v: torch.Tensor) -> np.float32:
  return _f32(torch.sqrt(torch.mean(v ** 2)).item())


def _initial_step(func, t0, y0, f0, direction, rtol, atol) -> np.float32:
  """scipy's automatic initial step size heuristic (order 5)."""
  scale = atol + torch.abs(y0) * rtol
  d0 = _rms(y0 / scale)
  d1 = _rms(f0 / scale)
  if d0 < 1e-5 or d1 < 1e-5:
    h0 = _f32(1e-6)
  else:
    h0 = _f32(_f32(0.01) * d0 / d1)
  y1 = y0 + float(_f32(h0 * direction)) * f0
  f1 = func(_f32(t0 + _f32(h0 * direction)), y1)
  d2 = _f32(_rms((f1 - f0) / scale) / h0)
  if d1 <= 1e-15 and d2 <= 1e-15:
    h1 = max(_f32(1e-6), _f32(h0 * _f32(1e-3)))
  else:
    h1 = _f32((_f32(0.01) / max(d1, d2)) ** _f32(1.0 / 5.0))
  return _f32(min(_f32(100) * h0, h1))


def odeint_dopri5(func: Callable[[np.float32, torch.Tensor], torch.Tensor],
                  y0: torch.Tensor, t0: float, t1: float, rtol: float = 1e-5,
                  atol: float = 1e-5, max_steps: int = 10000) -> ODEResult:
  """Integrate dy/dt = func(t, y) from t0 to t1 (either direction).

  ``func`` gets t as a host float32 scalar and y as the flat state."""
  t0, t1 = _f32(t0), _f32(t1)
  direction = _f32(np.sign(t1 - t0))
  dev = y0.device
  a = [torch.as_tensor(ai, device=dev) for ai in _A]
  b = torch.as_tensor(_B, device=dev)
  e = torch.as_tensor(_E, device=dev)

  f0 = func(t0, y0)
  h = _initial_step(func, t0, y0, f0, direction, rtol, atol)
  h = min(h, _f32(abs(t1 - t0)))

  def step_once(t, y, f, h):
    """One RK45 step attempt; returns (y_new, f_new, error_norm)."""
    hd = float(_f32(h * direction))
    ks = [f]
    for i in range(1, 7):
      dy = hd * torch.tensordot(a[i], torch.stack(ks), dims=1)
      ti = _f32(t + _f32(_f32(_C[i] * h) * direction))
      ks.append(func(ti, y + dy))
    k = torch.stack(ks)
    y_new = y + hd * torch.tensordot(b, k, dims=1)
    err = hd * torch.tensordot(e, k, dims=1)
    scale = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
    return y_new, ks[-1], _rms(err / scale)  # FSAL: k7 is f at (t+h, y_new)

  t, y, f = t0, y0, f0
  nfe, steps, done = 2, 0, False
  while not done and steps < max_steps:
    h_eff = min(h, _f32(abs(t1 - t)))
    y_new, f_new, err_norm = step_once(t, y, f, h_eff)
    if err_norm == 0.0:
      factor = _MAX_FACTOR
    else:
      factor = _f32(np.clip(_SAFETY * err_norm ** _ORDER_EXP,
                            _MIN_FACTOR, _MAX_FACTOR))
    h = _f32(h_eff * factor)
    if err_norm <= 1.0:  # accept
      t = _f32(t + _f32(h_eff * direction))
      y, f = y_new, f_new
    done = bool(abs(_f32(t - t0)) >= _f32(abs(_f32(t1 - t0)) - _f32(1e-12)))
    nfe += 6
    steps += 1
  return ODEResult(y=y, nfe=nfe, status=0 if done else 1)
