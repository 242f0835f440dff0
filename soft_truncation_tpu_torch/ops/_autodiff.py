"""What the kernels' wrappers need from PyTorch's automatic differentiation.

A wrapper calls its kernel directly where no derivative can be asked of the
call (serving, under ``torch.inference_mode`` / ``torch.no_grad``), and goes
through its ``torch.autograd.Function`` otherwise (:func:`records_derivatives`).
In that Function the forward gets plain tensors, but under ``torch.func.jvp``
the ``jvp`` rule gets its saved inputs and its tangents wrapped one level
deep, tensors without storage whose ``data_ptr()`` raises; :func:`plain`
takes the tensor behind them, which a kernel can read. The rule runs while
the transform is active, where an op may wrap its result again (``detach``
does): the rule's own work runs :func:`below_transforms`.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.forward_ad as forward_ad
from torch._C import _functorch
from torch._functorch import pyfunctorch


def records_derivatives() -> bool:
  """Whether a call must go through its Function: grad mode is on (reverse
  mode may record the call; ``torch.func.jvp`` runs with it on), or a
  forward-mode level is open (``torch.func.jvp``, or
  ``forward_ad.dual_level``, whose dual tensors carry tangents through
  ``torch.no_grad`` as well)."""
  return torch.is_grad_enabled() or forward_ad._current_level >= 0


def plain(t: torch.Tensor) -> torch.Tensor:
  """The tensor with storage behind ``t``: ``t`` itself unless
  ``torch.func.jvp`` wrapped it. Nested ``torch.func`` transforms are
  refused: a kernel would read only the innermost level."""
  if _functorch.is_functorch_wrapped_tensor(t):
    t = _functorch.get_unwrapped(t)
    if _functorch.is_functorch_wrapped_tensor(t):
      raise NotImplementedError("the hand-written kernels' jvp rules take "
                                "one level of torch.func transforms")
  return t


@contextlib.contextmanager
def below_transforms():
  """Run the block with the innermost ``torch.func`` transform popped (as
  functorch runs a Function's forward), so that ops on :func:`plain`
  tensors give plain tensors; a no-op outside the transforms. Under
  ``forward_ad`` dual tensors a Function's jvp rule already runs with
  forward mode off."""
  if _functorch.peek_interpreter_stack() is None:
    yield
    return
  with pyfunctorch.temporarily_pop_interpreter_stack():
    yield
