"""Score-function wrapping: label transforms and output calibration.

Counterpart of ``soft_truncation_tpu/models/score.py``:

  VP, continuous (subVP always): labels = t*999, or, with unbounded
    parametrization, the normalised antiderivative of the log-variance
    scaled to [0, 999]; with ``training.ddpm_score`` the model predicts
    scaled noise and score = -out / std(t) (subVP's "std" is 1 - e^{2 lmc},
    as in the JAX package).
  VP, discrete: labels = t*(N-1), std from the DDPM alphas grid.
  VE / reciprocal VE, continuous: labels = sigma(t) (the model embeds
    log sigma); discrete: labels = round((T-t)*(N-1)). The network's output
    is the score.

A bf16 network (``config.tpu.compute_dtype``): at eval the network runs on
parameters pre-cast once per eval function (:func:`cast_params_for_eval`),
loaded as the JAX package applies a tree, as stored
(:func:`load_eval_params`);
the score is promoted to f32 where JAX's is, by the per-example f32 std
(``batch_mul``, never a 0-dim tensor, which torch would treat as a scalar
and keep bf16) or, inside the network, by ``scale_by_sigma``; else it
leaves in the network's output dtype, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..sde.core import (SDE, VESDE, VPSDE, ReciprocalVESDE, SubVPSDE,
                        batch_mul)


# parameter names whose modules compute in f32 whatever the model's compute
# dtype: the GroupNorms (f32 statistics and affine), the Fourier time
# embedding, the logsnr PosDense (the JAX package's _F32_PARAM_MARKERS);
# every other leaf (the convs, NINs and Denses) is cast to it per call
F32_PARAM_MARKERS = ("norm", "fourier", "logsnr", "pos_dense")


def cast_params_for_eval(model) -> Optional[Dict[str, torch.Tensor]]:
  """The counterpart of ``soft_truncation_tpu/models/score.py::
  cast_params_for_eval``: for a model whose ``dtype`` is not f32, its f32
  parameters whose names hold none of :data:`F32_PARAM_MARKERS`, cast once
  to that dtype (detached), to run the network on
  (``torch.func.functional_call``) in place of casting them on every call:
  the convs see the same values, so no output bit changes. None for an f32
  model or a callable that is not one (the exported program's network)."""
  dtype = getattr(model, "dtype", torch.float32)
  if not isinstance(model, torch.nn.Module) or dtype == torch.float32:
    return None
  return {name: p.detach().to(dtype) for name, p in model.named_parameters()
          if p.dtype == torch.float32
          and not any(m in name.lower() for m in F32_PARAM_MARKERS)}


def load_eval_params(model: torch.nn.Module,
                     params: Dict[str, torch.Tensor]) -> None:
  """Load ``params`` (a state_dict: the EMA shadow, a params npz's) into
  ``model`` for evaluation, as the JAX package evaluates a parameter tree:
  as stored. A module whose compute dtype follows its parameters' dtype,
  a ``GroupNorm`` without a ``dtype`` of its own (as Flax's ``nn.GroupNorm``
  without ``dtype=``: NCSN++'s heads ``pyr_norm_*`` and ``out_norm``, the
  legacy networks' norms), takes its parameters in the dtype they are
  stored in, so that under a bf16 EMA a bf16 input gives a bf16 output
  there, as in JAX; every other parameter takes the stored values in its
  own dtype. The other leaves that JAX's ``cast_params_for_eval`` leaves
  as stored compute the same either way: the blocks' and attention's
  GroupNorms have their ``dtype`` (``norm_dtype``), and the Fourier
  embedding (log sigma times W), the legacy norms' affine vectors and
  embeddings, and LogSNR's PosDense (on no eval path) meet an f32 operand
  that promotes their bf16 values exactly. An f32 tree changes no bit."""
  from .layers import GroupNorm
  for name, module in model.named_modules():
    if isinstance(module, GroupNorm) and module.dtype is None:
      for pname, p in module.named_parameters(recurse=False):
        stored = params.get(f"{name}.{pname}" if name else pname)
        if stored is not None and stored.dtype != p.dtype:
          p.data = p.data.to(stored.dtype)
  model.load_state_dict(params)


def get_model_fn(model, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> Callable:
  """Raw network apply with the train/eval switch; at train the network's
  dropout draws from ``generator``, at eval it runs on
  :func:`cast_params_for_eval`'s parameters where there are any."""
  cast = None if train else cast_params_for_eval(model)

  def model_fn(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if train:
      return model(x, labels, train=True, generator=generator)
    if cast is not None:
      return torch.func.functional_call(model, cast, (x, labels),
                                        {"train": False})
    return model(x, labels, train=False)

  return model_fn


def get_score_fn(config, sde: SDE, model, train: bool = False,
                 continuous: bool = False,
                 generator: Optional[torch.Generator] = None) -> Callable:
  """Build s(x, t) from the raw network."""
  model_fn = get_model_fn(model, train=train, generator=generator)
  if isinstance(sde, (VESDE, ReciprocalVESDE)):

    def ve_score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
      if continuous:
        labels = sde.marginal_prob(torch.zeros_like(t), t)[1]
      else:
        labels = torch.round((sde.T - t) * (sde.N - 1)).long()
      return model_fn(x, labels)

    return ve_score_fn
  if not isinstance(sde, (VPSDE, SubVPSDE)):
    raise NotImplementedError(
        f"SDE class {type(sde).__name__} not yet supported.")
  unbounded = config.training.get("unbounded_parametrization", False)
  stab = config.training.get("stabilizing_constant", 1e-3)
  ddpm_score = config.training.get("ddpm_score", True)

  def score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if continuous or isinstance(sde, SubVPSDE):
      if unbounded:
        lo = sde.antiderivative(t.new_full((), 1e-5), stab)
        hi = sde.antiderivative(t.new_full((), sde.T), stab)
        labels = (sde.antiderivative(t, stab) - lo) / (hi - lo) * 999.0
      else:
        labels = t * 999.0
      std = sde.marginal_std(t)
      score = model_fn(x, labels)
    else:
      labels = t * (sde.N - 1)
      score = model_fn(x, labels)
      std = sde.sqrt_1m_alphas_cumprod(t.device)[labels.long()]
    if ddpm_score:
      score = -batch_mul(1.0 / std, score)
    return score

  return score_fn
