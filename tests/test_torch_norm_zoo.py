"""The port's normalization zoo (soft_truncation_tpu_torch/models/
normalization.py) against the JAX package's, variant by variant, on the
CPU: each Flax module's initialized parameters (and batch statistics)
carried into the port by ``from_jax_params``, the same NHWC input and
labels. The unbiased variances (VarianceNorm's spatial one, InstanceNorm++'s
across channels, at c=1 too, where the JAX package divides by max(c-1, 1))
and ConditionalBatchNorm2d's torch running statistics (momentum 0.1, the
unbiased batch variance accumulated over 3 train-mode updates, then eval)
are held in particular.

Tolerance: 1e-5 (rtol and atol), the bar of tests/test_normalization_parity.py:
both sides compute the same f32 reductions in another order.
"""

import jax
import numpy as np
import pytest
import torch

from soft_truncation_tpu.configs.base import default_config as jax_default
from soft_truncation_tpu.models import normalization as jax_zoo
from soft_truncation_tpu_torch.configs.base import default_config
from soft_truncation_tpu_torch.models import layers, normalization as zoo
from soft_truncation_tpu_torch.utils.jax_params import from_jax_params

B, H, W, NCLS = 3, 5, 4, 7
TOL = dict(rtol=1e-5, atol=1e-5)


def _x_y(c, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.standard_normal((B, H, W, c)) * 2.0 + 0.5).astype(np.float32)
  return x, rng.integers(0, NCLS, (B,)).astype(np.int32)


def _port(cls, c, variables, **kw):
  mod = cls(c, **kw)
  sd = from_jax_params(jax.tree.map(np.asarray, variables.get("params", {})))
  sd.update(from_jax_params(jax.tree.map(
      np.asarray, variables.get("batch_stats", {}))))
  mod.load_state_dict(sd)
  return mod


UNCONDITIONAL = {
    "InstanceNorm2d": (jax_zoo.InstanceNorm2d(), zoo.InstanceNorm2d, {}),
    "NoneNorm2d": (jax_zoo.NoneNorm2d(), zoo.NoneNorm2d, {}),
    "VarianceNorm2d": (jax_zoo.VarianceNorm2d(), zoo.VarianceNorm2d, {}),
    "InstanceNorm2dPlus": (jax_zoo.InstanceNorm2dPlus(),
                           zoo.InstanceNorm2dPlus, {}),
    "InstanceNorm2dPlus-nobias": (jax_zoo.InstanceNorm2dPlus(bias=False),
                                  zoo.InstanceNorm2dPlus, dict(bias=False)),
}


@pytest.mark.parametrize("c", [1, 6])
@pytest.mark.parametrize("name", sorted(UNCONDITIONAL))
def test_unconditional_norm_matches_jax(name, c):
  jmod, cls, kw = UNCONDITIONAL[name]
  x, _ = _x_y(c)
  variables = jmod.init(jax.random.PRNGKey(1), x)
  want = np.asarray(jmod.apply(variables, x))
  got = _port(cls, c, variables, **kw)(torch.from_numpy(x))
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


CONDITIONAL = {
    "ConditionalInstanceNorm2dPlus": (jax_zoo.ConditionalInstanceNorm2dPlus,
                                      zoo.ConditionalInstanceNorm2dPlus),
    "ConditionalInstanceNorm2d": (jax_zoo.ConditionalInstanceNorm2d,
                                  zoo.ConditionalInstanceNorm2d),
    "ConditionalVarianceNorm2d": (jax_zoo.ConditionalVarianceNorm2d,
                                  zoo.ConditionalVarianceNorm2d),
    "ConditionalNoneNorm2d": (jax_zoo.ConditionalNoneNorm2d,
                              zoo.ConditionalNoneNorm2d),
}


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", sorted(CONDITIONAL))
def test_conditional_norm_matches_jax(name, bias):
  jcls, cls = CONDITIONAL[name]
  c = 6
  x, y = _x_y(c, seed=2)
  jmod = jcls(num_classes=NCLS, bias=bias)
  variables = jmod.init(jax.random.PRNGKey(3), x, y)
  want = np.asarray(jmod.apply(variables, x, y))
  mod = _port(cls, c, variables, num_classes=NCLS, bias=bias)
  got = mod(torch.from_numpy(x), torch.from_numpy(y).long())
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
  # the per-class rows are read by label
  assert mod.embed.weight.shape[0] == NCLS


@pytest.mark.parametrize("bias", [True, False])
def test_conditional_batch_norm_train_eval_and_running_stats(bias):
  c = 6
  jmod = jax_zoo.ConditionalBatchNorm2d(num_classes=NCLS, bias=bias)
  x0, y0 = _x_y(c, seed=4)
  variables = jmod.init(jax.random.PRNGKey(5), x0, y0)
  mod = _port(zoo.ConditionalBatchNorm2d, c, variables, num_classes=NCLS,
              bias=bias)
  assert set(mod.state_dict()) >= {"bn.running_mean", "bn.running_var"}
  for step in range(3):
    x, y = _x_y(c, seed=10 + step)
    want, updated = jmod.apply(variables, x, y, train=True,
                               mutable=["batch_stats"])
    variables = {**variables, **updated}
    got = mod(torch.from_numpy(x), torch.from_numpy(y).long(), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
  stats = jax.tree.map(np.asarray, variables["batch_stats"]["bn"])
  np.testing.assert_allclose(mod.bn.running_mean.numpy(), stats["mean"],
                             **TOL)
  np.testing.assert_allclose(mod.bn.running_var.numpy(), stats["var"], **TOL)
  # torch's BatchNorm2d accumulates the unbiased (n / (n - 1)) batch
  # variance, not the biased one that normalizes
  for correction, close in ((1, True), (0, False)):
    var = np.ones(c)
    for step in range(3):
      var = 0.9 * var + 0.1 * np.var(_x_y(c, seed=10 + step)[0],
                                     axis=(0, 1, 2), ddof=correction)
    assert np.allclose(stats["var"], var, rtol=1e-5) == close, correction
  x, y = _x_y(c, seed=20)
  want = np.asarray(jmod.apply(variables, x, y, train=False))
  got = mod(torch.from_numpy(x), torch.from_numpy(y).long(), train=False)
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["InstanceNorm", "InstanceNorm++",
                                  "VarianceNorm", "GroupNorm"])
def test_get_normalization_picks_jax_variant(name):
  jc, pc = jax_default("cifar10"), default_config("cifar10")
  for cfg in (jc, pc):
    cfg.model.normalization = name
  c = 64
  x, _ = _x_y(c, seed=6)
  jmod = jax_zoo.get_normalization(jc)()
  variables = jmod.init(jax.random.PRNGKey(7), x)
  want = np.asarray(jmod.apply(variables, x))
  mod = zoo.get_normalization(pc)(c)
  if name == "GroupNorm":
    assert isinstance(mod, layers.GroupNorm) and mod.num_groups == 32
  mod.load_state_dict(from_jax_params(jax.tree.map(
      np.asarray, variables.get("params", {}))))
  got = mod(torch.from_numpy(x)).detach().numpy()
  np.testing.assert_allclose(got, want, **TOL)


def test_conditional_get_normalization_and_unknown_leaves():
  jc, pc = jax_default("cifar10"), default_config("cifar10")
  for cfg in (jc, pc):
    cfg.model.normalization = "InstanceNorm++"
    cfg.model.num_classes = NCLS
  make = zoo.get_normalization(pc, conditional=True)
  assert isinstance(make(6), zoo.ConditionalInstanceNorm2dPlus)
  pc.model.normalization = "VarianceNorm"
  with pytest.raises(NotImplementedError):
    zoo.get_normalization(pc, conditional=True)
  # from_jax_params still refuses a leaf it does not know
  with pytest.raises(ValueError):
    from_jax_params({"norm": {"delta": np.ones(3, np.float32)}})
  with pytest.raises(ValueError):  # 'alpha' is a vector, not a matrix
    from_jax_params({"norm": {"alpha": np.ones((3, 3), np.float32)}})
