"""The port stands alone: no module of soft_truncation_tpu_torch/ and not
chip_smoke.py imports jax, flax, ml_collections, absl or the JAX package
(the machine with the card has none of them), and the port's copies of
the config files carry the JAX files' values."""

import ast
import importlib
import pathlib

import pytest

from soft_truncation_tpu_torch.configs.base import load_config

import torch_tiny

REPO = pathlib.Path(torch_tiny.REPO)
BANNED = {"jax", "jaxlib", "flax", "ml_collections", "absl",
          "soft_truncation_tpu"}
PORT_FILES = sorted((REPO / "soft_truncation_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path):
  for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
    if isinstance(node, ast.Import):
      yield from (a.name.split(".")[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0]
    elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
          == "import_module" and node.args
          and isinstance(node.args[0], ast.Constant)):
      yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
  assert path.exists()
  assert not set(_imported_roots(path)) & BANNED


def _assert_same_values(jc, pc):
  checked = 0
  for section, values in pc.items():
    if not isinstance(values, dict):
      assert jc[section] == values, section
      continue
    for key, value in values.items():
      want = jc[section][key]
      if isinstance(want, (list, tuple)):
        want, value = tuple(want), tuple(value)
      assert want == value, f"{section}.{key}: {value!r} != {want!r}"
      checked += 1
  assert checked > 40


def test_port_flagship_config_equals_jax_config():
  """The flagship as published is a case of
  ``test_port_config_copy_equals_jax_config``; here, the tiny cut the
  parity tests apply, through each package's ``override``."""
  _assert_same_values(*torch_tiny.configs())


# the base keys the training, likelihood and sample-quality slices read
# (every optim key)
TRAIN_KEYS = {
    "training": {"batch_size", "n_iters", "snapshot_freq", "log_freq",
                 "snapshot_freq_for_preemption", "snapshot_sampling",
                 "likelihood_weighting", "reduce_mean",
                 "importance_sampling", "st", "reconstruction_loss", "mixed",
                 "ddpm_weight", "balanced", "num_train_data"},
    "eval": {"enable_bpd", "enable_sampling", "batch_size", "enable_loss",
             "bpd_dataset", "num_test_data", "residual", "lambda_",
             "probability_flow", "nelbo_iter", "nll_iter", "num_samples"},
    "data": {"random_flip", "dequantization"},
    "tpu": {"fid_resize"},
}


def test_port_base_holds_the_training_keys_with_jax_values():
  """The training keys, the eval keys of the likelihood and sample-quality
  slices, and ``tpu.fid_resize``."""
  from soft_truncation_tpu.configs.base import default_config as jax_default
  from soft_truncation_tpu_torch.configs.base import default_config
  jc, pc = jax_default("cifar10"), default_config("cifar10")
  assert set(pc.optim) == set(jc.optim)
  for section, keys in TRAIN_KEYS.items():
    assert keys <= set(pc[section]), section
  _assert_same_values(jc, pc)


# the keys slice 6c reads: the Picard samplers', the data-parallel mesh's
# and activation checkpointing's
SLICE_6C_KEYS = {
    "sampling": {"chunk", "picard_window", "picard_tol",
                 "picard_max_sweeps", "picard_unsafe_tol"},
    "tpu": {"mesh_shape", "remat", "remat_policy"},
}


def test_port_base_holds_the_picard_mesh_and_remat_keys_with_jax_values():
  from soft_truncation_tpu.configs.base import default_config as jax_default
  from soft_truncation_tpu_torch.configs.base import default_config
  for family in ("cifar10", "celeba", "lsun", "stl10"):
    jc, pc = jax_default(family), default_config(family)
    for section, keys in SLICE_6C_KEYS.items():
      assert keys <= set(pc[section]), (family, section)
      for key in keys:
        want, got = jc[section][key], pc[section][key]
        if isinstance(want, (list, tuple)):
          want, got = tuple(want), tuple(got)
        assert got == want, f"{family} {section}.{key}: {got!r} != {want!r}"
  assert "profile_dir" not in pc.tpu and "profile_dir" not in jc.tpu


def test_port_base_holds_the_dtype_knobs_with_jax_values():
  """The four dtype knobs of ``tpu``, JAX's defaults in every family."""
  from soft_truncation_tpu.configs.base import default_config as jax_default
  from soft_truncation_tpu_torch.configs.base import (DTYPE_KNOBS,
                                                      default_config,
                                                      tpu_dtype)
  for family in ("cifar10", "celeba", "lsun", "stl10"):
    jc, pc = jax_default(family), default_config(family)
    for knob in DTYPE_KNOBS:
      assert pc.tpu[knob] == jc.tpu[knob] == "float32", (family, knob)
      assert tpu_dtype(pc, knob) == "float32"


# the keys of the native pipeline and the K-step windows (slice 16)
SLICE_16_KEYS = {"data": {"pipeline"}, "tpu": {"steps_per_dispatch"}}


@pytest.mark.parametrize("family", ["cifar10", "celeba", "lsun", "stl10"])
def test_port_base_holds_the_pipeline_and_dispatch_keys_with_jax_values(
    family):
  from soft_truncation_tpu.configs.base import default_config as jax_default
  from soft_truncation_tpu_torch.configs.base import default_config
  jc, pc = jax_default(family), default_config(family)
  for section, keys in SLICE_16_KEYS.items():
    for key in keys:
      assert key in pc[section], (section, key)
      assert pc[section][key] == jc[section][key], (family, section, key)
  assert pc.data.pipeline == "tf" and pc.tpu.steps_per_dispatch == 1


SLICE_6C_MODULES = ("sample/parallel.py", "parallel/__init__.py",
                    "parallel/ddp.py", "utils/profiling.py",
                    "utils/torch_port.py")


def test_the_slice_6c_modules_are_held_to_the_import_rule():
  held = {str(p.relative_to(REPO / "soft_truncation_tpu_torch"))
          for p in PORT_FILES if "soft_truncation_tpu_torch" in p.parts}
  assert set(SLICE_6C_MODULES) <= held


PORT_CONFIGS = pathlib.Path(torch_tiny.PORT_CONFIGS)
JAX_CONFIGS = REPO / "soft_truncation_tpu" / "configs"
PUBLISHED_CONFIGS = sorted(p.relative_to(JAX_CONFIGS)
                           for p in JAX_CONFIGS.rglob("*.py")
                           if p.name not in ("__init__.py", "base.py"))


def test_the_port_copies_every_config_and_only_those():
  copies = sorted(p.relative_to(PORT_CONFIGS) for p in PORT_CONFIGS.rglob(
      "*.py") if p.name not in ("__init__.py", "base.py"))
  assert copies == PUBLISHED_CONFIGS and len(copies) == 33


@pytest.mark.parametrize("rel", PUBLISHED_CONFIGS, ids=str)
def test_port_config_copy_equals_jax_config(rel):
  """Every config file of the JAX package has a copy in the port, at the
  same relative path, with its values."""
  path = PORT_CONFIGS / rel
  assert path.exists(), rel
  jax_module = importlib.import_module(
      "soft_truncation_tpu.configs." + ".".join(rel.with_suffix("").parts))
  _assert_same_values(jax_module.get_config(), load_config(str(path)))
