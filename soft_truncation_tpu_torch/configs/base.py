"""Config schema for the PyTorch port: a small attribute dict + defaults.

Mirrors ``soft_truncation_tpu/configs/base.py`` without ``ml_collections``:
the same dataset families (``cifar10``, ``celeba``, ``lsun``, ``stl10``,
derived from CIFAR-10's as JAX derives them), the same section/key names
and values, limited to the keys the port reads. Keys a config file sets
beyond these (``model.embedding_dim``, the ``uncsn`` section,
``data.tfrecords_path``, ``data.category``) are read with JAX's defaults
where a file leaves them out. Config files under ``configs/`` are copies
of the JAX package's 33 files, importing this module instead of the JAX
one.

The JAX package's ``tpu`` section is carried where the port reads a key;
no config file sets any of its knobs, and the port reads them so:
  * ``mesh_shape``: () or (world size,), the ranks ``torchrun`` launches
    (``parallel/ddp.py``), or (d, s) with d * s the world size: the batch
    over d and each image's rows over s ranks (``parallel/mesh.py``);
  * ``remat`` / ``remat_policy``: activation checkpointing of NCSN++'s
    res-blocks, 'full' or 'conv_outputs' (``models/ncsnpp.py``);
  * ``activation_dtype``: '' (off) or 'float8_e4m3' (``ops/quant.py``;
    NCSN++'s convs store their inputs as e4m3);
  * ``fid_resize``: the Inception's resize (``eval/inception.py``);
  * ``profile_dir``: no key, as in JAX; ``run_lib.train`` reads it with
    ``get`` and the CLI accepts it (``main.OPTIONAL_KEYS``);
  * ``steps_per_dispatch`` (1): train steps per window, on one of two
    routes chosen before the first window and logged
    (``train/step.py::window_route``, ``run_lib.train``): 'graph', one
    CUDA graph replay of K steps, for K > 1 on the card alone or as the
    one rank of an NCCL group (its gradients' all-reduce captured);
    'eager', the K steps issued one by one, on the CPU, at K = 1, on gloo
    ranks (ranks sharing a card) and on NCCL groups of several ranks (a
    captured window across cards has not yet run). Either route trains
    what K steps train;
  * ``donate_state``, ``compilation_cache_dir``: no GPU meaning (eager
    PyTorch frees what it no longer holds; nothing is compiled ahead), not
    carried;
  * ``compute_dtype``, ``norm_dtype``, ``ema_dtype``, ``adam_mu_dtype``:
    'float32' (the default) or 'bfloat16', read through :func:`tpu_dtype`
    (any other value raises): the NCSN++ family's convs, NINs and Denses
    (and its fused sites' kernel mode) compute in ``compute_dtype``, its
    GroupNorms' outputs are ``norm_dtype`` (``models/ncsnpp.py``); the EMA
    shadow is stored in ``ema_dtype`` (``models/ema.py``) and Adam's first
    moment in ``adam_mu_dtype`` (``losses/losses.Optimizer``). The legacy
    networks read none of them, as in JAX;
  * ``dropout_bits`` (0, JAX's default) and ``rng_impl``
    ('threefry2x32'): the NCSN++ res-blocks' dropout draws packed masks of
    :func:`tpu_dropout_bits` bits (``models/dropout.py``), resolved as JAX
    resolves them: 0 (or 'auto') is 8 under a threefry ``rng_impl``, 32
    under any other; 8, 16 or 32 as given. The draws themselves come from
    torch's generator whatever ``rng_impl`` names.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping


class Config(dict):
  """dict with attribute access; nested mappings become ``Config``s."""

  def __init__(self, values: Mapping[str, Any] | None = None):
    super().__init__()
    for k, v in (values or {}).items():
      self[k] = v

  def __setitem__(self, key, value):
    if isinstance(value, Mapping) and not isinstance(value, Config):
      value = Config(value)
    super().__setitem__(key, value)

  def __getattr__(self, key):
    try:
      return self[key]
    except KeyError:
      raise AttributeError(key) from None

  def __setattr__(self, key, value):
    self[key] = value

  def __deepcopy__(self, memo):
    return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})


# The values of soft_truncation_tpu/configs/base.py::_CIFAR10 for every key
# the port reads, the ``tpu`` section's as the module docstring says.
_CIFAR10 = dict(
    training=dict(
        batch_size=128, n_iters=13000001, snapshot_freq=100000, log_freq=100,
        snapshot_freq_for_preemption=10000, snapshot_sampling=False,
        likelihood_weighting=True, continuous=True, reduce_mean=False,
        importance_sampling=True, unbounded_parametrization=False,
        ddpm_score=True, st=False, truncation_time=1e-5,
        num_train_data=50000, reconstruction_loss=False,
        stabilizing_constant=1e-3, mixed=False, ddpm_weight=0.01,
        balanced=False),
    sampling=dict(
        n_steps_each=1, noise_removal=True, probability_flow=False,
        snr=0.16, batch_size=1024, truncation_time=1e-5, chunk=0,
        dpm_steps=50, picard_window=16, picard_tol=1e-3, picard_max_sweeps=0,
        picard_unsafe_tol=False),
    eval=dict(
        batch_size=200, enable_sampling=False, enable_loss=True,
        enable_bpd=False, bpd_dataset="test", num_test_data=10000,
        residual=True, lambda_=0.0, probability_flow=True, nelbo_iter=0,
        nll_iter=0, num_samples=50000),
    data=dict(dataset="CIFAR10", image_size=32, random_flip=True,
              centered=False, dequantization="none", num_channels=3,
              transport_dtype="auto", pipeline="tf"),
    model=dict(
        sigma_min=0.01, sigma_max=50.0, num_scales=1000, beta_min=0.1,
        beta_max=20.0, dropout=0.1, embedding_type="fourier",
        auxiliary_resblock=True, attention=True, fourier_feature=False,
        lsgm=False),
    optim=dict(
        weight_decay=0.0, optimizer="Adam", lr=2e-4, beta1=0.9, eps=1e-8,
        warmup=5000, grad_clip=1.0, num_micro_batch=1, amsgrad=False),
    tpu=dict(mesh_shape=(), remat=False, remat_policy="full",
             fid_resize="host", activation_dtype="",
             compute_dtype="float32", norm_dtype="float32",
             ema_dtype="float32", adam_mu_dtype="float32",
             rng_impl="threefry2x32", dropout_bits=0,
             steps_per_dispatch=1),
)

# the tpu section's dtype knobs and the values the port takes for them
DTYPE_KNOBS = ("compute_dtype", "norm_dtype", "ema_dtype", "adam_mu_dtype")
DTYPES = ("float32", "bfloat16")


def tpu_dtype(config, key: str) -> str:
  """``config.tpu.<key>``, one of :data:`DTYPE_KNOBS`: 'float32' (also
  where the config has no such key) or 'bfloat16'; any other value
  raises."""
  if key not in DTYPE_KNOBS:
    raise KeyError(f"tpu.{key} is not a dtype knob")
  value = config.get("tpu", {}).get(key, "float32")
  if value not in DTYPES:
    raise ValueError(f"tpu.{key} must be one of {DTYPES}, not {value!r}")
  return value


def tpu_dropout_bits(config) -> int:
  """The res-blocks' dropout mask bits, ``config.tpu.dropout_bits``
  resolved as ``soft_truncation_tpu/models/ncsnpp.py::from_config``
  resolves it: 0 or 'auto' (the default) is 8 where ``tpu.rng_impl``
  names a threefry generator (also where the config has no such key), 32
  otherwise; any other value as given (32 where there is no ``tpu``
  section)."""
  tpu = config.get("tpu", None)
  if tpu is None:
    return 32
  raw = tpu.get("dropout_bits", 32)
  if raw in (0, "auto"):
    return 8 if "threefry" in str(tpu.get("rng_impl", "threefry2x32")) else 32
  return int(raw)


def _derive(base, changes, drop=None):
  """``base`` with ``changes`` merged per section and the ``drop`` keys
  removed: the JAX package's ``_derive``."""
  out = {sec: dict(vals) for sec, vals in base.items()}
  for sec, vals in changes.items():
    out.setdefault(sec, {}).update(vals)
  for sec, keys in (drop or {}).items():
    for k in keys:
      out[sec].pop(k, None)
  return out


_CELEBA = _derive(_CIFAR10, dict(
    training=dict(n_iters=1300001, snapshot_freq=50000, log_freq=50,
                  snapshot_sampling=True, likelihood_weighting=False,
                  num_train_data=162770),
    sampling=dict(snr=0.17, batch_size=512),
    eval=dict(batch_size=1024, num_test_data=19962),
    data=dict(dataset="CELEBA", image_size=64),
    model=dict(sigma_max=90.0),
))

_LSUN = _derive(_CIFAR10, dict(
    training=dict(batch_size=64, n_iters=24000001, snapshot_freq=200000,
                  log_freq=1000, snapshot_freq_for_preemption=5000,
                  snapshot_sampling=True, likelihood_weighting=False,
                  importance_sampling=False, num_train_data=162770),
    sampling=dict(snr=0.075, batch_size=16, truncation_time=1e-3),
    eval=dict(batch_size=512, enable_sampling=True),
    data=dict(dataset="LSUN", image_size=256),
    model=dict(sigma_max=378.0, num_scales=2000, dropout=0.0),
), drop=dict(eval=["num_test_data", "residual", "lambda_",
                   "probability_flow", "nelbo_iter", "nll_iter"]))

_STL10 = _derive(_CIFAR10, dict(
    training=dict(batch_size=196, num_train_data=105000),
    sampling=dict(snr=0.17),
    eval=dict(batch_size=512, enable_sampling=True, enable_loss=False),
    data=dict(dataset="STL10", image_size=48),
    model=dict(sigma_max=150.0),
))

_DEFAULTS = {"cifar10": _CIFAR10, "celeba": _CELEBA, "lsun": _LSUN,
             "stl10": _STL10}


def default_config(dataset: str = "cifar10") -> Config:
  """The default config of a dataset family: 'cifar10', 'celeba', 'lsun'
  or 'stl10'."""
  config = Config(copy.deepcopy(_DEFAULTS[dataset.lower()]))
  config.seed = 42
  return config


def override(config: Config, changes: Dict[str, Any]) -> Config:
  """Apply ``{section: {key: value}}`` overrides in place (new keys allowed)."""
  for section, values in changes.items():
    if isinstance(values, Mapping) and isinstance(config.get(section), Config):
      for k, v in values.items():
        config[section][k] = v
    else:
      config[section] = values
  return config


def load_config(path: str) -> Config:
  """Run a config file's ``get_config()`` (the file imports this module)."""
  import importlib.util
  spec = importlib.util.spec_from_file_location("_st_torch_config", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.get_config()
