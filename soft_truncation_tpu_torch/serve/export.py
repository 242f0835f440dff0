"""Ahead-of-time export of the sampler's score evaluation, for serving.

Counterpart of ``soft_truncation_tpu/serve/export.py``. The JAX package
exports the whole sampler as one StableHLO program. Here the exported unit
is the score evaluation ``score(x, t)``: the network with
``models/score.py::get_score_fn``'s SDE scaling, captured by
``torch.export`` at static shapes, with both hand-written kernels as the
opaque operators ``soft_truncation::gn_silu_conv3x3`` and ``::fir2``. The
sampler's loops (``pc``, ``ode`` on dopri5, ``dpm_solver``, ``picard``,
``picard_dpm``) stay on the host in ``sample/``, and so do the random
draws; :class:`ExportedScore` stands where the network stood, so the live
service and the replay run the same loop code and draw the same noise per
seed. A serving host replays the pair (artifact, params npz) with torch,
numpy and the port's ``ops``, ``sde``, ``sample`` and ``serve``: no
network module, no config file.

Several ranks (``export_sampler(mesh=...)``, ``--mesh N``): the sample
batch B is split over N ranks, each replaying the programs at B / N
(``SamplingService.from_artifact`` under ``torchrun``, exactly N ranks);
the meta's ``num_devices`` is N and its ``sample_shape`` the whole batch's.

Programs: one per (batch, continuous) the served methods need: the
artifact's batch B with continuous labels (``ode``, ``dpm_solver``,
``picard_dpm``), B with ``training.continuous``'s labels where that is
False (``pc``, ``picard``), and W*B where the config's method is Picard
(W its window; a Picard request at another window runs the B program per
B rows). The weights stay outside: each program takes the state_dict's
tensors (``params``) and, per res-block conv, the fused kernel's weight
operands (``operands``: the HWIO weight and its TF32 hi / lo split) as
inputs, which :class:`ExportedScore` prepares once per params load, so
one artifact serves every checkpoint with the same parameter tree.

A bf16 model (``config.tpu.compute_dtype``): the parameters that
``models/score.py::cast_params_for_eval`` casts are inputs in bf16, cast
once per params load (the meta names them, under ``cast_params``, and the
dtype, under ``compute_dtype``), so the graph holds no cast of them; each
fused conv's operands are its bf16 HWIO weight and the kernel's one bf16
operand, and the operator nodes run the kernels' bf16 modes. The replay
takes and returns what the live service does.

Artifact = one file::

    STTORCH1 | u32 meta length | meta JSON (utf-8) | torch.export payloads

the payloads in the order of ``meta["programs"]``, each ``bytes`` long.
The meta holds what the host loop needs (the SDE and its parameters, the
sampling keys, the sample shape, the draw scheme) besides provenance.

CLI: ``python -m soft_truncation_tpu_torch.serve.export --config <port
config> --out <prefix> [--workdir W] [--batch B] [--cpu]
[--config.<section>.<key> value ...]`` (the train CLI's overrides) writes
``<prefix>.pt2`` and ``<prefix>.params.npz`` (``--mesh N``: for N ranks)
from the EMA weights of
``W/checkpoints-meta/checkpoint`` (random weights, with a warning, without
one).
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import logging
import math
import os
import struct
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..ops.gn_conv import weight_operand
from ..utils import jax_params
from ..utils.device import resolve_device

log = logging.getLogger(__name__)

_MAGIC = b"STTORCH1"
EXTENSION = ".pt2"
# the sampling keys the host loop reads, copied into the meta where set
SAMPLING_KEYS = ("method", "predictor", "corrector", "snr", "n_steps_each",
                 "probability_flow", "noise_removal", "dpm_steps",
                 "truncation_time", "picard_window", "picard_tol",
                 "picard_max_sweeps", "picard_unsafe_tol", "chunk")
_SDE_KEYS = ("beta_min", "beta_max", "sigma_min", "sigma_max", "num_scales")
DRAWS = ("round r of a request with seed s: the prior from "
         "torch.Generator(device).manual_seed(SeedSequence([s mod 2**64, r])"
         ".generate_state(1, uint64)[0]), the PC noise from one seeded with "
         "[s mod 2**64, r, 1] (serve/server.py::_round_seed)")


class _Section(dict):
  """A config section rebuilt from the meta: a dict with attribute
  access, as the port's ``configs.base.Config`` (not imported here)."""

  def __getattr__(self, key):
    try:
      return self[key]
    except KeyError:
      raise AttributeError(key) from None

  def __setattr__(self, key, value):
    self[key] = value

  def __deepcopy__(self, memo):
    return type(self)({k: copy.deepcopy(v, memo) for k, v in self.items()})


def meta_config(meta: Dict[str, Any]) -> _Section:
  """The config sections the host loop reads (``get_sde``,
  ``get_sampling_fn``, the inverse scaler), rebuilt from an artifact's
  meta."""
  sde = meta["sde"]
  _, size, _, channels = meta["sample_shape"]
  return _Section(
      training=_Section(sde=sde["name"], continuous=meta["continuous"],
                        truncation_time=sde["truncation_time"],
                        eta=sde["eta"]),
      uncsn=_Section(eta=sde["eta"]),
      model=_Section({k: sde[k] for k in _SDE_KEYS},
                     name=meta["model_name"]),
      sampling=_Section(meta["sampling"],
                        batch_size=meta["sample_shape"][0]),
      data=_Section(centered=meta["centered"], image_size=size,
                    num_channels=channels))


class Program(NamedTuple):
  """One exported score evaluation: its batch and label kind."""
  name: str
  batch: int
  continuous: bool


class Exported(NamedTuple):
  """What :func:`export_sampler` returns and :func:`load_artifact` reads:
  the programs by name, their specs, the state_dict names they take (in
  order) and the convs whose weight operands they take after them, and
  the compute dtype with the names of the inputs pre-cast to it."""
  programs: Dict[str, Any]   # name -> torch.export.ExportedProgram
  specs: Tuple[Program, ...]
  params: Tuple[str, ...]
  operands: Tuple[str, ...]
  device_type: str
  num_devices: int = 1  # the ranks the batch is split over
  compute_dtype: str = "float32"
  cast: Tuple[str, ...] = ()


def _methods_continuous(config) -> Dict[str, bool]:
  continuous = bool(config.training.continuous)
  return {"pc": continuous, "picard": continuous, "ode": True,
          "dpm_solver": True, "picard_dpm": True}


def _window(config) -> int:
  """The Picard window of the config's method (0 for another method)."""
  method = config.sampling.method.lower()
  if method == "picard":
    return int(config.sampling.get("picard_window", 64))
  if method == "picard_dpm":
    return int(config.sampling.get("picard_window", 0)
               or config.sampling.get("dpm_steps", 50))
  return 0


def program_specs(config, batch: int) -> Tuple[Program, ...]:
  """The programs an artifact of ``config`` at ``batch`` holds (module
  docstring)."""
  kinds = _methods_continuous(config)
  specs = {(batch, c) for c in set(kinds.values())}
  window = _window(config)
  if window > 1:
    specs.add((window * batch, kinds[config.sampling.method.lower()]))
  return tuple(Program(f"score_b{b}_{'c' if c else 'd'}", b, c)
               for b, c in sorted(specs))


def operand_convs(model) -> List[str]:
  """Names of the convs that may run fused (conv0 / conv1 of each block
  that records fused sites): the program takes their weight operands."""
  from ..models.layers import DDPMConv  # the exporter has the network
  names = []
  for name, module in model.named_modules():
    if hasattr(module, "last_fused_sites"):
      for conv in ("conv0", "conv1"):
        if isinstance(getattr(module, conv, None), DDPMConv):
          names.append(f"{name}.{conv}" if name else conv)
  return names


def conv_operands(weight: torch.Tensor,
                  dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, ...]:
  """The HWIO weight in ``dtype`` and the kernel's operand of it (f32: hi
  and lo; bf16: one tensor) of an OIHW conv weight, as ``DDPMConv``
  derives them for the fused kernel (``weight_hwio``,
  ``weight_operand``)."""
  hwio = weight.detach().to(dtype).permute(2, 3, 1, 0).contiguous()
  return (hwio,) + tuple(weight_operand(hwio))


def operands_per_conv(dtype: torch.dtype) -> int:
  """How many inputs :func:`conv_operands` gives per conv."""
  return 2 if dtype == torch.bfloat16 else 3


def program_inputs(state: Dict[str, torch.Tensor], names, convs,
                   dtype: torch.dtype, cast) -> List[torch.Tensor]:
  """The programs' weight inputs from a state_dict: its tensors ``names``,
  those in ``cast`` cast to ``dtype``, then each of ``convs``' operands."""
  cast = set(cast)
  return [state[n].to(dtype) if n in cast else state[n] for n in names] + [
      t for c in convs for t in conv_operands(state[f"{c}.weight"], dtype)]


class _ScoreProgram(torch.nn.Module):
  """``forward(x, t, *params, *operands)``: the score of ``model`` with
  the state_dict's tensors and the convs' operands given as inputs. The
  network is held outside the module's registry, so the exported program
  owns no weights."""

  def __init__(self, config, sde, model, names, convs, continuous: bool):
    super().__init__()
    self.__dict__["_model"] = model
    self._config, self._sde = config, sde
    self.names, self.convs = list(names), list(convs)
    self._continuous = continuous
    self._per_conv = operands_per_conv(getattr(model, "dtype",
                                               torch.float32))

  def forward(self, x, t, *tensors):
    from ..models.score import get_score_fn
    model = self.__dict__["_model"]
    k = len(self.names)
    state = dict(zip(self.names, tensors[:k]))
    convs = [model.get_submodule(name) for name in self.convs]
    per = self._per_conv
    for i, conv in enumerate(convs):
      hwio, *operand = tensors[k + per * i:k + per * (i + 1)]
      conv.traced_operands = {"hwio": hwio, "operand": tuple(operand)}

    def network(x, labels, train=False):
      return torch.func.functional_call(model, state, (x, labels),
                                        {"train": train})

    try:
      return get_score_fn(self._config, self._sde, network, train=False,
                          continuous=self._continuous)(x, t)
    finally:
      for conv in convs:
        conv.traced_operands = None


def _check_chunk(config) -> None:
  chunk = int(config.sampling.get("chunk", 0) or 0)
  if (config.sampling.method.lower() in ("pc", "picard")
      and 0 < chunk < config.model.num_scales):
    raise ValueError(
        f"sampling.chunk = {chunk} partitions the sampler into segments, as "
        "the JAX package's self-jitting sampler does, which it refuses to "
        "export as one computation; export with sampling.chunk=0")


def make_serving_fn(config, batch: Optional[int] = None, device="cuda"):
  """The network and the score programs to export for ``config``.

  Returns ``(model, programs, shape)``: the network in eval mode on
  ``device`` (seed 0's weights; load the checkpoint's), ``{spec:
  module}`` with ``module(x, t, *params, *operands)`` the score evaluation
  of :class:`Program` ``spec``, and the NHWC sample shape. Chunked PC and
  Picard (``sampling.chunk`` within the chain) raise ValueError, as the
  JAX exporter refuses them."""
  from ..models import create_model
  from ..sde import get_sde
  _check_chunk(config)
  shape = (int(batch or config.sampling.batch_size), config.data.image_size,
           config.data.image_size, config.data.num_channels)
  model = create_model(config, device)
  sde = get_sde(config)
  names = list(model.state_dict())
  convs = operand_convs(model)
  programs = {spec: _ScoreProgram(config, sde, model, names, convs,
                                  spec.continuous)
              for spec in program_specs(config, shape[0])}
  return model, programs, shape


def export_sampler(config, params: Dict[str, torch.Tensor],
                   batch: Optional[int] = None, device="cuda", mesh=None
                   ) -> Tuple[Exported, Tuple[int, ...]]:
  """``torch.export`` each score program of ``config`` on ``device``.

  ``params`` (a port state_dict) gives the example inputs' values; the
  programs take the weights as inputs and keep none. With ``mesh`` (a
  mesh shape such as ``(4,)`` or ``(2, 2)``) the sample batch is split
  over its ranks, as JAX's ``export_sampler(mesh=...)``
  shards it over ``data``: the programs take batch / ranks samples, and
  a batch that the ranks do not divide raises ValueError. Returns
  ``(exported, shape)``, ``shape`` the whole batch's."""
  devices = math.prod(mesh) if mesh else 1
  whole = int(batch or config.sampling.batch_size)
  if whole % devices:
    raise ValueError(f"batch {whole} does not split over the mesh's "
                     f"{devices} ranks")
  from ..models.score import cast_params_for_eval, load_eval_params
  model, programs, shape = make_serving_fn(config, whole // devices, device)
  load_eval_params(model, params)
  state = model.state_dict()
  any_program = next(iter(programs.values()))
  names, convs = tuple(any_program.names), tuple(any_program.convs)
  dtype = getattr(model, "dtype", torch.float32)  # the legacy networks: f32
  cast = tuple(sorted(cast_params_for_eval(model) or ()))
  tensors = program_inputs(state, names, convs, dtype, cast)
  device = tensors[0].device
  exported = {}
  with torch.no_grad():
    for spec, module in programs.items():
      x = torch.zeros((spec.batch,) + tuple(shape[1:]), device=device)
      t = torch.full((spec.batch,), 0.5, device=device)
      program = torch.export.export(module, (x, t, *tensors), strict=False)
      program.example_inputs = None  # the weights: not in the artifact
      exported[spec.name] = program
  return Exported(exported, tuple(programs), names, convs, device.type,
                  devices, str(dtype).split(".")[-1],
                  cast), (whole,) + tuple(shape[1:])


def artifact_meta(config, shape, exported: Exported) -> Dict[str, Any]:
  """What the host loop needs to replay the programs without a config
  file, and provenance."""
  training, model = config.training, config.model
  eta = (training.get("eta") if "eta" in training
         else config.get("uncsn", {}).get("eta"))
  sde = {"name": training.sde, "truncation_time": training.truncation_time,
         "eta": eta}
  sde.update({k: model.get(k) for k in _SDE_KEYS})
  return {
      "model_name": model.name,
      "sde": sde,
      "num_scales": model.num_scales,
      "continuous": bool(training.continuous),
      "truncation_time": config.sampling.truncation_time,
      "sampling_method": config.sampling.method,
      "sampling": {k: config.sampling.get(k) for k in SAMPLING_KEYS
                   if config.sampling.get(k) is not None},
      "centered": bool(config.data.centered),
      "sample_shape": list(shape),
      "programs": [spec._asdict() for spec in exported.specs],
      "params": list(exported.params),
      "operands": list(exported.operands),
      "compute_dtype": exported.compute_dtype,
      "cast_params": list(exported.cast),
      "draws": DRAWS,
      "device_type": exported.device_type,
      "num_devices": exported.num_devices,
      "torch_version": torch.__version__,
      "output": "uint8 NHWC in [0,255] + nfe (host loop over score(x, t))",
  }


def save_artifact(exported: Exported, meta: Dict[str, Any],
                  path: str) -> None:
  """Write the single-file artifact (module docstring)."""
  payloads = []
  for spec in exported.specs:
    buf = io.BytesIO()
    torch.export.save(exported.programs[spec.name], buf)
    payloads.append(buf.getvalue())
  meta = dict(meta, programs=[dict(spec._asdict(), bytes=len(p))
                              for spec, p in zip(exported.specs, payloads)])
  meta_bytes = json.dumps(meta, sort_keys=True).encode("utf-8")
  with open(path, "wb") as f:
    f.write(_MAGIC)
    f.write(struct.pack(">I", len(meta_bytes)))
    f.write(meta_bytes)
    for p in payloads:
      f.write(p)


def read_meta(path: str) -> Tuple[Dict[str, Any], int]:
  """The artifact's meta and the offset of its first payload; ValueError
  for a file that is not one."""
  with open(path, "rb") as f:
    magic = f.read(len(_MAGIC))
    if magic != _MAGIC:
      raise ValueError(f"{path}: not a soft_truncation_tpu_torch serving "
                       f"artifact (bad magic {magic!r})")
    (meta_len,) = struct.unpack(">I", f.read(4))
    return (json.loads(f.read(meta_len).decode("utf-8")),
            len(_MAGIC) + 4 + meta_len)


def load_artifact(path: str, device=None) -> Tuple[Exported, Dict[str, Any]]:
  """Read an artifact back to ``(exported, meta)``. ``device`` defaults to
  the device type it was exported on; another type raises ValueError (the
  programs' constants and device arguments are that device's)."""
  meta, offset = read_meta(path)
  want = meta["device_type"]
  if device is not None and torch.device(device).type != want:
    raise ValueError(f"{path} was exported on {want}; it cannot be loaded "
                     f"on {torch.device(device).type}")
  resolve_device(want)  # raises for cuda without a card
  programs, specs = {}, []
  with open(path, "rb") as f:
    f.seek(offset)
    for entry in meta["programs"]:
      spec = Program(entry["name"], int(entry["batch"]),
                     bool(entry["continuous"]))
      programs[spec.name] = torch.export.load(
          io.BytesIO(f.read(int(entry["bytes"]))))
      specs.append(spec)
  return Exported(programs, tuple(specs), tuple(meta["params"]),
                  tuple(meta["operands"]), want,
                  int(meta.get("num_devices", 1)),
                  meta.get("compute_dtype", "float32"),
                  tuple(meta.get("cast_params", ()))), meta


def _param_dtypes(program, names) -> Dict[str, torch.dtype]:
  """The dtype each state_dict input ``names`` (the user inputs after x and
  t) of ``program`` was traced with."""
  from torch.export.graph_signature import InputKind
  user = [node for node, spec in zip(
      (n for n in program.graph.nodes if n.op == "placeholder"),
      program.graph_signature.input_specs)
          if spec.kind == InputKind.USER_INPUT]
  return {name: node.meta["val"].dtype
          for name, node in zip(names, user[2:])}


def _flat_call(program) -> Callable:
  """``call(x, t, inputs)``: the program's graph on its inputs in the
  order of its signature (its lifted constants, then x, t and ``inputs``).
  ``program.module()`` would check every input's shape and dtype on every
  call, some milliseconds at the ~700 inputs of a full-width network;
  :class:`ExportedScore` hands the graph tensors of the shapes it was
  exported at."""
  from torch.export.graph_signature import InputKind
  specs = program.graph_signature.input_specs
  user = [i for i, spec in enumerate(specs)
          if spec.kind == InputKind.USER_INPUT]
  if user != list(range(len(specs) - len(user), len(specs))):
    raise ValueError("the program's lifted inputs do not all come first")
  lifted = [program.constants[spec.target]
            if spec.kind in (InputKind.CONSTANT_TENSOR,
                             InputKind.CUSTOM_OBJ)
            else program.state_dict[spec.target]
            for spec in specs[:len(specs) - len(user)]]
  graph = program.graph_module

  def call(x, t, inputs):
    return graph(*lifted, x, t, *inputs)[0]

  return call


class ExportedScore:
  """The exported programs with a params load bound to them: what a
  sampler takes in place of the network (``sample/sampling.py::score_of``).

  ``score_fn(continuous)(x, t)`` runs the program of x's batch and that
  label kind, or, for a multiple of the artifact's batch B that no program
  has (a Picard window other than the exported one), the B program on
  each B rows in turn."""

  def __init__(self, exported: Exported, meta: Dict[str, Any],
               params: Dict[str, torch.Tensor], device=None):
    self.device = resolve_device(device or exported.device_type)
    if self.device.type != exported.device_type:
      raise ValueError(f"the programs were exported on "
                       f"{exported.device_type}, not {self.device.type}")
    missing = [n for n in exported.params if n not in params]
    if missing:
      raise ValueError(f"params lack {len(missing)} of the program's "
                       f"inputs, e.g. {missing[:3]}")
    # contiguous, as a load into the network's own tensors leaves them (a
    # dense weight transposed in place would take another GEMM order), in
    # the dtype the programs were traced with (a bf16 EMA's heads: bf16)
    dtypes = _param_dtypes(exported.programs[exported.specs[0].name],
                           exported.params)
    state = {n: params[n].to(self.device, dtypes[n]).contiguous()
             for n in exported.params}
    self.inputs = program_inputs(state, exported.params, exported.operands,
                                 getattr(torch, exported.compute_dtype),
                                 exported.cast)
    self.batch = int(meta["sample_shape"][0]) // exported.num_devices
    self._modules = {(s.batch, s.continuous): _flat_call(
        exported.programs[s.name]) for s in exported.specs}

  def score_fn(self, continuous: bool) -> Callable:
    continuous = bool(continuous)

    def score(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
      n = x.shape[0]
      module = self._modules.get((n, continuous))
      if module is not None:
        return module(x, t, self.inputs)
      one = self._modules.get((self.batch, continuous))
      if one is None or n % self.batch:
        raise ValueError(f"the artifact has no score program for batch "
                         f"{n} with continuous={continuous}")
      return torch.cat([one(x[i:i + self.batch], t[i:i + self.batch],
                            self.inputs)
                        for i in range(0, n, self.batch)])

    return score


def save_params_npz(params: Dict[str, torch.Tensor], path: str) -> None:
  """Write a port state_dict as the JAX package's params npz (Flax path
  names, the ``__dtypes__`` manifest for bfloat16 / fp8 leaves), the file
  ``tools/export_sampler.py`` writes for a JAX checkpoint."""
  jax_params.save_params_npz(jax_params.to_jax_params(params), path)


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
  """A params npz (either package's) as a port state_dict."""
  return jax_params.from_jax_params(jax_params.load_params_npz(path))


def _restore_ema(config, model, workdir: Optional[str]) -> bool:
  """Load the EMA weights of ``workdir``'s rolling checkpoint into
  ``model``; False where there is none."""
  if not workdir:
    return False
  from ..train import CheckpointManager, init_train_state
  manager = CheckpointManager(workdir)
  if not os.path.exists(manager.meta_path):
    return False
  state = init_train_state(config, model)
  manager.restore_meta(state)
  from ..models.score import load_eval_params
  load_eval_params(model, state.ema)
  return True


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--config", required=True,
                 help="a config file of the port (configs/...)")
  p.add_argument("--out", required=True,
                 help=f"output prefix: writes <out>{EXTENSION} and "
                      "<out>.params.npz")
  p.add_argument("--workdir", default=None,
                 help="restore the EMA weights of its checkpoint")
  p.add_argument("--batch", type=int, default=None,
                 help="samples per program call (default: "
                      "config.sampling.batch_size)")
  p.add_argument("--cpu", action="store_true",
                 help="export on the host CPU instead of the card")
  p.add_argument("--mesh", type=int, default=1,
                 help="ranks the batch is split over at replay (the "
                      "programs take batch / mesh samples)")
  args, overrides = p.parse_known_args(argv)
  logging.basicConfig(level=logging.INFO)
  from ..configs.base import load_config
  from ..main import apply_overrides
  from ..models import create_model
  config = apply_overrides(load_config(args.config), overrides)
  device = "cpu" if args.cpu else "cuda"
  model = create_model(config, device)
  if not _restore_ema(config, model, args.workdir):
    log.warning("=" * 72)
    log.warning("NO CHECKPOINT%s: EXPORTING RANDOMLY INITIALISED WEIGHTS",
                f" in {args.workdir}" if args.workdir else "")
    log.warning("=" * 72)
  params = model.state_dict()
  exported, shape = export_sampler(config, params, args.batch, device,
                                   (args.mesh,))
  path = args.out + EXTENSION
  save_artifact(exported, artifact_meta(config, shape, exported), path)
  save_params_npz(params, args.out + ".params.npz")
  log.info("wrote %s (%d bytes, programs %s) and %s.params.npz", path,
           os.path.getsize(path), [s.name for s in exported.specs], args.out)


if __name__ == "__main__":
  main()
