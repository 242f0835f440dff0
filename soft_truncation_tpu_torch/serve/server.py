"""Sampling server of the PyTorch port: the serving slice's entry point.

Counterpart of ``soft_truncation_tpu/serve/export.py::make_serving_fn`` and
``serve/server.py``: it builds ``get_sde`` -> ``create_model`` ->
``get_sampling_fn`` from a config, runs the sampler on the card and
quantises to uint8 NHWC. Stdlib ``http.server``; the device is
single-tenant, so requests serialise on a lock, and a request for ``num``
samples runs ``ceil(num / batch)`` sampler rounds at the service's batch.

Endpoints::

    GET  /healthz            -> 200 {"status": "ok", "meta": {...}}
    POST /sample             -> body {"num": int, "seed": int,
                                      "format": "npz" | "png",
                                      "method": "pc" | "ode" | "dpm_solver"
                                                | "picard" | "picard_dpm",
                                      "dpm_steps": int}
        npz: application/octet-stream, np.savez{"samples": uint8 NHWC,
             "nfe": int}
        png: image/png grid (up to 64 images); needs PIL, and where PIL is
             not installed the server answers npz only (``meta.formats``)

``method`` and ``dpm_steps`` default to the config's (``pc`` runs the
config's predictor and corrector over ``model.num_scales`` steps).
``picard`` and ``picard_dpm`` are the parallel-in-time versions of ``pc``
and ``dpm_solver`` (``sample/parallel.py``) with the config's
``sampling.picard_*`` keys: ``picard`` with a ``picard_tol`` above 0 on a
stochastic chain is refused (400), as the sampler refuses it.
Determinism: the same ``seed`` always returns the same samples; round ``r``
of a request draws its prior from a ``torch.Generator`` on the device
seeded from ``(seed, r)``, and the PC sampler's noise from a second one
seeded from ``(seed, r)`` on a separate stream.

Two ways to build the service, the same endpoints, checks and samples
per seed:

- live: ``SamplingService(config, params)`` builds ``get_sde`` ->
  ``create_model`` -> ``get_sampling_fn`` from a config;
- replay: ``SamplingService.from_artifact(artifact, params_npz)`` serves
  the pair ``serve/export.py`` writes. It builds no network and reads no
  config file (the host loop's keys come from the artifact's meta), and
  imports neither ``soft_truncation_tpu_torch.models`` nor ``.configs``:
  the samplers evaluate the exported score programs
  (``export.ExportedScore``) in the network's place, with the same draws.
  An artifact exported for N ranks (``export_sampler(mesh=...)``) replays
  under ``torchrun --nproc_per_node N`` and on no other count: rank 0
  takes each request (HTTP or :meth:`SamplingService.sample`) and hands it
  to the others (:meth:`SamplingService.follow`), every rank samples its
  B / N rows of each round (the prior and the PC noise drawn for the whole
  batch and cut to them; dopri5's error norms and the Langevin step sizes
  taken over the whole batch) and rank 0 gathers the samples: those of one
  process.

Run: ``python -m soft_truncation_tpu_torch.serve.server --config <file>
--params <npz> [--batch B] [--cpu] --port P``, with a config file of the
port (``soft_truncation_tpu_torch/configs/...``) and the params npz that
the JAX package's ``save_params_npz`` / ``tools/export_sampler.py`` (or the
port's ``serve/export.py``) write; or ``--artifact <file.pt2> --params
<npz> [--cpu]`` to replay an exported artifact.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data import get_data_inverse_scaler
from ..eval.sampling_io import _to_uint8, save_image_grid
from ..parallel.ddp import gather, join, shard, sharded_draw
from ..parallel.mesh import batch_sharded
from ..sample import get_sampling_fn
from ..sde import get_sde
from ..utils.device import resolve_device
from ..utils.jax_params import from_jax_params, load_params_npz

log = logging.getLogger(__name__)

METHODS = ("pc", "ode", "dpm_solver", "picard", "picard_dpm")
MAX_DPM_STEPS = 1000


def _round_seed(seed: int, r: int, stream: int = 0) -> int:
  """A 64-bit generator seed for round ``r`` of a request with ``seed``:
  stream 0 for the prior, 1 for the sampler's noise."""
  words = [seed % 2 ** 64, r] + ([stream] if stream else [])
  state = np.random.SeedSequence(words).generate_state(1, np.uint64)
  return int(state[0])


class SamplingService:
  """Sample from the port's model; thread-safe, deterministic per seed.

  ``params`` is the port model's state_dict (``from_jax_params`` of a Flax
  tree, or a port model's own). ``max_num`` bounds one request's work: the
  lock is held for all its rounds and their samples are buffered on the
  host. :meth:`from_artifact` builds the same service on an exported
  artifact instead of the network."""

  def __init__(self, config, params: Dict[str, torch.Tensor],
               batch: Optional[int] = None, device="cuda",
               max_num: int = 4096):
    from ..models import create_model
    device = resolve_device(device)
    from ..models.score import load_eval_params
    model = create_model(config, device)
    load_eval_params(model, params)
    self._setup(config, model, device, batch, max_num, {})

  @classmethod
  def from_artifact(cls, artifact: str, params: str, device=None,
                    max_num: int = 4096) -> "SamplingService":
    """The service on ``artifact`` (``serve/export.py``'s file) with the
    weights of the params npz ``params``, on the device type it was
    exported on (``device`` another type raises ValueError)."""
    from .export import ExportedScore, load_artifact, meta_config
    exported, meta = load_artifact(artifact, device)
    world = None
    if exported.num_devices > 1:
      world, device, _ = join(device or exported.device_type)
      if world.size != exported.num_devices:
        raise ValueError(
            f"{artifact} splits its batch over {exported.num_devices} ranks; "
            f"this world has {world.size} (launch it with torchrun "
            f"--nproc_per_node {exported.num_devices})")
    score = ExportedScore(exported, meta,
                          from_jax_params(load_params_npz(params)), device)
    service = cls.__new__(cls)
    service._setup(meta_config(meta), score, score.device,
                   meta["sample_shape"][0], max_num,
                   {"artifact": {k: meta.get(k, 1) for k in (
                       "programs", "torch_version", "device_type",
                       "num_devices")}}, world)
    return service

  def _setup(self, config, model, device, batch, max_num, meta, world=None):
    self.device = device
    self.config = config
    self.batch = int(batch or config.sampling.batch_size)
    self.shape = (self.batch, config.data.image_size, config.data.image_size,
                  config.data.num_channels)
    # the ranks the batch is split over (the replay on several ranks)
    self.world = world if world is not None and world.size > 1 else None
    ranks = self.world.size if self.world else 1
    self.local_shape = (self.batch // ranks,) + self.shape[1:]

    self.model = model  # the network, or the exported programs' replay
    self.sde = get_sde(config)
    self.max_num = int(max_num)
    self._samplers = {}
    self._lock = threading.Lock()  # single-tenant device
    self.formats = (("npz", "png") if importlib.util.find_spec("PIL")
                    else ("npz",))
    self.meta = {
        "model_name": config.model.name,
        "sde": config.training.sde,
        "num_scales": config.model.num_scales,
        "sampling_method": config.sampling.method,
        "predictor": config.sampling.get("predictor"),
        "corrector": config.sampling.get("corrector"),
        "methods": list(METHODS),
        "sample_shape": list(self.shape),
        "formats": list(self.formats),
        "device": str(self.device),
        "device_name": (torch.cuda.get_device_name(self.device)
                        if self.device.type == "cuda" else "cpu"),
        "output": "uint8 NHWC in [0,255] + nfe",
        **meta,
    }

  def prior(self, seed: int, r: int = 0) -> torch.Tensor:
    """The starting state of round ``r`` of a request with ``seed`` (this
    rank's rows of it)."""
    gen = torch.Generator(self.device).manual_seed(_round_seed(seed, r))
    x = self.sde.prior_sampling(gen, self.shape, self.device)
    return x if self.world is None else shard(x, self.world, 1)

  def noise(self, seed: int, r: int = 0) -> torch.Generator:
    """The generator of the PC sampler's noise in round ``r``."""
    return torch.Generator(self.device).manual_seed(
        _round_seed(seed, r, stream=1))

  def _draw(self, generator: torch.Generator):
    """The PC noise of a rank: each draw made for the whole batch from
    ``generator`` and cut to this rank's rows (``ddp.sharded_draw``)."""
    rows = sharded_draw(
        lambda kind, shape, high=None: torch.randn(
            shape, generator=generator, device=self.device),
        self.world.rank, self.world.size)
    return lambda like: rows("normal", like.shape)

  def sampler(self, method: str, dpm_steps: int):
    """The sampling function of ``method``, built once per (method, steps):
    ``sampler(self.model, generator, x=prior) -> (samples in [0, 1],
    nfe)``; ``pc`` and ``picard`` draw their noise from ``generator`` (or
    ``draw=``). A method the config's keys make invalid raises
    ValueError."""
    key = (method, dpm_steps if method in ("dpm_solver", "picard_dpm")
           else None)
    if key not in self._samplers:
      config = copy.deepcopy(self.config)
      config.sampling.method = method
      config.sampling.dpm_steps = dpm_steps
      self._samplers[key] = get_sampling_fn(
          config, self.sde, self.local_shape,
          get_data_inverse_scaler(config), config.sampling.truncation_time)
    return self._samplers[key]

  def sample(self, num: int, seed: int, method: Optional[str] = None,
             dpm_steps: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """``num`` uint8 NHWC samples and the total NFE. On several ranks, rank
    0 calls this and hands the request to the others (:meth:`follow`);
    each samples its rows and rank 0 gathers them."""
    with self._lock:
      request = self._check(num, method, dpm_steps) + (int(seed),)
      if self.world is not None:
        dist.broadcast_object_list([request], src=0)
      return self._rounds(*request)

  def follow(self) -> List[int]:
    """On a rank but 0 of several: sample the rows of each request rank 0
    hands over until it calls :meth:`stop`; returns each request's NFE as
    this rank's loop counted it."""
    nfes = []
    while True:
      box = [None]
      dist.broadcast_object_list(box, src=0)
      if box[0] is None:
        return nfes
      nfes.append(self._rounds(*box[0])[1])

  def stop(self) -> None:
    """On rank 0 of several: release the ranks in :meth:`follow`."""
    if self.world is not None:
      with self._lock:
        dist.broadcast_object_list([None], src=0)

  def _check(self, num, method, dpm_steps):
    """``(num, method, dpm_steps)`` of a request, checked, with the
    config's defaults filled in; ValueError for one out of bounds."""
    if not 0 < num <= self.max_num:
      raise ValueError(f"num must be in [1, {self.max_num}], got {num}")
    method = (method or self.config.sampling.method).lower()
    if method not in METHODS:
      raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if dpm_steps is None:
      dpm_steps = self.config.sampling.get("dpm_steps", 50)
    dpm_steps = int(dpm_steps)
    if not 0 < dpm_steps <= MAX_DPM_STEPS:
      raise ValueError(f"dpm_steps must be in [1, {MAX_DPM_STEPS}], got "
                       f"{dpm_steps}")
    if self.world is not None and method.startswith("picard"):
      raise ValueError(f"{method} is not served on several ranks")
    self.sampler(method, dpm_steps)  # a method the keys refuse raises here
    return num, method, dpm_steps

  def _rounds(self, num, method, dpm_steps, seed):
    chunks, nfe = [], 0
    sampler = self.sampler(method, dpm_steps)
    for r in range((num + self.batch - 1) // self.batch):
      if self.world is None:
        samples, n = sampler(self.model, self.noise(seed, r),
                             x=self.prior(seed, r))
      else:
        kwargs = ({"draw": self._draw(self.noise(seed, r))}
                  if method == "pc" else {})
        with batch_sharded():
          samples, n = sampler(self.model, self.noise(seed, r),
                               x=self.prior(seed, r), **kwargs)
        samples = gather(samples)
      chunks.append(_to_uint8(samples).cpu().numpy())
      nfe += int(n)
    return np.concatenate(chunks, axis=0)[:num], nfe


def _make_handler(service: SamplingService):

  class Handler(BaseHTTPRequestHandler):

    def log_message(self, fmt, *args):  # route to logging, not stderr
      log.info("%s - %s", self.address_string(), fmt % args)

    def _reply(self, code: int, body: bytes, ctype: str):
      self.send_response(code)
      self.send_header("Content-Type", ctype)
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)

    def _reply_json(self, code: int, obj):
      self._reply(code, json.dumps(obj).encode("utf-8"), "application/json")

    def do_GET(self):
      if self.path == "/healthz":
        self._reply_json(200, {"status": "ok", "meta": service.meta})
      else:
        self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
      if self.path != "/sample":
        self._reply_json(404, {"error": f"unknown path {self.path}"})
        return
      try:
        length = int(self.headers.get("Content-Length", 0))
        req = json.loads(self.rfile.read(length) or b"{}")
        if not isinstance(req, dict):
          raise ValueError(f"request body must be a JSON object, "
                           f"got {type(req).__name__}")
        num = int(req.get("num", service.batch))
        seed = int(req.get("seed", 0))
        fmt = str(req.get("format", "npz")).lower()
        if fmt not in service.formats:
          raise ValueError(f"format must be one of {service.formats}, got "
                           f"{fmt!r}")
        method = req.get("method")
        method = None if method is None else str(method)
        dpm_steps = req.get("dpm_steps")
        dpm_steps = None if dpm_steps is None else int(dpm_steps)
      except (ValueError, TypeError) as e:  # JSONDecodeError is a ValueError
        self._reply_json(400, {"error": str(e)})
        return
      try:
        samples, nfe = service.sample(num, seed, method, dpm_steps)
      except ValueError as e:  # request out of bounds
        self._reply_json(400, {"error": str(e)})
        return
      except Exception as e:  # sampler runtime failure: still reply
        log.exception("sampling failed")
        self._reply_json(500, {"error": f"sampling failed: {e}"})
        return
      buf = io.BytesIO()
      if fmt == "npz":
        np.savez_compressed(buf, samples=samples, nfe=np.asarray(nfe))
        self._reply(200, buf.getvalue(), "application/octet-stream")
      else:
        save_image_grid(samples, buf, format="PNG")
        self._reply(200, buf.getvalue(), "image/png")

  return Handler


def make_server(service: SamplingService, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
  """Bind the HTTP server (``port=0`` picks a free port; call
  ``serve_forever()`` to run)."""
  return ThreadingHTTPServer((host, port), _make_handler(service))


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  source = p.add_mutually_exclusive_group(required=True)
  source.add_argument("--config",
                      help="a config file of the port (configs/...)")
  source.add_argument("--artifact",
                      help="an artifact of serve/export.py: replay it "
                           "without the network or a config file")
  p.add_argument("--params", required=True,
                 help="params npz written by either package's "
                      "save_params_npz")
  p.add_argument("--batch", type=int, default=None,
                 help="samples per sampler round (default: "
                      "config.sampling.batch_size; an artifact's own)")
  p.add_argument("--cpu", action="store_true",
                 help="run on the host CPU instead of the card")
  p.add_argument("--host", default="0.0.0.0")
  p.add_argument("--port", type=int, default=8000)
  p.add_argument("--max-num", type=int, default=4096,
                 help="per-request sample-count cap")
  args, overrides = p.parse_known_args(argv)
  if args.artifact and overrides:
    p.error(f"an artifact carries its config: {overrides} not taken")
  # f32 model: no TF32 in the convolutions, and the same bytes per seed; a
  # bf16 model's products sum in f32, as JAX's do
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
  torch.backends.cudnn.deterministic = True
  logging.basicConfig(level=logging.INFO)
  device = "cpu" if args.cpu else "cuda"
  if args.artifact:
    if args.batch is not None:
      p.error("--batch is the artifact's own; export another to change it")
    service = SamplingService.from_artifact(args.artifact, args.params,
                                            device, max_num=args.max_num)
    if service.world is not None and service.world.rank:
      service.follow()  # rank 0 serves and hands each request over
      return
  else:
    from ..configs.base import load_config
    from ..main import apply_overrides
    config = apply_overrides(load_config(args.config), overrides)
    params = from_jax_params(load_params_npz(args.params))
    service = SamplingService(config, params, batch=args.batch,
                              device=device, max_num=args.max_num)
  srv = make_server(service, args.host, args.port)
  log.info("serving on %s:%d", *srv.server_address)
  try:
    srv.serve_forever()
  except KeyboardInterrupt:
    srv.shutdown()
  finally:
    service.stop()


if __name__ == "__main__":
  main()
