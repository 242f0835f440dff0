"""One rank of ``tests/test_torch_mesh.py``'s world: run as ``python
tests/torch_mesh_ranks.py <spec> <out>`` with the environment ``torchrun``
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), on the CPU under gloo. Imports torch and the port only.

``spec`` (a ``torch.save`` file) holds the mesh shape and the cases:

- ``steps``: name -> {config, params, batch, seed, draws (optional)}: one
  train step of the port from ``params`` on the global ``batch``, this
  rank's samples and rows of it, the draws from ``torch.Generator(seed)``
  or replayed from ``draws`` ((kind, array) in the order the step makes
  them, each the global batch's);
- ``windows``: name -> {config, params, batches, seed, draws}: a window
  of K steps (``make_multi_train_step`` on the mesh, on the CPU: route
  'eager') from ``params`` on the ``[K, B, H, W, C]`` raw ``batches``,
  step k's draws replayed from ``draws[k]``, and the same K steps as
  preprocess + ``make_train_step`` calls from the same state and
  generator;
- ``cli``: argument lists of ``soft_truncation_tpu_torch.main``, run in
  turn;
- ``replays``: name -> {config, weights, batch, artifact, params,
  requests}: rank 0 exports the score programs of ``config`` with
  ``weights`` for the world's ranks at ``batch`` to ``artifact``; then
  every rank serves it with the params npz ``params`` through
  ``SamplingService.from_artifact``, rank 0 sampling each request (num,
  seed, method) and the others following it.

Each rank writes ``<out>/rank<r>.pt``: per step its losses, its state
after the step, its shard's shape and the space collectives it ran; per
window its route, losses, state and collectives and those of its K
steps; per replay the (uint8 samples, nfe)
of each request (rank 0), or the nfe each rank's own loop counted.
"""

import os
import sys
import time

import numpy as np
import torch


def _replay(draws):
  it = iter(draws)

  def draw(kind, shape, high=None):
    want_kind, value = next(it)
    assert (kind, tuple(shape)) == (want_kind, tuple(value.shape)), (
        kind, shape, want_kind, value.shape)
    return torch.from_numpy(np.array(value))

  return draw


def _steps(cases, mesh):
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.parallel import spatial
  from soft_truncation_tpu_torch.parallel.mesh import shard_batch
  from soft_truncation_tpu_torch.sde import get_sde
  from soft_truncation_tpu_torch.train import (init_train_state,
                                               make_train_step)
  out = {}
  for name, case in cases.items():
    config = case["config"]
    model = create_model(config, "cpu")
    model.load_state_dict(case["params"])
    state = init_train_state(config, model)
    state.mesh = mesh
    parts = config.optim.num_micro_batch * (
        2 if config.training.get("mixed", False) else 1)
    batch = shard_batch(torch.from_numpy(case["batch"]), mesh, True, parts)
    draw = _replay(case["draws"]) if "draws" in case else None
    spatial.calls.clear()
    losses = make_train_step(config, get_sde(config))(
        state, batch, torch.Generator().manual_seed(case["seed"]), draw)
    out[name] = {"losses": losses, "state": state.state_dict(),
                 "local_shape": tuple(batch.shape),
                 "collectives": dict(spatial.calls)}
  return out


def _windows(cases, mesh):
  from soft_truncation_tpu_torch.data import make_preprocess_fn
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.parallel import spatial
  from soft_truncation_tpu_torch.parallel.mesh import shard_batch
  from soft_truncation_tpu_torch.sde import get_sde
  from soft_truncation_tpu_torch.train import (init_train_state,
                                               make_multi_train_step,
                                               make_train_step)
  out = {}
  for name, case in cases.items():
    config = case["config"]
    sde = get_sde(config)
    states = []
    for _ in range(2):
      model = create_model(config, "cpu")
      model.load_state_dict(case["params"])
      states.append(init_train_state(config, model))
      states[-1].mesh = mesh
    batches = torch.from_numpy(case["batches"])
    window = make_multi_train_step(config, sde, mesh, "cpu")
    spatial.calls.clear()
    losses = window(states[0], batches,
                    torch.Generator().manual_seed(case["seed"]),
                    draws=[_replay(d) for d in case["draws"]])
    collectives = dict(spatial.calls)
    step, preprocess = make_train_step(config, sde), make_preprocess_fn(config)
    parts = config.optim.num_micro_batch * (
        2 if config.training.get("mixed", False) else 1)
    generator = torch.Generator().manual_seed(case["seed"])
    spatial.calls.clear()
    step_losses = torch.stack([
        step(states[1], shard_batch(preprocess(b, generator), mesh, True,
                                    parts), generator, _replay(d))
        for b, d in zip(batches, case["draws"])])
    out[name] = {"route": window.route, "losses": losses,
                 "state": states[0].state_dict(), "collectives": collectives,
                 "step_losses": step_losses,
                 "step_state": states[1].state_dict(),
                 "step_collectives": dict(spatial.calls)}
  return out


def _replays(cases, world):
  import torch.distributed as dist
  from soft_truncation_tpu_torch.serve import export
  from soft_truncation_tpu_torch.serve.server import SamplingService
  out = {}
  for name, case in cases.items():
    if world.rank == 0:
      exported, shape = export.export_sampler(
          case["config"], case["weights"], case["batch"], "cpu",
          (world.size,))
      export.save_artifact(exported, export.artifact_meta(
          case["config"], shape, exported), case["artifact"])
    dist.barrier()
    service = SamplingService.from_artifact(case["artifact"],
                                            case["params"], "cpu")
    if world.rank == 0:
      out[name] = [service.sample(num, seed, method)
                   for num, seed, method in case["requests"]]
      service.stop()
    else:
      out[name] = service.follow()
    dist.barrier()
  return out


def main(spec_path, out_dir):
  from soft_truncation_tpu_torch import main as cli
  from soft_truncation_tpu_torch.parallel import ddp
  from soft_truncation_tpu_torch.parallel.mesh import make_mesh
  torch.set_num_threads(1)
  spec = torch.load(spec_path, weights_only=False)
  world, _, _ = ddp.join("cpu")
  mesh = make_mesh(spec["mesh_shape"], world)
  out = {"mesh": (mesh.data_index, mesh.space_index)}
  start = time.perf_counter()
  out["steps"] = _steps(spec.get("steps", {}), mesh)
  out["windows"] = _windows(spec.get("windows", {}), mesh)
  steps = time.perf_counter()
  for argv in spec.get("cli", ()):
    cli.main(argv)
  trained = time.perf_counter()
  out["replays"] = _replays(spec.get("replays", {}), world)
  print(f"steps {steps - start:.1f} s, cli {trained - steps:.1f} s, "
        f"replays {time.perf_counter() - trained:.1f} s", flush=True)
  torch.save(out, os.path.join(out_dir, f"rank{world.rank}.pt"))


if __name__ == "__main__":
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))
  main(*sys.argv[1:])
