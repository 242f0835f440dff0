"""How much room the 256x256 case of ``tests/test_torch_mesh.py`` has under
its bar at the NCSN++ default 8-bit dropout masks, on the CPU:

    python tests/torch_mesh_spread.py

(about a minute; prints one JSON line per measurement). It takes the case
as the test builds it (``STEPS["256px"]``) but with ``tpu.dropout_bits`` 0,
the default (8-bit masks), and measures:

1. ``masks``: the (2, 2) mesh's kept dropout lanes against one process's,
   element by element: four gloo ranks launched as ``torchrun`` launches
   them, each recording the lanes of every dropout it draws, against the
   one-process step's lanes cut to that rank's samples and image rows;
2. ``mesh``: the mesh's Adam moments and parameters after the step against
   one process's, as the test's ``_assert_same_state`` holds them: the
   largest error of each kind over ``atol = 1e-5 * largest`` (above 1
   fails the bar);
3. ``reordered``: one process's step again with the batch's samples in
   another order (every draw and mask following its sample), which reorders
   the step's sums over the batch and nothing else: the same ratio between
   two runs of the same arithmetic, the spread that rounding alone gives.
"""

import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = 4
PERMUTATIONS = ((1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_DRAW_LANES = {}  # the dropout's own draw_lanes, before any recording


def _case():
  from test_torch_mesh import _batch, _port_config
  from soft_truncation_tpu_torch.models import create_model
  config = _port_config("256px")
  config.tpu.dropout_bits = 0  # the default: 8-bit masks under threefry
  return dict(config=config, batch=_batch(config, 11), seed=21,
              params=create_model(config, "cpu", seed=1).state_dict())


def _recording_lanes(record, replay=None):
  """Make the dropout record the lanes it draws (or hand out ``replay``'s
  lanes, in order, instead)."""
  from soft_truncation_tpu_torch.models import dropout
  draw = _DRAW_LANES.setdefault("original", dropout.draw_lanes)

  def lanes(shape, bits, generator, device):
    out = draw(shape, bits, generator, device) if replay is None else (
        replay[len(record)])
    record.append(out.clone())
    return out

  dropout.draw_lanes = lanes


def _one_process(case, perm=None, draws=None, lanes=None):
  """One process's step, its draws and lanes recorded; with ``perm``
  the samples reordered and ``draws`` / ``lanes`` (an unpermuted run's)
  handed out reordered to follow them."""
  from soft_truncation_tpu_torch.losses import make_draw
  from soft_truncation_tpu_torch.models import create_model
  from soft_truncation_tpu_torch.sde import get_sde
  from soft_truncation_tpu_torch.train import (init_train_state,
                                               make_train_step)
  config = case["config"]
  model = create_model(config, "cpu")
  model.load_state_dict(case["params"])
  state = init_train_state(config, model)
  batch = torch.from_numpy(case["batch"])
  generator = torch.Generator().manual_seed(case["seed"])
  made, recorded = [], []
  b = batch.shape[0]

  def follow(t):
    return t[list(perm)] if perm is not None and t.dim() and (
        t.shape[0] == b) else t

  if perm is None:
    inner = make_draw(generator, "cpu")

    def draw(kind, shape, high=None):
      made.append(inner(kind, shape, high))
      return made[-1]
  else:
    it = iter(draws)

    def draw(kind, shape, high=None):
      return follow(next(it))
    batch = batch[list(perm)]
    lanes = [follow(t) for t in lanes]
  _recording_lanes(recorded, lanes)
  losses = make_train_step(config, get_sde(config))(state, batch, generator,
                                                    draw)
  return losses, state.state_dict(), made, recorded


def _ratios(got, want):
  """Per kind, max over tensors of |got - want| / (1e-5 * largest |want|
  of that kind): the test's bar is 1."""
  out = {}
  for kind in ("mu", "nu"):
    largest = max(w.abs().max().item() for w in want["optimizer"][kind])
    worst = max(((g - w).abs().max().item(), i) for i, (g, w) in enumerate(
        zip(got["optimizer"][kind], want["optimizer"][kind])))
    out[kind] = {"ratio": worst[0] / (1e-5 * largest), "tensor": worst[1]}
  for part in ("model", "ema"):
    out[part] = {"max_abs": max((got[part][k] - w).abs().max().item()
                                for k, w in want[part].items()),
                 "atol": 1e-5}
  return out


def _rank(spec_path, out_dir):
  """One rank of the mesh: the case's step, its lanes recorded."""
  sys.path.insert(0, os.path.dirname(HERE))
  import torch_mesh_ranks
  from soft_truncation_tpu_torch.parallel import ddp
  from soft_truncation_tpu_torch.parallel.mesh import make_mesh
  torch.set_num_threads(1)
  spec = torch.load(spec_path, weights_only=False)
  world, _, _ = ddp.join("cpu")
  mesh = make_mesh((2, 2), world)
  lanes = []
  _recording_lanes(lanes)
  step = torch_mesh_ranks._steps({"256px": spec}, mesh)["256px"]
  torch.save({"mesh": (mesh.data_index, mesh.space_index), "lanes": lanes,
              "state": step["state"]},
             os.path.join(out_dir, f"rank{world.rank}.pt"))


def main():
  sys.path[:0] = [HERE, os.path.dirname(HERE)]
  from test_torch_ddp import _free_port
  torch.set_num_threads(2)
  case = _case()
  with tempfile.TemporaryDirectory() as tmp:
    torch.save(case, os.path.join(tmp, "spec.pt"))
    env = dict(os.environ, WORLD_SIZE=str(RANKS),
               LOCAL_WORLD_SIZE=str(RANKS), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(HERE) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", os.path.join(tmp, "spec.pt"),
         tmp], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(RANKS)]
    _, alone, draws, lanes = _one_process(case)
    for p in procs:
      if p.wait() != 0:
        raise SystemExit(f"a rank failed: {p.returncode}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(RANKS)]
  b = case["batch"].shape[0]
  differ = compared = 0
  for got in ranks:
    i, j = got["mesh"]
    assert len(got["lanes"]) == len(lanes)
    for mine, whole in zip(got["lanes"], lanes):
      n, rows = mine.shape[0], mine.shape[1]
      want = whole[i * n:(i + 1) * n, j * rows:(j + 1) * rows]
      differ += int((mine != want).sum())
      compared += mine.numel()
  print(json.dumps({"masks": {"dropouts": len(lanes), "lanes": compared,
                              "lanes_differing": differ}}))
  print(json.dumps({"mesh": [_ratios(r["state"], alone) for r in ranks]}))
  for perm in PERMUTATIONS:
    assert sorted(perm) == list(range(b))
    _, again, _, _ = _one_process(case, perm, draws, lanes)
    print(json.dumps({"reordered": list(perm),
                      **_ratios(again, alone)}))


if __name__ == "__main__":
  if sys.argv[1:2] == ["--rank"]:
    _rank(*sys.argv[2:4])
  else:
    main()
