"""The port's exported sampler (soft_truncation_tpu_torch/serve/export.py)
and the server's replay of it, on the CPU.

The tiny flagship and UNCSN++ of ``torch_tiny`` are exported once each
(module fixtures). The kernels' operators are checked with
``torch.library.opcheck``; each exported graph holds one operator node per
fused and per FIR site and replays the eager score within 1e-6 of its
largest value; the artifact-served ``dpm_solver`` (3 steps, batch 2, the
JAX-written params npz) matches JAX's sampler from the same prior within
1e-4 (``tests/test_torch_sampling.py``'s bar: the samples reach a few
hundred); the port's params npz reads back through JAX's loader bit for
bit; the replay serves with the model and config packages unimportable.
One JAX program is compiled: the sampler of that comparison.
"""

import collections
import copy
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from soft_truncation_tpu.data import get_data_inverse_scaler as jax_inv
from soft_truncation_tpu.sample import get_sampling_fn as jax_sampling_fn
from soft_truncation_tpu.sde import get_sde as jax_get_sde
from soft_truncation_tpu.serve.export import (
    load_params_npz as jax_load_params_npz,
    save_params_npz as jax_save_params_npz)
from soft_truncation_tpu_torch.configs.base import override
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.models.score import get_score_fn
from soft_truncation_tpu_torch.ops import fir, gn_conv
from soft_truncation_tpu_torch.sde import get_sde
from soft_truncation_tpu_torch.serve import export, server
from soft_truncation_tpu_torch.serve.server import SamplingService
from soft_truncation_tpu_torch.train import CheckpointManager, init_train_state
from soft_truncation_tpu_torch.utils.jax_params import to_jax_params

import torch_tiny

BATCH = 2
DPM_STEPS = 3
SEED = 5
REPO = torch_tiny.REPO


def _export(config, model, directory, name):
  """Export ``model``'s score programs at BATCH on the CPU and write the
  artifact; returns (exported, artifact path)."""
  exported, shape = export.export_sampler(config, model.state_dict(), BATCH,
                                          "cpu")
  path = os.path.join(directory, name + export.EXTENSION)
  export.save_artifact(exported, export.artifact_meta(config, shape,
                                                      exported), path)
  return exported, path


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
  """The tiny flagship with JAX's weights: its JAX model and params, the
  port model, the artifact and the params npz JAX's save_params_npz
  wrote."""
  jc, pc, jmodel, params, pmodel = torch_tiny.build()
  directory = str(tmp_path_factory.mktemp("flagship"))
  exported, artifact = _export(pc, pmodel, directory, "flagship")
  npz = os.path.join(directory, "flagship.params.npz")
  jax_save_params_npz(params, npz)
  return dict(jc=jc, pc=pc, jmodel=jmodel, params=params, pmodel=pmodel,
              exported=exported, artifact=artifact, npz=npz)


@pytest.fixture(scope="module")
def uncsnpp(tmp_path_factory):
  _, pc = torch_tiny.configs(family=torch_tiny.UNCSNPP)
  pmodel = create_model(pc, "cpu", seed=4)
  directory = str(tmp_path_factory.mktemp("uncsnpp"))
  exported, artifact = _export(pc, pmodel, directory, "uncsnpp")
  return dict(pc=pc, pmodel=pmodel, exported=exported, artifact=artifact)


@pytest.fixture(scope="module")
def replay(flagship):
  return SamplingService.from_artifact(flagship["artifact"],
                                       flagship["npz"], "cpu", max_num=8)


def _gn_inputs(rng, n=2, h=4, w=4, c=8, o=8, groups=4):
  def f32(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
  x = f32(n, h, w, c)
  mean, rsqrt = gn_conv.gn_stats(x, groups)
  wt = f32(3, 3, c, o)
  hi, lo = gn_conv.weight_operand(wt)
  return x, f32(n, h, w, c), mean, rsqrt, f32(n, groups), f32(n, groups), \
      f32(c), f32(c), wt, f32(o), groups, hi, lo


@pytest.mark.parametrize("op", ["gn_silu_conv3x3", "gn_silu_conv3x3_jvp",
                                "fir2_up", "fir2_down"])
def test_opcheck(op):
  """(a) Schema, fake implementation and autograd registration of each
  operator at tiny shapes; the CPU implementation is the plain version."""
  rng = np.random.default_rng(0)
  (x, dx, mean, rsqrt, dmean, drsqrt, gamma, beta, wt, b, groups, hi,
   lo) = _gn_inputs(rng)
  if op == "gn_silu_conv3x3":
    args = (x, mean, rsqrt, gamma, beta, wt, b, groups, hi, lo)
    want = gn_conv.gn_silu_conv3x3_plain(*args[:8])
  elif op == "gn_silu_conv3x3_jvp":
    args = (x, dx, mean, dmean, rsqrt, drsqrt, gamma, beta, wt, groups, hi,
            lo)
    want = gn_conv.gn_silu_conv3x3_jvp_plain(*args[:10])
  else:
    mode = op[len("fir2_"):]
    args = (x, [1.0, 3.0, 3.0, 1.0], 2.0, mode, None, f"{mode}:forward")
    want = fir._fir2_plain(x, (1, 3, 3, 1), 2.0, mode)
  overload = getattr(torch.ops.soft_truncation, op.split("_up")[0]
                     .split("_down")[0]).default
  torch.library.opcheck(overload, args)
  torch.testing.assert_close(overload(*args), want, rtol=0, atol=0)


def test_op_route_and_direct_route_agree(monkeypatch):
  """A traced call and an eager one reach the same function through the
  operator (on a CPU tensor its plain version), and give the same result."""
  rng = np.random.default_rng(1)
  (x, _, mean, rsqrt, _, _, gamma, beta, wt, b, groups, hi,
   lo) = _gn_inputs(rng)
  xf = torch.from_numpy(rng.standard_normal((2, 4, 4, 8)).astype(np.float32))
  eager = (gn_conv.gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, wt, b, groups,
                                   (hi, lo)),
           fir.fir_upsample2(xf, (1, 3, 3, 1)))
  monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
  with torch.no_grad():
    traced = (gn_conv.gn_silu_conv3x3(x, mean, rsqrt, gamma, beta, wt, b,
                                      groups, (hi, lo)),
              fir.fir_upsample2(xf, (1, 3, 3, 1)))
  for got, want in zip(traced, eager):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _op_nodes(program):
  return collections.Counter(
      str(n.target).split(".")[1] for n in program.graph.nodes
      if n.op == "call_function" and "soft_truncation" in str(n.target))


@pytest.mark.parametrize("family", ["flagship", "uncsnpp"])
def test_graph_holds_one_node_per_site_and_replays_the_eager_score(
    family, request):
  """(b) One gn_silu_conv3x3 node per fused site and one fir2 node per FIR
  site; the replay within 1e-6 of the eager score's largest value."""
  case = request.getfixturevalue(family)
  pc, pmodel, exported = case["pc"], case["pmodel"], case["exported"]
  (spec,) = exported.specs
  assert (spec.batch, spec.continuous) == (BATCH, True)
  rng = np.random.default_rng(2)
  x = torch.from_numpy(rng.standard_normal(torch_tiny.SHAPE)
                       .astype(np.float32))
  t = torch.tensor([0.3, 0.8])
  with torch.no_grad():
    want = get_score_fn(pc, get_sde(pc), pmodel, continuous=True)(x, t)
    nodes = _op_nodes(exported.programs[spec.name])
    assert nodes["gn_silu_conv3x3"] == len(pmodel.fused_sites()) > 0
    assert nodes["fir2"] == len(pmodel.fir_sites())
    assert (nodes["fir2"] > 0) == (family == "uncsnpp")
    meta = export.artifact_meta(pc, (BATCH, 16, 16, 3), exported)
    score = export.ExportedScore(exported, meta, pmodel.state_dict(), "cpu")
    got = score.score_fn(True)(x, t)
  torch.testing.assert_close(got, want, rtol=0,
                             atol=1e-6 * want.abs().max().item())


def test_artifact_dpm_solver_matches_jax_from_the_same_prior(flagship,
                                                             replay):
  """(c) The slice against JAX: dpm_solver served from the artifact and
  the JAX-written npz, from JAX's prior."""
  jc = flagship["jc"]
  jc.sampling.method, jc.sampling.dpm_steps = "dpm_solver", DPM_STEPS
  jsde = jax_get_sde(jc)
  key = jax.random.PRNGKey(3)
  x0 = np.asarray(jsde.prior_sampling(jax.random.split(key)[1],
                                      torch_tiny.SHAPE))
  jfn = jax_sampling_fn(jc, jsde, torch_tiny.SHAPE, jax_inv(jc),
                        jc.sampling.truncation_time)
  want, want_nfe = jax.jit(lambda p, k: jfn(flagship["jmodel"], p, k))(
      flagship["params"], key)
  got, nfe = replay.sampler("dpm_solver", DPM_STEPS)(
      replay.model, x=torch.from_numpy(x0.copy()))
  assert nfe == int(want_nfe) == DPM_STEPS + 1
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-4)


def test_params_npz_reads_back_through_jax_bit_for_bit(flagship, tmp_path):
  """(d) The port's save_params_npz -> JAX's load_params_npz gives the JAX
  tree back, a bfloat16 leaf through the dtype manifest."""
  state = flagship["pmodel"].state_dict()
  path = str(tmp_path / "port.npz")
  export.save_params_npz(state, path)
  want = jax.tree_util.tree_leaves_with_path(flagship["params"])
  got = jax.tree_util.tree_leaves_with_path(jax_load_params_npz(path))
  assert [p for p, _ in got] == [p for p, _ in want]
  for (p, g), (_, w) in zip(got, want):
    assert g.dtype == w.dtype == np.float32, p
    np.testing.assert_array_equal(g, w)
  leaf = "down_0_0.conv0.bias"
  bf16 = dict(state, **{leaf: state[leaf].to(torch.bfloat16)})
  export.save_params_npz(bf16, path)
  tree = jax_load_params_npz(path)
  got_leaf = tree["down_0_0"]["conv0"]["bias"]
  assert got_leaf.dtype == ml_dtypes.bfloat16
  np.testing.assert_array_equal(
      got_leaf.view(np.uint16),
      state[leaf].numpy().astype(ml_dtypes.bfloat16).view(np.uint16))
  back = export.load_params_npz(path)
  assert back[leaf].dtype == torch.bfloat16  # carried as bf16, bit for bit
  assert torch.equal(back[leaf].view(torch.int16),
                     bf16[leaf].view(torch.int16))


def test_to_jax_params_is_the_inverse_of_from_jax_params(uncsnpp):
  """UNCSN++'s tree (Dense, NIN, GroupNorm, the Fourier W) round-trips."""
  from soft_truncation_tpu_torch.utils.jax_params import from_jax_params
  state = uncsnpp["pmodel"].state_dict()
  back = from_jax_params(to_jax_params(state))
  assert set(back) == set(state)
  for k, v in state.items():
    torch.testing.assert_close(back[k], v, rtol=0, atol=0)
  assert to_jax_params(state, "batch_stats") == {}


def test_artifact_round_trip_meta_and_refusals(flagship, tmp_path):
  """(e) The file reads back to the same programs and meta; a bad magic and
  another device type raise ValueError."""
  exported, meta = export.load_artifact(flagship["artifact"])
  assert exported.specs == flagship["exported"].specs
  assert exported.params == flagship["exported"].params
  assert exported.operands == flagship["exported"].operands
  pc = flagship["pc"]
  assert meta["model_name"] == "ncsnpp" and meta["sde"]["name"] == "vpsde"
  assert meta["sde"]["beta_min"] == pc.model.beta_min
  assert meta["sde"]["truncation_time"] == pc.training.truncation_time
  assert meta["num_scales"] == pc.model.num_scales
  assert meta["truncation_time"] == pc.sampling.truncation_time
  assert meta["sampling_method"] == pc.sampling.method == "ode"
  for key in ("predictor", "corrector", "snr", "n_steps_each",
              "probability_flow", "noise_removal"):
    assert meta["sampling"][key] == pc.sampling[key], key
  assert meta["sample_shape"] == [BATCH, 16, 16, 3]
  assert meta["device_type"] == "cpu"
  assert meta["torch_version"] == torch.__version__
  assert "SeedSequence" in meta["draws"] and "uint8" in meta["output"]
  assert [p["bytes"] > 0 for p in meta["programs"]] == [True]
  bad = tmp_path / "bad.pt2"
  bad.write_bytes(b"STSRV001" + open(flagship["artifact"], "rb").read()[8:])
  with pytest.raises(ValueError, match="bad magic"):
    export.load_artifact(str(bad))
  with pytest.raises(ValueError, match="exported on cpu"):
    export.load_artifact(flagship["artifact"], "cuda")
  with pytest.raises(ValueError, match="exported on cpu"):
    SamplingService.from_artifact(flagship["artifact"], flagship["npz"],
                                  "cuda")


def _live(flagship):
  return SamplingService(copy.deepcopy(flagship["pc"]),
                         flagship["pmodel"].state_dict(), batch=BATCH,
                         device="cpu")


def test_replay_serves_without_the_model_and_config_packages(flagship,
                                                             tmp_path):
  """(f) A fresh process with soft_truncation_tpu_torch.models and .configs
  unimportable serves a request from the pair: the live service's bytes
  and nfe."""
  out = str(tmp_path / "served.npz")
  code = (
      "import sys\n"
      "for m in ('soft_truncation_tpu_torch.models',"
      " 'soft_truncation_tpu_torch.configs'):\n"
      "  sys.modules[m] = None\n"
      "import numpy as np, torch\n"
      "torch.set_num_threads(2)\n"
      "from soft_truncation_tpu_torch.serve.server import SamplingService\n"
      f"s = SamplingService.from_artifact({flagship['artifact']!r}, "
      f"{flagship['npz']!r}, 'cpu')\n"
      f"a, n = s.sample(3, {SEED}, 'dpm_solver', {DPM_STEPS})\n"
      f"np.savez({out!r}, samples=a, nfe=n)\n")
  env = dict(os.environ, PYTHONPATH=REPO)
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, cwd=REPO, env=env, timeout=300)
  assert proc.returncode == 0, proc.stderr[-3000:]
  want, want_nfe = _live(flagship).sample(3, SEED, "dpm_solver", DPM_STEPS)
  with np.load(out) as f:
    np.testing.assert_array_equal(f["samples"], want)
    assert int(f["nfe"]) == want_nfe == 2 * (DPM_STEPS + 1)


def _post(url, body):
  req = urllib.request.Request(url, data=body if isinstance(body, bytes)
                               else json.dumps(body).encode())
  with urllib.request.urlopen(req, timeout=120) as r:
    return r.read()


def test_http_server_in_artifact_mode(flagship, monkeypatch):
  """(g) ``server.main(['--artifact', ...])``: /healthz names the
  artifact, /sample answers npz with the live service's bytes, and bad
  requests get 400."""
  made, make_server = [], server.make_server

  def make(service, host, port):  # a free port, and the server to test
    made.append(make_server(service, "127.0.0.1", 0))
    return made[-1]

  monkeypatch.setattr(server, "make_server", make)
  thread = threading.Thread(target=server.main, args=([
      "--artifact", flagship["artifact"], "--params", flagship["npz"],
      "--cpu", "--max-num", "4"],), daemon=True)
  thread.start()
  for _ in range(600):
    if made:
      break
    thread.join(timeout=0.1)
  (srv,) = made
  url = f"http://127.0.0.1:{srv.server_address[1]}"
  try:
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
      health = json.loads(r.read())
    assert health["status"] == "ok"
    assert health["meta"]["artifact"]["device_type"] == "cpu"
    assert health["meta"]["sample_shape"] == [BATCH, 16, 16, 3]
    body = _post(url + "/sample", {"num": 2, "seed": SEED,
                                   "method": "dpm_solver",
                                   "dpm_steps": DPM_STEPS})
    with np.load(io.BytesIO(body)) as f:
      want, nfe = _live(flagship).sample(2, SEED, "dpm_solver", DPM_STEPS)
      np.testing.assert_array_equal(f["samples"], want)
      assert int(f["nfe"]) == nfe
    for bad in ({"num": 0}, {"num": 5}, {"method": "nope"},
                {"method": "dpm_solver", "dpm_steps": 0}, b"[1]", b"{"):
      with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/sample", bad)
      assert e.value.code == 400, bad
  finally:
    srv.shutdown()
    thread.join(timeout=60)
    srv.server_close()


def test_picard_replays_through_the_batch_program(flagship, replay):
  """A Picard window with no program of its own runs the batch-B program
  per B rows: the live service's samples."""
  live = _live(flagship)
  live.config.sampling.picard_window = 2
  want = live.sample(2, SEED, "picard_dpm", DPM_STEPS)
  replay = copy.copy(replay)
  replay.config = copy.deepcopy(replay.config)
  replay.config.sampling.picard_window = 2
  replay._samplers = {}
  got = replay.sample(2, SEED, "picard_dpm", DPM_STEPS)
  np.testing.assert_array_equal(got[0], want[0])
  assert got[1] == want[1]


def test_chunked_picard_is_refused():
  """(h) As JAX refuses to export its self-jitting chunked sampler."""
  _, pc = torch_tiny.configs()
  pc.sampling.method, pc.sampling.chunk = "picard", 4
  with pytest.raises(ValueError, match="chunk"):
    export.make_serving_fn(pc, BATCH, "cpu")
  pc.sampling.chunk = 0
  specs = export.program_specs(pc, BATCH)
  window = pc.sampling.get("picard_window", 64)
  assert [(s.batch, s.continuous) for s in specs] == [(BATCH, True),
                                                      (window * BATCH, True)]


def _cli(tmp_path, name, extra=()):
  cut = []
  for section, values in torch_tiny.TINY.items():
    for key, value in values.items():
      cut += [f"--config.{section}.{key}", repr(value)]
  out = str(tmp_path / name)
  export.main(["--config", torch_tiny.PORT_FLAGSHIP, "--out", out, "--cpu",
               "--batch", str(BATCH), *extra, *cut])
  return out


def test_cli_exports_random_weights_and_a_checkpoints_ema(tmp_path, caplog):
  """(i) ``python -m ...serve.export --cpu``: random weights with a
  warning; with ``--workdir`` the EMA weights of a checkpoint written by
  CheckpointManager."""
  out = _cli(tmp_path, "random")
  assert "RANDOMLY INITIALISED" in caplog.text
  assert os.path.getsize(out + export.EXTENSION) > 0
  _, pc = torch_tiny.configs()
  random = export.load_params_npz(out + ".params.npz")
  model = create_model(pc, "cpu")
  state = init_train_state(pc, model)
  for k, v in state.ema.items():
    v.copy_(torch.full_like(v, 0.25) if v.is_floating_point() else v)
  workdir = str(tmp_path / "work")
  CheckpointManager(workdir).save_meta(state)
  caplog.clear()
  out = _cli(tmp_path, "ckpt", ["--workdir", workdir])
  assert "RANDOMLY INITIALISED" not in caplog.text
  params = export.load_params_npz(out + ".params.npz")
  assert set(params) == set(state.ema) == set(random)
  for k, v in params.items():
    torch.testing.assert_close(v, state.ema[k].float(), rtol=0, atol=0)
  meta, _ = export.read_meta(out + export.EXTENSION)
  assert meta["sample_shape"] == [BATCH, 16, 16, 3]
  assert meta["params"] == list(state.ema)
