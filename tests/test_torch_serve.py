"""The port's sampling server (soft_truncation_tpu_torch/serve/server.py) on
the CPU: the same contract as the JAX server (tests/test_serve.py):
deterministic per seed, bounded ``num``, HTTP /healthz and /sample."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from soft_truncation_tpu.eval.sampling_io import _to_uint8 as jax_to_uint8
from soft_truncation_tpu_torch.data import get_data_inverse_scaler
from soft_truncation_tpu_torch.eval.sampling_io import _to_uint8
from soft_truncation_tpu_torch.models import create_model
from soft_truncation_tpu_torch.sample import get_sampling_fn
from soft_truncation_tpu_torch.serve.server import (SamplingService,
                                                    _round_seed, make_server)

import torch_tiny


def _config():
  _, pc = torch_tiny.configs()
  pc.sampling.method = "dpm_solver"
  pc.sampling.dpm_steps = 3
  return pc


@pytest.fixture(scope="module")
def service():
  config = _config()
  params = create_model(config, "cpu", seed=7).state_dict()
  return SamplingService(config, params, batch=2, device="cpu", max_num=16)


@pytest.fixture(scope="module")
def server(service):
  srv = make_server(service, host="127.0.0.1", port=0)
  thread = threading.Thread(target=srv.serve_forever, daemon=True)
  thread.start()
  yield f"http://127.0.0.1:{srv.server_address[1]}"
  srv.shutdown()
  thread.join(timeout=30)
  srv.server_close()


def _post(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as r:
    return r.read(), r.headers.get("Content-Type")


def test_to_uint8_matches_jax():
  """Clip, then truncate toward zero, exactly as the JAX version does."""
  x = np.concatenate([np.linspace(-0.5, 1.5, 4001, dtype=np.float32),
                      np.arange(256, dtype=np.float32) / 255.0])
  want = np.asarray(jax_to_uint8(x))
  np.testing.assert_array_equal(_to_uint8(torch.from_numpy(x)).numpy(), want)


def test_service_is_deterministic_per_seed_and_matches_its_sampler(service):
  a, nfe = service.sample(3, seed=5)
  assert a.shape == (3, 16, 16, 3) and a.dtype == np.uint8
  assert nfe == 2 * (3 + 1)  # two rounds of 3 steps + the denoise eval
  b, _ = service.sample(3, seed=5)
  np.testing.assert_array_equal(a, b)
  c, _ = service.sample(3, seed=6)
  assert not np.array_equal(a, c)

  config = _config()
  sampler = get_sampling_fn(config, service.sde, service.shape,
                            get_data_inverse_scaler(config),
                            config.sampling.truncation_time)
  gen = torch.Generator("cpu").manual_seed(_round_seed(5, 0))
  direct, _ = sampler(service.model, gen)
  np.testing.assert_array_equal(_to_uint8(direct).numpy(), a[:2])
  # the same round from its prior handed in, as chip_smoke.py replays it
  replay, _ = service.sampler("dpm_solver", 3)(service.model,
                                               x=service.prior(5, 1))
  np.testing.assert_array_equal(_to_uint8(replay).numpy()[:1], a[2:])


def test_service_bounds_and_device(service):
  for num in (0, 17):
    with pytest.raises(ValueError):
      service.sample(num, seed=0)
  with pytest.raises(ValueError):
    service.sample(2, seed=0, method="picard")
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="no CUDA device"):
      SamplingService(_config(), service.model.state_dict(), batch=2)


def test_server_healthz_and_npz_sampling(server):
  with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
    health = json.loads(r.read())
  assert health["status"] == "ok"
  assert health["meta"]["sample_shape"] == [2, 16, 16, 3]

  # num=3 > batch=2 exercises the multi-round path and the final slice
  body, ctype = _post(server + "/sample", {"num": 3, "seed": 5})
  assert ctype == "application/octet-stream"
  with np.load(io.BytesIO(body)) as f:
    samples, nfe = f["samples"], int(f["nfe"])
  assert samples.shape == (3, 16, 16, 3) and samples.dtype == np.uint8
  assert nfe > 0
  body2, _ = _post(server + "/sample", {"num": 3, "seed": 5})
  assert body2 == body
  body3, _ = _post(server + "/sample", {"num": 3, "seed": 5,
                                        "method": "dpm_solver",
                                        "dpm_steps": 2})
  with np.load(io.BytesIO(body3)) as f:
    assert int(f["nfe"]) == 2 * (2 + 1)


def test_server_png_and_errors(server):
  body, ctype = _post(server + "/sample", {"num": 2, "seed": 0,
                                           "format": "png"})
  assert ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
  for bad in ({"num": 0}, {"num": 10**9}, {"format": "gif"},
              {"num": "xyz"}, {"num": None}, {"method": "picard"},
              {"dpm_steps": 0}, [1, 2]):
    req = urllib.request.Request(
        server + "/sample", data=json.dumps(bad).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
      urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400, bad
    assert "error" in json.loads(e.value.read())
  with pytest.raises(urllib.error.HTTPError) as e:
    urllib.request.urlopen(server + "/nope", timeout=30)
  assert e.value.code == 404
