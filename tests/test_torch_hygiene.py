"""The port stands alone: no module of soft_truncation_tpu_torch/ and not
chip_smoke.py imports jax, flax, ml_collections, absl or the JAX package
(the machine with the card has none of them), and the port's copy of the
flagship config carries the JAX config's values."""

import ast
import pathlib

import pytest

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


def test_port_flagship_config_equals_jax_config():
  jc, pc = torch_tiny.configs(changes={})
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
