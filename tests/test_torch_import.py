"""The PyTorch port stands alone: importing it (and chip_smoke.py) loads
neither JAX nor the JAX package, no source of the port names them, and an
entry point never falls back to the CPU by itself."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from score_based_channels_torch import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "score_based_channels_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import score_based_channels_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke  # the card's smoke script imports the port only
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.models import make_score_model
model = make_score_model(ModelConfig(ngf=4), device="cpu")
with torch.no_grad():
    y = model(torch.zeros(1, 64, 16, 2), 1.0)
assert y.shape == (1, 64, 16, 2) and torch.isfinite(y).all()
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "score_based_channels_tpu"))
assert not bad, bad
print("OK")
"""


def test_port_imports_without_jax():
    # tests/conftest.py imports jax in this process, so check in a fresh one
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), *PORT.rglob("*.cu")]))
def test_no_source_names_jax(path):
    text = (ROOT / path).read_text()
    found = re.findall(r"\bjax\b|\bjaxlib\b|\bflax\b|score_based_channels_tpu",
                       text)
    assert not found, f"{path} names {sorted(set(found))}"


def test_resolve_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from score_based_channels_torch.config import ModelConfig
    from score_based_channels_torch.eval.estimate import main
    from score_based_channels_torch.models import make_score_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_score_model(ModelConfig(ngf=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", "unused.npz"])  # the default device is the card
