"""Every module of the port, and chip_smoke.py, imports in a fresh
interpreter without loading jax or anything of the JAX package
(pyspectrogram_tpu): the port keeps its own copies of what it uses.

One case per module (pkgutil.walk_packages over the port). Each import runs
in its own subprocess with JAX_PLATFORMS=cpu and a timeout; a module-scoped
fixture runs them four at a time, so the cases cost one interpreter start
each without running one after another.
"""

import json
import os
import pkgutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import pyspectrogram_tpu_torch

REPO = Path(__file__).resolve().parents[1]
MODULES = ["pyspectrogram_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(pyspectrogram_tpu_torch.__path__,
                                          "pyspectrogram_tpu_torch."))
#: chip_smoke.py is imported, not run: it needs a card
CASES = MODULES + ["chip_smoke"]

PROBE = """
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m.split(".")[0] == "pyspectrogram_tpu")))
"""


def _import_alone(name: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", PROBE, name], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.fixture(scope="module")
def imports():
    with ThreadPoolExecutor(max_workers=4) as ex:
        return dict(zip(CASES, ex.map(_import_alone, CASES)))


def test_every_module_is_listed():
    """The walk found the port's subpackages and their modules."""
    for name in ("pyspectrogram_tpu_torch.io.reader",
                 "pyspectrogram_tpu_torch.native.ingest",
                 "pyspectrogram_tpu_torch.clients._qt_headless",
                 "pyspectrogram_tpu_torch.kernels.median_cuda"):
        assert name in MODULES
    assert len(MODULES) == len(set(MODULES)) > 40


@pytest.mark.parametrize("name", CASES)
def test_imports_nothing_of_jax(imports, name):
    res = imports[name]
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
