"""Every module of the port, chip_smoke.py, kernel_times.py and
examples/demo_torch.py import without loading jax, anything of the JAX
package (pyspectrogram_tpu) or h5py: the port keeps its own copies of what
it uses, and its own HDF5 layer (io.hdf5).

One case per module (pkgutil.walk_packages over the port). A module-scoped
fixture imports them all in turn in ONE fresh interpreter (JAX_PLATFORMS=cpu,
a timeout), recording after each import whether it failed and which
forbidden modules ``sys.modules`` holds. While every module before it was
clean, a case reads its own record: a forbidden module that appears first
after its import is its own. After the first dirty record the sequence
says nothing more, so each later case imports its module alone in a fresh
interpreter of its own. A clean port thus costs one interpreter start, not
one per module run four at a time beside the other test workers.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import pyspectrogram_tpu_torch

REPO = Path(__file__).resolve().parents[1]
MODULES = ["pyspectrogram_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(pyspectrogram_tpu_torch.__path__,
                                          "pyspectrogram_tpu_torch."))
#: chip_smoke.py, kernel_times.py and the port's demo are imported, not
#: run: the first two need a card
CASES = MODULES + ["chip_smoke", "kernel_times", "examples.demo_torch"]
#: marks the probe's own output lines among whatever an import prints
TAG = "ISOLATION-PROBE "

PROBE = f"""
import importlib, json, sys
for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
        error = None
    except BaseException as e:
        error = repr(e)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "h5py", "pyspectrogram_tpu"))
    print({TAG!r} + json.dumps({{"name": name, "error": error, "bad": bad}}),
          flush=True)
"""


def _probe(names) -> dict:
    """Import ``names`` in turn in one fresh interpreter -> {name: record}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", PROBE, *names], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    records = [json.loads(ln[len(TAG):]) for ln in res.stdout.splitlines()
               if ln.startswith(TAG)]
    assert res.returncode == 0 and len(records) == len(names), res.stderr
    return {r["name"]: r for r in records}


@pytest.fixture(scope="module")
def in_sequence():
    """Each case's record from the one-interpreter run, and whether every
    module before it was clean."""
    records = _probe(CASES)
    clean_before, out = True, {}
    for name in CASES:
        out[name] = (records[name], clean_before)
        r = records[name]
        clean_before = clean_before and r["error"] is None and not r["bad"]
    return out


def test_every_module_is_listed():
    """The walk found the port's subpackages and their modules."""
    for name in ("pyspectrogram_tpu_torch.io.reader",
                 "pyspectrogram_tpu_torch.io.hdf5",
                 "pyspectrogram_tpu_torch.native.ingest",
                 "pyspectrogram_tpu_torch.clients._qt_headless",
                 "pyspectrogram_tpu_torch.kernels.median_cuda",
                 "pyspectrogram_tpu_torch.kernels.gemm_fft",
                 "pyspectrogram_tpu_torch.parallel.mesh",
                 "pyspectrogram_tpu_torch.parallel.sharded",
                 "pyspectrogram_tpu_torch.parallel.dist_fft",
                 "pyspectrogram_tpu_torch.parallel.big_sti"):
        assert name in MODULES
    assert len(MODULES) == len(set(MODULES)) > 40


@pytest.mark.parametrize("name", CASES)
def test_imports_nothing_of_jax(in_sequence, name):
    record, clean_before = in_sequence[name]
    if not clean_before:
        record = _probe([name])[name]
    assert record["error"] is None, record["error"]
    assert record["bad"] == []
