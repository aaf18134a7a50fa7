"""examples/demo_torch.py against examples/demo.py on the CPU.

Both demos run end to end (synthesize -> STI -> processor loop -> CLI
stream -> filter/WAV) into temporary directories of their own, the port's
with ``device="cpu"``. The printed peak and iterations must agree, the
median PSD CSV within 1e-4 dB on bins within 60 dB of the peak (the
standing dB tolerance, ROADMAP Queue 3), the stream command's summary
likewise, and the WAV sample for sample within one 16-bit step: the
filter is torch.fft against jnp.fft in float32, and the WAV is that
signal's real part scaled to 0.9 of full scale and rounded, so a value at
a rounding boundary may land one step apart.

chip_smoke.py runs the demo's step 1 (write_capture, RFDataset) and steps
2-5 on a card; the last test runs that path here against the demo's own
run.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

ARTIFACTS = ("waterfall.png", "psd.csv", "stream.png", "filtered.wav")


def _load(name: str):
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pstpu_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # register BEFORE exec, per importlib docs
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kwargs) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (outdir, printed), "port": (outdir, printed)}."""
    jdir = tmp_path_factory.mktemp("demo_jax")
    pdir = tmp_path_factory.mktemp("demo_port")
    return {"jax": (jdir, _run(_load("demo").main, str(jdir))),
            "port": (pdir, _run(_load("demo_torch").main, str(pdir),
                                device="cpu"))}


def _lines(printed: str, key: str) -> list:
    """The printed lines holding ``key``, each cut before its paths."""
    return [ln.split(" -> ")[0].split(", latency")[0]
            for ln in printed.splitlines() if key in ln]


@pytest.mark.parametrize("key", ["peak at", "iterations [", "[1/5]",
                                 "[5/5]"])
def test_demo_prints_as_jax(runs, key):
    got, want = _lines(runs["port"][1], key), _lines(runs["jax"][1], key)
    assert got == want and len(got) == 1
    if key == "peak at":
        assert got == ["      peak at +125.0 kHz"]


@pytest.mark.parametrize("name", ARTIFACTS)
def test_demo_writes_artifact(runs, name):
    for outdir, _ in runs.values():
        assert (outdir / name).is_file() and (outdir / name).stat().st_size


def test_demo_psd_csv_matches_jax(runs):
    got, want = (np.loadtxt(runs[k][0] / "psd.csv", delimiter=",",
                            skiprows=1) for k in ("port", "jax"))
    assert got.shape == want.shape == (4096, 2)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    keep = want[:, 1] >= want[:, 1].max() - 60.0
    np.testing.assert_allclose(got[keep, 1], want[keep, 1], atol=1e-4,
                               rtol=0)


def test_demo_stream_matches_jax(runs):
    """Step 4's ``stream`` command: its JSON summary line."""
    got, want = ([json.loads(ln) for ln in runs[k][1].splitlines()
                  if ln.startswith("{")] for k in ("port", "jax"))
    assert len(got) == len(want) == 1
    (got,), (want,) = got, want
    assert (got["columns"], got["ring_columns"]) == (want["columns"],
                                                     want["ring_columns"])
    assert abs(got["peak_dbfs"] - want["peak_dbfs"]) <= 1e-4


def test_demo_wav_matches_jax(runs):
    (rate, got), (jrate, want) = (wavfile.read(runs[k][0] / "filtered.wav")
                                  for k in ("port", "jax"))
    assert rate == jrate == 48_000
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_demo_steps_from_memory(tmp_path, runs):
    """chip_smoke's demo path: step 1 as the demo's main() takes it (its
    CAPTURE written, then opened as a Digital RF directory) and steps 2-5
    write what the demo's own run writes, held by the phase's own
    comparison."""
    demo = chip_smoke.load_demo()
    demo.write_capture(tmp_path / "capture", **demo.CAPTURE)
    ds = demo.RFDataset(tmp_path / "capture")
    assert chip_smoke.capture_files(tmp_path / "capture")
    printed, _, _ = chip_smoke.run_demo(demo, ds, "cpu", tmp_path)
    pdir, pprinted = runs["port"]
    held = chip_smoke.demo_vs(tmp_path, pdir, printed, pprinted)
    assert held["psd_db"] <= 1e-4 and held["wav_max_steps"] <= 1
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "psd.csv", delimiter=",", skiprows=1),
        np.loadtxt(pdir / "psd.csv", delimiter=",", skiprows=1))
