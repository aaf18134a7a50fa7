"""The port's bench (pyspectrogram_tpu_torch.bench) on the CPU at tiny
shapes: each row family measures, run_all returns the documented rows with
no kernel launch counted (a CPU tensor takes the plain versions), the
snapshot check gives the verdicts the JAX bench's tests hold it to
(tests/test_cli.py), the multi-tab and end-to-end loops run, the latter
against the JAX bench's on one capture, and without a CUDA device the
bench refuses before it measures anything. Only the card gives the bench's
numbers (chip_smoke.py's bench phase).

Tolerance: the end-to-end loop's ``acc`` (the sum of each window's first
median bin in dBFS) within 1e-3 dB per window of the JAX bench's on the
same Digital RF capture.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from pyspectrogram_tpu_torch import bench
from pyspectrogram_tpu_torch.clients.cli import NO_CUDA

REPO = Path(__file__).resolve().parents[1]

#: the rows the bench's docstring documents, in run_all's order
DOCUMENTED_ROWS = [
    "sti/1024/auto/welch", "sti/1024/auto/parity",
    "sti/1024/xla/welch", "sti/1024/xla/parity",
    "sti/4096/auto/welch", "sti/4096/auto/parity",
    "sti/4096/xla/welch", "sti/4096/xla/parity",
    "sti/65536/auto/welch", "sti/65536/auto/parity",
    "sti/65536/xla/welch", "sti/65536/xla/parity",
    "stream/4096/exact", "stream/4096/overlap2048",
    "display/4096/refresh", "mtab/7/display",
]

TINY = ["--device", "cpu", "--nint", "1", "--ntime", "2", "--iters", "1"]


def _args(*extra):
    return bench.build_parser().parse_args([*TINY, *extra])


def _jax_bench():
    """The JAX package's bench, the repository root's bench.py."""
    sys.path.insert(0, str(REPO))
    import bench as jax_bench

    return jax_bench


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("key", ["sti/1024/auto/welch", "sti/4096/xla/parity",
                                 "stream/4096/exact",
                                 "stream/4096/overlap2048",
                                 "display/4096/refresh", "mtab/7/display"])
def test_measure_row_each_family(key):
    before = bench.read_counts()
    gs, p50_ms, extra = bench.measure_row(key, _args("--ntime", "4"), "cpu")
    assert bench.read_counts() == before
    if key.split("/")[0] in ("sti", "stream"):
        assert gs > 0 and p50_ms > 0
    else:
        assert gs is None and p50_ms is None
        assert extra and all(v > 0 for v in extra.values())


def test_measure_row_rejects_unknown_keys():
    for key in ("sti/4096/pallas/display", "stream/4096/display",
                "mtab/3/display"):
        with pytest.raises(ValueError):
            bench.measure_row(key, _args(), "cpu")


def test_run_all_returns_the_documented_rows_and_launches_nothing():
    before = bench.read_counts()
    rows = bench.run_all(_args(), "cpu")
    assert [r["key"] for r in rows] == DOCUMENTED_ROWS == list(bench.ROW_KEYS)
    assert bench.read_counts() == before
    for r in rows:
        assert set(r["launches"]) == set(before)
        assert not any(r["launches"].values()), r
        if r["key"].split("/")[0] in ("sti", "stream"):
            assert r["gs"] > 0 and r["p50_ms"] > 0


def _pin(tmp_path, rows, config=None):
    pin = tmp_path / "pin.json"
    pin.write_text(json.dumps({"rows": rows, "config": config}))
    return str(pin)


def test_check_snapshot_passes_within_tolerance(tmp_path, capsys):
    pin = _pin(tmp_path, [{"key": "sti/4096/auto/welch", "gs": 10.0},
                          {"key": "mtab/7/display", "merged_ms": 20.0}])
    ok = bench.check_snapshot([{"key": "sti/4096/auto/welch", "gs": 9.2},
                               {"key": "mtab/7/display", "merged_ms": 30.0}],
                              pin, 0.10)
    err = capsys.readouterr().err
    assert ok and "PASS" in err and "info" in err   # mtab reported, not gated


def test_check_snapshot_missing_row_fails(tmp_path, capsys):
    pin = _pin(tmp_path, [{"key": "sti/4096/auto/welch", "gs": 10.0},
                          {"key": "stream/4096/exact", "gs": 1.0}])
    ok = bench.check_snapshot([{"key": "sti/4096/auto/welch", "gs": 10.0}],
                              pin, 0.10)
    assert not ok and "MISSING stream/4096/exact" in capsys.readouterr().err


def test_check_snapshot_retries_a_regressed_row(tmp_path, capsys):
    """A row under its floor is measured again through ``remeasure`` (up to
    twice); a reading that recovers passes, one that stays low fails."""
    pin = _pin(tmp_path, [{"key": "sti/1024/auto/welch", "gs": 10.0}])
    calls = []

    def recovers(key):
        calls.append(key)
        return 9.5, 0.1, {}

    ok = bench.check_snapshot([{"key": "sti/1024/auto/welch", "gs": 8.0}],
                              pin, 0.10, remeasure=recovers)
    assert ok and calls == ["sti/1024/auto/welch"]
    assert "retry 1" in capsys.readouterr().err
    calls.clear()

    def stays_low(key):
        calls.append(key)
        return 5.0, 0.2, {}

    ok = bench.check_snapshot([{"key": "sti/1024/auto/welch", "gs": 8.0}],
                              pin, 0.10, remeasure=stays_low)
    assert not ok and len(calls) == 2
    assert "REGRESSED" in capsys.readouterr().err


def test_check_snapshot_remeasures_suspect_high_rows(tmp_path, capsys):
    """A row over twice its pin is measured once more and the new reading
    used (as tests/test_cli.py holds the JAX bench)."""
    pin = _pin(tmp_path, [{"key": "sti/1024/auto/welch", "gs": 12.0}])
    calls = []

    def remeasure(key):
        calls.append(key)
        return 12.5, 0.1, {}

    ok = bench.check_snapshot([{"key": "sti/1024/auto/welch", "gs": 5000.0}],
                              pin, 0.10, remeasure=remeasure)
    err = capsys.readouterr().err
    assert ok and calls == ["sti/1024/auto/welch"]
    assert "suspect-high" in err and "12.500" in err


@pytest.mark.parametrize("change", [{"ntime": 64}, {"card": "cpu"}])
def test_check_snapshot_refuses_another_shape_or_card(tmp_path, capsys,
                                                      change):
    config = {"nint": 4, "ntime": 128, "nsub": 2,
              "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    pin = _pin(tmp_path, [{"key": "sti/4096/auto/welch", "gs": 10.0}],
               config)
    ok = bench.check_snapshot([{"key": "sti/4096/auto/welch", "gs": 10.0}],
                              pin, 0.10, config={**config, **change})
    assert not ok and "REFUSED" in capsys.readouterr().err
    assert bench.check_snapshot([{"key": "sti/4096/auto/welch", "gs": 10.0}],
                                pin, 0.10, config=config)


def test_bench_multitab_tiny():
    before = bench.read_counts()
    m = bench.bench_multitab(B=2, nfft=128, ntime=8, iters=2, device="cpu")
    assert set(m) == {"merged_ms", "solo_ms", "speedup"}
    assert m["merged_ms"] > 0 and m["solo_ms"] > 0 and m["speedup"] > 0
    assert bench.read_counts() == before


@pytest.mark.parametrize("dtype", ["i16", "c64"])
def test_bench_e2e_matches_jax(tmp_path, dtype):
    """The same capture under one cache_root (whichever bench writes it,
    the other reads it): the same windows, and the windows' median bins
    within 1e-3 dB each."""
    kw = dict(gb=0.001, nfft=512, nint=1, ntime=32, nsub=1,
              cache_root=str(tmp_path), dtype=dtype)
    _, _, want = _jax_bench().bench_e2e(**kw)
    e2e_sps, host_sps, got = bench.bench_e2e(**kw, device="cpu")
    assert e2e_sps > 0 and host_sps > 0
    assert got["windows"] == want["windows"] >= 8
    assert got["gb"] == want["gb"]
    assert abs(got["acc"] - want["acc"]) <= 1e-3 * got["windows"]


def test_bench_e2e_from_memory():
    """Without cache_root the capture is held in memory (the card's
    machine has no h5py)."""
    e2e_sps, host_sps, meta = bench.bench_e2e(
        gb=0.0005, nfft=256, nint=1, ntime=16, nsub=2, dtype="i16",
        device="cpu")
    assert e2e_sps > 0 and host_sps > 0
    assert meta["windows"] == int(0.0005 * 2 ** 30) // (4 * 2) // (256 * 16)
    assert -200.0 < meta["acc"] / meta["windows"] < 0.0


def test_main_prints_the_headline_line(capsys):
    assert bench.main(["--device", "cpu", "--nfft", "256", "--nint", "1",
                       "--ntime", "4", "--iters", "2"]) == 0
    res = _last_json(capsys)
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "p50_ms",
                        "stream_p50_ms", "card"}
    assert res["metric"] == "sti_throughput_c64_nfft256"
    assert res["card"] == "cpu" and res["unit"] == "samples/s"
    assert res["value"] > 0 and res["p50_ms"] > 0 and res["stream_p50_ms"] > 0


def test_main_trace_reports_the_busy_share(tmp_path, capsys):
    assert bench.main(["--device", "cpu", "--nfft", "256", "--nint", "1",
                       "--ntime", "4", "--iters", "2", "--trace",
                       str(tmp_path)]) == 0
    res = _last_json(capsys)
    assert Path(res["trace"]).is_file()
    assert res["device_busy_share"] == 0.0          # no device on the CPU
    assert res["traced_ms"] > 0


def test_main_display_and_e2e_lines(capsys):
    assert bench.main(["--device", "cpu", "--display", "--nfft", "256"]) == 0
    d = _last_json(capsys)
    assert d["metric"] == "display_refresh_readback_nfft256"
    assert d["tile_bytes"] < d["float_bytes"] and d["card"] == "cpu"
    assert bench.main(["--device", "cpu", "--e2e", "--e2e-gb", "0.0005",
                       "--nfft", "256", "--nint", "1", "--e2e-dtype",
                       "i16"]) == 0
    e = _last_json(capsys)
    assert e["source"] == "memory" and e["windows"] >= 1
    assert e["value"] > 0 and e["host_ingest_samples_per_s"] > 0


def test_main_snapshot_pins_config_and_check_refuses_another_card(
        tmp_path, capsys):
    pin = tmp_path / "pin.json"
    assert bench.main([*TINY, "--snapshot", str(pin)]) == 0
    snap = json.loads(pin.read_text())
    assert [r["key"] for r in snap["rows"]] == DOCUMENTED_ROWS
    assert snap["config"] == {"nint": 1, "ntime": 2, "nsub": 2,
                              "card": "cpu"}
    snap["config"]["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    pin.write_text(json.dumps(snap))
    capsys.readouterr()
    assert bench.main([*TINY, "--check", str(pin)]) == 1
    assert "REFUSED" in capsys.readouterr().err


def test_main_refuses_cuda_without_a_card(monkeypatch, capsys):
    """--device cuda (the default) without a CUDA device: a JSON error and
    rc 1, and nothing measured on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")

    def measured(*a, **k):
        raise AssertionError("the bench measured without its device")

    for name in ("bench_sti", "bench_streaming", "run_all", "bench_display",
                 "bench_e2e"):
        monkeypatch.setattr(bench, name, measured)
    before = bench.read_counts()
    for argv in ([], ["--all"], ["--e2e"], ["--device", "cuda:0"]):
        assert bench.main(argv) == 1
        assert _last_json(capsys) == {"error": NO_CUDA}
    assert bench.read_counts() == before
