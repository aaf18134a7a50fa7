"""The harness end to end on the CPU at a small size: files found by
name, the result line, the refusal without a card, and the check: sound
runs pass it, the control (the reference in bfloat16 in the program's
place) and every planted fault fail it."""

import json
import shutil
import subprocess
import sys

import pytest

from cells import run_tiny
from drfbench import faults, spec

CELLS = ("browse.headline", "live.tick30s")


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    and BENCHMARK.json entries, with no edit to the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark(waiting=True)
    conf = json.loads((spec.ROOT / bench["configs"][0]["file"]).read_text())
    conf["name"] = "drf_10msps_c64_1sub"
    conf["sample_rate"], conf["num_subchannels"] = 10_000_000, 1
    conf["signal"]["tones"] = conf["signal"]["tones"][:1]
    (root / "benchmark/configs/drf_10msps_c64_1sub.json").write_text(
        json.dumps(conf))
    traffic = json.loads(
        (spec.BENCH_DIR / "traffic/browse.headline.json").read_text())
    traffic["view"]["display_tile"] = True
    traffic["limits"] = {"frame_start_errors": 0, "tile_level_gap": 1,
                         "median_db_gap": 0.1}
    (root / "benchmark/traffic/browse.tiles.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/metrics/requests.count.py").write_text(
        "def read(run):\n    return len(run.latencies.get('request', []))\n")
    bench["configs"].append({
        "name": "drf_10msps_c64_1sub", "source": "https://example.org/x",
        "file": "benchmark/configs/drf_10msps_c64_1sub.json",
        "reduced": [], "why": "a test"})
    bench["workloads"].append({
        "name": "browse.tiles", "config": "drf_10msps_c64_1sub",
        "traffic": "browse.tiles", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "browse.headline" in m.get("workloads", []):
            m["workloads"].append("browse.tiles")
    bench["per_layer"].append({
        "name": "requests.count", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "host read and assembly",
        "moves": "request_ms_p50", "workloads": ["browse.tiles"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got = spec.cell(spec.load_benchmark(root), "browse.tiles", root=root,
                    bench_dir=root / "benchmark")
    assert got["config"]["sample_rate"] == 10_000_000
    assert got["traffic"]["view"]["display_tile"] is True
    assert sorted(m["name"] for m in got["end_to_end"]) == [
        "request_ms_p50", "setup_s"]
    assert [m["name"] for m in got["per_layer"]] == ["requests.count"]
    read = spec.metric_reader("requests.count", root / "benchmark")

    class Run:
        latencies = {"request": [0.1, 0.2, 0.3]}

    assert read(Run()) == 3
    # a traffic kind that needs code of its own is a file too
    (root / "benchmark/drfbench/mtab.py").write_text(
        "class Driver:\n    kind = 'request'\n")
    assert spec.traffic_driver("mtab", root / "benchmark").kind == "request"
    with pytest.raises(spec.SpecError):
        spec.traffic_driver("nowhere", root / "benchmark")
    # the cells already there are unchanged
    old = spec.cell(spec.load_benchmark(root), "browse.headline", root=root,
                    bench_dir=root / "benchmark")
    assert "requests.count" not in [m["name"] for m in old["per_layer"]]


def test_waiting_cells_run_by_name_and_leave_the_benchmark_as_it_is():
    """A cell written out under benchmark/waiting/ is found by name; the
    merge adds only its entries."""
    own = spec.load_benchmark()
    merged = spec.load_benchmark(waiting=True)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert merged[key][:len(own[key])] == own[key]
    cell = spec.cell(merged, "browse.headline")
    assert cell["traffic"]["kind"] == "browse"
    assert sorted(m["name"] for m in cell["end_to_end"]) == [
        "request_ms_p50", "setup_s"]
    for w in own["workloads"]:
        assert spec.cell(merged, w["name"]) == spec.cell(own, w["name"])


def test_every_metric_has_a_reader():
    from drfbench.browse import Browse
    from drfbench.live import Live

    assert spec.traffic_driver("browse") is Browse
    assert spec.traffic_driver("live") is Live
    bench = spec.load_benchmark(waiting=True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]


def test_without_a_card_no_result():
    """The harness refuses to run without a CUDA card: a non-zero exit
    and nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         "browse.headline", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder alone: a
    non-zero exit and nothing on standard output."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "browse.headline",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_its_line_has_the_contracts_keys(name):
    import run as bench

    out = run_tiny(name)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    line = json.loads(bench.result_line(out))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    cell = spec.cell(spec.load_benchmark(waiting=True), name)
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(line["checks"]) == set(cell["traffic"]["limits"])
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_its_per_layer_metrics(name):
    import run as bench

    out = bench.run_cell(__import__("cells").tiny_cell(name), 11, 1.0, True,
                         "cpu", bench.boot_clock())
    line = json.loads(bench.result_line(out))
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    # without a device trace the roofline finds nothing to read; the
    # host spans and the idle share still read
    assert not any("roofline" in k for k in line["metrics"])
    assert any(k.endswith("_ms.request") or k.endswith("_ms.tick")
               for k in line["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    """The reference in bfloat16, in the program's place, fails at least
    one number at the cell's limits."""
    out = run_tiny(name, seed=21, control=True)
    assert out["correct"] is True, out["checks"]
    assert out["control"]["correct"] is False, out["control"]["checks"]


def _faults_of_cells():
    bench = spec.load_benchmark(waiting=True)
    for name in CELLS:
        kind = spec.cell(bench, name)["traffic"]["kind"]
        for fault in spec.traffic_driver(kind).FAULTS:
            yield name, kind, fault


@pytest.mark.parametrize("name, kind, fault", list(_faults_of_cells()))
def test_planted_fault_fails_the_check(name, kind, fault):
    with faults.plant(kind, fault):
        # a stale tick's lag grows with the window: 3 s of it
        out = run_tiny(name, seed=31, seconds=3.0)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    """A short run of each cell on the card, through the command the
    driver runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str((1 << 31) + 17), "--seconds", "3", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
