"""BENCHMARK.json and the files it names, found by name.

A configuration is ``configs[].file``; a traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver
``benchmark/drfbench/<kind>.py`` (its class ``Driver``); a metric is the
reader ``benchmark/metrics/<metric>.py``. Adding any of them needs new
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

#: the checkout's root (BENCHMARK.json) and the benchmark's folder
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


#: a name of BENCHMARK.json, and so of a file found by it
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


def load_benchmark(root: Path = ROOT, waiting: bool = False) -> dict:
    """BENCHMARK.json; with ``waiting``, also the entries of the cells
    written out under ``benchmark/waiting/`` that BENCHMARK.json does not
    hold yet (a cell whose bounds this host cannot hold), so that they
    run by name as its own cells do."""
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no {path}")
    bench = json.loads(path.read_text())
    if waiting:
        for extra in sorted((Path(root) / "benchmark" / "waiting").glob(
                "*.json")):
            for key, entries in json.loads(extra.read_text()).items():
                have = {e["name"] for e in bench[key]}
                bench[key] += [e for e in entries if e["name"] not in have]
    return bench


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, workload: str, root: Path = ROOT,
         bench_dir: Path = BENCH_DIR) -> dict:
    """The cell ``workload``: its entry, configuration, traffic mix and
    the metrics it reports (end-to-end and per-layer)."""
    w = _by_name(bench["workloads"], workload, "workload")
    conf_entry = _by_name(bench["configs"], w["config"], "config")
    config = json.loads((Path(root) / conf_entry["file"]).read_text())
    traffic_path = Path(bench_dir) / "traffic" / f"{w['traffic']}.json"
    if not traffic_path.is_file():
        raise SpecError(f"no traffic file {traffic_path}")
    traffic = json.loads(traffic_path.read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"workload": w, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer}


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _module(path: Path, prefix: str, name: str, what: str):
    if not NAME.fullmatch(name) or not path.is_file():
        raise SpecError(f"no {what} {path}")
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of ``benchmark/metrics/<name>.py``."""
    return _module(Path(bench_dir) / "metrics" / f"{name}.py",
                   "drfbench_metric_", name, "metric reader").read


def traffic_driver(kind: str, bench_dir: Path = BENCH_DIR):
    """The class ``Driver`` of ``benchmark/drfbench/<kind>.py``: the code
    that runs a traffic mix of that kind."""
    path = Path(bench_dir) / "drfbench" / f"{kind}.py"
    own = Path(__file__).resolve().parent
    if NAME.fullmatch(kind) and path.is_file() and path.resolve().parent == own:
        # this package's own module, so that a patch of it applies
        return importlib.import_module(f"drfbench.{kind}").Driver
    return _module(path, "drfbench_kind_", kind, "traffic kind").Driver
