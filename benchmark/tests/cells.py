"""The cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same files and limits, with a shorter capture and smaller transforms."""

from drfbench import spec


def tiny_cell(name: str) -> dict:
    cell = spec.cell(spec.load_benchmark(waiting=True), name)
    if cell["traffic"]["kind"] == "browse":
        cell["config"]["seconds"] = 3
        cell["traffic"]["view"].update(nfft=256, nint=2, ntime=16)
        cell["traffic"]["check_requests"] = 6
    else:
        cell["config"]["seconds"] = 3
        cell["traffic"]["view"].update(nfft=256, hop=128, ntime=20,
                                       stream_seconds=2.0)
        cell["traffic"]["warmup_s"] = 0.5
        cell["traffic"]["check_ticks"] = 3
    return cell


def run_tiny(name: str, seed: int = 7, seconds: float = 1.5, **kw) -> dict:
    import run as bench

    return bench.run_cell(tiny_cell(name), seed, seconds, False, "cpu",
                          bench.boot_clock(), **kw)
