"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernels B1 (STI PSD) and B2 (time-median) from
pyspectrogram_tpu_torch/csrc with nvcc, holds each against its plain torch
version on the card, drives the written-mode STI request through
StiPipeline.compute at the headline size (nfft 4096, nint 4, ntime 128, two
subchannels, welch, exact; its 33.5 MB block takes the prefetch branch), in
display-tile mode, and at the reference GUI's default (nfft 1024, nint 1,
ntime 100), checks the results, and times kernels and request with CUDA
events and the wall clock. Every phase prints one JSON line; the last line
is ``{"ok": true, "device": {...}}``. Any failed check raises, and the exit
code is then non-zero. Needs one CUDA device; imports torch, numpy and the
port only.

The capture is a seeded two-tone complex64 array served by the port's
in-memory dataset, so the request's host read, assembly and copies run as
they do for a Digital RF capture, without HDF5 files (the reader needs
h5py).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def two_tone(n: int, sample_rate: float, freqs_hz, noise_rms: float,
             seed: int):
    """(n, len(freqs_hz)) complex64: one full-scale tone per subchannel
    plus complex white noise."""
    import numpy as np

    t = np.arange(n, dtype=np.float64) / sample_rate
    x = np.stack([np.exp(2j * np.pi * f * t) for f in freqs_hz], axis=1)
    rng = np.random.default_rng(seed)
    x += noise_rms * (rng.standard_normal(x.shape)
                      + 1j * rng.standard_normal(x.shape)) / np.sqrt(2.0)
    return x.astype(np.complex64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.kernels import _build, median_cuda, sti_cuda
    from pyspectrogram_tpu_torch.models import sti
    from pyspectrogram_tpu_torch.ops import plain, stft

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "spill" in ln or "registers" in ln
             or "Function properties" in ln]
    print("\n".join(ptxas), file=sys.stderr)
    emit({"phase": "build", "seconds": build_s,
          "nvcc_seconds": _build.build_seconds, "card": card})

    # phase 2: B1 against psd_torch on the card
    rng = np.random.default_rng(0)
    b1_err = 0.0
    n_cases = 0
    for nfft in (256, 1024, 4096, 16384, 32768):
        for mode, nint in (("welch", 1), ("welch", 4), ("parity", 3)):
            for nsub in (1, 2):
                for dtype in ("float32", "int16"):
                    for contiguous in (True, False):
                        ntime = 8
                        nsamp = nfft * nint * ntime + (0 if contiguous
                                                       else 4096 + 17)
                        if dtype == "int16":
                            x = rng.integers(-2 ** 14, 2 ** 14,
                                             (2 * nsub, nsamp)).astype(np.int16)
                            ref = 2.0 ** 15.5
                        else:
                            x = rng.standard_normal(
                                (2 * nsub, nsamp)).astype(np.float32)
                            ref = 1.0
                        if contiguous:
                            st = np.arange(ntime) * nfft * nint
                        else:
                            st = rng.integers(0, nsamp - nfft * nint, ntime)
                        xd = torch.from_numpy(x).to(dev)
                        sd = torch.from_numpy(st.astype(np.int32)).to(dev)
                        kw = dict(nfft=nfft, nint=nint, mode=mode, ref=ref)
                        got = sti_cuda.sti_psd_cuda(xd, sd, **kw)
                        want = plain.psd_torch(xd, sd, **kw)
                        torch.cuda.synchronize()
                        err = (got - want).abs().max().item()
                        check(torch.allclose(got, want, rtol=2e-4, atol=1e-6),
                              f"B1 disagrees at nfft={nfft} mode={mode} "
                              f"nint={nint} nsub={nsub} {dtype} "
                              f"contiguous={contiguous}: max abs {err}")
                        b1_err = max(b1_err, err)
                        n_cases += 1
    emit({"phase": "b1_vs_plain", "cases": n_cases, "max_abs_err": b1_err,
          "rtol": 2e-4, "atol": 1e-6})

    # phase 3: B2 against its plain version and np.median, bit for bit
    b2_cases = 0
    for n in (33, 64, 100, 128, 129):
        for m in (1, 2):
            for nfft in (1024, 4096):
                p = rng.exponential(size=(n, m, nfft)).astype(np.float32)
                p[: n // 3, :, : nfft // 4] = p[n // 3, :, : nfft // 4]
                pd = torch.from_numpy(p).to(dev)
                got = median_cuda.median_over_time_cuda(pd).cpu().numpy()
                want = np.median(p, axis=0).astype(np.float32)
                check(np.array_equal(got, plain.median_bisect(pd).cpu().numpy())
                      and np.array_equal(got, want),
                      f"B2 is not bit-exact at n={n} m={m} nfft={nfft}")
                b2_cases += 1
    emit({"phase": "b2_vs_plain", "cases": b2_cases, "max_abs_err": 0.0})

    # phase 4: the main path at real size, through StiPipeline.compute
    sr = 1_000_000
    tones = [sr / 16.0, sr / 8.0]
    n_samp = 128 * 4096 * 4            # the headline request's 2,097,152
    ds = MemoryDataset(two_tone(n_samp, sr, tones, noise_rms=1e-3, seed=1),
                       sr)
    chan = ds.channels[0]
    headline = SpectrogramConfig(nfft=4096, nint=4, ntime=128, mode="welch",
                                 precision="exact")
    requests = [("headline", headline),
                ("display_tile", headline.replace(display_tile=True)),
                ("reference_default", SpectrogramConfig())]
    launches = {"sti_psd": 0, "median": 0}
    blocks = {}
    for label, cfg in requests:
        frame_len = cfg.nfft * cfg.nint
        # two subchannels: four float32 planes
        prefetch = 4 * cfg.ntime * frame_len * 4 >= sti.PREFETCH_MIN_BYTES
        pipe = sti.StiPipeline(ds, cfg, device=dev)
        sti_cuda.sti_psd_cuda.launches = 0
        median_cuda.median_over_time_cuda.launches = 0
        res = pipe.compute()
        torch.cuda.synchronize()
        n_b1 = sti_cuda.sti_psd_cuda.launches
        n_b2 = median_cuda.median_over_time_cuda.launches
        check(n_b1 > 0 and n_b2 > 0,
              f"{label}: the request launched B1 {n_b1}x and B2 {n_b2}x")
        launches["sti_psd"] += n_b1
        launches["median"] += n_b2
        # the host-assembled block through the device half alone: the
        # same kernels on the same samples, so equal bit for bit to what
        # compute() (prefetch branch or not) returned
        pm, starts, mask = sti.assemble_device_block(
            ds, chan, None, res.frame_starts, frame_len)
        blocks[label] = (cfg, pm, starts, mask, res.frame_starts)
        direct = pipe.compute_block(pm, starts, mask, cfg, 1.0,
                                    ds.sr_dict[chan], res.frame_starts)
        for f in ("sxx_dbfs", "sxx_med_dbfs", "tile", "mask"):
            check(np.array_equal(getattr(res, f), getattr(direct, f)),
                  f"{label}: compute() and compute_block differ in {f}")
        ref_res = sti.StiPipeline(ds, cfg, device="cpu").compute()
        check(np.array_equal(res.frame_starts, ref_res.frame_starts)
              and np.array_equal(res.times, ref_res.times)
              and np.array_equal(res.freqs, ref_res.freqs)
              and res.mask.all(), f"{label}: frame axes differ from the CPU run")
        med = res.sxx_med_dbfs
        check(med.shape == (cfg.nfft, 2) and np.isfinite(med).all(),
              f"{label}: median PSD of shape {med.shape}")
        peaks = []
        for s, f in enumerate(tones):
            k = int(med[:, s].argmax())
            peaks.append(float(med[k, s]))
            check(abs(res.freqs[k] - f) <= sr / cfg.nfft and abs(med[k, s])
                  <= 0.1, f"{label}: sub {s} peak {med[k, s]} dBFS at "
                          f"{res.freqs[k]} Hz, expected ~0 at {f}")
        d_med = float(np.abs(med - ref_res.sxx_med_dbfs)[
            ref_res.sxx_med_dbfs >= ref_res.sxx_med_dbfs.max(0) - 60].max())
        check(d_med <= 1e-3, f"{label}: median dB differs from the CPU run "
                             f"by {d_med}")
        line = {"phase": f"request_{label}", "nfft": cfg.nfft,
                "nint": cfg.nint, "ntime": cfg.ntime, "prefetch": prefetch,
                "peaks_dbfs": peaks, "b1_launches": n_b1,
                "b2_launches": n_b2, "max_db_diff_vs_cpu": d_med}
        if cfg.display_tile:
            check(res.sxx_dbfs is None and res.tile.dtype == np.uint8
                  and res.tile.shape[:2] == (cfg.ntime, 2),
                  f"{label}: tile of shape {res.tile.shape}")
            d = np.abs(res.tile.astype(int) - ref_res.tile.astype(int))
            check(d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size,
                  f"{label}: tile differs from the CPU run on "
                  f"{np.count_nonzero(d)} pixels, by up to {d.max()}")
            line["tile_pixels_off_by_one"] = int(np.count_nonzero(d))
        else:
            sx, rx = res.sxx_dbfs, ref_res.sxx_dbfs
            check(sx.shape == (cfg.nfft, cfg.ntime, 2)
                  and np.isfinite(sx).all(), f"{label}: sxx of {sx.shape}")
            keep = rx >= rx.max(axis=0, keepdims=True) - 60.0
            d_sxx = float(np.abs(sx - rx)[keep].max())
            check(d_sxx <= 1e-3, f"{label}: sxx_dbfs differs from the CPU "
                                 f"run by {d_sxx} dB")
            line["max_db_diff_vs_cpu"] = max(d_med, d_sxx)
            # the median is exact: np.median of the card's linear power
            fn = stft.make_sti_fn_pm(nfft=cfg.nfft, nint=cfg.nint,
                                     mode=cfg.mode, contiguous=True,
                                     return_linear=True)
            out = fn(torch.from_numpy(pm).to(dev),
                     torch.from_numpy(starts).to(dev))
            lin = out["sxx"].cpu().numpy()
            check(np.array_equal(out["sxx_med"].cpu().numpy(),
                                 np.median(lin, axis=0).astype(np.float32)),
                  f"{label}: the card's median is not np.median")
            check(np.array_equal(np.moveaxis(
                out["sxx_med_dbfs"].cpu().numpy(), -1, 0), med),
                f"{label}: the request's median differs from a rerun")
        emit(line)

    # phase 5: the kernels against their plain versions on the main path's
    # own tensors, then timing: CUDA events for device work, the wall
    # clock for whole requests
    def event_ms(fn, iters=50, warm=5):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def in_turns(plain_fn, kernel_fn):
        """plain, kernel, kernel, plain on one card: (kernel, plain) ms."""
        t = [event_ms(plain_fn), event_ms(kernel_fn), event_ms(kernel_fn),
             event_ms(plain_fn)]
        return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2

    def wall_ms(fn, n=100, warm=5):
        walls = []
        for i in range(n + warm):
            t0 = time.perf_counter()
            fn()
            if i >= warm:
                walls.append(time.perf_counter() - t0)
        return [float(v) for v in np.percentile(walls, [50, 90]) * 1e3]

    timing = {}
    for label in ("headline", "reference_default"):
        cfg, pm, starts, mask, n_st = blocks[label]
        xd = torch.from_numpy(pm).to(dev)
        sd = torch.from_numpy(starts).to(dev)
        psd_kw = dict(nfft=cfg.nfft, nint=cfg.nint, mode=cfg.mode)
        n_proc = cfg.nfft * cfg.nint * cfg.ntime * 2
        p = sti_cuda.sti_psd_cuda(xd, sd, **psd_kw)
        p_plain = plain.psd_torch(xd, sd, **psd_kw)
        err = (p - p_plain).abs().max().item()
        check(torch.allclose(p, p_plain, rtol=2e-4, atol=1e-6),
              f"{label}: B1 disagrees with psd_torch by {err}")
        b1_err = max(b1_err, err)
        check(torch.equal(median_cuda.median_over_time_cuda(p),
                          plain.median_bisect(p)),
              f"{label}: B2 is not bit-exact against median_bisect")
        b1_ms, b1_plain_ms = in_turns(
            lambda: plain.psd_torch(xd, sd, **psd_kw),
            lambda: sti_cuda.sti_psd_cuda(xd, sd, **psd_kw))
        b2_ms, b2_plain_ms = in_turns(
            lambda: plain.median_bisect(p),
            lambda: median_cuda.median_over_time_cuda(p))
        fn = stft.make_sti_fn_pm(nfft=cfg.nfft, nint=cfg.nint,
                                 mode=cfg.mode, contiguous=True)
        program_ms = event_ms(lambda: fn(xd, sd))
        pinned = torch.from_numpy(pm).pin_memory()
        h2d_ms = event_ms(lambda: xd.copy_(pinned, non_blocking=True),
                          iters=20)
        frame_len = cfg.nfft * cfg.nint
        asm_ms = wall_ms(lambda: sti.assemble_device_block(
            ds, chan, None, n_st, frame_len), n=10, warm=1)
        pipe = sti.StiPipeline(ds, cfg, device=dev)
        block_ms = wall_ms(lambda: pipe.compute_block(
            pm, starts, mask, cfg, 1.0, ds.sr_dict[chan], n_st))
        req_ms = wall_ms(pipe.compute)
        timing[label] = dict(b1_ms=b1_ms, b1_plain_ms=b1_plain_ms,
                             b2_ms=b2_ms, b2_plain_ms=b2_plain_ms)
        emit({"phase": f"timing_{label}", "card": card,
              "nfft": cfg.nfft, "nint": cfg.nint, "ntime": cfg.ntime,
              "nsub": 2, "samples_per_request": n_proc,
              "b1_max_abs_err": err,
              "b1_ms": b1_ms, "b1_plain_ms": b1_plain_ms,
              "b1_samples_per_s": n_proc / (b1_ms * 1e-3),
              "b1_plain_samples_per_s": n_proc / (b1_plain_ms * 1e-3),
              "b2_ms": b2_ms, "b2_plain_ms": b2_plain_ms,
              "device_program_ms": program_ms,
              "device_program_samples_per_s": n_proc / (program_ms * 1e-3),
              "h2d_ms": h2d_ms, "h2d_bytes": pm.nbytes,
              "host_assemble_ms_p50": asm_ms[0],
              "compute_block_p50_ms": block_ms[0],
              "compute_block_p90_ms": block_ms[1],
              "request_n": 100, "request_p50_ms": req_ms[0],
              "request_p90_ms": req_ms[1],
              "request_samples_per_s": n_proc / (req_ms[0] * 1e-3)})

    # B1's four-step split at nfft 32768, on a block of the headline's size
    nfft, nint, ntime = 32768, 4, 16
    x = rng.standard_normal((4, nfft * nint * ntime)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
    psd_kw = dict(nfft=nfft, nint=nint, mode="welch")
    err = (sti_cuda.sti_psd_cuda(xd, sd, **psd_kw)
           - plain.psd_torch(xd, sd, **psd_kw)).abs().max().item()
    b1_big_ms, b1_big_plain_ms = in_turns(
        lambda: plain.psd_torch(xd, sd, **psd_kw),
        lambda: sti_cuda.sti_psd_cuda(xd, sd, **psd_kw))
    emit({"phase": "timing_b1_nfft32768", "card": card, "nfft": nfft,
          "nint": nint, "ntime": ntime, "nsub": 2, "b1_max_abs_err": err,
          "b1_ms": b1_big_ms, "b1_plain_ms": b1_big_plain_ms})

    head = timing["headline"]
    emit({"kernels": [
        {"name": "sti_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/sti_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:409",
         "launches": launches["sti_psd"], "max_abs_err": b1_err,
         "ms": head["b1_ms"], "plain_ms": head["b1_plain_ms"]},
        {"name": "median", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/median.cu",
         "replaces": "pyspectrogram_tpu/kernels/median_pallas.py:77",
         "launches": launches["median"], "max_abs_err": 0.0,
         "ms": head["b2_ms"], "plain_ms": head["b2_plain_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
