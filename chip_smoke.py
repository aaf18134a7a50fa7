"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernels B1 (STI PSD), B2 (time-median), B3 (overlap-hop streaming
push) and B4 (STI PSD at nfft >= 65536) from pyspectrogram_tpu_torch/csrc
with nvcc, holds each against its plain torch version on the card, and
drives the port's paths on the card, checking what comes out:

- the written-mode STI request through StiPipeline.compute at the headline
  size (nfft 4096, nint 4, ntime 128, two subchannels, welch, exact; its
  33.5 MB block takes the prefetch branch), in display-tile mode, at the
  reference GUI's default (nfft 1024, nint 1, ntime 100), and at nfft
  65536 and 2^20 (kernel B4);
- StreamingSti at the JAX bench's streaming shapes (nfft 4096, nsub 2,
  8 columns per push, ring 256: exact, display, hop 2048);
- LiveStreamEngine at full width (a 30 s window of a 1 MS/s two-channel
  capture that grows between ticks: a 480 MB ring on the card), its
  checkpoint and resume, and at nfft 2^20;
- the multi-tab runtime: B2 over a batch of requests against its plain
  version and against solo launches; the JAX bench's mtab/7/display
  (seven display-tile tabs merged by SharedRefreshScheduler into one
  BatchedStiPipeline launch, each tab bit-equal to its solo request, with
  a torch.profiler trace of one cycle); three merged headline tabs (mixed
  dtypes and dBFS references) and the head-of-line wait behind them; a
  threaded written SpectrogramProcessor; and N = 1, 3, 7 streaming
  processors on their own threads over one capture a writer thread grows;
- the port's entry points: the pstpu-torch commands (sti at the headline
  shape with its .npz and session, resume, psd, sti-batch over three
  captures, stream with and without --hop 2048, watch at the 30 s window,
  sti at nfft 65536) through ``build_parser()``, and the viewer's
  MainWindow on the headless widget kit (a written tab at the reference
  default, a live tab at the 30 s window), its plots recorded;
- filter_signal over a 30 s, 1 MS/s two-tone capture (58,592 frames of
  nfft 1024) against the same call on the CPU, and regenerate_signal;

then times kernels, pushes, ticks and requests with CUDA events and the
wall clock. Every phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the exit
code is then non-zero. Needs one CUDA device; imports torch, numpy and the
port only.

The captures are seeded two-tone complex64 arrays served by the port's
in-memory dataset, so the host reads, assembly and copies run as they do
for a Digital RF capture, without HDF5 files (the reader needs h5py).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: linear-power tolerance of a kernel against its plain version (the JAX
#: package's own kernel-vs-XLA tolerance)
LIN = dict(rtol=2e-4, atol=1e-6)
#: B4 against its plain version: at nfft 2^20 a white-noise bin's power is
#: ~1/nfft, so an absolute floor bounds nothing; the relative tolerance the
#: JAX package holds its own big kernel to, plus 1e-4 of the column's mean
B4_RTOL, B4_MEAN_ATOL = 2e-3, 1e-4
#: display colour range of the streaming tiles (dBFS): full-scale tones and
#: their sidelobes, with the floor above the captures' noise
COLOR_RANGE_DB = (-80.0, 0.0)


def live_samples(sr: int) -> int:
    """Samples of the live engine's capture at ``sr``: 31 s to start with
    (a 30 s window plus one), then 5.5 s of appends and two 2^20-sample
    blocks (rounded up to whole 16-sample tone periods)."""
    return 31 * sr + 6 * sr + 2 * (1 << 20)


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


def long_two_tone(n: int, noise_rms: float, seed: int):
    """two_tone's tones at sample_rate/16 and /8 (each a 16-sample period,
    tiled) plus float32 white noise: (n, 2) complex64 for n a multiple of
    16, made fast enough for tens of seconds at 1 MS/s."""
    import numpy as np

    k = np.arange(16)
    period = np.stack([np.exp(2j * np.pi * k / 16), np.exp(2j * np.pi * k / 8)],
                      axis=1).astype(np.complex64)
    x = np.tile(period, (n // 16, 1))
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((n, 2, 2), dtype=np.float32)
    noise *= np.float32(noise_rms / np.sqrt(2.0))
    x += noise.view(np.complex64)[..., 0]
    return x


def event_ms(fn, iters=50, warm=5):
    """Mean device ms per call over ``iters`` calls, by CUDA events."""
    import torch

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


def in_turns(plain_fn, kernel_fn, iters=50):
    """plain, kernel, kernel, plain on one card: (kernel, plain) ms."""
    t = [event_ms(plain_fn, iters), event_ms(kernel_fn, iters),
         event_ms(kernel_fn, iters), event_ms(plain_fn, iters)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def wall_ms(fn, n=100, warm=5):
    """(p50, p90) wall ms per call."""
    import numpy as np

    walls = []
    for i in range(n + warm):
        t0 = time.perf_counter()
        fn()
        if i >= warm:
            walls.append(time.perf_counter() - t0)
    return [float(v) for v in np.percentile(walls, [50, 90]) * 1e3]


def _wrappers():
    from pyspectrogram_tpu_torch.kernels import (
        big_cuda,
        median_cuda,
        stream_cuda,
        sti_cuda,
    )

    return {"sti_psd": sti_cuda.sti_psd_cuda,
            "median": median_cuda.median_over_time_cuda,
            "stream_psd": stream_cuda.stream_psd_cuda,
            "big_psd": big_cuda.big_psd_cuda}


def reset_counts() -> None:
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["median"].batched_launches = 0


def read_counts() -> dict:
    """Launches per kernel, plus B2's launches over a batch of requests
    (``median_batched``, also counted in ``median``)."""
    counts = {k: fn.launches for k, fn in _wrappers().items()}
    counts["median_batched"] = _wrappers()["median"].batched_launches
    return counts


def add_counts(total: dict, run: dict) -> None:
    for k, v in run.items():
        total[k] += v


def db_diff(got, want, floor_db=60.0, axis=-1):
    """Largest dB difference on bins within ``floor_db`` of their column's
    peak (``axis`` the frequency axis)."""
    import numpy as np

    keep = want >= want.max(axis=axis, keepdims=True) - floor_db
    return float(np.abs(got - want)[keep].max())


def check_tiles(got, want, what: str) -> int:
    """Two uint8 tiles within one level on <= 0.1% of pixels; returns the
    pixels that differ."""
    import numpy as np

    check(got.shape == want.shape, f"{what}: tiles of {got.shape} and "
                                   f"{want.shape}")
    d = np.abs(got.astype(int) - want.astype(int))
    n = int(np.count_nonzero(d))
    check(d.max() <= 1 and n <= 1e-3 * got.size,
          f"{what}: tiles differ on {n} pixels, by up to {d.max()}")
    return n


def phase_b3(dev, gen):
    """B3 against psd_torch at starts t*hop on seeded normal planes."""
    import torch

    from pyspectrogram_tpu_torch.kernels import stream_cuda
    from pyspectrogram_tpu_torch.ops import plain

    err, cases = 0.0, 0
    for nfft in (1024, 4096, 16384, 32768):
        for hop in (nfft // 2, nfft // 4, 3 * nfft // 8 + 12):
            for mode, nint in (("welch", 1), ("welch", 2), ("parity", 2)):
                for nsub in (1, 2):
                    for k in (1, 5, 32):
                        width = nfft * nint - hop + k * hop
                        x = torch.randn((2 * nsub, width), generator=gen,
                                        device=dev)
                        kw = dict(nfft=nfft, nint=nint, mode=mode)
                        got = stream_cuda.stream_psd_cuda(x, hop=hop, **kw)
                        starts = torch.arange(k, dtype=torch.int32,
                                              device=dev) * hop
                        want = plain.psd_torch(x, starts, **kw)
                        torch.cuda.synchronize()
                        e = (got - want).abs().max().item()
                        check(torch.allclose(got, want, **LIN),
                              f"B3 disagrees at nfft={nfft} hop={hop} "
                              f"mode={mode} nint={nint} nsub={nsub} k={k}: "
                              f"max abs {e}")
                        err = max(err, e)
                        cases += 1
    emit({"phase": "b3_vs_plain", "cases": cases, "max_abs_err": err, **LIN})
    return err


def b4_errors(got, want):
    """(max abs error, max relative error, max error over the tolerance)
    of B4's power against the plain version's."""
    d = (got - want).abs()
    lim = B4_RTOL * want.abs() + B4_MEAN_ATOL * want.mean(dim=-1,
                                                           keepdim=True)
    pos = want > 0
    return (d.max().item(), (d[pos] / want[pos]).max().item(),
            (d / lim).max().item())


def phase_b4(dev, gen):
    """B4 against psd_torch over its sizes, modes, dtypes and starts."""
    import torch

    from pyspectrogram_tpu_torch.kernels import big_cuda
    from pyspectrogram_tpu_torch.ops import plain

    err = rel = 0.0
    cases = 0
    for nfft in (1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
        for mode, nint in (("welch", 1), ("welch", 2), ("parity", 2)):
            for nsub in (1, 2):
                for dtype in ("float32", "int16"):
                    for contiguous in (True, False):
                        ntime = 2 + cases % 3
                        frame_len = nfft * nint
                        nsamp = frame_len * ntime + (0 if contiguous
                                                     else 4096 + 17)
                        if dtype == "int16":
                            x = torch.randint(-2 ** 14, 2 ** 14,
                                              (2 * nsub, nsamp),
                                              generator=gen, device=dev,
                                              dtype=torch.int16)
                            ref = 2.0 ** 15.5
                        else:
                            x = torch.randn((2 * nsub, nsamp), generator=gen,
                                            device=dev)
                            ref = 1.0
                        if contiguous:
                            starts = torch.arange(ntime, device=dev) * frame_len
                        else:
                            starts = torch.randint(0, nsamp - frame_len,
                                                   (ntime,), generator=gen,
                                                   device=dev)
                        starts = starts.to(torch.int32)
                        kw = dict(nfft=nfft, nint=nint, mode=mode, ref=ref)
                        got = big_cuda.big_psd_cuda(x, starts, **kw)
                        want = plain.psd_torch(x, starts, **kw)
                        torch.cuda.synchronize()
                        e, r, over = b4_errors(got, want)
                        check(over <= 1.0,
                              f"B4 disagrees at nfft={nfft} mode={mode} "
                              f"nint={nint} nsub={nsub} {dtype} "
                              f"contiguous={contiguous}: max rel {r}, "
                              f"{over} x the tolerance")
                        err, rel = max(err, e), max(rel, r)
                        cases += 1
    emit({"phase": "b4_vs_plain", "cases": cases, "max_abs_err": err,
          "max_rel_err": rel, "rtol": B4_RTOL,
          "atol_of_column_mean": B4_MEAN_ATOL})
    return err


def phase_big_requests(dev, ds, tones, launches):
    """The written request at nfft 65536 and 2^20 through
    StiPipeline.compute (prefetch branch, kernel B4)."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.models import sti
    from pyspectrogram_tpu_torch.ops import stft

    chan = ds.channels[0]
    sr = float(ds.sr_dict[chan])
    for cfg in (SpectrogramConfig(nfft=1 << 16, nint=4, ntime=32),
                SpectrogramConfig(nfft=1 << 20, nint=1, ntime=16)):
        label = f"request_nfft{cfg.nfft}"
        frame_len = cfg.nfft * cfg.nint
        prefetch = 4 * cfg.ntime * frame_len * 4 >= sti.PREFETCH_MIN_BYTES
        check(prefetch, f"{label}: expected the prefetch branch")
        pipe = sti.StiPipeline(ds, cfg, device=dev)
        reset_counts()
        res = pipe.compute()
        torch.cuda.synchronize()
        run = read_counts()
        check(run["big_psd"] > 0, f"{label}: B4 launched {run['big_psd']}x")
        add_counts(launches, run)
        med = res.sxx_med_dbfs
        check(med.shape == (cfg.nfft, 2) and np.isfinite(med).all()
              and res.mask.all(), f"{label}: median PSD of {med.shape}")
        peaks = []
        for s, f in enumerate(tones):
            k = int(med[:, s].argmax())
            peaks.append(float(med[k, s]))
            check(abs(res.freqs[k] - f) <= sr / cfg.nfft
                  and abs(med[k, s]) <= 0.1,
                  f"{label}: sub {s} peak {med[k, s]} dBFS at "
                  f"{res.freqs[k]} Hz, expected ~0 at {f}")
        # the median is exact: np.median of the card's linear power
        pm, starts, _ = sti.assemble_device_block(ds, chan, None,
                                                  res.frame_starts, frame_len)
        fn = stft.make_sti_fn_pm(nfft=cfg.nfft, nint=cfg.nint, mode=cfg.mode,
                                 contiguous=True, return_linear=True)
        out = fn(torch.from_numpy(pm).to(dev), torch.from_numpy(starts).to(dev))
        lin = out["sxx"].cpu().numpy()
        check(np.array_equal(out["sxx_med"].cpu().numpy(),
                             np.median(lin, axis=0).astype(np.float32)),
              f"{label}: the card's median is not np.median")
        check(np.array_equal(np.moveaxis(out["sxx_med_dbfs"].cpu().numpy(),
                                         -1, 0), med),
              f"{label}: the request's median differs from a rerun")
        ref = sti.StiPipeline(ds, cfg, device="cpu").compute()
        check(np.array_equal(res.frame_starts, ref.frame_starts),
              f"{label}: frame starts differ from the CPU run")
        d = max(db_diff(med, ref.sxx_med_dbfs, axis=0),
                db_diff(res.sxx_dbfs, ref.sxx_dbfs, axis=0))
        check(d <= 1e-3, f"{label}: dB differs from the CPU run by {d}")
        emit({"phase": label, "nfft": cfg.nfft, "nint": cfg.nint,
              "ntime": cfg.ntime, "prefetch": prefetch, "peaks_dbfs": peaks,
              "launches": run, "max_db_diff_vs_cpu": d})


def phase_streaming(dev, card, x, sr):
    """StreamingSti at the JAX bench's streaming shapes (bench.py:133-185),
    against the same pushes on the CPU; then the push timings. Returns
    (launch counts of the runs, B3 ms and plain ms on the overlap2048
    push buffer, B3's error there)."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch.display.tile import make_tile_spec
    from pyspectrogram_tpu_torch.kernels import stream_cuda
    from pyspectrogram_tpu_torch.models.streaming import StreamingSti
    from pyspectrogram_tpu_torch.ops import plain, stft

    nfft, nsub, k = 4096, 2, 8
    # the colour floor sits above the -96 dB noise floor, where two
    # float32 FFTs (the card's, the CPU's) differ by ~1e-3 dB and would
    # flip levels at random; the tones' peaks and sidelobes quantize
    spec = make_tile_spec(stft.shifted_freqs(nfft, sr), (-500.0, 500.0),
                          COLOR_RANGE_DB)
    pm = np.ascontiguousarray(x.view(np.float32).T)     # (4, n) planes
    total = {k_: 0 for k_ in read_counts()}
    runs = [("exact", None, 256, "exact"), ("display", None, 256, "display"),
            ("overlap2048", 2048, 256, "exact"),
            ("overlap2048_scatter", 2048, 252, "exact")]
    timing = {}
    for label, hop, ring_len, precision in runs:
        block_len = k * (hop or nfft)
        n_push = ring_len // k + 8                      # wraps the ring
        blocks = [pm[:, i * block_len:(i + 1) * block_len]
                  for i in range(n_push)]
        kw = dict(nfft=nfft, nint=1, nsub=nsub, block_len=block_len, hop=hop,
                  ring_len=ring_len, precision=precision)
        s = StreamingSti(device=dev, **kw)
        sc = StreamingSti(device="cpu", **kw)
        dev_blocks = [torch.from_numpy(b).to(dev) for b in blocks]
        reset_counts()
        st = s.init_state()
        for b in dev_blocks:
            st, _ = s.push(st, b, return_db=False)
        snap, n_valid = s.snapshot(st)
        tile, _ = s.snapshot_quantized(st, spec)
        med = s.median_psd(st)
        view, vmed = s.refresh_view(st, 32, 7, spec=spec, n_med=200)
        torch.cuda.synchronize()
        run = read_counts()
        want_kernel = "sti_psd" if hop is None else "stream_psd"
        check(run[want_kernel] > 0 and run["median"] > 0,
              f"stream {label}: launches {run}")
        add_counts(total, run)
        stc = sc.init_state()
        for b in blocks:
            stc, _ = sc.push(stc, torch.from_numpy(b), return_db=False)
        check(st.total_cols == stc.total_cols == n_push * k
              and n_valid == ring_len, f"stream {label}: counters")
        d = max(db_diff(snap, sc.snapshot(stc)[0]),
                db_diff(med, sc.median_psd(stc)),
                db_diff(vmed, sc.refresh_view(stc, 32, 7, spec=spec,
                                              n_med=200)[1]))
        check(d <= 1e-3, f"stream {label}: dB differs from the CPU run by {d}")
        n_off = check_tiles(tile, sc.snapshot_quantized(stc, spec)[0],
                            f"stream {label} snapshot")
        n_off += check_tiles(view, sc.refresh_view(stc, 32, 7, spec=spec,
                                                   n_med=200)[0],
                             f"stream {label} refresh view")
        ring = st.ring.cpu().numpy()
        check(np.array_equal(stft.median_over_time(st.ring).cpu().numpy(),
                             np.median(ring, axis=0).astype(np.float32)),
              f"stream {label}: the ring's median is not np.median")
        line = {"phase": f"stream_{label}", "nfft": nfft, "nsub": nsub,
                "cols_per_block": k, "hop": hop or nfft,
                "ring_len": ring_len, "pushes": n_push, "launches": run,
                "max_db_diff_vs_cpu": d, "tile_pixels_off_by_one": n_off}
        if ring_len == 256:
            # push time: CUDA events around each of 300 pushes, warm
            blk = dev_blocks[0]
            for _ in range(20):
                st, _ = s.push(st, blk, return_db=False)
            evs = [(torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True)) for _ in range(300)]
            t0 = time.perf_counter()
            for a, b in evs:
                a.record()
                st, _ = s.push(st, blk, return_db=False)
                b.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / len(evs) * 1e3
            ms = np.array([a.elapsed_time(b) for a, b in evs])
            p50 = float(np.percentile(ms, 50))
            line.update(card=card, push_n=len(evs), push_p50_ms=p50,
                        push_p90_ms=float(np.percentile(ms, 90)),
                        push_wall_mean_ms=wall,
                        push_samples_per_s=block_len * nsub / (p50 * 1e-3))
            timing[label] = p50
        emit(line)
    # B3 against psd_torch on the overlap2048 push buffer (carry + block)
    buf = torch.from_numpy(pm[:, :2048 + k * 2048].copy()).to(dev)
    starts = torch.arange(k, dtype=torch.int32, device=dev) * 2048
    got = stream_cuda.stream_psd_cuda(buf, nfft=nfft, hop=2048)
    want = plain.psd_torch(buf, starts, nfft=nfft)
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, **LIN), f"B3 on the push buffer: {err}")
    b3_ms, b3_plain_ms = in_turns(
        lambda: plain.psd_torch(buf, starts, nfft=nfft),
        lambda: stream_cuda.stream_psd_cuda(buf, nfft=nfft, hop=2048),
        iters=200)
    emit({"phase": "timing_b3_overlap2048", "card": card, "nfft": nfft,
          "hop": 2048, "k": k, "nsub": nsub, "b3_max_abs_err": err,
          "b3_ms": b3_ms, "b3_plain_ms": b3_plain_ms})
    return total, b3_ms, b3_plain_ms, err


def phase_live(dev, card, x, sr):
    """LiveStreamEngine at full width over an in-memory capture that grows
    from the first 31 s of ``x`` (two tones at ``sr``):
    cold start, ticks after appends, exact median, checkpoint + resume bit
    for bit, tick timing; the same at nfft 2^20 (B4); and the engine on
    the CPU at a 1 s window as the reference. Returns the launch counts
    and (B2's ms, its plain version's ms, the window's shape)."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.kernels import median_cuda
    from pyspectrogram_tpu_torch.ops import plain, stft
    from pyspectrogram_tpu_torch.ops.plain import to_dbfs
    from pyspectrogram_tpu_torch.runtime import LiveStreamEngine

    tones = [sr / 16.0, sr / 8.0]
    big = 1 << 20
    n0 = 31 * sr
    pos = n0
    ds = MemoryDataset(x[:n0], sr)
    cfg = SpectrogramConfig(nfft=4096, hop=2048, ntime=100,
                            stream_seconds=30.0, display_tile=True,
                            color_range_db=COLOR_RANGE_DB, streaming=True)
    total = {k: 0 for k in read_counts()}

    def grow(n):
        nonlocal pos
        ds.append(x[pos:pos + n])
        pos += n
        ds.bnds_update()

    def check_peaks(res, label):
        med = res.sxx_med_dbfs
        for s, f in enumerate(tones):
            k = int(med[:, s].argmax())
            check(abs(res.freqs[k] - f) <= sr / len(res.freqs)
                  and abs(med[k, s]) <= 0.1,
                  f"{label}: sub {s} peak {med[k, s]} dBFS at "
                  f"{res.freqs[k]} Hz")
        check(res.mask.all() and res.tile.dtype == np.uint8
              and res.tile.shape[1] == 2, f"{label}: mask/tile")
        return [float(med[:, s].max()) for s in range(2)]

    reset_counts()
    t0 = time.perf_counter()
    eng = LiveStreamEngine(ds, cfg, dev)
    res = eng.tick(cfg)
    cold_s = time.perf_counter() - t0
    ring_len = eng.sti.ring_len
    ring_bytes = eng.state.ring.numel() * 4
    # at 1 MS/s: 14,649 columns of hop 2048 in 30 s, 32 per push, a
    # 14,656-row ring of 2 x 4096 float32 bins (480 MB)
    W = -(-30 * sr // 2048)
    check((eng.window_cols, eng.cols_per_block, ring_len)
          == (W, 32, -(-W // 32) * 32) and ring_bytes == ring_len * 2 * 4096 * 4,
          f"live geometry {eng.window_cols}, {eng.cols_per_block}, "
          f"{ring_len}")
    check_peaks(res, "live cold start")
    reads = []
    for _ in range(3):
        read0, next0 = eng.samples_read, eng.next_sample
        grow(sr)
        res = eng.tick(cfg)
        # O(delta): every sample read is pushed once, and the cursor
        # stops within one block of the data's end
        check(eng.samples_read - read0 == eng.next_sample - next0
              and 0 <= pos - eng.next_sample < eng.block_len,
              f"live tick read {eng.samples_read - read0} samples")
        reads.append(eng.samples_read - read0)
    peaks = check_peaks(res, "live tick")
    torch.cuda.synchronize()
    run = read_counts()
    check(run["stream_psd"] > 0 and run["median"] > 0,
          f"live engine launches {run}")
    add_counts(total, run)
    # the tick's median is exact: np.median of the read-back window
    rows = torch.from_numpy((eng.state.total_cols - W + np.arange(W))
                            % ring_len).to(dev)
    window = eng.state.ring.index_select(0, rows)
    med_lin = stft.median_over_time(window)
    check(np.array_equal(med_lin.cpu().numpy(),
                         np.median(window.cpu().numpy(), axis=0)
                         .astype(np.float32)),
          "live: the window's median is not np.median")
    check(np.array_equal(res.sxx_med_dbfs, np.moveaxis(
        to_dbfs(med_lin, cfg.eps).cpu().numpy(), -1, 0)),
          "live: the tick's median is not the window's")
    # checkpoint, resume on the card, append, tick both: bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ck = eng.save(Path(tmp) / "live.npz")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng2 = LiveStreamEngine.resume(ds, cfg, ck, dev)
        resume_s = time.perf_counter() - t0
    grow(sr // 2)
    ra, rb = eng.tick(cfg), eng2.tick(cfg)
    for f in ("tile", "sxx_med_dbfs", "frame_starts", "times", "mask"):
        check(np.array_equal(getattr(ra, f), getattr(rb, f)),
              f"live: the resumed engine differs in {f}")
    del eng2
    # tick timing: 0.1 s of samples appended before each tick
    walls = []
    for _ in range(20):
        ds.append(x[pos:pos + sr // 10])
        pos += sr // 10
        t0 = time.perf_counter()
        ds.bnds_update()
        eng.tick(cfg)
        walls.append(time.perf_counter() - t0)
    tick_p50, tick_p90 = (float(v) for v in
                          np.percentile(walls, [50, 90]) * 1e3)
    # B2 over the window in turns with its plain version, bit for bit
    check(torch.equal(median_cuda.median_over_time_cuda(window),
                      plain.median_bisect(window)),
          "live: B2 over the window is not median_bisect's")
    b2_ms, b2_plain_ms = in_turns(
        lambda: plain.median_bisect(window),
        lambda: median_cuda.median_over_time_cuda(window), iters=5)
    b2_window = (b2_ms, b2_plain_ms, list(window.shape))
    gather_ms = event_ms(lambda: eng.state.ring.index_select(0, rows),
                         iters=5, warm=1)
    emit({"phase": "live_full_width", "card": card, "sample_rate": sr,
          "nfft": cfg.nfft, "hop": cfg.hop, "stream_seconds": 30.0,
          "window_cols": W, "cols_per_block": eng.cols_per_block,
          "ring_len": ring_len, "ring_bytes": ring_bytes,
          "cold_start_s": cold_s, "tick_samples_read": reads,
          "peaks_dbfs": peaks, "launches": run, "save_s": save_s,
          "resume_s": resume_s, "resumed_bit_equal": True,
          "tick_n": len(walls), "tick_p50_ms": tick_p50,
          "tick_p90_ms": tick_p90, "b2_window_ms": b2_ms,
          "b2_window_plain_ms": b2_plain_ms,
          "b2_share_of_tick_p50": b2_ms / tick_p50,
          "window_gather_ms": gather_ms})
    del eng, window

    # nfft 2^20, contiguous hop, an 8 s window: B4 on the streaming path
    cfg_big = SpectrogramConfig(nfft=big, ntime=100, stream_seconds=8.0,
                                display_tile=True,
                                color_range_db=COLOR_RANGE_DB, streaming=True)
    reset_counts()
    t0 = time.perf_counter()
    engb = LiveStreamEngine(ds, cfg_big, dev)
    res = engb.tick(cfg_big)
    cold_big_s = time.perf_counter() - t0
    for _ in range(2):
        grow(big)
        res = engb.tick(cfg_big)
    torch.cuda.synchronize()
    run_big = read_counts()
    check(run_big["big_psd"] > 0, f"live 2^20 launches {run_big}")
    add_counts(total, run_big)
    peaks_big = check_peaks(res, "live 2^20")
    emit({"phase": "live_nfft1048576", "card": card, "nfft": big,
          "stream_seconds": 8.0, "window_cols": engb.window_cols,
          "cols_per_block": engb.cols_per_block, "cold_start_s": cold_big_s,
          "peaks_dbfs": peaks_big, "launches": run_big})
    del engb

    # the engine on the card against the engine on the CPU, 1 s window
    for c in (cfg.replace(stream_seconds=1.0),
              cfg_big.replace(stream_seconds=1.0)):
        n_small = 2 * max(sr, big)
        small = MemoryDataset(x[:n_small], sr)
        e_dev = LiveStreamEngine(small, c, dev)
        e_cpu = LiveStreamEngine(small, c, "cpu")
        d = n_off = 0
        for i in range(3):
            if i:
                small.append(x[n_small + (i - 1) * big:n_small + i * big])
                small.bnds_update()
            a, b = e_dev.tick(c), e_cpu.tick(c)
            check(a is not None and b is not None,
                  f"live nfft {c.nfft}: no column after tick {i}")
            for f in ("frame_starts", "times", "mask", "freqs"):
                check(np.array_equal(getattr(a, f), getattr(b, f)),
                      f"live nfft {c.nfft}: {f} differs from the CPU engine")
            d = max(d, db_diff(a.sxx_med_dbfs, b.sxx_med_dbfs, axis=0))
            n_off += check_tiles(a.tile, b.tile, f"live nfft {c.nfft}")
        check(d <= 1e-3, f"live nfft {c.nfft}: median dB differs from the "
                         f"CPU engine by {d}")
        emit({"phase": f"live_vs_cpu_nfft{c.nfft}", "stream_seconds": 1.0,
              "ticks": 3, "max_db_diff_vs_cpu": d,
              "tile_pixels_off_by_one": n_off})
    return total, b2_window


def phase_b2_batched(dev, card, rng):
    """B2 over a batch of requests against its plain version
    (median_bisect per request) and np.median, bit for bit, at the merged
    launches' shapes and an odd n; then timed in turns against the plain
    version and against B solo launches. Returns {shape: (kernel ms,
    plain ms, solo ms)}."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch.kernels import median_cuda
    from pyspectrogram_tpu_torch.ops import plain

    out = {}
    for shape in ((7, 100, 1, 1024), (3, 128, 2, 4096), (5, 129, 2, 1024)):
        B, n = shape[:2]
        p = rng.exponential(size=shape).astype(np.float32)
        p[:, : n // 3, :, : shape[-1] // 4] = p[:, n // 3 : n // 3 + 1, :,
                                                : shape[-1] // 4]
        pd = torch.from_numpy(p).to(dev)
        got = median_cuda.median_over_time_cuda(pd, batched=True)
        want = np.median(p, axis=1).astype(np.float32)
        plain_b = torch.stack([plain.median_bisect(pd[b]) for b in range(B)])
        check(np.array_equal(got.cpu().numpy(), want)
              and torch.equal(got, plain_b),
              f"batched B2 is not bit-exact at {shape}")

        def solo():
            for b in range(B):
                median_cuda.median_over_time_cuda(pd[b])

        def plain_fn():
            for b in range(B):
                plain.median_bisect(pd[b])

        k_ms, plain_ms = in_turns(
            plain_fn, lambda: median_cuda.median_over_time_cuda(
                pd, batched=True), iters=20)
        k2_ms, solo_ms = in_turns(solo, lambda: median_cuda
                                  .median_over_time_cuda(pd, batched=True),
                                  iters=50)
        out[shape] = ((k_ms + k2_ms) / 2, plain_ms, solo_ms)
        emit({"phase": "b2_batched_vs_plain", "card": card,
              "shape": list(shape), "max_abs_err": 0.0,
              "batched_ms": out[shape][0], "plain_ms": plain_ms,
              "solo_launches_ms": solo_ms})
    return out


def _tab_callbacks(events: list, terms: list):
    from pyspectrogram_tpu_torch.runtime import ProcessorCallbacks

    return ProcessorCallbacks(on_iterated=events.append,
                              on_terminated=terms.append)


def phase_mtab_display(dev, card, sr):
    """The JAX bench's mtab/7/display (bench.py:188-261) at full width:
    seven written display-tile tabs (nfft 1024, ntime 100, colour ranges
    (-110 - i, -40)) over one 2^20-sample 1 MS/s capture, merged by the
    shared scheduler: one merged launch of 7, a static second cycle with
    no launch, each tab equal to its solo request bit for bit, merged vs
    solo cycle times, and a traced merged cycle's device busy share.
    Returns the first cycle's launch counts."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.models import batch, sti
    from pyspectrogram_tpu_torch.runtime import (
        SharedRefreshScheduler,
        SpectrogramProcessor,
    )
    from pyspectrogram_tpu_torch.utils.profiling import (
        StageTimer,
        device_busy_share,
        device_trace,
    )

    B, f0 = 7, 125_000.0
    ds = MemoryDataset(two_tone(1 << 20, sr, [f0], noise_rms=1e-3, seed=3),
                       sr)
    cfg = SpectrogramConfig(nfft=1024, nint=1, ntime=100, display_tile=True)
    sched = SharedRefreshScheduler(autostart=False)
    events = [[] for _ in range(B)]
    tabs = [SpectrogramProcessor(
        "written", ds, i, cfg.replace(color_range_db=(-110.0 - i, -40.0)),
        callbacks=_tab_callbacks(events[i], []), scheduler=sched,
        device=dev).start() for i in range(B)]
    merge_bytes = 2 * 1 * B * cfg.ntime * cfg.nfft * 4
    check(merge_bytes >= batch.BATCH_PREFETCH_MIN_BYTES,
          "mtab_7_display: expected the batched prefetch branch")
    reset_counts()
    sched.tick_once()
    torch.cuda.synchronize()
    run = read_counts()
    check((sched.merged_launches, sched.merged_requests) == (1, B)
          and sched.solo_launches == 0,
          f"mtab_7_display: merged {sched.merged_launches} launches of "
          f"{sched.merged_requests}, {sched.solo_launches} solo")
    check(run["sti_psd"] > 0 and run["median_batched"] > 0,
          f"mtab_7_display: launches {run}")
    reset_counts()
    sched.tick_once()
    torch.cuda.synchronize()
    second = read_counts()
    check(not any(second.values())
          and all(p.skipped_recomputes == 1 for p in tabs)
          and all(len(e) == 2 for e in events),
          f"mtab_7_display: static cycle launched {second}")
    solos = [sti.StiPipeline(ds, p.config, device=dev) for p in tabs]
    for i, (e, s) in enumerate(zip(events, solos)):
        got, want = e[0], s.compute()
        for f in ("tile", "sxx_med_dbfs", "times", "mask", "plot_freqs"):
            check(np.array_equal(getattr(got, f), getattr(want, f)),
                  f"mtab_7_display: tab {i} differs from its solo request "
                  f"in {f}")
        med = got.sxx_med_dbfs[:, 0]
        k = int(med.argmax())
        check(got.tile.shape[:2] == (cfg.ntime, 1)
              and abs(got.freqs[k] - f0) <= sr / cfg.nfft
              and abs(med[k]) <= 0.1,
              f"mtab_7_display: tab {i} peak {med[k]} dBFS at "
              f"{got.freqs[k]} Hz")

    def merged_cycle():
        for p in tabs:
            p._last_key = None                  # dirty every cycle
        sched.tick_once()

    def solo_cycle():
        for s in solos:
            s.compute()                         # with its bounds refresh

    turns = [wall_ms(fn, n=15, warm=2) for fn in
             (merged_cycle, solo_cycle, solo_cycle, merged_cycle)]
    merged_ms = (turns[0][0] + turns[3][0]) / 2
    solo_ms = (turns[1][0] + turns[2][0]) / 2
    timer = StageTimer()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp) as prof:
            with timer.stage("merged_cycle"):
                merged_cycle()
                torch.cuda.synchronize()
        busy = device_busy_share(prof.trace_path, "merged_cycle")
        kernels = sorted(
            ((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
             if getattr(e, "device_time_total", 0) > 0),
            key=lambda kv: -kv[1])[:6]
    for p in tabs:
        p.abort()
    emit({"phase": "mtab_7_display", "card": card, "tabs": B,
          "nfft": cfg.nfft, "ntime": cfg.ntime, "capture_samples": 1 << 20,
          "merge_bytes": merge_bytes, "prefetch": True, "launches": run,
          "merged_launches": 1, "merged_requests": B,
          "static_cycle_skips": B, "merged_equals_solo": True,
          "cycles": 15, "merged_cycle_p50_ms": merged_ms,
          "solo_cycle_p50_ms": solo_ms, "speedup": solo_ms / merged_ms,
          "traced_cycle_ms": busy["span_ms"],
          "device_busy_ms": busy["device_busy_ms"],
          "device_busy_share": busy["busy_share"],
          "device_events": busy["device_events"],
          "top_device_ms": [[k, v] for k, v in kernels]})
    return run


def phase_mtab_headline(dev, card, ds, sr, tones):
    """Three float-output tabs at the headline shape (nfft 4096, nint 4,
    ntime 128, nsub 2, welch, exact) merged into one launch over the
    prefetch branch: two read ``ds`` (complex64, ref 1), one an int16
    copy of it at ref 2^15.5 (the mixed-dtype merge, the inv_ref_sq
    scale). Each tab against its solo request within 1e-3 dB within 60 dB
    of each column's peak; then the head-of-line wait of a
    reference-default tab registered behind them, against its wait alone.
    Returns the launch counts."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.models import batch, sti
    from pyspectrogram_tpu_torch.runtime import (
        SharedRefreshScheduler,
        SpectrogramProcessor,
    )

    chan = ds.channels[0]
    x = ds.reader.samples * np.float32(2 ** 14)
    x16 = np.empty(x.shape, np.dtype([("r", np.int16), ("i", np.int16)]))
    x16["r"], x16["i"] = np.rint(x.real), np.rint(x.imag)
    ref16 = 2.0 ** 15.5
    ds16 = MemoryDataset(x16, sr, channel=chan, ref=ref16)
    cfg = SpectrogramConfig(nfft=4096, nint=4, ntime=128, mode="welch",
                            precision="exact")
    sched = SharedRefreshScheduler(autostart=False)
    events = [[], [], []]
    tabs = [SpectrogramProcessor("written", d, i, cfg,
                                 callbacks=_tab_callbacks(events[i], []),
                                 scheduler=sched, device=dev).start()
            for i, d in enumerate((ds, ds, ds16))]
    merge_bytes = 2 * 2 * 3 * cfg.ntime * cfg.nfft * cfg.nint * 4
    check(merge_bytes >= batch.BATCH_PREFETCH_MIN_BYTES,
          "mtab_3_headline: expected the batched prefetch branch")
    reset_counts()
    t0 = time.perf_counter()
    sched.tick_once()
    torch.cuda.synchronize()
    cycle_ms = (time.perf_counter() - t0) * 1e3
    run = read_counts()
    check((sched.merged_launches, sched.merged_requests) == (1, 3)
          and run["sti_psd"] > 0 and run["median_batched"] > 0,
          f"mtab_3_headline: merged {sched.merged_launches} of "
          f"{sched.merged_requests}, launches {run}")
    d = 0.0
    peaks = []
    for i, (p, e) in enumerate(zip(tabs, events)):
        got, want = e[0], sti.StiPipeline(p.ds, cfg, device=dev).compute()
        check(np.array_equal(got.times, want.times)
              and np.array_equal(got.mask, want.mask),
              f"mtab_3_headline: tab {i} frame axes differ from solo")
        d = max(d, db_diff(got.sxx_dbfs, want.sxx_dbfs, axis=0),
                db_diff(got.sxx_med_dbfs, want.sxx_med_dbfs, axis=0))
        want_peak = 0.0 if i < 2 else 20 * np.log10(2 ** 14 / ref16)
        for s_, f in enumerate(tones):
            med = got.sxx_med_dbfs[:, s_]
            k = int(med.argmax())
            peaks.append(float(med[k]))
            check(abs(got.freqs[k] - f) <= sr / cfg.nfft
                  and abs(med[k] - want_peak) <= 0.1,
                  f"mtab_3_headline: tab {i} sub {s_} peak {med[k]} dBFS "
                  f"at {got.freqs[k]} Hz")
    check(d <= 1e-3, f"mtab_3_headline: merged differs from solo by {d} dB")

    # head of line: a reference-default tab registered after the three
    # headline tabs gets its frame only when their merged launch is done;
    # alone on its own scheduler, after its own request
    from pyspectrogram_tpu_torch.runtime import ProcessorCallbacks

    def hol_ms(sched_, others) -> float:
        arrived = []
        small = SpectrogramProcessor(
            "written", ds, 9, SpectrogramConfig(),
            callbacks=ProcessorCallbacks(
                on_iterated=lambda e: arrived.append(time.perf_counter())),
            scheduler=sched_, device=dev).start()
        waits = []
        for _ in range(4):
            for t in others + [small]:
                t._last_key = None              # dirty every cycle
            t0 = time.perf_counter()
            sched_.tick_once()
            waits.append((arrived[-1] - t0) * 1e3)
        small.abort()
        return float(np.median(waits[1:]))

    hol = {"behind_headline_ms": hol_ms(sched, tabs),
           "alone_ms": hol_ms(SharedRefreshScheduler(autostart=False), [])}
    for p in tabs:
        p.abort()
    emit({"phase": "mtab_3_headline", "card": card, "tabs": 3,
          "nfft": cfg.nfft, "nint": cfg.nint, "ntime": cfg.ntime, "nsub": 2,
          "merge_bytes": merge_bytes, "prefetch": True,
          "dtypes": ["complex64", "complex64", "int16"],
          "refs": [1.0, 1.0, ref16], "launches": run,
          "merged_cycle_ms": cycle_ms, "peaks_dbfs": peaks,
          "max_db_diff_vs_solo": d,
          "head_of_line_reference_default_tab": hol})
    return run


def phase_processor_written(dev, card, sr):
    """One threaded written processor without a scheduler: on a static
    capture 5 iterations are one compute and 4 delta skips, then
    Terminated OK; on a capture grown after every iteration, every
    iteration recomputes and chases the new end. Returns the launch
    counts of the static run."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.runtime import SpectrogramProcessor

    x = two_tone(1 << 20, sr, [125_000.0], noise_rms=1e-3, seed=5)
    cfg = SpectrogramConfig(nfft=1024, nint=1, ntime=100)
    events, terms = [], []
    p = SpectrogramProcessor("written", MemoryDataset(x, sr), 0, cfg,
                             callbacks=_tab_callbacks(events, terms),
                             written_sleep=0.0, max_iterations=5, device=dev)
    reset_counts()
    p.start()
    p.join(120)
    torch.cuda.synchronize()
    run = read_counts()
    check(not p._thread.is_alive() and len(events) == 5
          and p.skipped_recomputes == 4
          and [int(t.reason) for t in terms] == [0],
          f"processor_written: {len(events)} iterations, "
          f"{p.skipped_recomputes} skips, terminated {terms}")
    check(run["sti_psd"] > 0 and run["median"] > 0,
          f"processor_written: launches {run}")
    static = p.latency_stats()

    n0, grow = 1 << 19, sr // 10
    ds = MemoryDataset(x[:n0], sr)
    grown, ends, terms2 = [n0], [], []

    def on_iterated(e):
        ends.append(e.times[-1])
        ds.append(x[grown[0]:grown[0] + grow])
        grown[0] += grow

    from pyspectrogram_tpu_torch.runtime import ProcessorCallbacks

    p2 = SpectrogramProcessor(
        "written", ds, 1, cfg,
        callbacks=ProcessorCallbacks(on_iterated=on_iterated,
                                     on_terminated=terms2.append),
        written_sleep=0.0, max_iterations=4, device=dev)
    p2.start()
    p2.join(120)
    check(not p2._thread.is_alive() and len(ends) == 4
          and p2.skipped_recomputes == 0
          and all(b > a for a, b in zip(ends, ends[1:]))
          and [int(t.reason) for t in terms2] == [0],
          f"processor_written: grown capture gave {len(ends)} iterations, "
          f"{p2.skipped_recomputes} skips")
    emit({"phase": "processor_written", "card": card, "nfft": cfg.nfft,
          "ntime": cfg.ntime, "static_iterations": 5, "static_skips": 4,
          "launches": run, "static_latency": static,
          "grown_iterations": 4, "grown_recomputes": 4,
          "grown_latency": p2.latency_stats()})
    return run


def phase_live_tabs(dev, card, x, sr):
    """N streaming processors (N = 1, 3, 7), one thread each, over one
    capture that a writer thread grows by 0.1 s every 0.1 s, at
    live_full_width's shape (30 s window, nfft 4096, hop 2048, display
    tile, ntime 100; a 480 MB ring per tab). Each tab runs 21 iterations
    (a cold start and 20 ticks); the tones' peaks are checked on every
    iteration; per-tab tick p50/p90 over the 20 ticks. ``x`` repeats
    (its length is a multiple of the tones' 16-sample period). Returns
    the launch counts."""
    import threading

    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.runtime import SpectrogramProcessor

    tones = [sr / 16.0, sr / 8.0]
    cfg = SpectrogramConfig(nfft=4096, hop=2048, ntime=100,
                            stream_seconds=30.0, display_tile=True,
                            color_range_db=COLOR_RANGE_DB)
    total = {k: 0 for k in read_counts()}
    n0, step = 31 * sr, sr // 10
    iters = 21
    for n_tabs in (1, 3, 7):
        ds = MemoryDataset(x[:n0], sr)
        stop = threading.Event()
        written = [n0]

        def write():
            while not stop.wait(0.1):
                idx = np.arange(written[0], written[0] + step) % len(x)
                ds.append(x[idx])
                written[0] += step

        events = [[] for _ in range(n_tabs)]
        terms = [[] for _ in range(n_tabs)]
        tabs = [SpectrogramProcessor(
            "streaming", ds, i, cfg,
            callbacks=_tab_callbacks(events[i], terms[i]),
            max_iterations=iters, device=dev) for i in range(n_tabs)]
        reset_counts()
        writer = threading.Thread(target=write, daemon=True)
        t0 = time.perf_counter()
        writer.start()
        for p in tabs:
            p.start()
        for p in tabs:
            p.join(300)
        wall_s = time.perf_counter() - t0
        stop.set()
        writer.join(10)
        torch.cuda.synchronize()
        run = read_counts()
        check(not writer.is_alive()
              and not any(p._thread.is_alive() for p in tabs),
              f"live_tabs_{n_tabs}: threads still running")
        check(run["stream_psd"] > 0 and run["median"] > 0,
              f"live_tabs_{n_tabs}: launches {run}")
        add_counts(total, run)
        p50s, p90s, peaks = [], [], []
        for i, (p, ev, tm) in enumerate(zip(tabs, events, terms)):
            check(len(ev) == iters and [int(t.reason) for t in tm] == [0],
                  f"live_tabs_{n_tabs}: tab {i} gave {len(ev)} iterations, "
                  f"terminated {tm}")
            for j, e in enumerate(ev):
                for s_, f in enumerate(tones):
                    med = e.sxx_med_dbfs[:, s_]
                    k = int(med.argmax())
                    check(abs(e.freqs[k] - f) <= sr / cfg.nfft
                          and abs(med[k]) <= 0.1,
                          f"live_tabs_{n_tabs}: tab {i} iteration {j} sub "
                          f"{s_} peak {med[k]} dBFS at {e.freqs[k]} Hz")
                    peaks.append(float(med[k]))
            ticks = np.asarray(list(p.latencies_s)[1:]) * 1e3
            p50s.append(float(np.percentile(ticks, 50)))
            p90s.append(float(np.percentile(ticks, 90)))
        cold = [float(p.latencies_s[0]) for p in tabs]
        emit({"phase": f"live_tabs_{n_tabs}", "card": card, "tabs": n_tabs,
              "nfft": cfg.nfft, "hop": cfg.hop, "stream_seconds": 30.0,
              "ring_bytes_per_tab": tabs[0]._live.engine.state.ring.numel()
              * 4, "iterations_per_tab": iters, "launches": run,
              "tick_p50_ms": p50s, "tick_p90_ms": p90s,
              "tick_p50_ms_median": float(np.median(p50s)),
              "cold_start_s": cold, "wall_s": wall_s,
              "samples_written": written[0] - n0,
              "peak_dbfs_min": min(peaks), "peak_dbfs_max": max(peaks),
              "latency_stats_tab0": tabs[0].latency_stats(),
              "capture_end_s": written[0] / sr,
              "newest_column_s": [float((e[-1].times[-1] - np.datetime64(
                  0, "us")) / np.timedelta64(1, "s")) for e in events]})
        del tabs, events, ds
        torch.cuda.empty_cache()
    return total


def periodic_two_tone(n: int, sample_rate: float, freqs_hz, period: int,
                      noise_rms: float, seed: int):
    """(n,) complex64: unit tones at ``freqs_hz`` with seeded phases, each
    a whole number of cycles per ``period`` samples (so one period, tiled,
    makes tens of seconds fast), plus float32 white noise; and the tones
    alone, each as its own (n,) complex64 array."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = np.arange(period) / sample_rate
    tones = [np.tile(np.exp(1j * (2 * np.pi * f * k + ph)).astype(
        np.complex64), n // period)
        for f, ph in zip(freqs_hz, rng.uniform(0, 2 * np.pi, len(freqs_hz)))]
    noise = rng.standard_normal((n, 2), dtype=np.float32)
    noise *= np.float32(noise_rms / np.sqrt(2.0))
    x = noise.view(np.complex64)[:, 0]
    for t in tones:
        x += t
    return x, tones


def tone_checks(y, keep, cut, edge: int):
    """(largest error of ``y`` against the kept tone, the cut tone's level
    in dB under the kept one's) on the fully covered interior (``edge``
    samples in from each end); both tones are projected out of ``y``."""
    import numpy as np

    sl = slice(edge, len(y) - edge)
    err = float(np.abs(y[sl] - keep[:len(y)][sl]).max())
    a_keep = abs(np.vdot(keep[:len(y)][sl], y[sl]))
    a_cut = abs(np.vdot(cut[:len(y)][sl], y[sl]))
    return err, float(20 * np.log10(a_cut / a_keep))


def phase_filter(dev, card, seconds: int = 30, sr: int = 1_000_000):
    """filter_signal over a seeded ``seconds`` s two-tone capture at
    ``sr`` (tones at 50 and 300 kHz), low-pass at 120 kHz with nfft 1024:
    the card against the port's CPU run, the kept tone against the ideal
    one and the cut tone's level; the STFT, mask and ISTFT timed with CUDA
    events; then regenerate_signal with a band-pass mask on the same
    spectra. The filters reach no kernel of B1-B4 (``torch.fft``)."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch.ops import filters

    nfft, hop, atol = 1024, 512, 1e-5
    x, (t50, t300) = periodic_two_tone(seconds * sr, sr, (50e3, 300e3), 20,
                                       noise_rms=1e-4, seed=5)
    reset_counts()
    t0 = time.perf_counter()
    y = filters.filter_signal(x, sr, "lowpass", 120e3, nfft=nfft,
                              device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    run = read_counts()
    t0 = time.perf_counter()
    y_cpu = filters.filter_signal(x, sr, "lowpass", 120e3, nfft=nfft,
                                  device="cpu")
    cpu_wall_s = time.perf_counter() - t0
    nframes = (len(x) - nfft) // hop + 1
    check(y.shape == y_cpu.shape == ((nframes - 1) * hop + nfft,)
          and np.isfinite(y).all(), f"filter: output of {y.shape}")
    sl = slice(nfft, len(y) - nfft)
    d = float(np.abs(y[sl] - y_cpu[sl]).max())
    check(d <= atol, f"filter: the card differs from the CPU run by {d}")
    keep_err, cut_db = tone_checks(y, t50, t300, nfft)
    check(keep_err < 5e-3 and cut_db < -60,
          f"filter: kept tone off by {keep_err}, cut tone at {cut_db} dB")
    del y, y_cpu
    # the three steps on the card, by CUDA events
    packed = torch.from_numpy(x.view(np.float32).reshape(-1, 2)).to(dev)
    stft = filters.make_stft_fn(nfft=nfft, hop=hop, device=dev)
    istft = filters.make_istft_fn(nfft=nfft, hop=hop, nframes=nframes,
                                  device=dev)
    mask = torch.from_numpy(filters.band_mask(nfft, sr, "lowpass", 120e3)
                            ).to(dev)[None, :, None]
    spectra = stft(packed)
    masked = spectra * mask
    stft_ms = event_ms(lambda: stft(packed), iters=5, warm=1)
    mask_ms = event_ms(lambda: spectra * mask, iters=5, warm=1)
    istft_ms = event_ms(lambda: istft(masked), iters=5, warm=1)
    del masked
    bp = filters.band_mask(nfft, sr, "bandpass", (250e3, 350e3))
    t0 = time.perf_counter()
    y2 = filters.regenerate_signal(spectra, nfft, hop, freq_mask=bp,
                                   device=dev)
    regen_s = time.perf_counter() - t0
    regen_err, regen_cut_db = tone_checks(y2, t300, t50, nfft)
    check(regen_err < 5e-3 and regen_cut_db < -60,
          f"regenerate: kept tone off by {regen_err}, cut tone at "
          f"{regen_cut_db} dB")
    emit({"phase": "filter_full_width", "card": card, "seconds": seconds,
          "sample_rate": sr, "n_samples": len(x), "nfft": nfft, "hop": hop,
          "nframes": nframes, "spectra_bytes": spectra.numel() * 4,
          "kind": "lowpass", "cutoff_hz": 120e3, "wall_s": wall_s,
          "cpu_wall_s": cpu_wall_s, "max_abs_diff_vs_cpu": d, "atol": atol,
          "kept_tone_max_err": keep_err, "cut_tone_db": cut_db,
          "stft_ms": stft_ms, "mask_ms": mask_ms, "istft_ms": istft_ms,
          "regenerate_band_hz": [250e3, 350e3], "regenerate_s": regen_s,
          "regenerate_kept_max_err": regen_err,
          "regenerate_cut_db": regen_cut_db, "launches": run})
    del packed, spectra
    torch.cuda.empty_cache()


def run_cli(argv, **datasets):
    """Parse ``argv`` with the port CLI's parser, put the opened datasets
    in the place of their path arguments (``dataset=`` / ``datasets=``),
    run the command with every launch count at 0, and return (its last
    JSON line, what it wrote to stderr, the launches, its wall seconds)."""
    import contextlib
    import io

    import torch

    from pyspectrogram_tpu_torch.clients import cli

    args = cli.build_parser().parse_args([str(a) for a in argv])
    for k, v in datasets.items():
        setattr(args, k, v)
    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = args.fn(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    run = read_counts()
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and lines, f"cli {argv[0]}: exit {rc}, stdout "
                             f"{out.getvalue()[-400:]!r}")
    return json.loads(lines[-1]), err.getvalue(), run, wall_s


def phase_cli(dev, card, ds, ds_long, tones, tmp, window_s: float = 30.0):
    """The pstpu-torch commands as a user runs them, through
    ``build_parser()``, with in-memory captures in the place of the
    dataset paths: sti at the headline shape (+ .npz and a saved session,
    held against the same command on the CPU), resume, psd, sti-batch over
    three captures, stream with and without --hop 2048, watch at a
    ``window_s`` window, and sti at nfft 65536. Each command's peaks must
    be within 0.1 dB of 0 dBFS and its kernels launched. Returns the
    launch counts."""
    import importlib.util
    import re

    import numpy as np

    from pyspectrogram_tpu_torch.display import sti_tile
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset

    sr = float(ds.sr_dict[ds.channels[0]])
    renderer = ("matplotlib" if importlib.util.find_spec("matplotlib")
                else "pixels" if importlib.util.find_spec("PIL") else None)
    check(renderer is not None, "cli: neither matplotlib nor PIL is "
                                "installed, so no PNG can be written")
    head = ("--nfft", 4096, "--nint", 4, "--ntime", 128)
    batch = [MemoryDataset(two_tone(128 * 4096 * 4, sr, tones, 1e-3,
                                    seed=20 + i), sr, channel=f"cap{i}")
             for i in range(3)]
    t = Path(tmp)
    cmds = [
        ("sti", ["sti", "MEM", *head, "--out", t / "sti.png", "--npz",
                 t / "sti.npz", "--save-session", t / "session.npz"],
         dict(dataset=ds), ("sti_psd", "median")),
        ("resume", ["resume", t / "session.npz", "--out", t / "resumed.png"],
         dict(dataset=ds), ("sti_psd", "median")),
        ("psd", ["psd", "MEM", *head, "--out", t / "psd.csv"],
         dict(dataset=ds), ("sti_psd", "median")),
        ("sti_batch", ["sti-batch", "A", "B", "C", *head, "--out-dir",
                       t / "batch"], dict(datasets=batch),
         ("sti_psd", "median_batched")),
        ("stream", ["stream", "MEM", "--nfft", 4096, "--cols-per-block", 8,
                    "--ring-len", 256, "--out", t / "stream.png"],
         dict(dataset=ds), ("sti_psd", "median")),
        ("stream_hop2048", ["stream", "MEM", "--nfft", 4096, "--hop", 2048,
                            "--cols-per-block", 8, "--ring-len", 256,
                            "--out", t / "stream_hop.png"],
         dict(dataset=ds), ("stream_psd", "median")),
        ("watch", ["watch", "MEM", "--nfft", 4096, "--hop", 2048, "--ntime",
                   100, "--window-s", window_s, "--refresh-s", 0.0,
                   "--iterations", 4, "--crange", -80, 0, "--out",
                   t / "watch.png"], dict(dataset=ds_long),
         ("stream_psd", "median")),
        ("sti_nfft65536", ["sti", "MEM", "--nfft", 1 << 16, "--nint", 4,
                           "--ntime", 32, "--out", t / "sti65536.png"],
         dict(dataset=ds_long), ("big_psd",)),
    ]
    total = {k: 0 for k in read_counts()}
    for label, argv, datasets, kernels in cmds:
        res, err, run, wall_s = run_cli([*argv, "--device", dev], **datasets)
        check(all(run[k] > 0 for k in kernels),
              f"cli_{label}: launches {run}, expected {kernels}")
        add_counts(total, run)
        artifacts = []
        if label == "psd":
            csv = np.loadtxt(res["csv"], delimiter=",", skiprows=1)
            check(csv.shape == (4096, 2), f"cli_psd: csv of {csv.shape}")
            peaks = [float(csv[:, 1].max())]
            artifacts.append(res["csv"])
        elif label == "sti_batch":
            check(res["batched"] == 3, f"cli_sti_batch: {res}")
            peaks = [r["peak_dbfs"] for r in res["results"]]
            artifacts += [r["png"] for r in res["results"]]
        elif label == "watch":
            peaks = [float(v) for v in re.findall(r"peak\s+(-?[\d.]+) dBFS",
                                                  err)]
            check(res["iterations"] == 4 and len(peaks) == 4,
                  f"cli_watch: {res}, stderr {err[-400:]!r}")
            artifacts.append(res["png"])
        elif label == "resume":
            check(res["shape"] == [4096, 128, 2], f"cli_resume: {res}")
            peaks = [0.0]
            artifacts.append(res["png"])
        else:
            peaks = [res["peak_dbfs"]]
            artifacts.append(res["png"])
        check(all(abs(p) <= 0.1 for p in peaks),
              f"cli_{label}: peaks {peaks} dBFS, expected ~0")
        for a in artifacts:
            check(Path(a).is_file() and Path(a).stat().st_size > 0,
                  f"cli_{label}: no {a}")
        line = {"phase": f"cli_{label}", "card": card,
                "argv": [str(a) for a in argv], "wall_s": wall_s,
                "launches": run, "peaks_dbfs": peaks,
                "artifacts": [Path(a).name for a in artifacts]
                + (["sti.npz", "session.npz"] if label == "sti" else []),
                "renderer": renderer}
        if label == "sti":
            # the same command on the CPU; the .npz on the card's renderer
            cpu, _, _, cpu_s = run_cli([*argv[:-6], "--out", t / "cpu.png",
                                        "--npz", t / "cpu.npz", "--device",
                                        "cpu"], **datasets)
            a, b = np.load(t / "sti.npz"), np.load(t / "cpu.npz")
            check(np.array_equal(a["freqs"], b["freqs"])
                  and np.array_equal(a["times"], b["times"]),
                  "cli_sti: frame axes differ from the CPU run")
            d = max(db_diff(a["sxx_dbfs"], b["sxx_dbfs"], axis=0),
                    db_diff(a["sxx_med_dbfs"], b["sxx_med_dbfs"], axis=0),
                    abs(res["peak_dbfs"] - cpu["peak_dbfs"]))
            check(d <= 1e-3, f"cli_sti: dB differs from the CPU run by {d}")
            rgba, pf = sti_tile(a["sxx_dbfs"][..., 0], a["freqs"],
                                (-100.0, 0.0), device=dev)
            rgba_cpu, _ = sti_tile(a["sxx_dbfs"][..., 0], a["freqs"],
                                   (-100.0, 0.0), device="cpu")
            check(rgba.shape == (128, len(pf), 4)
                  and np.array_equal(rgba, rgba_cpu),
                  "cli_sti: sti_tile on the card differs from the CPU's")
            line.update(cpu_wall_s=cpu_s, max_db_diff_vs_cpu=d,
                        p50_column_db=res["p50_column_db"],
                        sti_tile_equal_cpu=True)
        if label == "watch":
            line["latency"] = res["latency"]
        emit(line)
    return total


def phase_gui(dev, card, ds_written, ds_live, tones, tmp,
              window_s: float = 30.0):
    """The port's viewer on the headless widget kit: MainWindow on the
    card, its plots recorded (recording_figure_kit: the card's machine has
    no matplotlib), the directory dialog's answer mapped to in-memory
    captures. One written tab at the reference default, then one live tab
    at a ``window_s`` window (nfft 4096, hop 2048) for four refreshes:
    each frame reaches the window and is drawn, peaks at 0 dBFS, no
    warning dialog. Returns the launch counts."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch.clients import gui

    check(gui.HEADLESS, "gui: expected the headless widget kit")
    dialogs = gui.QtWidgets
    dialogs.QMessageBox.journal = []
    sources = {"written": ds_written, "live": ds_live}
    win = gui.MainWindow(device=dev, figure_kit=gui.recording_figure_kit,
                         open_dataset=sources.__getitem__)
    win._last_dir_file = lambda: Path(tmp) / "last_dir.txt"
    total = {k: 0 for k in read_counts()}

    def wait(pred, timeout):
        t0 = time.perf_counter()
        while not pred():
            check(time.perf_counter() - t0 < timeout, "gui: timed out")
            time.sleep(0.01)
        return time.perf_counter() - t0

    def run_tab(tab_id, label, source, n_frames, kernels, **widgets):
        st = win.states[tab_id]
        for name, v in widgets.items():
            if name == "live_check":
                st.live_check.setChecked(v)
            else:
                getattr(st, name).setValue(v)
        dialogs.QFileDialog.existing_directory = source
        reset_counts()
        st.start_btn.click()
        check(st.processor is not None and st.processor.is_running,
              f"gui {label}: the tab did not start")
        first_s = wait(lambda: st.last is not None, 120)
        wait(lambda: st.last.i >= n_frames - 1, 120)
        st.stop_btn.click()
        wait(lambda: not st.processor.is_running, 60)
        st.processor.join(30)
        torch.cuda.synchronize()
        run = read_counts()
        check(all(run[k] > 0 for k in kernels),
              f"gui {label}: launches {run}, expected {kernels}")
        add_counts(total, run)
        p = st.last
        check(p.tile is not None and p.tile.dtype == np.uint8
              and p.mask.all(), f"gui {label}: payload tile/mask")
        peaks = []
        for s, f in enumerate(tones):
            med = p.sxx_med_dbfs[:, s]
            k = int(med.argmax())
            check(abs(p.freqs[k] - f) <= 2 * float(p.freqs[1] - p.freqs[0])
                  and abs(med[k]) <= 0.1,
                  f"gui {label}: sub {s} peak {med[k]} dBFS at "
                  f"{p.freqs[k]} Hz")
            peaks.append(float(med[k]))
        # the frame the window drew: the waterfall from the payload's tile
        drawn = [c for c in st.sti_ax.calls if c[0] == "pcolormesh"]
        check(len(drawn) == 1 and np.array_equal(drawn[0][1][2],
                                                 p.tile[:, 0, :]),
              f"gui {label}: the window did not draw the last frame")
        check(sum(c[0] == "plot" for c in st.psd_ax.calls) == len(tones),
              f"gui {label}: PSD lines {st.psd_ax.calls}")
        return {"phase": f"gui_headless_{label}", "card": card,
                "nfft": st.processor.config.nfft,
                "ntime": st.processor.config.ntime,
                "streaming": st.processor.config.streaming,
                "frames": p.i + 1, "first_frame_s": first_s,
                "tile_shape": list(p.tile.shape), "peaks_dbfs": peaks,
                "launches": run, "plots": "recorded"}

    line = run_tab(1, "written", "written", 1, ("sti_psd", "median"))
    emit(line)
    win.new_tab()
    line = run_tab(2, "live", "live", 4, ("stream_psd", "median"),
                   live_check=True, window_s=window_s, nfft=4096,
                   hop_w=2048)
    eng = win.states[2].processor._live.engine
    line.update(stream_seconds=window_s, window_cols=eng.window_cols,
                ring_bytes=eng.state.ring.numel() * 4,
                latency=win.states[2].processor.latency_stats())
    emit(line)
    check(dialogs.QMessageBox.journal == [],
          f"gui: warnings {dialogs.QMessageBox.journal}")
    check(win.close(), "gui: the window refused to close")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.kernels import (
        _build,
        big_cuda,
        median_cuda,
        sti_cuda,
    )
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

    # B3 and B4 against their plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b3_err = phase_b3(dev, gen)
    b4_err = phase_b4(dev, gen)

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
    launches = {k: 0 for k in read_counts()}
    blocks = {}
    for label, cfg in requests:
        frame_len = cfg.nfft * cfg.nint
        # two subchannels: four float32 planes
        prefetch = 4 * cfg.ntime * frame_len * 4 >= sti.PREFETCH_MIN_BYTES
        pipe = sti.StiPipeline(ds, cfg, device=dev)
        reset_counts()
        res = pipe.compute()
        torch.cuda.synchronize()
        run = read_counts()
        n_b1 = run["sti_psd"]
        n_b2 = run["median"]
        check(n_b1 > 0 and n_b2 > 0,
              f"{label}: the request launched B1 {n_b1}x and B2 {n_b2}x")
        add_counts(launches, run)
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

    # the multi-tab runtime: B2 over a batch of requests, merged launches
    # through the shared scheduler, one threaded written processor
    b2_batched = phase_b2_batched(dev, card, rng)
    add_counts(launches, phase_mtab_display(dev, card, sr))
    add_counts(launches, phase_mtab_headline(dev, card, ds, sr, tones))
    add_counts(launches, phase_processor_written(dev, card, sr))

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

    # the other paths, on a long two-tone capture at 1 MS/s: the written
    # request at nfft >= 65536 over its first 31 s, the streaming core, and
    # the live engine, which grows a capture from it
    x_long = long_two_tone(live_samples(sr), noise_rms=1e-3, seed=2)
    phase_big_requests(dev, MemoryDataset(x_long[:31 * sr], sr), tones,
                       launches)
    stream_counts, b3_ms, b3_plain_ms, b3_push_err = phase_streaming(
        dev, card, x_long[:2 * sr], sr)
    add_counts(launches, stream_counts)
    live_counts, b2_window = phase_live(dev, card, x_long, sr)
    add_counts(launches, live_counts)
    add_counts(launches, phase_live_tabs(dev, card, x_long, sr))

    # the port's own entry points: the pstpu-torch commands and the viewer
    # (reading from memory: the card's machine has no HDF5 reader), then
    # the filters at full width
    ds_long = MemoryDataset(x_long[:31 * sr], sr)
    with tempfile.TemporaryDirectory() as tmp:
        add_counts(launches, phase_cli(dev, card, ds, ds_long, tones, tmp))
        add_counts(launches, phase_gui(dev, card, ds, ds_long, tones, tmp))
    del x_long, ds_long
    phase_filter(dev, card)

    # B4 at the written request's shapes: 65536 x 4 x 32 and 2^20 x 1 x 16
    b4 = {}
    for nfft, nint, ntime in ((1 << 16, 4, 32), (1 << 20, 1, 16)):
        xd = torch.randn((4, nfft * nint * ntime), generator=gen, device=dev)
        sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
        psd_kw = dict(nfft=nfft, nint=nint, mode="welch")
        e, r, over = b4_errors(big_cuda.big_psd_cuda(xd, sd, **psd_kw),
                               plain.psd_torch(xd, sd, **psd_kw))
        check(over <= 1.0, f"B4 at nfft {nfft}: max rel {r}")
        b4_err = max(b4_err, e)
        b4[nfft] = in_turns(lambda: plain.psd_torch(xd, sd, **psd_kw),
                            lambda: big_cuda.big_psd_cuda(xd, sd, **psd_kw),
                            iters=20)
        n_proc = nfft * nint * ntime * 2
        emit({"phase": f"timing_b4_nfft{nfft}", "card": card, "nfft": nfft,
              "nint": nint, "ntime": ntime, "nsub": 2,
              "b4_max_abs_err": e, "b4_max_rel_err": r,
              "b4_ms": b4[nfft][0], "b4_plain_ms": b4[nfft][1],
              "b4_samples_per_s": n_proc / (b4[nfft][0] * 1e-3)})

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
         "ms": head["b2_ms"], "plain_ms": head["b2_plain_ms"],
         "batched_launches": launches["median_batched"],
         "batched_shape": [7, 100, 1, 1024],
         "batched_ms": b2_batched[(7, 100, 1, 1024)][0],
         "batched_plain_ms": b2_batched[(7, 100, 1, 1024)][1],
         "batched_solo_launches_ms": b2_batched[(7, 100, 1, 1024)][2],
         "window_shape": b2_window[2], "window_ms": b2_window[0],
         "window_plain_ms": b2_window[1]},
        {"name": "stream_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/stream_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:767",
         "launches": launches["stream_psd"],
         "max_abs_err": max(b3_err, b3_push_err),
         "ms": b3_ms, "plain_ms": b3_plain_ms},
        {"name": "big_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/big_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:970",
         "launches": launches["big_psd"], "max_abs_err": b4_err,
         "ms": b4[1 << 16][0], "plain_ms": b4[1 << 16][1]},
    ]})
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was never launched on the port's paths")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
