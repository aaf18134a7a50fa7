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
- the mesh tier on torch.distributed: a 1x1 mesh over NCCL in this
  process, then four ranks spawned on the one card over gloo (a 2x2 mesh,
  the distributed FFT on 4x1), each running StiPipeline(mesh=) at the
  headline (float and display tile), make_batched_sti_fn_mesh over 7
  requests, the distributed FFT at 2^20, the big-FFT STI at 2^18 and the
  summed-bisection median against the one-device run, the 2x2 results
  against the 1x1 ones, and every rank's B1/B2 launches; the 1x1 phase
  also holds make_sti_fn(fft_impl="gemm") to a float64 FFT with TF32
  allowed; both phases then run the streaming mesh (h): StreamingSti(mesh=)
  at the streaming shapes (B1, B3 and B2 per rank, one B4 push), the
  full-width LiveStreamEngine(mesh=) with its checkpoint resumed on the
  mesh and on one device, and a streaming SpectrogramProcessor(mesh=),
  bit for bit against the one-device objects (1x1) and the 1x1 outputs
  (2x2), with every rank's B1-B4 launches and the push and tick times;
- the port's bench (pyspectrogram_tpu_torch.bench) at the JAX bench's
  default shapes: every row of its --all suite, each with the launches of
  its kernels, and its headline line;

B1 and B3 are held to their plain version at every power of two from 256
to 32768, and two calls of each to the same bits; the build's ptxas report
must show no spill in their register-pass kernel or in either launch of
the four-step split (fft_common.cuh), whose two launches are also timed
alone.
B2 is held bit for bit to its plain version on adversarial cubes too
(ties across the middle, +-0, subnormals, +-inf, all-equal columns, n on
both sides of its tile/radix boundary, odd and even, a batch of 7), in
each of its two designs. Then it times kernels, pushes, ticks and requests
with CUDA events and the wall clock, and computes each kernel's bound (the
least time an H100 needs to move its bytes or do its float32 operations;
the timing and bound helpers are the bench module's)
beside the one PyTorch call that computes the same function where there is
one (``torch.median``, ``torch.quantile``). Every phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the exit
code is then non-zero. Needs one CUDA device; imports torch, numpy and the
port only.

The captures are seeded two-tone complex64 arrays served by the port's
in-memory dataset, so the host reads, assembly and copies run as they do
for a Digital RF capture, without HDF5 files (the reader needs h5py).
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

from pyspectrogram_tpu_torch.bench import (
    card_of,
    device_ms,
    event_ms,
    in_turns,
    median_bound,
    psd_bound,
    read_counts,
    reset_counts,
    traced_device_ms,
    wall_ms,
)

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


def kernel_resources(build_log: str, kernel: str):
    """ptxas's registers, spill bytes and stack frame of every instance of
    the template ``kernel`` in the build's ``-Xptxas -v`` output, each with
    its nfft (the product of its leading integer template arguments)."""
    import math
    import re

    name = re.compile(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S*" + kernel + r"I((?:Li\d+E)+)\S*?)'?"
                      r"(?: for|$)")
    out, cur = [], None
    for ln in build_log.splitlines():
        m = name.search(ln)
        if m:
            if cur is None or cur["kernel"] != m.group(1):
                cur = {"kernel": m.group(1),
                       "nfft": math.prod(int(v) for v in
                                         re.findall(r"\d+", m.group(2))),
                       "registers": None, "spill_stores": None,
                       "spill_loads": None, "stack": None}
                out.append(cur)
            continue
        if "entry function" in ln or "Function properties" in ln:
            cur = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def reg_kernel_resources(build_log: str):
    """kernel_resources of the register-pass PSD kernel (fft_common.cuh
    reg_psd_kernel, B1 and B3 up to 16384 points)."""
    return kernel_resources(build_log, "reg_psd_kernel")


def four_step_resources(build_log: str):
    """kernel_resources of both launches of the four-step split
    (fft_common.cuh fs_cols_kernel, fs_rows_kernel: B1 and B3 at 32768,
    B4), each entry with its launch, "cols" or "rows"."""
    out = []
    for launch in ("cols", "rows"):
        for k in kernel_resources(build_log, f"fs_{launch}_kernel"):
            out.append(dict(k, launch=launch))
    return out


def ptxas_summary(res):
    """{nfft: [most registers, most spill bytes]} over ptxas entries."""
    return {n: [max(k["registers"] for k in res if k["nfft"] == n),
                max(k["spill_stores"] + k["spill_loads"] for k in res
                    if k["nfft"] == n)]
            for n in sorted({k["nfft"] for k in res})}


def four_step_launch_ms(samples_pm, starts, nfft: int, nint: int,
                        iters=20):
    """CUDA-event ms of the four-step split's launch 1 (columns) alone,
    launch 2 (rows) alone and the pair, over all columns of ``starts`` in
    one launch pair (welch, the default window): the two launches that
    kernels.big_cuda.four_step_psd makes per chunk of columns."""
    import torch

    from pyspectrogram_tpu_torch.kernels import _build, big_cuda

    nsub, ntime = samples_pm.shape[0] // 2, starts.shape[0]
    win, tw, inv = _build.psd_device_constants(
        nfft, nint, "welch", ("kaiser", 1.7), 1.0, samples_pm.device)
    work = torch.empty((ntime, nsub, nint, nfft, 2),
                       device=samples_pm.device)
    out = torch.empty((ntime, nsub, nfft), device=samples_pm.device)

    def cols():
        big_cuda.launch_cols(samples_pm, starts, nfft, nint, win, tw, work)

    def rows():
        big_cuda.launch_rows(work, nsub, ntime, nfft, nint, tw, inv, out)

    def pair():
        cols()
        rows()

    return {"cols_ms": event_ms(cols, iters=iters),
            "rows_ms": event_ms(rows, iters=iters),
            "pair_ms": event_ms(pair, iters=iters)}


def fft_alone_ms(samples_pm, starts, nfft: int, frame_len: int, iters=20):
    """torch.fft.fft over the same windowed complex frames a PSD kernel
    transforms (frames built outside the timing): the FFT alone, for
    context; no single PyTorch call computes window + FFT + |X|^2 + Welch
    sum + fftshift."""
    import torch

    st = starts.to(torch.int64)
    idx = st[:, None] + torch.arange(frame_len, device=samples_pm.device)
    fr = samples_pm[:, idx].to(torch.float32)
    c = torch.complex(fr[0::2], fr[1::2]).reshape(fr.shape[0] // 2, -1, nfft)
    c = c * torch.hann_window(nfft, periodic=True, device=c.device)
    return event_ms(lambda: torch.fft.fft(c), iters=iters)


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


def adversarial_cube(kind: str, n: int, cols: int, seed: int):
    """(n, cols) float32 cube for B2: exponential power, ties across the
    middle, +-0 / subnormals / +-inf, or all-equal columns."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind == "exponential":
        return rng.exponential(size=(n, cols)).astype(np.float32)
    if kind == "ties":
        p = rng.integers(0, 4, (n, cols)).astype(np.float32)
        p[:, ::3] = 2.0
        return p
    if kind == "specials":
        vals = np.array([-np.inf, -1.5, -1e-40, -1e-45, -0.0, 0.0, 1e-45,
                         1e-40, 1.17549435e-38, 3.0, np.inf], np.float32)
        p = vals[rng.integers(0, len(vals), (n, cols))]
        p[:, 0] = np.where(np.arange(n) % 2, np.float32(-0.0),
                           np.float32(0.0))
        p[:, 1] = np.where(np.arange(n) < n // 2, np.float32(-1e-45),
                           np.float32(0.0))
        return p
    p = np.empty((n, cols), np.float32)                 # all-equal columns
    p[:] = rng.exponential(size=cols).astype(np.float32)
    p[:, 0], p[:, 1], p[:, 2] = -0.0, np.inf, -np.inf
    return p


def b2_check(got, pd, p_host, what: str, batched: bool = False) -> None:
    """B2's result ``got`` bit-equal to median_bisect on the card and
    equal (NaN where NaN, -0 == +0) to np.median of the host copy."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch.ops import plain

    want = (torch.stack([plain.median_bisect(q) for q in pd]) if batched
            else plain.median_bisect(pd))
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"B2 is not median_bisect's bits: {what}")
    npm = np.median(p_host, axis=1 if batched else 0).astype(np.float32)
    check(np.array_equal(got.cpu().numpy(), npm, equal_nan=True),
          f"B2 is not np.median: {what}")


def b2_in(design: str, fn):
    """``fn()`` with kernel B2 forced into one of its designs (the wrapper
    picks by n through median_cuda.regime; the tile design's own check
    refuses an n whose tile does not fit)."""
    from pyspectrogram_tpu_torch.kernels import median_cuda

    pick = median_cuda.regime
    median_cuda.regime = lambda n: design
    try:
        return fn()
    finally:
        median_cuda.regime = pick


def phase_b2(dev, rng):
    """B2 against median_bisect (bits) and np.median (values): PR 1's
    exponential cubes with runs of duplicates, then adversarial cubes at
    n on both sides of the tile/radix boundary, odd and even, with column
    counts that take 16-byte loads and ones that do not, a misaligned
    buffer, and a batch of 7; each design the tile fits is run."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch.kernels import median_cuda

    cases = 0
    for n in (33, 64, 100, 128, 129):
        for m in (1, 2):
            for nfft in (1024, 4096):
                p = rng.exponential(size=(n, m, nfft)).astype(np.float32)
                p[: n // 3, :, : nfft // 4] = p[n // 3, :, : nfft // 4]
                pd = torch.from_numpy(p).to(dev)
                b2_check(median_cuda.median_over_time_cuda(pd), pd, p,
                         f"n={n} m={m} nfft={nfft}")
                cases += 1
    kinds = ("exponential", "ties", "specials", "equal")
    ns = (33, 34, 127, 128, 129, 682, 683, 2047, 2048, 14649, 14650)
    for n in ns:
        for kind in kinds:
            for cols in ((4096 if n < 4096 else 512), 37):
                p = adversarial_cube(kind, n, cols, seed=n + cols)
                pd = torch.from_numpy(p).to(dev)
                designs = ["radix"] + (["tile"] if median_cuda.regime(n)
                                       == "tile" else [])
                for design in designs:
                    got = b2_in(design, lambda: median_cuda
                                .median_over_time_cuda(pd))
                    b2_check(got, pd, p,
                             f"{kind} n={n} cols={cols} {design}")
                    cases += 1
        # a buffer 4 bytes off 16-byte alignment: the radix design's
        # 4-byte loads
        p = adversarial_cube("exponential", n, 64, seed=n)
        flat = torch.empty(p.size + 1, device=dev)
        pd = flat[1:].view(n, 64)
        pd.copy_(torch.from_numpy(p))
        got = b2_in("radix", lambda: median_cuda.median_over_time_cuda(pd))
        b2_check(got, pd, p, f"misaligned n={n}")
        cases += 1
    for n in (100, 2048, 2049):
        p = np.stack([adversarial_cube(kinds[b % 4], n, 1024, seed=10 * b)
                      for b in range(7)])
        pd = torch.from_numpy(p).to(dev)
        for design in ["radix"] + (["tile"] if median_cuda.regime(n)
                                   == "tile" else []):
            got = b2_in(design, lambda: median_cuda.median_over_time_cuda(
                pd, batched=True))
            b2_check(got, pd, p, f"batch of 7 n={n} {design}", batched=True)
            cases += 1
    emit({"phase": "b2_vs_plain", "cases": cases, "max_abs_err": 0.0,
          "adversarial_n": list(ns), "kinds": list(kinds)})


def phase_b3(dev, gen):
    """B3 against psd_torch at starts t*hop on seeded normal planes."""
    import torch

    from pyspectrogram_tpu_torch.kernels import stream_cuda
    from pyspectrogram_tpu_torch.ops import plain

    err, cases = 0.0, 0
    for nfft in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
        for hop in (nfft // 2, nfft // 4, 3 * nfft // 8 + 12):
            for mode, nint in (("welch", 1), ("welch", 2), ("parity", 2)):
                for nsub in (1, 2):
                    for k in (1, 5, 32):
                        width = nfft * nint - hop + k * hop
                        x = torch.randn((2 * nsub, width), generator=gen,
                                        device=dev)
                        kw = dict(nfft=nfft, nint=nint, mode=mode)
                        got = stream_cuda.stream_psd_cuda(x, hop=hop, **kw)
                        again = stream_cuda.stream_psd_cuda(x, hop=hop, **kw)
                        starts = torch.arange(k, dtype=torch.int32,
                                              device=dev) * hop
                        want = plain.psd_torch(x, starts, **kw)
                        torch.cuda.synchronize()
                        e = (got - want).abs().max().item()
                        check(torch.allclose(got, want, **LIN),
                              f"B3 disagrees at nfft={nfft} hop={hop} "
                              f"mode={mode} nint={nint} nsub={nsub} k={k}: "
                              f"max abs {e}")
                        check(torch.equal(got.view(torch.int32),
                                          again.view(torch.int32)),
                              f"B3 differs between two calls at nfft={nfft} "
                              f"hop={hop} mode={mode} k={k}")
                        err = max(err, e)
                        cases += 1
    emit({"phase": "b3_vs_plain", "cases": cases, "max_abs_err": err, **LIN,
          "bit_identical_reruns": cases})
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
    (launch counts of the runs, B3's numbers on the overlap2048 push
    buffer: ms, plain ms, error, FFT-alone ms and bound)."""
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
    b3 = dict(ms=b3_ms, plain_ms=b3_plain_ms, err=err,
              device_ms=device_ms(lambda: stream_cuda.stream_psd_cuda(
                  buf, nfft=nfft, hop=2048), iters=50),
              fft_alone_ms=fft_alone_ms(buf, starts, nfft, nfft, iters=200),
              bound=psd_bound((buf,), got, nfft, k * nsub))
    emit({"phase": "timing_b3_overlap2048", "card": card, "nfft": nfft,
          "hop": 2048, "k": k, "nsub": nsub, "b3_max_abs_err": err,
          "b3_ms": b3_ms, "b3_plain_ms": b3_plain_ms,
          "b3_device_ms": b3["device_ms"],
          "b3_fft_alone_ms": b3["fft_alone_ms"],
          "b3_bound_ms": b3["bound"][0], "b3_bound_by": b3["bound"][1]})
    return total, b3


def phase_live(dev, card, x, sr):
    """LiveStreamEngine at full width over an in-memory capture that grows
    from the first 31 s of ``x`` (two tones at ``sr``):
    cold start, ticks after appends, exact median, checkpoint + resume bit
    for bit, tick timing; the same at nfft 2^20 (B4); and the engine on
    the CPU at a 1 s window as the reference. Returns the launch counts,
    (B2's ms, its plain version's ms, the window's shape) and the tick's
    p50 and p90 ms."""
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
    # the library yardstick: torch.median, the same function at odd n
    med_k = median_cuda.median_over_time_cuda(window)
    lib_ms = event_ms(lambda: torch.median(window, dim=0).values, iters=5,
                      warm=1)
    lib_equal = torch.equal(torch.median(window, dim=0).values, med_k)
    win_dev_ms = device_ms(
        lambda: median_cuda.median_over_time_cuda(window), iters=5)
    b2_window = dict(ms=b2_ms, plain_ms=b2_plain_ms, library_ms=lib_ms,
                     device_ms=win_dev_ms,
                     library_bit_equal=lib_equal,
                     bound=median_bound(window, med_k),
                     shape=list(window.shape),
                     design=median_cuda.regime(window.shape[0]))
    del med_k
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
          "b2_window_device_ms": win_dev_ms,
          "b2_window_library": "torch.median",
          "b2_window_library_ms": lib_ms,
          "b2_window_library_bit_equal": lib_equal,
          "b2_window_bound_ms": b2_window["bound"][0],
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
    return total, b2_window, {"tick_p50_ms": tick_p50,
                              "tick_p90_ms": tick_p90}


def phase_b2_batched(dev, card, rng):
    """B2 over a batch of requests against its plain version
    (median_bisect per request) and np.median, bit for bit, at the merged
    launches' shapes and an odd n; then timed in turns against the plain
    version and against B solo launches, and beside torch.quantile's
    midpoint median over the same axis (the library yardstick). Returns
    {shape: dict of ms, plain_ms, solo_ms, library_ms, bound}."""
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
        q = pd.reshape(B, n, -1)

        def quantile():
            return torch.quantile(q, 0.5, dim=1, interpolation="midpoint")

        lib_ms = event_ms(quantile, iters=20)
        lib_equal = torch.equal(quantile().reshape(got.shape), got)
        dev_ms = device_ms(lambda: median_cuda.median_over_time_cuda(
            pd, batched=True))
        out[shape] = dict(ms=(k_ms + k2_ms) / 2, plain_ms=plain_ms,
                          device_ms=dev_ms,
                          solo_ms=solo_ms, library_ms=lib_ms,
                          library_bit_equal=lib_equal,
                          bound=median_bound(pd, got))
        emit({"phase": "b2_batched_vs_plain", "card": card,
              "shape": list(shape), "max_abs_err": 0.0,
              "batched_ms": out[shape]["ms"], "plain_ms": plain_ms,
              "solo_launches_ms": solo_ms, "device_ms": dev_ms,
              "library": "torch.quantile(midpoint)", "library_ms": lib_ms,
              "library_bit_equal": lib_equal,
              "bound_ms": out[shape]["bound"][0],
              "design": median_cuda.regime(n)})
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


#: the mesh phases' request shapes: the headline (nfft 4096, nint 4, ntime
#: 128, two subchannels), a batch of 7 requests at the reference default's
#: nfft 1024 over 100 columns, the distributed FFT at the reference's 2^20
#: ceiling, and the big-FFT STI at 2^18 (nint 1, 16 columns, two
#: subchannels); every input is made from a seed, the same on every rank
MESH_SR = 1_000_000
MESH_BATCH = dict(B=7, nfft=1024, ntime=100, nsub=2)
MESH_DIST_NFFT = 1 << 20
MESH_BIG = dict(nfft=1 << 18, nint=1, ntime=16, nsub=2)
#: the column-sharded pipeline at 2^18 takes 40 columns: at 32 or fewer
#: the time median is the sorting network, not kernel B2
MESH_BIG_PIPELINE = dict(MESH_BIG, ntime=40)
#: the big-FFT STI against the one-device program (the JAX package's own
#: big-FFT tolerance, tests/test_big_sti.py), and the distributed and GEMM
#: FFTs against a reference FFT, as a fraction of its largest |X|
BIG_DB_ATOL = 2e-2
FFT_REL_ATOL = 1e-4
MESH_RANKS = 4


def mesh_dir() -> Path:
    """build/mesh of this checkout: the FileStore of the NCCL phase and the
    results the one-card 2x2 phase compares with."""
    return Path(__file__).resolve().parent / "build" / "mesh"


def counted(fn):
    """(fn(), the launches it made): the counts set to 0 just before the
    call and read just after it, on a synchronised card."""
    import torch

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def mesh_paths(mesh, fft_mesh, dev) -> tuple:
    """The mesh paths on this rank, each against the one-device run on the
    same card and the same inputs:

    (a) StiPipeline(mesh=).compute() at the headline, float and display
        tile (column sharding: B1 per shard, B2 after the gather);
    (b) make_batched_sti_fn_mesh over 7 requests (B1, batched B2);
    (c) make_distributed_fft at 2^20 on ``fft_mesh``'s time axis;
    (d) make_bigfft_sti_fn at 2^18, float and tile;
    (g) StiPipeline(mesh=).compute() at 2^18 x 1 x 40 with nsub 2, which
        divides over chan: column sharding, B4 per shard, B2 after the
        gather;
    (f) ops.stft.median_over_time_psum of a time-sharded cube, bit for bit
        against np.median.

    Returns ({name: host array} of the mesh results, {path: CUDA-event ms
    of the mesh call and of the solo one, launches, errors}, the launches
    of all mesh calls)."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.display.tile import make_tile_spec
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.models import batch, sti
    from pyspectrogram_tpu_torch.ops import stft
    from pyspectrogram_tpu_torch.parallel import big_sti, dist_fft
    from pyspectrogram_tpu_torch.parallel import mesh as pmesh
    from pyspectrogram_tpu_torch.parallel.mesh import TIME_AXIS

    res, line = {}, {}
    total = {k: 0 for k in read_counts()}

    def path(name: str, run: dict, mesh_ms: float, solo_ms: float, **kw):
        add_counts(total, run)
        line[name] = {"ms": mesh_ms, "solo_ms": solo_ms, "launches": run,
                      **kw}

    # (a) the headline request through the pipeline
    tones = [MESH_SR / 16.0, MESH_SR / 8.0]
    ds = MemoryDataset(two_tone(128 * 4096 * 4, MESH_SR, tones,
                                noise_rms=1e-3, seed=1), MESH_SR)
    headline = SpectrogramConfig(nfft=4096, nint=4, ntime=128)
    for label, cfg in (("a_headline", headline),
                       ("a_display_tile", headline.replace(
                           display_tile=True))):
        pipe = sti.StiPipeline(ds, cfg, dev, mesh=mesh)
        solo = sti.StiPipeline(ds, cfg, dev)
        got, run = counted(pipe.compute)
        want = solo.compute()
        key = "tile" if cfg.display_tile else "sxx_dbfs"
        for f in (key, "sxx_med_dbfs"):
            res[f"{label}_{f}"] = getattr(got, f)
        check(np.array_equal(got.frame_starts, want.frame_starts)
              and np.array_equal(got.mask, want.mask),
              f"{label}: frame axes differ from the one-device request")
        bit_equal = all(np.array_equal(getattr(got, f), getattr(want, f))
                        for f in (key, "sxx_med_dbfs"))
        d_med = db_diff(got.sxx_med_dbfs, want.sxx_med_dbfs, axis=0)
        err = {"bit_equal": bit_equal, "max_db_diff_med": d_med}
        if cfg.display_tile:
            err["tile_pixels_off"] = check_tiles(got.tile, want.tile, label)
        else:
            err["max_db_diff"] = db_diff(got.sxx_dbfs, want.sxx_dbfs, axis=0)
        check(max(v for k, v in err.items() if k.startswith("max_db"))
              <= 1e-3, f"{label}: the mesh request differs from the "
                       f"one-device one: {err}")
        path(label, run, event_ms(pipe.compute, iters=5, warm=1),
             event_ms(solo.compute, iters=5, warm=1), **err)

    # (g) the pipeline at 2^18: nsub divides over chan, so the request
    # column-shards with kernel B4 on each shard and B2 after the gather
    # (the tier a meshed request takes at big nfft; (d) is the one taken
    # when nsub does not divide)
    big = SpectrogramConfig(nfft=MESH_BIG_PIPELINE["nfft"],
                            nint=MESH_BIG_PIPELINE["nint"],
                            ntime=MESH_BIG_PIPELINE["ntime"])
    ds_big = MemoryDataset(two_tone(big.nfft * big.nint * big.ntime, MESH_SR,
                                    tones, noise_rms=1e-3, seed=2), MESH_SR)
    pipe = sti.StiPipeline(ds_big, big, dev, mesh=mesh)
    solo = sti.StiPipeline(ds_big, big, dev)
    check(not pipe._use_bigfft(big, MESH_BIG_PIPELINE["nsub"]),
          "g_pipeline_big: the pipeline picks the distributed FFT")
    got, run = counted(pipe.compute)
    check(run["big_psd"] > 0 and run["median"] > 0,
          f"g_pipeline_big: launched B4 {run['big_psd']}x, "
          f"B2 {run['median']}x")
    want = solo.compute()
    for f in ("sxx_dbfs", "sxx_med_dbfs"):
        res[f"g_pipeline_big_{f}"] = getattr(got, f)
    err = {"bit_equal": all(np.array_equal(getattr(got, f), getattr(want, f))
                            for f in ("sxx_dbfs", "sxx_med_dbfs")),
           "max_db_diff": db_diff(got.sxx_dbfs, want.sxx_dbfs),
           "max_db_diff_med": db_diff(got.sxx_med_dbfs, want.sxx_med_dbfs)}
    check(max(err["max_db_diff"], err["max_db_diff_med"]) <= 1e-3,
          f"g_pipeline_big: the mesh request differs from the one-device "
          f"one: {err}")
    path("g_pipeline_big", run, event_ms(pipe.compute, iters=3, warm=1),
         event_ms(solo.compute, iters=3, warm=1), **err)

    # (b) 7 requests merged over the time axis
    B, nfft, ntime, nsub = (MESH_BATCH[k] for k in ("B", "nfft", "ntime",
                                                    "nsub"))
    fn = batch.make_batched_sti_fn_mesh(mesh, nfft=nfft, ntime=ntime, B=B)
    rng = np.random.default_rng(21)
    merged = np.zeros((2 * nsub, fn.padded_cols * nfft), np.float32)
    merged[:, :B * ntime * nfft] = rng.standard_normal(
        (2 * nsub, B * ntime * nfft))
    inv = (1.0 / np.arange(1, B + 1) ** 2).astype(np.float32)
    local = torch.from_numpy(np.ascontiguousarray(pmesh.local_shard(
        merged, mesh, fn.input_specs()[0]))).to(dev)
    out, run = counted(lambda: fn(local, inv))
    got = {k: pmesh.assemble(v, mesh, fn.output_specs[k]).cpu().numpy()
           for k, v in out.items()}
    got["sxx_dbfs"] = got["sxx_dbfs"][:B * ntime].reshape(B, ntime, nsub,
                                                         nfft)
    solo_fn = batch.make_batched_sti_fn_pm(nfft=nfft, ntime=ntime)
    xd = torch.from_numpy(merged[:, :B * ntime * nfft]).to(dev)
    want = {k: v.cpu().numpy() for k, v in solo_fn(xd, inv).items()}
    for k in got:
        res[f"b_{k}"] = got[k]
    err = {"bit_equal": all(np.array_equal(got[k], want[k]) for k in got),
           "max_db_diff": max(db_diff(got[k], want[k], 30.0) for k in got)}
    check(err["max_db_diff"] <= 1e-3, f"b_batch: {err}")
    path("b_batch", run, event_ms(lambda: fn(local, inv), iters=10, warm=2),
         event_ms(lambda: solo_fn(xd, inv), iters=10, warm=2), **err)

    # (c) the distributed 4-step FFT at 2^20
    fft = dist_fft.make_distributed_fft(fft_mesh, TIME_AXIS, MESH_DIST_NFFT)
    n1, n2 = fft.n1n2
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(MESH_DIST_NFFT)
         + 1j * rng.standard_normal(MESH_DIST_NFFT)).astype(np.complex64)
    planes = [torch.from_numpy(np.ascontiguousarray(pmesh.local_shard(
        a, fft_mesh, fft.input_spec))).to(dev)
        for a in (x.real.reshape(n1, n2), x.imag.reshape(n1, n2))]
    (xr, xi), run = counted(lambda: fft(*planes))
    xr, xi = (pmesh.assemble(v, fft_mesh, sp).cpu().numpy()
              for v, sp in zip((xr, xi), fft.output_specs))
    got = (dist_fft.reference_order(xr)
           + 1j * dist_fft.reference_order(xi)).astype(np.complex64)
    xd = torch.from_numpy(x).to(dev)
    want = torch.fft.fft(xd).cpu().numpy()
    res["c_fft"] = got
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(rel <= FFT_REL_ATOL, f"c_dist_fft: max error {rel} of max |X|")
    path("c_dist_fft", run, event_ms(lambda: fft(*planes), iters=10),
         event_ms(lambda: torch.fft.fft(xd), iters=10),
         max_err_of_max_abs=rel, n1n2=[n1, n2])

    # (d) the big-FFT STI at 2^18, float and display tile
    nfft, nint, ntime, nsub = (MESH_BIG[k] for k in ("nfft", "nint",
                                                     "ntime", "nsub"))
    rng = np.random.default_rng(8)
    pm = (0.3 * rng.standard_normal((2 * nsub, ntime * nfft))).astype(
        np.float32)
    pd = torch.from_numpy(pm).to(dev)
    sd = stft.hop_starts(ntime, nfft, dev)
    freqs = stft.shifted_freqs(nfft, MESH_SR)
    spec = make_tile_spec(freqs, (-200.0, 200.0), (-80.0, -20.0))
    for label, tile in (("d_bigfft", None), ("d_bigfft_tile", spec)):
        fn = big_sti.make_bigfft_sti_fn(mesh, TIME_AXIS, nfft=nfft,
                                        nint=nint, tile=tile)
        n1, n2 = fn.n1n2
        frames = np.ascontiguousarray(
            pm.reshape(nsub, 2, ntime, nfft).transpose(2, 0, 1, 3))
        x2 = big_sti.frames_to_x2(frames, nfft, fn.nseg, n1, n2)
        local = torch.from_numpy(np.ascontiguousarray(pmesh.local_shard(
            x2, mesh, fn.input_spec))).to(dev)
        args = (local,) if tile is None else (local, spec.qparams)
        out, run = counted(lambda: fn(*args))
        got = {k: v.cpu().numpy() if k == "tile" else big_sti.to_freq_order(
            pmesh.assemble(v, mesh, fn.output_specs[k]).cpu().numpy())
            for k, v in out.items()}
        solo_fn = stft.make_sti_fn_pm(nfft=nfft, nint=nint, contiguous=True,
                                      tile=tile)
        want = {k: v.cpu().numpy() for k, v in solo_fn(pd, sd).items()}
        for k in got:
            res[f"{label}_{k}"] = got[k]
        err = {"max_db_diff_med": float(np.abs(
            got["sxx_med_dbfs"] - want["sxx_med_dbfs"]).max())}
        if tile is None:
            err["max_db_diff"] = float(np.abs(
                got["sxx_dbfs"] - want["sxx_dbfs"]).max())
        else:
            err["tile_pixels_off"] = check_tiles(got["tile"], want["tile"],
                                                 label)
        check(max(v for k, v in err.items() if k.startswith("max_db"))
              <= BIG_DB_ATOL, f"{label}: {err}")
        path(label, run, event_ms(lambda: fn(*args), iters=5, warm=1),
             event_ms(lambda: solo_fn(pd, sd), iters=5, warm=1), **err)

    # (f) the summed-bisection median of a time-sharded cube
    rng = np.random.default_rng(5)
    p = rng.exponential(size=(128, 2, 4096)).astype(np.float32)
    local = torch.from_numpy(np.ascontiguousarray(pmesh.local_shard(
        p, mesh, (TIME_AXIS, None, None)))).to(dev)
    med, run = counted(lambda: stft.median_over_time_psum(
        local, mesh, TIME_AXIS, ntime_valid=128))
    check(np.array_equal(med.cpu().numpy(), np.median(p, axis=0)),
          "f_psum_median: not np.median bit for bit")
    path("f_psum_median", run, event_ms(lambda: stft.median_over_time_psum(
        local, mesh, TIME_AXIS, ntime_valid=128), iters=5, warm=1),
        event_ms(lambda: stft.median_over_time(torch.from_numpy(p).to(dev)),
                 iters=5, warm=1), bit_equal_np_median=True)
    return res, line, total


def gemm_dft_path(dev) -> dict:
    """(e) make_sti_fn(fft_impl="gemm") at the headline against
    fft_impl="xla", and the GEMM DFT of 64 of its frames against a float64
    numpy FFT, with the caller's TF32 switch on; a complex64 GEMM DFT under
    the same switch shows what TF32 would cost."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch.kernels import gemm_fft
    from pyspectrogram_tpu_torch.ops import stft

    nfft, nint, ntime = 4096, 4, 128
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((nfft * nint * ntime, 2))
         + 1j * rng.standard_normal((nfft * nint * ntime, 2))).astype(
        np.complex64)
    xd = torch.from_numpy(x).to(dev)
    sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
    kw = dict(nfft=nfft, nint=nint, return_linear=True)
    gemm, xla = (stft.make_sti_fn(fft_impl=f, **kw) for f in ("gemm", "xla"))
    frames = xd[: 64 * nfft, 0].reshape(64, nfft)
    want = np.fft.fft(frames.cpu().numpy().astype(np.complex128))
    plan = gemm_fft.make_plan(nfft)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True   # a caller allowing TF32
    try:
        got, want_sti = gemm(xd, sd), xla(xd, sd)
        big = gemm_fft.make_gemm_fft(nfft)(frames).cpu().numpy()
        d1, d2, tw = (torch.from_numpy((r + 1j * i).astype(np.complex64)).to(
            dev) for r, i in ((plan.d1r, plan.d1i), (plan.d2r, plan.d2i),
                              (plan.twr, plan.twi)))
        c64 = torch.matmul(torch.matmul(d1, frames.reshape(
            64, plan.n1, plan.n2)) * tw, d2).transpose(-1, -2).reshape(
            64, nfft).cpu().numpy()
        gemm_ms = event_ms(lambda: gemm(xd, sd), iters=10)
        xla_ms = event_ms(lambda: xla(xd, sd), iters=10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    scale = np.abs(want).max()
    rel = float(np.abs(big - want).max() / scale)
    check(rel <= FFT_REL_ATOL, f"e_gemm: max error {rel} of max |X|")
    check(torch.allclose(got["sxx"], want_sti["sxx"], **LIN),
          "e_gemm: the GEMM STI disagrees with the torch.fft one by "
          f"{(got['sxx'] - want_sti['sxx']).abs().max().item()}")
    return {"ms": gemm_ms, "solo_ms": xla_ms, "max_err_of_max_abs": rel,
            "complex64_tf32_err_of_max_abs": float(
                np.abs(c64 - want).max() / scale),
            "sxx_max_abs_diff_vs_xla": (
                got["sxx"] - want_sti["sxx"]).abs().max().item()}


#: (h), the streaming mesh: the bench's stream shapes (nfft 4096, two
#: subchannels, 8 columns a push, a 256-column ring), B4's push (nfft
#: 65536, nint 1, 4 columns, a 16-column ring), phase_live's full-width
#: engine (a 30 s window of a 1 MS/s capture, hop 2048) over a capture of
#: MESH_LIVE_SECONDS, and the timed ticks after 0.1 s appends
MESH_STREAM = dict(nfft=4096, nsub=2, k=8, ring_len=256)
MESH_STREAM_BIG = dict(nfft=1 << 16, k=4, ring_len=16)
MESH_LIVE_SECONDS = 36
MESH_LIVE_TICKS = 10


def streaming_mesh_paths(mesh, dev, one_device: bool) -> tuple:
    """(h) the streaming mesh on this rank:

    - StreamingSti(mesh=) at the bench's stream shapes, ``exact`` (B1 per
      rank) and ``overlap2048`` (B3 per rank): pushes that wrap the ring,
      then refresh_view with a display tile and a 200-column median (B2
      per rank), and each push timed; one push at nfft 65536 (B4 per rank)
      with its dB columns gathered. Each against the one-device stream on
      the same card and blocks, bit for bit;
    - LiveStreamEngine(mesh=) at phase_live's full width: a cold start,
      three ticks after the capture grows by 1 s, save, resume(mesh=) and
      a tick bit for bit the pre-save one, the meshed checkpoint in the
      one-device resume (global rank 0), then MESH_LIVE_TICKS ticks timed
      after 0.1 s appends;
    - a streaming SpectrogramProcessor(mesh=) preloaded from that
      checkpoint, two iterations.

    With ``one_device`` (the 1x1 phase) the engine and the processor also
    run on one device over the same capture, tick for tick, and must
    equal the meshed ones bit for bit; the 2x2 phase holds its outputs to
    the 1x1 phase's instead (mesh_rank). Returns ({name: host array},
    {path: numbers}, the launches of the meshed calls)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.display.tile import make_tile_spec
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.models.streaming import StreamingSti
    from pyspectrogram_tpu_torch.ops import stft
    from pyspectrogram_tpu_torch.parallel import mesh as pmesh
    from pyspectrogram_tpu_torch.parallel.mesh import CHAN_AXIS, TIME_AXIS
    from pyspectrogram_tpu_torch.runtime import (
        LiveStreamEngine,
        ProcessorCallbacks,
        SpectrogramProcessor,
    )

    sr = MESH_SR
    res, line = {}, {}
    total = {k: 0 for k in read_counts()}

    def mesh_call(fn):
        out, run = counted(fn)
        add_counts(total, run)
        return out, run

    x = long_two_tone(MESH_LIVE_SECONDS * sr, noise_rms=1e-3, seed=2)
    pm = np.ascontiguousarray(x[:2 * sr].view(np.float32).T)   # 4 planes
    nfft, nsub, k, ring_len = (MESH_STREAM[f] for f in ("nfft", "nsub", "k",
                                                        "ring_len"))
    spec = make_tile_spec(stft.shifted_freqs(nfft, sr), (-500.0, 500.0),
                          COLOR_RANGE_DB)

    def pushes_ms(s, blk):
        """CUDA-event ms a push of the device block ``blk``, over 100."""
        box = [s.init_state()]

        def step():
            box[0], _ = s.push(box[0], blk, return_db=False)

        return event_ms(step, iters=100, warm=10)

    for label, hop in (("exact", None), (f"overlap{nfft // 2}", nfft // 2)):
        block_len = k * (hop or nfft)
        blocks = [pm[:, i * block_len:(i + 1) * block_len]
                  for i in range(ring_len // k + 8)]          # wraps
        kw = dict(nfft=nfft, nint=1, nsub=nsub, block_len=block_len,
                  hop=hop, ring_len=ring_len)
        meshed = StreamingSti(device=dev, mesh=mesh, **kw)
        solo = StreamingSti(device=dev, **kw)

        def run(s):
            st = s.init_state()
            for b in blocks:
                st, _ = s.push(st, b, return_db=False)
            tile, med = s.refresh_view(st, 32, 7, spec=spec, n_med=200)
            view, _ = s.refresh_view(st, 32, 7, n_med=200)
            return {"tile": tile, "view": view, "median": med,
                    "ring_median": s.median_psd(st)}

        got, run_counts = mesh_call(lambda: run(meshed))
        want = run(solo)
        kernel = "sti_psd" if hop is None else "stream_psd"
        check(run_counts[kernel] > 0 and run_counts["median"] > 0,
              f"h_stream_{label}: launches {run_counts}")
        bit_equal = all(np.array_equal(got[f], want[f]) for f in got)
        check(bit_equal, f"h_stream_{label}: the meshed stream differs "
                         "from the one-device one")
        for f, v in got.items():
            res[f"h_stream_{label}_{f}"] = v
        blk = torch.from_numpy(blocks[0]).to(dev)
        line[f"h_stream_{label}"] = {
            "pushes": len(blocks), "launches": run_counts,
            "bit_equal": bit_equal, "push_ms": pushes_ms(meshed, blk),
            "solo_push_ms": pushes_ms(solo, blk)}

    big = MESH_STREAM_BIG
    kw = dict(nfft=big["nfft"], nint=1, nsub=nsub,
              block_len=big["k"] * big["nfft"], ring_len=big["ring_len"])
    blk = pm[:, :kw["block_len"]]
    meshed = StreamingSti(device=dev, mesh=mesh, **kw)
    solo = StreamingSti(device=dev, **kw)
    (_, cols), run_counts = mesh_call(lambda: meshed.push(
        meshed.init_state(), blk))
    _, want = solo.push(solo.init_state(), blk)
    check(run_counts["big_psd"] > 0, f"h_stream_b4: launches {run_counts}")
    check(torch.equal(cols, want), "h_stream_b4: the meshed push's dB "
                                   "columns differ from the one-device one's")
    res["h_stream_b4_cols"] = cols.cpu().numpy()
    line["h_stream_b4"] = {"nfft": big["nfft"], "k": big["k"],
                           "launches": run_counts, "bit_equal": True}
    del meshed, solo, cols, want

    # the full-width live engine over a capture that grows between ticks
    cfg = SpectrogramConfig(nfft=4096, hop=2048, ntime=100,
                            stream_seconds=30.0, display_tile=True,
                            color_range_db=COLOR_RANGE_DB, streaming=True)
    pos = 31 * sr
    ds = MemoryDataset(x[:pos], sr)
    fields = ("tile", "sxx_med_dbfs", "frame_starts", "times", "mask")

    def grow(n):
        nonlocal pos
        ds.append(x[pos:pos + n])
        pos += n
        ds.bnds_update()

    def same(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in fields)

    t0 = time.perf_counter()
    eng, _ = mesh_call(lambda: LiveStreamEngine(ds, cfg, dev, mesh=mesh))
    ticks = [mesh_call(lambda: eng.tick(cfg))[0]]
    cold_s = time.perf_counter() - t0
    solo = LiveStreamEngine(ds, cfg, dev) if one_device else None
    solo_equal = None if solo is None else same(ticks[0], solo.tick(cfg))
    for _ in range(3):
        grow(sr)
        ticks.append(mesh_call(lambda: eng.tick(cfg))[0])
        if solo is not None:
            solo_equal = solo_equal and same(ticks[-1], solo.tick(cfg))
    check(solo_equal is not False, "h_live: a meshed tick differs from the "
                                   "one-device engine's")
    pre = ticks[-1]
    med = pre.sxx_med_dbfs
    for s_, f in enumerate((sr / 16.0, sr / 8.0)):
        b = int(med[:, s_].argmax())
        check(abs(pre.freqs[b] - f) <= sr / len(pre.freqs)
              and abs(med[b, s_]) <= 0.1,
              f"h_live: sub {s_} peak {med[b, s_]} dBFS at {pre.freqs[b]}")
    check(pre.tile.shape[1] == nsub and pre.mask.all(), "h_live: tile/mask")
    for f in ("tile", "sxx_med_dbfs", "frame_starts"):
        res[f"h_live_{f}"] = getattr(pre, f)
    # save, resume on the mesh, tick with no new samples: the pre-save tick
    tp, cp = (pmesh.axis_size(mesh, a) for a in (TIME_AXIS, CHAN_AXIS))
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    path = eng.save(mesh_dir() / f"live_{tp}x{cp}.npz")
    save_s = time.perf_counter() - t0
    save_peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
    t0 = time.perf_counter()
    eng2, _ = mesh_call(lambda: LiveStreamEngine.resume(ds, cfg, path, dev,
                                                        mesh=mesh))
    resume_s = time.perf_counter() - t0
    resumed_equal = same(mesh_call(lambda: eng2.tick(cfg))[0], pre)
    check(resumed_equal, "h_live: the resumed tick differs from the "
                         "pre-save one")
    del eng2
    solo_resume_equal = None
    if dist.get_rank() == 0:
        e1 = LiveStreamEngine.resume(ds, cfg, path, dev)
        solo_resume_equal = same(e1.tick(cfg), pre)
        check(solo_resume_equal, "h_live: the one-device resume of the "
                                 "meshed checkpoint differs")
        del e1
    walls, solo_walls = [], []
    for _ in range(MESH_LIVE_TICKS):
        ds.append(x[pos:pos + sr // 10])
        pos += sr // 10
        t0 = time.perf_counter()
        ds.bnds_update()
        eng.tick(cfg)
        walls.append(time.perf_counter() - t0)
        if solo is not None:
            t0 = time.perf_counter()
            ds.bnds_update()
            solo.tick(cfg)
            solo_walls.append(time.perf_counter() - t0)
    ring_bytes = eng.state.ring.numel() * 4
    del eng, solo
    live = {"cold_start_s": cold_s, "ticks_checked": len(ticks),
            "ring_bytes_on_this_rank": ring_bytes,
            "save_s": save_s, "save_device_peak_mb": save_peak_mb,
            "resume_s": resume_s,
            "resumed_bit_equal": resumed_equal,
            "solo_resume_bit_equal": solo_resume_equal,
            "tick_n": len(walls),
            "tick_p50_ms": float(np.percentile(walls, 50) * 1e3),
            "tick_p90_ms": float(np.percentile(walls, 90) * 1e3)}
    if solo_walls:
        live.update(solo_bit_equal=solo_equal,
                    solo_tick_p50_ms=float(np.percentile(solo_walls, 50)
                                           * 1e3),
                    solo_tick_p90_ms=float(np.percentile(solo_walls, 90)
                                           * 1e3))
    line["h_live"] = live

    # a streaming processor on the mesh, preloaded from the checkpoint
    def processor(m):
        events = []
        proc = SpectrogramProcessor(
            "streaming", ds, 0, cfg,
            callbacks=ProcessorCallbacks(on_iterated=events.append),
            streaming_sleep=0.0, max_iterations=2, device=dev, mesh=m)
        proc.preload_live_state(path)
        proc.run()
        check(len(events) == 2 and proc.reason is not None
              and int(proc.reason) == 0,
              f"h_processor: {len(events)} iterations, reason {proc.reason}")
        return events[-1]

    t0 = time.perf_counter()
    it, run_counts = mesh_call(lambda: processor(mesh))
    proc_s = time.perf_counter() - t0
    check(run_counts["stream_psd"] > 0 and run_counts["median"] > 0,
          f"h_processor: launches {run_counts}")
    for f in ("tile", "sxx_med_dbfs"):
        res[f"h_processor_{f}"] = getattr(it, f)
    proc_line = {"iterations": 2, "seconds": proc_s, "launches": run_counts}
    if one_device:
        want = processor(None)
        proc_line["solo_bit_equal"] = all(
            np.array_equal(getattr(it, f), getattr(want, f))
            for f in ("tile", "sxx_med_dbfs", "times", "mask"))
        check(proc_line["solo_bit_equal"], "h_processor: the meshed "
                                           "processor differs from the "
                                           "one-device one")
    line["h_processor"] = proc_line
    return res, line, total


def check_stream_mesh_launches(run: dict, what: str) -> None:
    check(all(run[k] > 0 for k in ("sti_psd", "stream_psd", "median",
                                   "big_psd")),
          f"{what}: the streaming mesh launched B1 {run['sti_psd']}x, B2 "
          f"{run['median']}x, B3 {run['stream_psd']}x, B4 {run['big_psd']}x")


def check_mesh_launches(run: dict, what: str) -> None:
    check(run["sti_psd"] > 0 and run["median"] > 0
          and run["median_batched"] > 0 and run["big_psd"] > 0,
          f"{what}: launched B1 {run['sti_psd']}x, B2 {run['median']}x, "
          f"batched B2 {run['median_batched']}x, B4 {run['big_psd']}x")


def phase_mesh_1x1_nccl(dev, card, live_ticks: dict) -> dict:
    """The mesh paths on a 1x1 mesh over NCCL in this process (the device
    transport; every axis has one rank, so no collective is called), the
    streaming mesh (h) against the one-device objects, and the GEMM DFT;
    saves the results under build/mesh for the 2x2 phase. ``live_ticks``
    (phase_live's tick p50/p90) is printed beside (h)'s. Returns the
    launches."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyspectrogram_tpu_torch.parallel import make_mesh

    d = mesh_dir()
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    # bind this process's card before the mesh ("cuda" is the current one)
    torch.cuda.set_device(torch.cuda.current_device() if dev.index is None
                          else dev.index)
    dist.init_process_group("nccl", store=dist.FileStore(str(d / "store"), 1),
                            rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        mesh = make_mesh("cuda")
        res, line, run = mesh_paths(mesh, mesh, dev)
        line["e_gemm"] = gemm_dft_path(dev)
        seconds = time.perf_counter() - t0
        h_res, h_line, h_run = streaming_mesh_paths(mesh, dev,
                                                    one_device=True)
        h_seconds = time.perf_counter() - t0 - seconds
    finally:
        dist.destroy_process_group()
    check_mesh_launches(run, "mesh_1x1_nccl")
    check_stream_mesh_launches(h_run, "mesh_1x1_nccl (h)")
    np.savez(d / "mesh_1x1.npz", **res, **h_res)
    h_line["h_live"]["solo_live_full_width"] = live_ticks
    emit({"phase": "mesh_1x1_nccl", "card": card, "mesh": [1, 1],
          "backend": "nccl", "seconds": seconds, "paths": line,
          "launches": run})
    emit({"phase": "mesh_1x1_nccl_streaming", "card": card, "mesh": [1, 1],
          "backend": "nccl", "seconds": h_seconds, "paths": h_line,
          "launches": h_run})
    add_counts(run, h_run)
    return run


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_rank(rank: int, world: int, port: int, card: str,
              live_ticks: dict) -> None:
    """One rank of the one-card 2x2 phase (torch.multiprocessing, spawn):
    gloo over localhost, every rank on cuda:0, the mesh paths on a 2x2
    mesh and the distributed FFT on a 4x1 one. Rank 0 gathers every rank's
    launches, compares with the 1x1 phase's results, prints the phase's
    line and writes its launches under build/mesh."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyspectrogram_tpu_torch.parallel import make_mesh
    from pyspectrogram_tpu_torch.parallel import mesh as pmesh
    from pyspectrogram_tpu_torch.parallel.mesh import TIME_AXIS

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        t0 = time.perf_counter()
        mesh = make_mesh("cuda", 2, 2)
        mesh41 = make_mesh("cuda", 4, 1)
        dev = pmesh.mesh_device(mesh)
        res, line, run = mesh_paths(mesh, mesh41, dev)
        seconds = time.perf_counter() - t0
        h_res, h_line, h_run = streaming_mesh_paths(mesh, dev,
                                                    one_device=False)
        h_seconds = time.perf_counter() - t0 - seconds
        counts = {**run, **{f"h_{k}": v for k, v in h_run.items()}}
        keys = sorted(counts)
        mine = torch.tensor([[counts[k] for k in keys]], device=dev)
        every = pmesh.all_gather(mine, mesh41, TIME_AXIS, dim=0).cpu()
    finally:
        dist.destroy_process_group()
    if rank:
        return
    ranks = [dict(zip(keys, map(int, row))) for row in every.tolist()]
    h_ranks = [{k: c[f"h_{k}"] for k in h_run} for c in ranks]
    ranks = [{k: c[k] for k in run} for c in ranks]
    for r, (c, hc) in enumerate(zip(ranks, h_ranks)):
        check_mesh_launches(c, f"mesh_2x2_one_card rank {r}")
        check_stream_mesh_launches(hc, f"mesh_2x2_one_card (h) rank {r}")
    one = np.load(mesh_dir() / "mesh_1x1.npz")
    vs = {}
    for k, v in {**res, **h_res}.items():
        w = one[k]
        check(v.shape == w.shape, f"mesh_2x2 {k}: {v.shape} vs {w.shape}")
        if k.startswith("h_"):
            # the streaming mesh: bit for bit the 1x1 mesh's output
            vs[k] = {"bit_equal": bool(np.array_equal(v, w))}
            check(vs[k]["bit_equal"], f"mesh_2x2 {k} differs from the 1x1 "
                                      "mesh's")
            continue
        if v.dtype == np.uint8:
            vs[k] = {"pixels_off": check_tiles(v, w, f"mesh_2x2 {k}")}
            continue
        diff = np.abs(v.astype(np.complex128) - w)
        vs[k] = {"bit_equal": bool(np.array_equal(v, w)),
                 "max_abs_diff": float(diff.max())}
        if k == "c_fft":
            # both against the same reference FFT, each within FFT_REL_ATOL
            ok = diff.max() <= 2 * FFT_REL_ATOL * np.abs(w).max()
        elif k.startswith("d_"):
            ok = diff.max() <= BIG_DB_ATOL
        else:
            # dB of the column-sharded tiers: the linear powers at the
            # standing kernel tolerance
            ok = np.allclose(10.0 ** (v / 10.0), 10.0 ** (w / 10.0), **LIN)
        check(ok, f"mesh_2x2 {k} differs from the 1x1 mesh's: {vs[k]}")
    total = {k: sum(c[k] + hc[k] for c, hc in zip(ranks, h_ranks))
             for k in run}
    h_line["h_live"]["solo_live_full_width"] = live_ticks
    emit({"phase": "mesh_2x2_one_card", "card": card, "mesh": [2, 2],
          "fft_mesh": [4, 1], "backend": "gloo", "ranks_on_one_card": world,
          "seconds": seconds, "paths": line,
          "vs_mesh_1x1": {k: v for k, v in vs.items()
                          if not k.startswith("h_")},
          "launches_by_rank": ranks,
          "launches": {k: sum(c[k] for c in ranks) for k in run}})
    emit({"phase": "mesh_2x2_one_card_streaming", "card": card,
          "mesh": [2, 2], "backend": "gloo", "ranks_on_one_card": world,
          "seconds": h_seconds, "paths": h_line,
          "vs_mesh_1x1": {k: v for k, v in vs.items()
                          if k.startswith("h_")},
          "launches_by_rank": h_ranks,
          "launches": {k: sum(c[k] for c in h_ranks) for k in h_run}})
    (mesh_dir() / "mesh_2x2.json").write_text(json.dumps(total))


def phase_mesh_2x2_one_card(card, live_ticks: dict) -> dict:
    """Four ranks spawned on the one card (mesh_rank); a rank's exception
    fails the run, and ranks still running after 600 s are killed and fail
    it. Returns the launches of every rank."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(mesh_rank, args=(MESH_RANKS, _free_port(), card,
                                              live_ticks),
                             nprocs=MESH_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            fail("mesh_2x2_one_card: ranks still running after 600 s")
    return json.loads((mesh_dir() / "mesh_2x2.json").read_text())


#: the launch counters each bench row must move (kernels.*'s counters, as
#: read_counts names them); every other counter must stay at 0. The xla
#: rows run torch.fft and B2 alone; B4 takes the PSD at nfft 65536
BENCH_ROW_KERNELS = {
    **{f"sti/{n}/auto/{m}": {"sti_psd", "median"} for n in (1024, 4096)
       for m in ("welch", "parity")},
    **{f"sti/65536/auto/{m}": {"big_psd", "median"}
       for m in ("welch", "parity")},
    **{f"sti/{n}/xla/{m}": {"median"} for n in (1024, 4096, 65536)
       for m in ("welch", "parity")},
    "stream/4096/exact": {"sti_psd"},
    "stream/4096/overlap2048": {"stream_psd"},
    "display/4096/refresh": {"sti_psd"},
    "mtab/7/display": {"sti_psd", "median", "median_batched"},
}


def phase_bench(dev, card, program_ms: float) -> dict:
    """The port's bench (pyspectrogram_tpu_torch.bench) on the card at the
    JAX bench's default shapes (nint 4, ntime 128, nsub 2): every row of
    run_all, each present with finite positive numbers and launches that
    show its kernels (BENCH_ROW_KERNELS), then main's headline line, whose
    p50_ms is printed beside phase 5's device_program_ms at the same shape
    (no check between them). Returns the phase's launch counts."""
    import contextlib
    import io
    import math

    import torch

    from pyspectrogram_tpu_torch import bench

    args = bench.build_parser().parse_args(["--device", str(dev)])
    reset_counts()
    t0 = time.perf_counter()
    rows = bench.run_all(args, dev)
    headline = io.StringIO()
    with contextlib.redirect_stdout(headline):
        rc = bench.main(["--device", str(dev)])
    torch.cuda.synchronize()
    run = read_counts()
    seconds = time.perf_counter() - t0
    check([r["key"] for r in rows] == list(bench.ROW_KEYS),
          f"bench: rows {[r['key'] for r in rows]}")
    for row in rows:
        nums = {k: v for k, v in row.items() if k not in ("key", "launches")}
        check(nums and all(isinstance(v, (int, float)) and math.isfinite(v)
                           and v > 0 for v in nums.values()),
              f"bench: row {row['key']} holds {nums}")
        want, got = BENCH_ROW_KERNELS[row["key"]], row["launches"]
        check(all(got[k] > 0 for k in want)
              and all(v == 0 for k, v in got.items() if k not in want),
              f"bench: row {row['key']} launched {got}, expected {want}")
        emit({"phase": "bench_row", **row, "card": card})
    check(rc == 0, f"bench: main returned {rc}")
    head = json.loads(headline.getvalue().strip().splitlines()[-1])
    check(head["metric"] == "sti_throughput_c64_nfft4096"
          and head["card"] == card
          and all(math.isfinite(head[k]) and head[k] > 0
                  for k in ("value", "p50_ms", "stream_p50_ms")),
          f"bench: headline {head}")
    emit({"phase": "bench_headline", **head,
          "timing_headline_device_program_ms": program_ms,
          "rows": len(rows), "seconds": seconds, "launches": run})
    return run


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
    card = card_of(dev)
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
    reg = reg_kernel_resources(_build.build_log)
    fs = four_step_resources(_build.build_log)
    for k in reg + fs:
        print(f"ptxas {k['kernel']}: {k['registers']} registers, "
              f"{k['spill_stores']} B spill stores, {k['spill_loads']} B "
              f"spill loads, {k['stack']} B stack", file=sys.stderr)
    check((reg and fs) or not _build.build_log,
          "the build log has no ptxas lines for the register-pass kernel "
          "or the four-step split")
    check(all(k["spill_stores"] == k["spill_loads"] == 0 for k in reg),
          "ptxas spilled in the register-pass kernel: "
          f"{[k for k in reg if k['spill_stores'] or k['spill_loads']]}")
    emit({"phase": "ptxas_reg_psd", "kernels": len(reg),
          "registers": sorted({k["registers"] for k in reg}),
          "max_spill_bytes": max((k["spill_stores"] + k["spill_loads"]
                                  for k in reg), default=None),
          "by_nfft": {n: max(k["registers"] for k in reg if k["nfft"] == n)
                      for n in sorted({k["nfft"] for k in reg})}})
    check(all(k["spill_stores"] == k["spill_loads"] == 0 for k in fs),
          "ptxas spilled in the four-step split: "
          f"{[k for k in fs if k['spill_stores'] or k['spill_loads']]}")
    emit({"phase": "ptxas_four_step", "kernels": len(fs),
          "max_spill_bytes": max((k["spill_stores"] + k["spill_loads"]
                                  for k in fs), default=None),
          "cols_by_nfft": ptxas_summary([k for k in fs
                                         if k["launch"] == "cols"]),
          "rows_by_nfft": ptxas_summary([k for k in fs
                                         if k["launch"] == "rows"])})

    # phase 2: B1 against psd_torch on the card, every power of two of its
    # range, and two calls of it bit-identical
    rng = np.random.default_rng(0)
    b1_err = 0.0
    n_cases = 0
    for nfft in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
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
                        again = sti_cuda.sti_psd_cuda(xd, sd, **kw)
                        want = plain.psd_torch(xd, sd, **kw)
                        torch.cuda.synchronize()
                        err = (got - want).abs().max().item()
                        check(torch.allclose(got, want, rtol=2e-4, atol=1e-6),
                              f"B1 disagrees at nfft={nfft} mode={mode} "
                              f"nint={nint} nsub={nsub} {dtype} "
                              f"contiguous={contiguous}: max abs {err}")
                        check(torch.equal(got.view(torch.int32),
                                          again.view(torch.int32)),
                              f"B1 differs between two calls at nfft={nfft} "
                              f"mode={mode} {dtype}")
                        b1_err = max(b1_err, err)
                        n_cases += 1
    emit({"phase": "b1_vs_plain", "cases": n_cases, "max_abs_err": b1_err,
          "rtol": 2e-4, "atol": 1e-6, "bit_identical_reruns": n_cases})

    # phase 3: B2 against its plain version and np.median, bit for bit,
    # adversarial cubes included, in both of its designs
    phase_b2(dev, rng)

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
        # the library yardstick: torch.quantile's midpoint median (its
        # input limit is 2^24 elements; both shapes are under it)
        q2d = p.reshape(p.shape[0], -1)
        med = median_cuda.median_over_time_cuda(p)

        def quantile():
            return torch.quantile(q2d, 0.5, dim=0, interpolation="midpoint")

        b2_lib_ms = event_ms(quantile)
        b2_lib_equal = torch.equal(quantile().reshape(med.shape), med)
        b1_fft_ms = fft_alone_ms(xd, sd, cfg.nfft, cfg.nfft * cfg.nint)
        n_tr = cfg.ntime * 2 * (cfg.nint if cfg.mode == "welch" else 1)
        b1_bound = psd_bound((xd, sd), p, cfg.nfft, n_tr)
        b2_bound = median_bound(p, med)
        b1_dev_ms = device_ms(lambda: sti_cuda.sti_psd_cuda(xd, sd, **psd_kw))
        b2_dev_ms = device_ms(lambda: median_cuda.median_over_time_cuda(p))
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
                             b1_fft_alone_ms=b1_fft_ms, b1_bound=b1_bound,
                             b1_device_ms=b1_dev_ms, b2_device_ms=b2_dev_ms,
                             b2_ms=b2_ms, b2_plain_ms=b2_plain_ms,
                             b2_library_ms=b2_lib_ms,
                             b2_library_bit_equal=b2_lib_equal,
                             b2_bound=b2_bound,
                             device_program_ms=program_ms)
        emit({"phase": f"timing_{label}", "card": card,
              "nfft": cfg.nfft, "nint": cfg.nint, "ntime": cfg.ntime,
              "nsub": 2, "samples_per_request": n_proc,
              "b1_max_abs_err": err,
              "b1_ms": b1_ms, "b1_plain_ms": b1_plain_ms,
              "b1_samples_per_s": n_proc / (b1_ms * 1e-3),
              "b1_plain_samples_per_s": n_proc / (b1_plain_ms * 1e-3),
              "b1_device_ms": b1_dev_ms, "b2_device_ms": b2_dev_ms,
              "b1_fft_alone_ms": b1_fft_ms, "b1_bound_ms": b1_bound[0],
              "b1_bound_by": b1_bound[1],
              "b2_ms": b2_ms, "b2_plain_ms": b2_plain_ms,
              "b2_library": "torch.quantile(midpoint)",
              "b2_library_ms": b2_lib_ms,
              "b2_library_bit_equal": b2_lib_equal,
              "b2_bound_ms": b2_bound[0], "b2_design":
                  median_cuda.regime(cfg.ntime),
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

    # B1 at the top of its one-block range (16384) and as the four-step
    # split (32768), each on a block of the headline's size
    b1_big = {}
    for nfft, nint, ntime in ((16384, 4, 32), (32768, 4, 16)):
        x = rng.standard_normal((4, nfft * nint * ntime)).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
        psd_kw = dict(nfft=nfft, nint=nint, mode="welch")
        got = sti_cuda.sti_psd_cuda(xd, sd, **psd_kw)
        err = (got - plain.psd_torch(xd, sd, **psd_kw)).abs().max().item()
        b1_big_ms, b1_big_plain_ms = in_turns(
            lambda: plain.psd_torch(xd, sd, **psd_kw),
            lambda: sti_cuda.sti_psd_cuda(xd, sd, **psd_kw))
        big_bound = psd_bound((xd, sd), got, nfft, ntime * 2 * nint)
        b1_big[nfft] = {
            "phase": f"timing_b1_nfft{nfft}", "card": card, "nfft": nfft,
            "nint": nint, "ntime": ntime, "nsub": 2, "b1_max_abs_err": err,
            "b1_ms": b1_big_ms, "b1_plain_ms": b1_big_plain_ms,
            "b1_device_ms": traced_device_ms(
                lambda: sti_cuda.sti_psd_cuda(xd, sd, **psd_kw),
                expect=20 * (2 if nfft > sti_cuda.ONE_BLOCK_MAX_NFFT
                             else 1))[0],
            "b1_bound_ms": big_bound[0], "b1_bound_by": big_bound[1]}
        if nfft > sti_cuda.ONE_BLOCK_MAX_NFFT:
            # the four-step split's two launches, each timed alone
            b1_big[nfft].update(four_step_launch_ms(xd, sd, nfft, nint))
        emit(b1_big[nfft])

    # B4 at the written request's shapes: 65536 x 4 x 32 and 2^20 x 1 x 16
    b4 = {}
    for nfft, nint, ntime in ((1 << 16, 4, 32), (1 << 20, 1, 16)):
        xd = torch.randn((4, nfft * nint * ntime), generator=gen, device=dev)
        sd = torch.arange(ntime, dtype=torch.int32, device=dev) * nfft * nint
        psd_kw = dict(nfft=nfft, nint=nint, mode="welch")
        got = big_cuda.big_psd_cuda(xd, sd, **psd_kw)
        e, r, over = b4_errors(got, plain.psd_torch(xd, sd, **psd_kw))
        check(over <= 1.0, f"B4 at nfft {nfft}: max rel {r}")
        b4_err = max(b4_err, e)
        b4[nfft] = in_turns(lambda: plain.psd_torch(xd, sd, **psd_kw),
                            lambda: big_cuda.big_psd_cuda(xd, sd, **psd_kw),
                            iters=20)
        # the device time from a trace that holds every launch the calls
        # made (a trace that drops kernel events reads low): 20 calls,
        # else 5, as kernel_times.py takes it; taken early in the run,
        # since a trace late in a long process has come back without
        # kernel events
        chunks = -(-ntime // big_cuda.chunk_columns(
            ntime, 2 * nint * nfft * 8, big_cuda.WORKSPACE_MAX_BYTES))
        for calls in (20, 5):
            dev_ms, dev_events = traced_device_ms(
                lambda: big_cuda.big_psd_cuda(xd, sd, **psd_kw),
                iters=calls, expect=2 * chunks * calls)
            if dev_ms is not None:
                break
        dev_note = None if dev_ms is not None else (
            f"no trace of 20 or 5 calls held their {2 * chunks} kernel "
            f"events a call (the most: {dev_events})")
        b4[nfft] += (fft_alone_ms(xd, sd, nfft, nfft * nint),
                     psd_bound((xd, sd), got, nfft, ntime * 2 * nint),
                     dev_ms)
        del got
        n_proc = nfft * nint * ntime * 2
        emit({"phase": f"timing_b4_nfft{nfft}", "card": card, "nfft": nfft,
              "nint": nint, "ntime": ntime, "nsub": 2,
              "b4_max_abs_err": e, "b4_max_rel_err": r,
              "b4_ms": b4[nfft][0], "b4_plain_ms": b4[nfft][1],
              "b4_fft_alone_ms": b4[nfft][2], "b4_bound_ms": b4[nfft][3][0],
              "b4_bound_by": b4[nfft][3][1], "b4_device_ms": b4[nfft][4],
              "b4_device_events": dev_events,
              "b4_launches_traced": 2 * chunks * calls,
              "b4_device_note": dev_note,
              **four_step_launch_ms(xd, sd, nfft, nint),
              "b4_samples_per_s": n_proc / (b4[nfft][0] * 1e-3)})

    # the other paths, on a long two-tone capture at 1 MS/s: the written
    # request at nfft >= 65536 over its first 31 s, the streaming core, and
    # the live engine, which grows a capture from it
    x_long = long_two_tone(live_samples(sr), noise_rms=1e-3, seed=2)
    phase_big_requests(dev, MemoryDataset(x_long[:31 * sr], sr), tones,
                       launches)
    stream_counts, b3 = phase_streaming(dev, card, x_long[:2 * sr], sr)
    add_counts(launches, stream_counts)
    live_counts, b2_window, live_ticks = phase_live(dev, card, x_long, sr)
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

    # the mesh tier: a 1x1 mesh over NCCL in this process, then four ranks
    # on the one card over gloo, a 2x2 mesh
    add_counts(launches, phase_mesh_1x1_nccl(dev, card, live_ticks))
    add_counts(launches, phase_mesh_2x2_one_card(card, live_ticks))

    # the port's bench at the JAX bench's default shapes: every row, then
    # the headline line (last, so that its thousands of launches precede
    # no profiler trace of the phases above)
    add_counts(launches, phase_bench(
        dev, card, timing["headline"]["device_program_ms"]))

    head = timing["headline"]
    bat = b2_batched[(7, 100, 1, 1024)]
    # library_ms: one PyTorch call computing the same function, where one
    # exists; no single call computes B1, B3 or B4 (window + FFT + |X|^2 +
    # Welch sum + fftshift), so theirs is null and fft_alone_ms times
    # torch.fft.fft over the same windowed frames for context
    emit({"kernels": [
        {"name": "sti_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/sti_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:409",
         "launches": launches["sti_psd"], "max_abs_err": b1_err,
         "ms": head["b1_ms"], "plain_ms": head["b1_plain_ms"],
         "device_ms": head["b1_device_ms"],
         "bound_ms": head["b1_bound"][0], "bound_by": head["b1_bound"][1],
         "library_ms": None, "fft_alone_ms": head["b1_fft_alone_ms"]},
        {"name": "median", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/median.cu",
         "replaces": "pyspectrogram_tpu/kernels/median_pallas.py:77",
         "launches": launches["median"], "max_abs_err": 0.0,
         "ms": head["b2_ms"], "plain_ms": head["b2_plain_ms"],
         "device_ms": head["b2_device_ms"],
         "bound_ms": head["b2_bound"][0], "bound_by": head["b2_bound"][1],
         "library_ms": head["b2_library_ms"],
         "library": "torch.quantile(midpoint)",
         "library_bit_equal": head["b2_library_bit_equal"],
         "batched_launches": launches["median_batched"],
         "batched_shape": [7, 100, 1, 1024],
         "batched_ms": bat["ms"], "batched_plain_ms": bat["plain_ms"],
         "batched_solo_launches_ms": bat["solo_ms"],
         "batched_device_ms": bat["device_ms"],
         "batched_library_ms": bat["library_ms"],
         "batched_library_bit_equal": bat["library_bit_equal"],
         "batched_bound_ms": bat["bound"][0],
         "window_shape": b2_window["shape"], "window_ms": b2_window["ms"],
         "window_plain_ms": b2_window["plain_ms"],
         "window_device_ms": b2_window["device_ms"],
         "window_library_ms": b2_window["library_ms"],
         "window_library": "torch.median",
         "window_library_bit_equal": b2_window["library_bit_equal"],
         "window_bound_ms": b2_window["bound"][0]},
        {"name": "stream_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/stream_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:767",
         "launches": launches["stream_psd"],
         "max_abs_err": max(b3_err, b3["err"]),
         "ms": b3["ms"], "plain_ms": b3["plain_ms"],
         "device_ms": b3["device_ms"],
         "bound_ms": b3["bound"][0], "bound_by": b3["bound"][1],
         "library_ms": None, "fft_alone_ms": b3["fft_alone_ms"]},
        {"name": "big_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/big_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:970",
         "launches": launches["big_psd"], "max_abs_err": b4_err,
         "ms": b4[1 << 16][0], "plain_ms": b4[1 << 16][1],
         "device_ms": b4[1 << 16][4],
         "bound_ms": b4[1 << 16][3][0], "bound_by": b4[1 << 16][3][1],
         "library_ms": None, "fft_alone_ms": b4[1 << 16][2],
         "nfft1048576_ms": b4[1 << 20][0],
         "nfft1048576_bound_ms": b4[1 << 20][3][0],
         "nfft32768_b1_ms": b1_big[32768]["b1_ms"],
         "nfft32768_b1_device_ms": b1_big[32768]["b1_device_ms"],
         "nfft32768_b1_bound_ms": b1_big[32768]["b1_bound_ms"]},
    ]})
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was never launched on the port's paths")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
