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
- the main path from Digital RF files on disk (the "files" phase), read
  and written by the port's own HDF5 layer (io.hdf5): DigitalRFWriter
  writes 30 s of the two tones at 1 MS/s on two subchannels (480 MB);
  StiPipeline.compute over RFDataset(dir) at the headline, bit for bit
  against the same request over a MemoryDataset of the same samples, the
  reference default and nfft 65536 (B4); the headline request and its
  host read timed warm and after a page cache drop (the pages it left
  resident and the capture's file system recorded, so a "cold" row says
  whether it read the disk), pooled and with io_workers=0; the
  headline's frame reads taken apart into the system calls io.fastread
  makes, the same reads replayed alone, and a file's first probe; a gzip
  capture through the chunk-decoding path; and a
  LiveStreamEngine at the 30 s window ticking while a writer thread
  grows the capture, its final view bit-equal to an engine over memory;
- the port's entry points: the pstpu-torch commands on Digital RF
  directories (synth writing three captures, info, sti at the headline
  shape with its .npz and session, resume, psd, sti-batch over the three,
  stream with and without --hop 2048, filter with its new channel read
  back, and on the files phase's capture watch at the 30 s window and sti
  at nfft 65536) through ``build_parser()``, and the viewer's
  MainWindow on the headless widget kit (a written tab at the reference
  default, a live tab at the 30 s window), its plots recorded;
- filter_signal over a 30 s, 1 MS/s two-tone capture (58,592 frames of
  nfft 1024) against the same call on the CPU, and regenerate_signal;
- the user recipes as a user writes them (the "recipes" phase): every
  block of docs/cookbook_torch.md in one namespace, section by section,
  its §5 rank script on four gloo ranks sharing the card (a 2x2 mesh), and
  examples/demo_torch.py's steps 1-5, each against the same recipe on the
  CPU in this process, their captures written and read as files;
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

Outside the files phase, the CLI and the recipes, the captures are
seeded two-tone complex64 arrays served by the port's in-memory dataset
(io.memory.MemoryDataset), whose host reads, assembly and copies run as
they do for a Digital RF capture; the files phase holds the two to the
same bits.
"""

from __future__ import annotations

import contextlib
import io
import json
import platform
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


def check_tiles(got, want, what: str, near=None) -> int:
    """Two uint8 tiles within one level on every pixel, and on <= 0.1% of
    the pixels, or of the ``near`` ones (near_peak): farther under a
    full-scale tone the dB of two float32 FFTs is not held (ROADMAP Queue
    3), and its sidelobes cross levels. Returns the (``near``) pixels that
    differ."""
    import numpy as np

    check(got.shape == want.shape, f"{what}: tiles of {got.shape} and "
                                   f"{want.shape}")
    d = np.abs(got.astype(int) - want.astype(int))
    near = np.broadcast_to(True if near is None else near, d.shape)
    n = int(np.count_nonzero(d[near]))
    check(d.max() <= 1 and n <= 1e-3 * near.sum(),
          f"{what}: tiles differ on {n} of {near.sum()} pixels, by up to "
          f"{d.max()}")
    return n


def near_peak(db, freqs, plot_freqs):
    """Where a display tile's pixels lie within 60 dB of their column's
    peak: ``db`` is the same frames' float dBFS, (ntime, nsub, nfft) or,
    for every column alike, the median PSD (nsub, nfft); ``plot_freqs``
    the tile's bins among ``freqs``. Returns a bool mask that broadcasts
    against the (ntime, nsub, nplot) tile."""
    import numpy as np

    idx = np.searchsorted(freqs, plot_freqs)
    check(np.array_equal(freqs[idx], plot_freqs), "tile bins off the axis")
    return db[..., idx] >= db.max(axis=-1, keepdims=True) - 60.0


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
    # B2 once a tick (its CUDA graph's replays counted as launches)
    check(run["stream_psd"] > 0 and run["median"] == 4,
          f"live engine launches {run}, expected B2 once in each of 4 ticks")
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


# ------------------------------------------------------------ files
#: the files phase's capture: 30 s of the two tones at 1 MS/s on two
#: subchannels, complex64 (480 MB of samples in 30 one-second files); the
#: gzip capture holds its first 2 s; the growing capture gains 0.1 s
#: blocks
FILES_SECONDS, GZIP_SECONDS, GROW_BLOCKS = 30, 2, 20
#: headline requests and host assemblies timed in each cache state, and
#: the live engine's ticks while the capture grows
FILES_REQUESTS, FILES_ASSEMBLIES, FILES_TICKS = 20, 10, 20
#: the live tick's limit (PERF.md §2)
TICK_LIMIT_MS = 80.0


def capture_files(top) -> list:
    return sorted(Path(top).rglob("*.h5"))


def sync_files(top) -> None:
    """Flush a capture's files to the disk."""
    import os

    for p in capture_files(top):
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def drop_cache(top) -> float:
    """Ask the kernel to evict a capture's (synced) files from the page
    cache (POSIX_FADV_DONTNEED); returns the share of their pages still
    resident after it, so 0.0 means the next read comes from the disk."""
    import os

    files = capture_files(top)
    for p in files:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return resident_share(files)


def resident_share(paths) -> float:
    """The share of the files' pages that the page cache holds: mincore
    over a shared read-only mapping of each file."""
    import ctypes
    import mmap
    import os

    import numpy as np

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long)
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p)
    failed = ctypes.c_void_p(-1).value
    held = total = 0
    for p in paths:
        size = os.path.getsize(p)
        if not size:
            continue
        fd = os.open(p, os.O_RDONLY)
        try:
            addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd,
                             0)
            if addr in (None, failed):
                raise OSError(ctypes.get_errno(), f"mmap of {p}")
            try:
                pages = -(-size // mmap.PAGESIZE)
                vec = (ctypes.c_ubyte * pages)()
                if libc.mincore(ctypes.c_void_p(addr), size, vec):
                    raise OSError(ctypes.get_errno(), f"mincore of {p}")
                held += int((np.frombuffer(vec, np.uint8) & 1).sum())
                total += pages
            finally:
                libc.munmap(ctypes.c_void_p(addr), size)
        finally:
            os.close(fd)
    return held / max(total, 1)


#: file systems whose pages are their storage: a read there never reaches
#: a disk, whatever the page cache holds
MEMORY_FS = ("tmpfs", "ramfs")


def mount_of(path) -> dict:
    """The mount that holds ``path`` (the longest mount point above it in
    /proc/self/mounts): its point, file system type and source."""
    import os

    real = os.path.realpath(path)
    best = ("", "unknown", "unknown")
    with open("/proc/self/mounts") as f:
        for line in f:
            src, point, fstype = line.split()[:3]
            point = point.replace("\\040", " ")
            inside = real == point or real.startswith(point.rstrip("/") + "/")
            if inside and len(point) >= len(best[0]):
                best = (point, fstype, src)
    return {"mount": best[0], "fs": best[1], "source": best[2]}


#: the system calls io.fastread makes for a read, timed by read_parts
READ_CALLS = ("stat", "open", "preadv", "close")


@contextlib.contextmanager
def timed_os_calls(spent: dict, preads: list):
    """Wrap os.stat / open / preadv / close for the block: each adds its
    wall seconds and one call to ``spent[name]`` ([seconds, calls]); each
    preadv also appends (path, byte offset, bytes read) to ``preads``."""
    import os

    real = {k: getattr(os, k) for k in READ_CALLS}
    paths = {}

    def wrap(name):
        fn = real[name]

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
            if name == "open":
                paths[out] = args[0]
            elif name == "preadv":
                preads.append((paths.get(args[0]), args[2], out))
            return out
        return call

    for k in READ_CALLS:
        setattr(os, k, wrap(k))
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(os, k, fn)


def read_parts(ds, mem, chan, n_st, frame_len, passes: int = 5) -> dict:
    """Where a read of frames from files goes. The frames are read one by
    one through ``ds.reader.read_vector_raw``, as assemble_device_block
    reads frames that lie apart, and the same from ``mem``;
    io.drf_format.files_overlapping, which finds each frame's files, is
    timed alone; one more pass times the system calls io.fastread makes
    inside the reads; the recorded preadvs are replayed alone (open,
    preadv, close) into fresh memory and into one reused buffer; and each
    file the frames touch is probed by a FastSpanReader that has not
    mapped it. Times are ms over all the frames, p50 over ``passes``."""
    import os

    import numpy as np

    from pyspectrogram_tpu_torch.io import drf_format as fmt
    from pyspectrogram_tpu_torch.io.fastread import FastSpanReader

    starts = [int(s) for s in n_st]

    def p50(fn):
        out = []
        for _ in range(passes):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return float(np.percentile(out, 50) * 1e3)

    def frames(src):
        return lambda: [src.reader.read_vector_raw(s, frame_len, chan,
                                                   return_mask=True)
                        for s in starts]

    files_ms = p50(frames(ds))
    memory_ms = p50(frames(mem))
    props = ds.reader._channel_props(chan)
    cdir = ds.reader.top_dir / chan
    overlap_ms = p50(lambda: [fmt.files_overlapping(props, cdir, s,
                                                    s + frame_len)
                              for s in starts])
    spent = {k: [0.0, 0] for k in READ_CALLS}
    preads = []
    with timed_os_calls(spent, preads):
        t0 = time.perf_counter()
        frames(ds)()
        instrumented_ms = (time.perf_counter() - t0) * 1e3
    check(preads and all(p is not None for p, _, _ in preads),
          "files read parts: the reads made no preadv of a known file")
    nbytes = sum(b for _, _, b in preads)
    reused = np.empty(max(b for _, _, b in preads), np.uint8)
    reused[:] = 0

    def replay(fresh):
        for path, off, want in preads:
            buf = np.empty(want, np.uint8) if fresh else reused[:want]
            view = memoryview(buf)
            fd = os.open(path, os.O_RDONLY)
            try:
                done = 0
                while done < want:
                    got = os.preadv(fd, [view[done:]], off + done)
                    check(got > 0, f"files read parts: short read of {path}")
                    done += got
            finally:
                os.close(fd)

    fresh_ms = p50(lambda: replay(True))
    reused_ms = p50(lambda: replay(False))
    touched = sorted({p for p, _, _ in preads})
    t0 = time.perf_counter()
    for path in touched:
        check(FastSpanReader(workers=1)._probe(Path(path)) is not None,
              f"files read parts: {path} does not map")
    probe_ms = (time.perf_counter() - t0) * 1e3 / len(touched)
    return {"frames": len(starts), "frame_bytes": nbytes // len(starts),
            "passes": passes, "files_read_vector_raw_ms": files_ms,
            "memory_read_vector_raw_ms": memory_ms,
            "files_overlapping_ms": overlap_ms,
            "instrumented_pass_ms": instrumented_ms,
            "syscalls": {k: {"calls": c, "ms": s * 1e3}
                         for k, (s, c) in spent.items()},
            "preadv_bytes": nbytes,
            "replay_fresh_memory_ms": fresh_ms,
            "replay_reused_buffer_ms": reused_ms,
            "replay_reused_gb_per_s": nbytes / (reused_ms * 1e-3) / 1e9,
            "probe_unmapped_file_ms": probe_ms,
            "probed_files": len(touched)}


def same_result(a, b, what: str) -> None:
    """Two StiResults bit for bit."""
    import numpy as np

    for f in ("sxx_dbfs", "sxx_med_dbfs", "tile", "frame_starts", "times",
              "freqs", "mask"):
        x, y = getattr(a, f), getattr(b, f)
        check((x is None and y is None) or np.array_equal(x, y),
              f"{what}: {f} differs")


FILES_START = 1451661840


def files_capture_samples(sr: int, tones):
    """The files phase's capture: FILES_SECONDS of the two tones, and the
    GROW_BLOCKS blocks of 0.1 s its writer thread appends."""
    import numpy as np

    from pyspectrogram_tpu_torch.io.synthetic import tone_signal

    x = two_tone(FILES_SECONDS * sr, sr, tones, noise_rms=1e-3, seed=1)
    ext = tone_signal(GROW_BLOCKS * (sr // 10), sr, tones,
                      start_sample=len(x), noise_rms=1e-3,
                      seed=3).astype(np.complex64)
    return x, ext


def phase_files(dev, card, tmp, mem_ticks: dict):
    """The main path from Digital RF files on disk, read and written by the
    port's own HDF5 layer (io.hdf5): DigitalRFWriter writes the 30 s
    capture from samples made beforehand (write_capture runs in phase_cli's
    synth); StiPipeline.compute over RFDataset(dir) at the headline (bit
    for bit against the same request over a MemoryDataset of the same
    samples, and against the CPU in dB), the reference default and nfft
    65536 (B4); compute() and the host read + assembly timed warm and
    after a page cache drop before each call (its pages still resident
    measured, with the capture's file system), with the pooled reader and
    with io_workers=0; the headline's frame reads taken apart
    (read_parts); a gzip capture through the chunk-decoding path; a
    writer thread growing the capture while a LiveStreamEngine at the
    30 s window ticks on it, its final view bit-equal to an engine over a
    MemoryDataset fed the same blocks. Returns (the launches made from the
    files, the capture's directory)."""
    import threading

    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io import DigitalRFWriter, RFDataset
    from pyspectrogram_tpu_torch.io.memory import MemoryDataset
    from pyspectrogram_tpu_torch.models import sti
    from pyspectrogram_tpu_torch.runtime import LiveStreamEngine

    sr = 1_000_000
    tones = [sr / 16.0, sr / 8.0]
    n = FILES_SECONDS * sr
    top = Path(tmp) / "capture"
    from_files = {k: 0 for k in read_counts()}

    def on_files(fn):
        """Run ``fn`` with its launches counted as made from the files."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        add_counts(from_files, read_counts())
        return out

    # 1. make the samples, then write them as write_capture does (its
    # channel, start and cadences), the write alone timed
    t0 = time.perf_counter()
    x, ext = files_capture_samples(sr, tones)
    synth_s = time.perf_counter() - t0
    start = int(FILES_START * sr)
    w = DigitalRFWriter(top, "ch0", np.complex64, start_global_index=start,
                        sample_rate_numerator=sr, num_subchannels=2)
    t0 = time.perf_counter()
    w.rf_write(x)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sync_files(top)
    sync_s = time.perf_counter() - t0
    files = capture_files(top)
    disk_bytes = sum(p.stat().st_size for p in files)
    where = mount_of(top)
    mem = MemoryDataset(x, sr, start=start)
    ds = RFDataset(top)
    chan = ds.channels[0]
    check(ds.bnds[chan] == mem.bnds[chan] == (start, start + n - 1)
          and ds.ref_dict[chan] == 1.0 and len(files) == FILES_SECONDS + 1,
          f"files: capture of bounds {ds.bnds}, {len(files)} files")
    emit({"phase": "files_write", "card": card, "seconds": FILES_SECONDS,
          "sample_rate": sr, "nsub": 2, "sample_bytes": x.nbytes,
          "disk_bytes": disk_bytes, "files": len(files),
          "synthesis_s": synth_s, "write_s": write_s, "fsync_s": sync_s,
          "write_mb_per_s": x.nbytes / write_s / 1e6,
          "capture_mount": where, "kernel": platform.release()})

    # 2. requests from disk, bit for bit against memory
    headline = SpectrogramConfig(nfft=4096, nint=4, ntime=128, mode="welch",
                                 precision="exact")
    # at ntime <= 32 the median is the sorting network, not B2
    requests = [("headline", headline, ("sti_psd", "median")),
                ("reference_default", SpectrogramConfig(),
                 ("sti_psd", "median")),
                ("nfft65536", SpectrogramConfig(nfft=1 << 16, nint=4,
                                                ntime=32), ("big_psd",))]
    for label, cfg, kernels in requests:
        pipe = sti.StiPipeline(ds, cfg, device=dev)
        before = dict(from_files)
        res = on_files(pipe.compute)
        run = {k: from_files[k] - before[k] for k in from_files}
        check(all(run[k] > 0 for k in kernels),
              f"files {label}: launches {run}, expected {kernels}")
        same_result(res, sti.StiPipeline(mem, cfg, device=dev).compute(),
                    f"files {label} against memory")
        med = res.sxx_med_dbfs
        peaks = []
        for s, f in enumerate(tones):
            k = int(med[:, s].argmax())
            peaks.append(float(med[k, s]))
            check(abs(res.freqs[k] - f) <= sr / cfg.nfft
                  and abs(med[k, s]) <= 0.1,
                  f"files {label}: sub {s} peak {med[k, s]} dBFS at "
                  f"{res.freqs[k]} Hz")
        line = {"phase": f"files_request_{label}", "card": card,
                "nfft": cfg.nfft, "nint": cfg.nint, "ntime": cfg.ntime,
                "prefetch": 4 * cfg.ntime * cfg.nfft * cfg.nint * 4
                >= sti.PREFETCH_MIN_BYTES,
                "bit_equal_memory": True, "peaks_dbfs": peaks,
                "launches": run}
        if label == "headline":
            cpu = sti.StiPipeline(ds, cfg, device="cpu").compute()
            check(np.array_equal(res.frame_starts, cpu.frame_starts),
                  "files headline: frame starts differ from the CPU run")
            d = max(db_diff(med, cpu.sxx_med_dbfs, axis=0),
                    db_diff(res.sxx_dbfs, cpu.sxx_dbfs, axis=0))
            check(d <= 1e-3, f"files headline: dB differs from the CPU run "
                             f"by {d}")
            line["max_db_diff_vs_cpu"] = d
            n_st = res.frame_starts
        emit(line)

    # 3. the headline request and its host half, warm and after a page
    # cache drop, pooled reader and io_workers=0, beside the same over
    # memory; a "cold" row is a disk read only where the drop evicted the
    # pages from a file system that is not memory
    frame_len = headline.nfft * headline.nint
    resident = []

    def walls(fn, calls, cold):
        out = []
        for _ in range(calls):
            if cold:
                resident.append(drop_cache(top))
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return [float(v) for v in np.percentile(out, [50, 90]) * 1e3]

    timing = {}
    for label, src in (("memory", mem), ("files", ds),
                       ("files_io_workers0", RFDataset(top, io_workers=0))):
        pipe = sti.StiPipeline(src, headline, device=dev)
        pipe.compute()
        for temp in (("warm",) if label == "memory" else ("warm", "cold")):
            cold = temp == "cold"
            resident.clear()
            req = walls(pipe.compute, FILES_REQUESTS, cold)
            asm = walls(lambda: sti.assemble_device_block(
                src, chan, None, n_st, frame_len), FILES_ASSEMBLIES, cold)
            row = {"request_p50_ms": req[0], "request_p90_ms": req[1],
                   "host_read_assemble_p50_ms": asm[0],
                   "host_read_assemble_p90_ms": asm[1]}
            if cold:
                share = max(resident)
                row["resident_after_drop_max"] = share
                row["disk_read"] = (share < 0.01
                                    and where["fs"] not in MEMORY_FS)
                if not row["disk_read"]:
                    row["note"] = "cache drop ineffective, not a disk read"
            timing[f"{label}_{temp}"] = row
    emit({"phase": "files_timing_headline", "card": card,
          "requests": FILES_REQUESTS, "assemblies": FILES_ASSEMBLIES,
          "block_bytes": 4 * 128 * frame_len * 4,
          "capture_fs": where["fs"], **timing})
    emit({"phase": "files_read_parts", "card": card,
          **read_parts(ds, mem, chan, n_st, frame_len)})

    # 4. gzip: the chunk-decoding path, bit for bit against the plain files
    gz = Path(tmp) / "gzip"
    ng = GZIP_SECONDS * sr
    w = DigitalRFWriter(gz, chan, np.complex64, start_global_index=start,
                        sample_rate_numerator=sr, num_subchannels=2,
                        compression_level=1)
    t0 = time.perf_counter()
    for s in range(0, ng, sr // 10):
        w.rf_write(x[s:s + sr // 10])
    gz_write_s = time.perf_counter() - t0
    ds_gz = RFDataset(gz)
    t0 = time.perf_counter()
    got = ds_gz.reader.read_vector_raw(start, ng, chan)
    gz_read_s = time.perf_counter() - t0
    check(np.array_equal(got, ds.reader.read_vector_raw(start, ng, chan))
          and np.array_equal(got, x[:ng]),
          "files gzip: reads differ from the uncompressed capture's")
    cfg = SpectrogramConfig()
    res = on_files(sti.StiPipeline(ds_gz, cfg, device=dev).compute)
    same_result(res, sti.StiPipeline(MemoryDataset(x[:ng], sr, start=start),
                                     cfg, device=dev).compute(),
                "files gzip request against memory")
    gz_bytes = sum(p.stat().st_size for p in capture_files(gz))
    emit({"phase": "files_gzip", "card": card, "seconds": GZIP_SECONDS,
          "compression_level": 1, "sample_bytes": x[:ng].nbytes,
          "disk_bytes": gz_bytes, "write_s": gz_write_s,
          "write_mb_per_s": x[:ng].nbytes / gz_write_s / 1e6,
          "read_s": gz_read_s,
          "read_mb_per_s": x[:ng].nbytes / gz_read_s / 1e6,
          "bit_equal_uncompressed": True, "request_bit_equal_memory": True})
    del got, ds_gz

    # 5. a writer thread grows the capture while the live engine ticks
    cfg = SpectrogramConfig(nfft=4096, hop=2048, ntime=100,
                            stream_seconds=30.0, display_tile=True,
                            color_range_db=COLOR_RANGE_DB, streaming=True)
    blk = sr // 10
    ds_live = RFDataset(top)
    t0 = time.perf_counter()
    eng = LiveStreamEngine(ds_live, cfg, dev)
    on_files(lambda: eng.tick(cfg))
    cold_s = time.perf_counter() - t0
    mem_live = MemoryDataset(x, sr, start=start)
    eng_mem = LiveStreamEngine(mem_live, cfg, dev)
    eng_mem.tick(cfg)
    w = DigitalRFWriter(top, chan, np.complex64,
                        start_global_index=start + n,
                        sample_rate_numerator=sr, num_subchannels=2)
    appends, errors = [], []

    def produce():
        try:
            for i in range(GROW_BLOCKS):
                t1 = time.perf_counter()
                w.rf_write(ext[i * blk:(i + 1) * blk])
                appends.append(time.perf_counter() - t1)
                time.sleep(0.1)
        except BaseException as e:       # raised again in this thread
            errors.append(e)

    producer = threading.Thread(target=produce, name="files-writer")
    ticks, reads = [], []
    reset_counts()
    producer.start()
    for _ in range(FILES_TICKS):
        read0 = eng.samples_read
        t1 = time.perf_counter()
        ds_live.bnds_update()
        eng.tick(cfg)
        ticks.append(time.perf_counter() - t1)
        reads.append(eng.samples_read - read0)
        time.sleep(0.1)
    producer.join(60)
    check(not producer.is_alive() and not errors,
          f"files growing: the writer failed {errors}")
    ds_live.bnds_update()
    res = eng.tick(cfg)
    torch.cuda.synchronize()
    add_counts(from_files, read_counts())
    mem_live.append(ext)
    mem_live.bnds_update()
    want = eng_mem.tick(cfg)
    check(ds_live.bnds[chan] == (start, start + n + len(ext) - 1)
          and eng.next_sample == eng_mem.next_sample,
          f"files growing: bounds {ds_live.bnds[chan]}, cursor "
          f"{eng.next_sample} against {eng_mem.next_sample}")
    for f in ("tile", "sxx_med_dbfs", "frame_starts", "times", "mask"):
        check(np.array_equal(getattr(res, f), getattr(want, f)),
              f"files growing: the final view differs from memory in {f}")
    tick_p50, tick_p90 = (float(v) for v in
                          np.percentile(ticks, [50, 90]) * 1e3)
    emit({"phase": "files_growing", "card": card, "stream_seconds": 30.0,
          "nfft": cfg.nfft, "hop": cfg.hop, "block_s": 0.1,
          "blocks": GROW_BLOCKS, "cold_start_s": cold_s, "ticks": len(ticks),
          "tick_p50_ms": tick_p50, "tick_p90_ms": tick_p90,
          "tick_limit_ms": TICK_LIMIT_MS,
          "memory_tick_p50_ms": mem_ticks.get("tick_p50_ms"),
          "memory_tick_p90_ms": mem_ticks.get("tick_p90_ms"),
          "tick_samples_read": reads,
          "append_p50_ms": float(np.percentile(appends, 50) * 1e3),
          "append_mb_per_s": ext.nbytes / sum(appends) / 1e6,
          "final_view_bit_equal_memory": True})
    del eng, eng_mem, mem_live, mem, x, ext
    torch.cuda.empty_cache()

    # 6. what the files launched
    for k in ("sti_psd", "median", "big_psd"):
        check(from_files[k] > 0, f"files: kernel {k} was never launched")
    emit({"phase": "files", "card": card, "launches": from_files})
    return from_files, top


# ------------------------------------------------------------ the formats
#: the committed captures in HDF5's newer formats (written by h5py, which
#: the card's machine lacks), and their manifest
FORMATS_DIR = Path(__file__).resolve().parent / "tests" / "data" / \
    "hdf5_formats"


def fixture_samples(spec: dict, seed: int):
    """A fixture's (n, nsub) int16 complex ``{r, i}`` samples from its
    manifest entry, with numpy integer arithmetic alone: on subchannel s a
    tone of period ``periods[s]`` samples (a table of rounded cos/sin
    values) plus noise uniform on [-noise, noise] from splitmix64 of
    (seed, s, part, row). The same function as the fixture script's
    (tests/torch_hdf5_fixtures.py), which wrote the files."""
    import numpy as np

    n, nsub, amp, na = spec["n"], spec["nsub"], spec["amplitude"], \
        spec["noise"]
    out = np.zeros((n, nsub), [("r", "<i2"), ("i", "<i2")])
    rows = np.arange(n, dtype=np.uint64)
    for s, period in enumerate(spec["periods"][:nsub]):
        ph = 2 * np.pi * np.arange(period) / period
        for part, table in (("r", amp * np.cos(ph)), ("i", amp * np.sin(ph))):
            tone = np.round(table).astype(np.int64)[np.arange(n) % period]
            z = (rows + np.uint64((seed * 8 + s * 2 + (part == "i")) << 32)
                 ) * np.uint64(0x9E3779B97F4A7C15)
            z ^= z >> np.uint64(30)
            z *= np.uint64(0xBF58476D1CE4E5B9)
            z ^= z >> np.uint64(27)
            z *= np.uint64(0x94D049BB133111EB)
            z ^= z >> np.uint64(31)
            noise = (z % np.uint64(2 * na + 1)).astype(np.int64) - na
            out[part][:, s] = tone + noise
    return out


#: what a fixture's files phase requests: B1 + B2 at the reference
#: default, B4 at nfft 65536 (two frames), B3 through a live engine whose
#: 2 s window covers the whole fixture
FORMATS_REQUESTS = (("reference_default", dict(), ("sti_psd", "median")),
                    ("nfft65536", dict(nfft=1 << 16, nint=1, ntime=2),
                     ("big_psd",)))
FORMATS_LIVE = dict(nfft=4096, hop=2048, ntime=100, stream_seconds=2.0,
                    display_tile=True, color_range_db=COLOR_RANGE_DB,
                    streaming=True)
INT16_REF = 2.0 ** 15.5
FORMATS_PARSES, FORMATS_READS = 20, 5


def fixture_dataset(name: str, manifest: dict):
    """(MemoryDataset of a fixture's regenerated samples, its directory,
    the samples), the samples held to the manifest's digest first."""
    import hashlib

    from pyspectrogram_tpu_torch.io.memory import MemoryDataset

    spec = manifest["samples"]
    entry = manifest["fixtures"][name]
    x = fixture_samples(spec, entry["seed"])
    check(hashlib.sha256(x.tobytes()).hexdigest() == entry["sha256"],
          f"formats {name}: the regenerated samples differ from the "
          f"manifest's digest")
    sr = spec["sample_rate"]
    mem = MemoryDataset(x, sr, channel=manifest["channel"],
                        start=spec["start_second"] * sr, ref=INT16_REF)
    return mem, FORMATS_DIR / name, x


def phase_files_formats(dev, card, tmp) -> dict:
    """The main path from captures in HDF5's newer formats (the committed
    fixtures, FORMATS_DIR: libver "latest" with an extensible-array index,
    the same through shuffle + gzip + fletcher32, libver "v110" big-endian
    with a fixed-array index), read by the port's HDF5 layer. For each:
    the whole capture read through RFDataset (pooled and io_workers=0)
    equal to the manifest's regenerated samples; StiPipeline.compute at
    the reference default (B1, B2) and at nfft 65536 (B4), pooled and
    io_workers=0, bit for bit against the same request over a
    MemoryDataset of the samples; a LiveStreamEngine's cold start (B3)
    bit for bit against an engine over memory; one file's open + parse
    time and the capture's read rate beside the same for the port's own
    earliest-format write of the samples (the parse also with io.hdf5's
    remembered checksums cleared before each, as a first open finds
    them), and fletcher32's rate over the chunk bytes. Returns the
    launches made from the fixtures."""
    import numpy as np
    import torch

    from pyspectrogram_tpu_torch import SpectrogramConfig
    from pyspectrogram_tpu_torch.io import DigitalRFWriter, RFDataset, hdf5
    from pyspectrogram_tpu_torch.io import hdf5_blocks
    from pyspectrogram_tpu_torch.models import sti
    from pyspectrogram_tpu_torch.runtime import LiveStreamEngine

    manifest = json.loads((FORMATS_DIR / "manifest.json").read_text())
    spec = manifest["samples"]
    sr, n = spec["sample_rate"], spec["n"]
    start = spec["start_second"] * sr
    chan = manifest["channel"]
    from_files = {k: 0 for k in read_counts()}

    def on_files(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        add_counts(from_files, read_counts())
        return out

    def p50_s(fn, k):
        out = []
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return float(np.median(out))

    def parse(path):
        """Open one file and parse what a read needs: the superblock,
        headers, both datasets' messages, the index rows, the chunk
        index."""
        with hdf5.File(path) as f:
            d = f["rf_data"]
            f["rf_data_index"][...]
            return d.id.get_num_chunks() if d.chunks else 0

    live_cfg = SpectrogramConfig(**FORMATS_LIVE)
    for name, entry in manifest["fixtures"].items():
        mem, top, x = fixture_dataset(name, manifest)
        files = [top / rel for rel in entry["files"]]
        first = files[0].read_bytes()
        line = {"phase": f"files_formats_{name}", "card": card,
                "libver": entry["libver"], "superblock": first[8],
                "chunk_index": ("extensible array" if b"EAHD" in first
                                else "fixed array" if b"FAHD" in first
                                else "other"),
                "filters": entry["filters"], "byteorder": entry["byteorder"],
                "files": len(files), "rows": n, "nsub": spec["nsub"],
                "disk_bytes": sum(p.stat().st_size for p in files)}
        with hdf5.File(files[0]) as f:
            d = f["rf_data"]
            line["rf_data"] = {"dtype": str(d.dtype), "chunks": d.chunks,
                               "maxshape": d.maxshape,
                               "fletcher32": d.fletcher32,
                               "chunks_indexed": d.id.get_num_chunks()}
        check(line["superblock"] in (2, 3) and line["chunk_index"] != "other",
              f"formats {name}: superblock {line['superblock']}, chunk "
              f"index {line['chunk_index']}")
        # 1. the capture as read equals the samples
        for workers in (None, 0):
            ds = RFDataset(top, io_workers=workers)
            check(ds.bnds[chan] == (start, start + n - 1)
                  and ds.ref_dict[chan] == INT16_REF,
                  f"formats {name}: bounds {ds.bnds}, ref {ds.ref_dict}")
            got = ds.reader.read_vector_raw(start, n, chan)
            check(all(np.array_equal(got[k], x[k]) for k in ("r", "i")),
                  f"formats {name}: io_workers={workers} read differs from "
                  f"the manifest's samples")
        # 2. B1 + B2 and B4, pooled and io_workers=0, against memory
        reqs = {}
        for label, kw, kernels in FORMATS_REQUESTS:
            cfg = SpectrogramConfig(**kw)
            want = sti.StiPipeline(mem, cfg, device=dev).compute()
            for workers in (None, 0):
                before = dict(from_files)
                pipe = sti.StiPipeline(RFDataset(top, io_workers=workers),
                                       cfg, device=dev)
                res = on_files(pipe.compute)
                run = {k: from_files[k] - before[k] for k in from_files}
                check(all(run[k] > 0 for k in kernels),
                      f"formats {name} {label}: launches {run}, expected "
                      f"{kernels}")
                same_result(res, want, f"formats {name} {label} "
                                       f"io_workers={workers} vs memory")
            med = want.sxx_med_dbfs
            reqs[label] = {"nfft": cfg.nfft, "ntime": cfg.ntime,
                           "bit_equal_memory": True,
                           "peak_dbfs": [float(med[:, s].max())
                                         for s in range(med.shape[1])],
                           "launches": run}
        line["requests"] = reqs
        # 3. B3: the live engine's cold start over the fixture
        eng = LiveStreamEngine(RFDataset(top), live_cfg, dev)
        before = dict(from_files)
        res = on_files(lambda: eng.tick(live_cfg))
        run = {k: from_files[k] - before[k] for k in from_files}
        want = LiveStreamEngine(mem, live_cfg, dev).tick(live_cfg)
        check(run["stream_psd"] > 0, f"formats {name} live: launches {run}")
        for f in ("tile", "sxx_med_dbfs", "frame_starts", "times", "mask"):
            check(np.array_equal(getattr(res, f), getattr(want, f)),
                  f"formats {name} live: the view differs from memory in {f}")
        line["live"] = {"nfft": live_cfg.nfft, "hop": live_cfg.hop,
                        "stream_seconds": live_cfg.stream_seconds,
                        "window_cols": eng.window_cols,
                        "bit_equal_memory": True, "launches": run}
        # 4. open + parse and read rate, beside the port's own write of the
        # samples in the earliest format (gzip where the fixture is
        # compressed: the port writes no shuffle or fletcher32)
        twin = Path(tmp) / "formats" / name
        gz = 4 if entry["filters"].get("compression") else 0
        w = DigitalRFWriter(twin, chan, x.dtype, start_global_index=start,
                            sample_rate_numerator=sr,
                            num_subchannels=spec["nsub"],
                            file_cadence_millisecs=1000,
                            subdir_cadence_secs=3600, compression_level=gz)
        w.rf_write(x)
        twin_files = [p for p in capture_files(twin)
                      if p.name.startswith("rf@")]
        check(len(twin_files) == len(files) and
              twin_files[0].read_bytes()[8] == 0,
              f"formats {name}: the earliest-format twin has "
              f"{len(twin_files)} files")
        nbytes = x.nbytes
        for label, where, path in (("fixture", top, files[0]),
                                   ("earliest_twin", twin, twin_files[0])):
            parse(path)
            ds = RFDataset(where)
            ds.reader.read_vector_raw(start, n, chan)
            line[label] = {
                "open_parse_ms": p50_s(lambda: parse(path),
                                       FORMATS_PARSES) * 1e3,
                "open_parse_unremembered_ms": p50_s(
                    lambda: (hdf5_blocks._lookup3_of.cache_clear(),
                             parse(path)), FORMATS_PARSES) * 1e3,
                "read_mb_per_s": nbytes / p50_s(
                    lambda: ds.reader.read_vector_raw(start, n, chan),
                    FORMATS_READS) / 1e6,
                "read_io_workers0_mb_per_s": nbytes / p50_s(
                    lambda: RFDataset(where, io_workers=0).reader
                    .read_vector_raw(start, n, chan), FORMATS_READS) / 1e6}
        if entry["filters"].get("fletcher32"):
            raw = x.astype(np.dtype([("r", "<i2"), ("i", "<i2")])).tobytes()
            line["fletcher32_mb_per_s"] = len(raw) / p50_s(
                lambda: hdf5_blocks.fletcher32(raw), FORMATS_READS) / 1e6
        emit(line)
    for k in ("sti_psd", "median", "stream_psd", "big_psd"):
        check(from_files[k] > 0,
              f"files_formats: kernel {k} was never launched")
    emit({"phase": "files_formats", "card": card,
          "fixtures": list(manifest["fixtures"]),
          "h5py_that_wrote_them": manifest["h5py"],
          "hdf5_that_wrote_them": manifest["hdf5"],
          "launches": from_files})
    return from_files


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
        # B2 once a tick (its CUDA graph's replays counted as launches)
        check(run["stream_psd"] > 0 and run["median"] == n_tabs * iters,
              f"live_tabs_{n_tabs}: launches {run}, expected B2 once in "
              f"each of {n_tabs} x {iters} ticks")
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


def run_cli(argv):
    """Parse ``argv`` with the port CLI's parser, run the command with every
    launch count at 0, and return (the JSON it printed last, what it wrote
    to stderr, the launches, its wall seconds)."""
    import contextlib
    import io

    import torch

    from pyspectrogram_tpu_torch.clients import cli

    args = cli.build_parser().parse_args([str(a) for a in argv])
    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = args.fn(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    run = read_counts()
    text = out.getvalue().strip()
    check(rc == 0 and text, f"cli {argv[0]}: exit {rc}, stdout "
                            f"{text[-400:]!r}")
    # info prints one indented object, the others one line each
    res = json.loads(text if argv[0] == "info" else text.splitlines()[-1])
    return res, err.getvalue(), run, wall_s


def phase_cli(dev, card, tmp, long_top, window_s: float = 30.0):
    """The pstpu-torch commands as a user runs them, through
    ``build_parser()``, on Digital RF directories: synth writes three
    captures of the headline's 2,097,152 samples, info describes one
    (against RFDataset's bounds), then sti at the headline shape (+ .npz
    and a saved session, held against the same command on the CPU),
    resume, psd, sti-batch over the three, stream with and without --hop
    2048, filter (its new channel read back and held against filter_signal
    on the CPU), and on the files phase's capture ``long_top`` watch at a
    ``window_s`` window and sti at nfft 65536. Each command's peaks must
    be within 0.1 dB of 0 dBFS and its kernels launched. Returns the
    launch counts."""
    import importlib.util
    import re

    import numpy as np

    from pyspectrogram_tpu_torch.display import sti_tile
    from pyspectrogram_tpu_torch.io import RFDataset
    from pyspectrogram_tpu_torch.ops.filters import filter_signal

    sr = 1_000_000
    renderer = ("matplotlib" if importlib.util.find_spec("matplotlib")
                else "pixels" if importlib.util.find_spec("PIL") else None)
    check(renderer is not None, "cli: neither matplotlib nor PIL is "
                                "installed, so no PNG can be written")
    t = Path(tmp)
    caps = [t / f"cap{i}" for i in range(3)]
    synth = []
    for i, cap in enumerate(caps):
        res, _, _, wall_s = run_cli(
            ["synth", "--out", cap, "--channel", f"cap{i}", "--n-samples",
             128 * 4096 * 4, "--sample-rate", sr, "--nsub", 2,
             "--noise-rms", 1e-3])
        check(res["n_samples"] == 128 * 4096 * 4 and res["channel"] ==
              f"cap{i}", f"cli_synth: {res}")
        synth.append(wall_s)
    emit({"phase": "cli_synth", "card": card, "captures": len(caps),
          "n_samples": 128 * 4096 * 4, "nsub": 2, "wall_s": synth,
          "mb_per_s": [128 * 4096 * 4 * 16 / s / 1e6 for s in synth]})
    info, _, _, info_s = run_cli(["info", caps[0]])
    ds0 = RFDataset(caps[0])
    check(info["cap0"]["bounds"] == list(ds0.bnds["cap0"])
          and info["cap0"]["num_subchannels"] == 2
          and info["cap0"]["sample_rate"] == str(sr),
          f"cli_info: {info}")
    emit({"phase": "cli_info", "card": card, "wall_s": info_s,
          "bounds": info["cap0"]["bounds"]})
    head = ("--nfft", 4096, "--nint", 4, "--ntime", 128)
    on = ("--device", dev)
    cmds = [
        ("sti", ["sti", caps[0], *head, "--out", t / "sti.png", "--npz",
                 t / "sti.npz", "--save-session", t / "session.npz", *on],
         ("sti_psd", "median")),
        ("resume", ["resume", t / "session.npz", "--out", t / "resumed.png",
                    *on], ("sti_psd", "median")),
        ("psd", ["psd", caps[0], *head, "--out", t / "psd.csv", *on],
         ("sti_psd", "median")),
        ("sti_batch", ["sti-batch", *caps, *head, "--out-dir", t / "batch",
                       *on], ("sti_psd", "median_batched")),
        ("stream", ["stream", caps[0], "--nfft", 4096, "--cols-per-block", 8,
                    "--ring-len", 256, "--out", t / "stream.png", *on],
         ("sti_psd", "median")),
        ("stream_hop2048", ["stream", caps[0], "--nfft", 4096, "--hop", 2048,
                            "--cols-per-block", 8, "--ring-len", 256,
                            "--out", t / "stream_hop.png", *on],
         ("stream_psd", "median")),
        ("filter", ["filter", caps[0], "--out", t / "filtered", "--kind",
                    "lowpass", "--cutoff", 90_000, "--nfft", 1024, *on], ()),
        ("watch", ["watch", long_top, "--nfft", 4096, "--hop", 2048,
                   "--ntime", 100, "--window-s", window_s, "--refresh-s",
                   0.0, "--iterations", 4, "--crange", -80, 0, "--out",
                   t / "watch.png", *on], ("stream_psd", "median")),
        ("sti_nfft65536", ["sti", long_top, "--nfft", 1 << 16, "--nint", 4,
                           "--ntime", 32, "--out", t / "sti65536.png", *on],
         ("big_psd",)),
    ]
    total = {k: 0 for k in read_counts()}
    for label, argv, kernels in cmds:
        res, err, run, wall_s = run_cli(argv)
        check(all(run[k] > 0 for k in kernels),
              f"cli_{label}: launches {run}, expected {kernels}")
        add_counts(total, run)
        artifacts = []
        line = {"phase": f"cli_{label}", "card": card,
                "argv": [str(a) for a in argv], "wall_s": wall_s,
                "launches": run, "renderer": renderer}
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
            line["latency"] = res["latency"]
        elif label == "resume":
            check(res["shape"] == [4096, 128, 2], f"cli_resume: {res}")
            peaks = [0.0]
            artifacts.append(res["png"])
        elif label == "filter":
            # the new channel, read back, against filter_signal on the CPU
            lo, hi = ds0.bnds["cap0"]
            x = ds0.read(lo, hi - lo + 1, "cap0")[:, 0]
            want = filter_signal(x, float(sr), "lowpass", 90_000.0,
                                 nfft=1024, device="cpu").astype(np.complex64)
            out = RFDataset(t / "filtered")
            check(out.channels == ["cap0_filtered"]
                  and out.bnds["cap0_filtered"] == (lo, lo + len(want) - 1),
                  f"cli_filter: wrote {out.channels} {out.bnds}")
            got = out.reader.read_vector_raw(lo, len(want),
                                             "cap0_filtered")[:, 0]
            d = float(np.abs(got - want)[1024:-1024].max())
            check(res["n_samples"] == len(want) and d <= 1e-5,
                  f"cli_filter: the channel differs from the CPU's by {d}")
            k = np.abs(np.fft.fft(got[1024:1024 + 65536]))
            peaks = [float(20 * np.log10(k.max() / 65536))]
            line.update(max_abs_diff_vs_cpu=d, atol=1e-5,
                        kept_tone_hz=float(np.fft.fftfreq(65536, 1 / sr)[
                            int(k.argmax())]))
            check(abs(line["kept_tone_hz"] - sr / 16) <= sr / 65536,
                  f"cli_filter: kept tone at {line['kept_tone_hz']} Hz")
            artifacts.append(t / "filtered" / "cap0_filtered"
                             / "drf_properties.h5")
        else:
            peaks = [res["peak_dbfs"]]
            artifacts.append(res["png"])
        check(all(abs(p) <= 0.1 for p in peaks),
              f"cli_{label}: peaks {peaks} dBFS, expected ~0")
        for a in artifacts:
            check(Path(a).is_file() and Path(a).stat().st_size > 0,
                  f"cli_{label}: no {a}")
        line.update(peaks_dbfs=peaks, artifacts=[Path(a).name for a in
                                                 artifacts]
                    + (["sti.npz", "session.npz"] if label == "sti" else []))
        if label == "sti":
            # the same command on the CPU; the .npz on the card's renderer
            cpu, _, _, cpu_s = run_cli(["sti", caps[0], *head, "--out",
                                        t / "cpu.png", "--npz",
                                        t / "cpu.npz", "--device", "cpu"])
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
        emit(line)
    return total


def phase_gui(dev, card, ds_written, ds_live, tones, tmp,
              window_s: float = 30.0, dirs=()):
    """The port's viewer on the headless widget kit: MainWindow on the
    card, its plots recorded (recording_figure_kit: the card's machine has
    no matplotlib), the directory dialog's answer mapped to in-memory
    captures. One written tab at the reference default, then one live tab
    at a ``window_s`` window (nfft 4096, hop 2048) for four refreshes:
    each frame reaches the window and is drawn, peaks at 0 dBFS, no
    warning dialog. Then, for each of ``dirs`` ((label, Digital RF
    directory, MemoryDataset of its samples, its tones, live?)), a tab of
    a second MainWindow with no ``open_dataset``, which opens the
    directory itself, against the same tab over the memory twin in the
    first window: the last frames bit for bit, Start -> first frame of
    each. Returns the launch counts."""
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

    def run_tab(tab_id, label, source, n_frames, kernels, window=None,
                tab_tones=tones, peak_db=0.0, **widgets):
        st = (window or win).states[tab_id]
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
        for s, f in enumerate(tab_tones):
            med = p.sxx_med_dbfs[:, s]
            k = int(med.argmax())
            check(abs(p.freqs[k] - f) <= 2 * float(p.freqs[1] - p.freqs[0])
                  and (peak_db is None or abs(med[k] - peak_db) <= 0.1),
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
    # tabs on Digital RF directories, each beside its memory twin
    win_dir = gui.MainWindow(device=dev, figure_kit=gui.recording_figure_kit)
    win_dir._last_dir_file = lambda: Path(tmp) / "last_dir_files.txt"
    for j, (label, directory, mem, dir_tones, live) in enumerate(dirs):
        sources[f"{label}_memory"] = mem
        kw = (dict(live_check=True, window_s=window_s, nfft=4096,
                   hop_w=2048) if live else {})
        n_frames = 4 if live else 1
        kernels = ("stream_psd", "median") if live else ("sti_psd", "median")
        win.new_tab()
        mem_tab = max(win.states)
        mem_line = run_tab(mem_tab, f"{label}_memory", f"{label}_memory",
                           n_frames, kernels, tab_tones=dir_tones,
                           peak_db=None, **kw)
        if j:
            win_dir.new_tab()
        dir_tab = max(win_dir.states)
        line = run_tab(dir_tab, f"{label}_files", str(directory), n_frames,
                       kernels, window=win_dir, tab_tones=dir_tones,
                       peak_db=None, **kw)
        got, want = win_dir.states[dir_tab].last, win.states[mem_tab].last
        for f in ("tile", "sxx_med_dbfs", "freqs", "times", "mask"):
            check(np.array_equal(getattr(got, f), getattr(want, f)),
                  f"gui {label}: the frame from files differs from "
                  f"memory's in {f}")
        line.update(directory=directory.name, frames_bit_equal_memory=True,
                    memory_first_frame_s=mem_line["first_frame_s"],
                    memory_peaks_dbfs=mem_line["peaks_dbfs"])
        emit(line)
    check(dialogs.QMessageBox.journal == [],
          f"gui: warnings {dialogs.QMessageBox.journal}")
    check(win.close() and win_dir.close(),
          "gui: a window refused to close")
    return total


# ------------------------------------------------------------ the recipes
#: the port's user recipes, run as written by the "recipes" phase
REPO = Path(__file__).resolve().parent
COOKBOOK = REPO / "docs" / "cookbook_torch.md"
DEMO = REPO / "examples" / "demo_torch.py"
#: the cookbook's device line, and the prefix of every path it writes
DEVICE_LINE = 'DEVICE = "cuda"'
RECIPE_PATHS = "/tmp/cookbook_"
#: the standing dB tolerance of a port result against another run: bins
#: within 60 dB of a tone's column peak, 30 dB of a noise column's
DB_ATOL = 1e-4
#: the kernels each recipe must launch on the card (read_counts' names):
#: at ntime <= 32 a median is the sorting network, so B2 runs in §6's
#: 64-column batch and the demo's 128-column requests; §8's hop is B3's
RECIPE_KERNELS = {
    "cookbook_1": ("sti_psd",), "cookbook_2": ("sti_psd",),
    "cookbook_3": ("sti_psd",), "cookbook_4": ("sti_psd",),
    "cookbook_5": ("sti_psd",), "cookbook_6": ("sti_psd", "median_batched"),
    "cookbook_7": ("sti_psd",), "cookbook_8": ("stream_psd",),
    "cookbook_5_mesh": ("sti_psd",), "demo": ("sti_psd", "median"),
}


def cookbook_recipes(text: str) -> list:
    """docs/cookbook_torch.md as [(label, session source, rank script or
    None)]: "cookbook_0" for what precedes §1, "cookbook_N" for section
    N; its session blocks are fenced ```python, its rank script
    ```python torchrun."""
    import re

    parts = re.split(r"^## (\d+)\. .*$", text, flags=re.M)
    out = []
    for label, body in [("0", parts[0]), *zip(parts[1::2], parts[2::2])]:
        session = re.findall(r"```python\n(.*?)```", body, re.S)
        script = re.findall(r"```python torchrun\n(.*?)```", body, re.S)
        out.append((f"cookbook_{label}", "\n\n".join(session),
                    script[0] if script else None))
    return out


def for_device(src: str, device: str, root) -> str:
    """A recipe's source with ``device`` in its device line and its paths
    under the directory ``root``."""
    check(src.count(DEVICE_LINE) <= 1, f"{DEVICE_LINE!r} twice in a block")
    return (src.replace(DEVICE_LINE, f"DEVICE = {device!r}")
            .replace(RECIPE_PATHS, f"{root}/"))


def synchronize(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run_cookbook(device: str, root):
    """Every session block of docs/cookbook_torch.md, section by section
    in one namespace, with ``device`` in its device line and its captures
    and files under ``root``. Returns (the namespace, {label: (seconds,
    launches)}). Fails if a thread the blocks started is still alive after
    them."""
    import threading

    before = set(threading.enumerate())
    ns = {"__name__": "cookbook"}
    runs = {}
    for label, session, _ in cookbook_recipes(COOKBOOK.read_text()):
        code = compile(for_device(session, device, root),
                       f"{COOKBOOK}#{label}", "exec")
        reset_counts()
        t0 = time.perf_counter()
        exec(code, ns)  # noqa: S102
        synchronize(device)
        runs[label] = (time.perf_counter() - t0, read_counts())
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive()]
    check(not left, f"cookbook on {device}: threads still running {left}")
    return ns, runs


def cookbook_rank(rank: int, world: int, port: int, src: str,
                  out_dir: str) -> None:
    """One rank of the §5 rank script (torch.multiprocessing, spawn), with
    the environment torchrun gives a rank; writes its seconds and launches
    to ``out_dir``/rank{rank}.json."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    t0 = time.perf_counter()
    code = compile(src, f"{COOKBOOK}#cookbook_5 rank {rank}", "exec")
    exec(code, {"__name__": "__main__"})  # noqa: S102
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        {"seconds": time.perf_counter() - t0, "launches": read_counts()}))


def run_cookbook_mesh(device: str, root):
    """The §5 rank script on MESH_RANKS spawned ranks, as ``torchrun
    --nproc-per-node 4`` starts it (gloo unless each rank has a card of
    its own; rank 0 writes the capture, every rank opens it). A rank's
    exception fails the run, and ranks still running after 300 s are
    killed and fail it. Returns (rank 0's saved result, each rank's
    record)."""
    import numpy as np
    import torch.multiprocessing as mp

    (src,) = [s for _, _, s in cookbook_recipes(COOKBOOK.read_text()) if s]
    out = Path(root) / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        cookbook_rank,
        args=(MESH_RANKS, _free_port(), for_device(src, device, root),
              str(out)),
        nprocs=MESH_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            fail("cookbook §5: ranks still running after 300 s")
    records = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(MESH_RANKS)]
    with np.load(Path(root) / "mesh.npz") as z:
        saved = {k: z[k] for k in z.files}
    return saved, records


def load_demo():
    """examples/demo_torch.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("demo_torch", DEMO)
    demo = importlib.util.module_from_spec(spec)
    sys.modules["demo_torch"] = demo
    spec.loader.exec_module(demo)
    return demo


def run_demo(demo, ds, device: str, out):
    """The demo's steps 2-5 on the opened dataset ``ds`` -> (what they
    printed, their seconds, their launches)."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        demo.run_steps(ds, out, device)
    synchronize(device)
    return buf.getvalue(), time.perf_counter() - t0, read_counts()


def db_close(got, want, what: str, floor_db: float, axis=-1) -> float:
    """db_diff of two dB arrays, which must be at most DB_ATOL."""
    check(got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}")
    d = db_diff(got, want, floor_db, axis)
    check(d <= DB_ATOL, f"{what}: {d} dB from the other run")
    return d


def cookbook_vs(ns: dict, ref: dict) -> dict:
    """Each recipe's results in namespace ``ns`` against the same names in
    ``ref``: dB at DB_ATOL (60 dB under a tone's peak, 30 dB under a noise
    column's), tiles as check_tiles holds them within 60 dB of the peak,
    frame axes and the scheduler's counters equal. Returns {label: what
    was held}."""
    import numpy as np

    out = {}
    a, b = ns["res"], ref["res"]
    for f in ("freqs", "times", "frame_starts", "mask"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"cookbook §1: res.{f} differs")
    out["cookbook_1"] = {
        "res_db": max(db_close(a.sxx_dbfs, b.sxx_dbfs, "§1 res", 60, 0),
                      db_close(a.sxx_med_dbfs, b.sxx_med_dbfs, "§1 med",
                               60, 0))}
    t = ref["res_t"]
    out["cookbook_2"] = {"res_t_pixels_off": check_tiles(
        ns["res_t"].tile, t.tile, "§2 res_t.tile", near_peak(
            np.moveaxis(b.sxx_dbfs, 0, -1), b.freqs, t.plot_freqs))}
    out["cookbook_3"] = {
        "med_db": db_close(ns["med"], ref["med"], "§3 med", 30),
        "view_db": db_close(ns["view"], ref["view"], "§3 view", 30)}
    check(len(ns["frames"]) == len(ref["frames"]), "§4: frame counts")
    f = ref["frames"][-1]
    out["cookbook_4"] = {"frame_pixels_off": check_tiles(
        ns["frames"][-1].tile, f.tile, "§4 frames[-1]", near_peak(
            f.sxx_med_dbfs.T, f.freqs, f.plot_freqs))}
    out["cookbook_5"] = {"res_1_db": db_close(
        ns["res_1"].sxx_dbfs, ref["res_1"].sxx_dbfs, "§5 res_1", 60, 0)}
    d = 0.0
    for name in ("results", "wide"):
        for i, (x, y) in enumerate(zip(ns[name], ref[name])):
            d = max(d, db_close(x.sxx_dbfs, y.sxx_dbfs, f"§6 {name}[{i}]",
                                60, 0),
                    db_close(x.sxx_med_dbfs, y.sxx_med_dbfs,
                             f"§6 {name}[{i}] med", 60, 0))
    out["cookbook_6"] = {"results_db": d}
    counters = [(s.merged_launches, s.merged_requests,
                 [p.skipped_recomputes for p, _ in t])
                for s, t in ((ns["sched"], ns["tabs"]),
                             (ref["sched"], ref["tabs"]))]
    check(counters[0] == counters[1], f"§7: counters {counters}")
    out["cookbook_7"] = {"merged_launches": counters[0][0],
                         "merged_requests": counters[0][1]}
    check(np.array_equal(ns["r"].frame_starts, ref["r"].frame_starts),
          "§8: r.frame_starts differ")
    out["cookbook_8"] = {"r_db": db_close(ns["r"].sxx_dbfs,
                                          ref["r"].sxx_dbfs, "§8 r", 60, 0)}
    return out


def demo_vs(out, ref, printed: str, ref_printed: str) -> dict:
    """The demo's artifacts under ``out`` against those under ``ref``: the
    peak line and the iterations it printed equal, the stream command's
    columns equal and its peak at DB_ATOL, psd.csv in dB at DB_ATOL within
    60 dB of the peak, filtered.wav within one 16-bit step, every
    artifact written."""
    import numpy as np
    from scipy.io import wavfile

    out, ref = Path(out), Path(ref)

    def lines(text, key):
        return [ln.split(" -> ")[0].split(", latency")[0]
                for ln in text.splitlines() if key in ln]

    for key in ("peak at", "iterations ["):
        check(len(lines(printed, key)) == 1
              and lines(printed, key) == lines(ref_printed, key),
              f"demo: {key!r} lines differ: {lines(printed, key)} vs "
              f"{lines(ref_printed, key)}")
    check("peak at +125.0 kHz" in printed, "demo: no +125.0 kHz peak")
    (stream,), (ref_stream,) = ([json.loads(ln) for ln in text.splitlines()
                                 if ln.startswith("{")]
                                for text in (printed, ref_printed))
    check(stream["columns"] == ref_stream["columns"]
          and stream["ring_columns"] == ref_stream["ring_columns"]
          and abs(stream["peak_dbfs"] - ref_stream["peak_dbfs"]) <= DB_ATOL,
          f"demo: stream {stream} vs {ref_stream}")
    for name in ("waterfall.png", "psd.csv", "stream.png", "filtered.wav"):
        check((out / name).is_file() and (out / name).stat().st_size > 0,
              f"demo: no {name}")
    a = np.loadtxt(out / "psd.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(ref / "psd.csv", delimiter=",", skiprows=1)
    check(np.array_equal(a[:, 0], b[:, 0]), "demo: psd.csv frequencies")
    d = db_close(a[:, 1], b[:, 1], "demo psd.csv", 60)
    (ra, wa), (rb, wb) = (wavfile.read(out / "filtered.wav"),
                          wavfile.read(ref / "filtered.wav"))
    check(ra == rb and wa.shape == wb.shape, "demo: WAVs of other shapes")
    lsb = int(np.abs(wa.astype(int) - wb.astype(int)).max())
    check(lsb <= 1, f"demo: filtered.wav differs by {lsb} steps")
    return {"psd_db": d, "wav_max_steps": lsb,
            "stream_peak_dbfs": stream["peak_dbfs"]}


def phase_recipes(card) -> dict:
    """The port's user recipes on the card as a user runs them, their
    captures written and read as Digital RF files, each held against the
    same recipe on the CPU in this process: every session block of
    docs/cookbook_torch.md (one line per section), the §5 rank script on
    four gloo ranks sharing the card (a 2x2 mesh), held against the CPU's
    one-device §5 request, and examples/demo_torch.py's step 1
    (write_capture, RFDataset) and steps 2-5. Returns the phase's
    launches, the ranks' included."""
    total = {k: 0 for k in read_counts()}
    files = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ns, runs = run_cookbook("cuda", tmp / "card")
        ref, cpu_runs = run_cookbook("cpu", tmp / "cpu")
        files["cookbook"] = len(capture_files(tmp / "card"))
        check(files["cookbook"] == len(capture_files(tmp / "cpu")) > 0,
              "recipes: the cookbook wrote no HDF5 files")
        vs = cookbook_vs(ns, ref)
        for label, (seconds, run) in runs.items():
            kernels = RECIPE_KERNELS.get(label, ())
            check(all(run[k] > 0 for k in kernels),
                  f"recipe {label}: launches {run}, expected {kernels}")
            add_counts(total, run)
            emit({"phase": f"recipe_{label}", "card": card,
                  "seconds": seconds, "cpu_seconds": cpu_runs[label][0],
                  "launches": run, "vs_cpu": vs.get(label, {})})
        del ns

        t0 = time.perf_counter()
        saved, ranks = run_cookbook_mesh("cuda", tmp / "mesh")
        seconds = time.perf_counter() - t0
        files["mesh"] = len(capture_files(tmp / "mesh"))
        check(files["mesh"] > 0, "recipe §5: rank 0 wrote no HDF5 files")
        for r, rec in enumerate(ranks):
            check(all(rec["launches"][k] > 0
                      for k in RECIPE_KERNELS["cookbook_5_mesh"]),
                  f"recipe §5: rank {r} launches {rec['launches']}")
            add_counts(total, rec["launches"])
        want = ref["res_1"]
        d = max(db_close(saved["sxx_dbfs"], want.sxx_dbfs, "§5 res_m", 60, 0),
                db_close(saved["sxx_med_dbfs"], want.sxx_med_dbfs,
                         "§5 res_m med", 60, 0))
        emit({"phase": "recipe_cookbook_5_mesh", "card": card, "mesh": [2, 2],
              "backend": "gloo", "ranks_on_one_card": len(ranks),
              "seconds": seconds,
              "rank_seconds": [r["seconds"] for r in ranks],
              "launches_by_rank": [r["launches"] for r in ranks],
              "vs_cpu": {"res_m_vs_cpu_res_1_db": d,
                         "res_m_bit_equal_res_1_on_each_rank": True}})
        del ref

        demo = load_demo()
        # the demo's step 1, as its main() takes it
        demo.write_capture(tmp / "capture", **demo.CAPTURE)
        ds = demo.RFDataset(tmp / "capture")
        files["demo"] = len(capture_files(tmp / "capture"))
        printed, seconds, run = run_demo(demo, ds, "cuda", tmp / "demo_card")
        cpu_printed, cpu_seconds, _ = run_demo(demo, ds, "cpu",
                                               tmp / "demo_cpu")
        check(all(run[k] > 0 for k in RECIPE_KERNELS["demo"]),
              f"recipe demo: launches {run}")
        add_counts(total, run)
        emit({"phase": "recipe_demo", "card": card, "steps": "2-5",
              "seconds": seconds, "cpu_seconds": cpu_seconds,
              "launches": run,
              "vs_cpu": demo_vs(tmp / "demo_card", tmp / "demo_cpu",
                                printed, cpu_printed)})
    for k in ("sti_psd", "median", "median_batched", "stream_psd"):
        check(total[k] > 0, f"recipes: kernel {k} was never launched")
    emit({"phase": "recipes", "card": card,
          "seconds": time.perf_counter() - t_phase, "hdf5_files": files,
          "launches": total})
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


#: GiB of capture the bench's --e2e rows stream, from memory and files
E2E_GB = 0.25


def phase_bench(dev, card, program_ms: float) -> dict:
    """The port's bench (pyspectrogram_tpu_torch.bench) on the card at the
    JAX bench's default shapes (nint 4, ntime 128, nsub 2): every row of
    run_all, each present with finite positive numbers and launches that
    show its kernels (BENCH_ROW_KERNELS), then main's headline line, whose
    p50_ms is printed beside phase 5's device_program_ms at the same shape
    (no check between them); then main's --e2e line at E2E_GB GiB from
    memory and with --e2e-cache (a Digital RF capture on disk), each rate
    finite and positive, B1 and B2 launched. Returns the phase's launch
    counts."""
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

    # the capture -> device rate end to end (--e2e), from memory and from
    # a Digital RF capture the bench writes into a temporary directory
    # (--e2e-cache) and reads through the port's HDF5 layer
    e2e = {}
    with tempfile.TemporaryDirectory() as cache:
        for source, extra in (("memory", []),
                              ("digital_rf", ["--e2e-cache", cache])):
            out = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = bench.main(["--device", str(dev), "--e2e", "--e2e-gb",
                                 str(E2E_GB), *extra])
            torch.cuda.synchronize()
            e2e_run = read_counts()
            row = json.loads(out.getvalue().strip().splitlines()[-1])
            check(rc == 0 and row["source"] == source
                  and all(math.isfinite(row[k]) and row[k] > 0 for k in
                          ("value", "host_ingest_samples_per_s")),
                  f"bench e2e from {source}: {row}")
            check(e2e_run["sti_psd"] > 0 and e2e_run["median"] > 0,
                  f"bench e2e from {source}: launches {e2e_run}")
            add_counts(run, e2e_run)
            e2e[source] = {"e2e_samples_per_s": row["value"],
                           "host_ingest_samples_per_s":
                               row["host_ingest_samples_per_s"],
                           "windows": row["windows"],
                           "seconds": time.perf_counter() - t0,
                           "launches": e2e_run}
    emit({"phase": "bench_e2e", "card": card, "gb": E2E_GB,
          "metric": row["metric"], **e2e})
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

    # the main path from Digital RF files on disk, written and read by the
    # port's own HDF5 layer; then the pstpu-torch commands on directories
    # (the files phase's capture among them) and the viewer, then the
    # filters at full width
    ds_long = MemoryDataset(x_long[:31 * sr], sr)
    with tempfile.TemporaryDirectory() as tmp:
        files_counts, long_top = phase_files(dev, card, tmp, live_ticks)
        add_counts(launches, files_counts)
        formats_counts = phase_files_formats(dev, card, tmp)
        add_counts(launches, formats_counts)
        cli_counts = phase_cli(dev, card, tmp, long_top)
        check(cli_counts["stream_psd"] > 0,
              "cli: B3 was never launched from the files")
        add_counts(launches, cli_counts)
        # the viewer's tabs on directories: a fixture in the latest format
        # (written tab) and the files phase's grown capture (live tab)
        x_files, ext = files_capture_samples(sr, tones)
        manifest = json.loads((FORMATS_DIR / "manifest.json").read_text())
        fx_mem, fx_dir, _ = fixture_dataset("latest_plain", manifest)
        fx_sr = manifest["samples"]["sample_rate"]
        dirs = [("fixture_latest_plain", fx_dir, fx_mem,
                 [fx_sr / 16.0, fx_sr / 8.0], False),
                ("capture", long_top,
                 MemoryDataset(np.concatenate([x_files, ext]), sr,
                               start=FILES_START * sr), tones, True)]
        add_counts(launches, phase_gui(dev, card, ds, ds_long, tones, tmp,
                                       dirs=dirs))
        del x_files, ext, dirs
    del x_long, ds_long
    phase_filter(dev, card)

    # the user recipes as written: the cookbook's blocks, its rank script on
    # four ranks sharing the card, and the demo's steps, each against the
    # same recipe on the CPU
    add_counts(launches, phase_recipes(card))

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
    # torch.fft.fft over the same windowed frames for context;
    # files_launches: those the files phase made reading from disk;
    # formats_launches: those files_formats made from the fixtures
    emit({"kernels": [
        {"name": "sti_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/sti_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:409",
         "launches": launches["sti_psd"],
         "files_launches": files_counts["sti_psd"],
         "formats_launches": formats_counts["sti_psd"],
         "max_abs_err": b1_err,
         "ms": head["b1_ms"], "plain_ms": head["b1_plain_ms"],
         "device_ms": head["b1_device_ms"],
         "bound_ms": head["b1_bound"][0], "bound_by": head["b1_bound"][1],
         "library_ms": None, "fft_alone_ms": head["b1_fft_alone_ms"]},
        {"name": "median", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/median.cu",
         "replaces": "pyspectrogram_tpu/kernels/median_pallas.py:77",
         "launches": launches["median"],
         "files_launches": files_counts["median"],
         "formats_launches": formats_counts["median"],
         "max_abs_err": 0.0,
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
         "files_launches": files_counts["stream_psd"],
         "formats_launches": formats_counts["stream_psd"],
         "max_abs_err": max(b3_err, b3["err"]),
         "ms": b3["ms"], "plain_ms": b3["plain_ms"],
         "device_ms": b3["device_ms"],
         "bound_ms": b3["bound"][0], "bound_by": b3["bound"][1],
         "library_ms": None, "fft_alone_ms": b3["fft_alone_ms"]},
        {"name": "big_psd", "route": "cuda",
         "source": "pyspectrogram_tpu_torch/csrc/big_psd.cu",
         "replaces": "pyspectrogram_tpu/kernels/sti_pallas.py:970",
         "launches": launches["big_psd"],
         "files_launches": files_counts["big_psd"],
         "formats_launches": formats_counts["big_psd"],
         "max_abs_err": b4_err,
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
