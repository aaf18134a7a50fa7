"""pstpu-torch — the pstpu CLI over the PyTorch + CUDA port.

The same subcommands, flags and JSON lines as pyspectrogram_tpu's ``pstpu``
(clients/cli.py), with the compute on a torch device:

  info      — channels, subchannels, rates, bounds of a Digital RF dataset
  sti       — compute an STI and save a waterfall PNG (and optional .npz);
              --save-session persists the request tuple
  sti-batch — one STI PNG per dataset from one merged launch
  resume    — re-run a saved session exactly
  psd       — compute the median PSD and save CSV
  stream    — one pass of incremental streaming through the device ring
  watch     — live streaming viewer loop (headless GUI-equivalent)
  filter    — high/low/band-pass filter a span and write a new DRF channel
              (+ optional WAV regeneration)
  gui       — the interactive viewer
  synth     — generate a synthetic tone/chirp/noise capture
  bench     — the STI throughput benchmark (pyspectrogram_tpu_torch.bench)

One flag is added: ``--device`` on every command that computes ("cuda" by
default, or e.g. "cpu", "cuda:1"). With no CUDA device and no ``--device``,
a command prints a JSON error and exits 1; it never falls back to the CPU
by itself. ``info``, ``synth`` and the argument helpers are copies of the
JAX CLI's (pyspectrogram_tpu/clients/cli.py), on the port's own reader,
writer and config: the port imports nothing of that package.

:func:`build_parser` returns the parser; a dataset argument may also be an
opened RFDataset (such as io.memory.MemoryDataset) set on the parsed
arguments before ``args.fn(args)``, which is how a capture held in memory
is served where there is no HDF5 reader.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np

NO_CUDA = ("torch sees no CUDA device: pass --device cpu (or another torch "
           "device) to run elsewhere")


def _on_device(cmd):
    """Resolve ``args.device`` before ``cmd`` runs: "cuda" when not given.
    A CUDA device that torch does not see prints a JSON error and returns
    1 instead of running the command."""

    @functools.wraps(cmd)
    def run(args) -> int:
        import torch

        if args.device is None:
            args.device = "cuda"
        if (torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            print(json.dumps({"error": NO_CUDA}))
            return 1
        return cmd(args)

    return run


def cmd_info(args) -> int:
    from pyspectrogram_tpu_torch.io import RFDataset, sample_to_datetime

    ds = RFDataset(args.dataset)
    out = {}
    for chan in ds.channels:
        lo, hi = ds.bnds[chan]
        sr = ds.sr_dict[chan]
        out[chan] = {
            "sample_rate": str(sr),
            "num_subchannels": int(len(ds.chan_2sub[chan])),
            "bounds": [int(lo), int(hi)],
            "start": sample_to_datetime(lo, sr).isoformat(),
            "end": sample_to_datetime(hi, sr).isoformat(),
            "dbfs_ref": ds.ref_dict[chan],
            "entries": [e for e, (c, _) in ds.chan_entries.items() if c == chan],
        }
    print(json.dumps(out, indent=2))
    return 0


def _config_from(args):
    from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig

    kw = dict(
        nfft=args.nfft, nint=args.nint, ntime=args.ntime, mode=args.mode,
        channel=args.channel, precision=getattr(args, "precision", "exact"),
    )
    if args.window:
        kw["window"] = (
            ("kaiser", args.kaiser_beta) if args.window == "kaiser"
            else args.window
        )
    if args.crange:
        kw["color_range_db"] = tuple(args.crange)
    if args.frange:
        kw["freq_window_khz"] = tuple(args.frange)
    if args.tstart is not None or args.tend is not None:
        kw["time_span"] = (args.tstart, args.tend)
    if getattr(args, "hop", None):
        kw["hop"] = args.hop
    return SpectrogramConfig(**kw)


def _open(dataset):
    """A dataset argument: a Digital RF directory, or an opened RFDataset."""
    from pyspectrogram_tpu_torch.io import RFDataset

    return dataset if isinstance(dataset, RFDataset) else RFDataset(dataset)


def _label(dataset) -> str:
    """A dataset argument as its JSON and file-name label: the path, or an
    opened dataset's first channel."""
    from pyspectrogram_tpu_torch.io import RFDataset

    return (dataset.channels[0] if isinstance(dataset, RFDataset)
            else str(dataset))


@_on_device
def cmd_sti_batch(args) -> int:
    """Render one STI PNG per dataset from a SINGLE merged launch
    (models.batch: the multi-tab pattern at 1/N the launches)."""
    from pathlib import Path as _P

    from pyspectrogram_tpu_torch.display import save_sti_png
    from pyspectrogram_tpu_torch.models.batch import BatchedStiPipeline

    cfg = _config_from(args)
    requests = [(_open(d), args.channel) for d in args.datasets]
    results = BatchedStiPipeline(requests, cfg, device=args.device).compute()
    out_dir = _P(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # unique output names even when dataset basenames collide
    base_names = [_P(_label(d)).name for d in args.datasets]
    names = [
        b if base_names.count(b) == 1 else f"{i:02d}_{b}"
        for i, b in enumerate(base_names)
    ]
    outs = []
    for dset, res, stem in zip(args.datasets, results, names):
        name = out_dir / (stem + ".png")
        out = save_sti_png(
            str(name), res.freqs, res.times,
            res.sxx_dbfs[..., args.subchannel],
            colorrange=cfg.color_range_db,
            freqrange_khz=cfg.freq_window_khz,
            renderer=args.renderer, device=args.device,
        )
        outs.append({
            "dataset": _label(dset), "png": out,
            "peak_dbfs": float(res.sxx_med_dbfs[:, args.subchannel].max()),
        })
    print(json.dumps({"batched": len(outs), "results": outs}))
    return 0


@_on_device
def cmd_sti(args) -> int:
    from pyspectrogram_tpu_torch.display import save_result_npz, save_sti_png
    from pyspectrogram_tpu_torch.models.sti import StiPipeline

    ds = _open(args.dataset)
    cfg = _config_from(args)
    res = StiPipeline(ds, cfg, device=args.device).compute()
    if args.save_session:
        from pyspectrogram_tpu_torch.runtime import checkpoint

        checkpoint.save_session(
            args.save_session, _label(args.dataset), cfg,
            sample_bounds=(int(res.frame_starts[0]),
                           int(res.frame_starts[-1])))
    sub = args.subchannel
    timerange = None
    if args.t0 is not None or args.t1 is not None:
        # save-subset crop in seconds into the result (the GUI save
        # sub-tab's Start/End time fields; reference drfview.py:1434)
        t0 = res.times[0] + np.timedelta64(int((args.t0 or 0.0) * 1e6), "us")
        t1 = (res.times[-1] if args.t1 is None
              else res.times[0] + np.timedelta64(int(args.t1 * 1e6), "us"))
        timerange = (t0, t1)
    out = save_sti_png(
        args.out, res.freqs, res.times, res.sxx_dbfs[..., sub],
        colorrange=cfg.color_range_db, freqrange_khz=cfg.freq_window_khz,
        timerange=timerange, renderer=args.renderer, device=args.device,
    )
    if args.npz:
        # the --t0/--t1 subset applies to the npz sidecar like the PNG;
        # the frequency crop only with an explicit --frange (the config's
        # default display window must not drop bins from a data export)
        save_result_npz(args.npz, res.freqs, res.times, res.sxx_dbfs,
                        res.sxx_med_dbfs, timerange=timerange,
                        freqrange_khz=(tuple(args.frange)
                                       if args.frange else None))
    print(json.dumps({
        "png": out, "shape": list(res.sxx_dbfs.shape),
        "peak_dbfs": float(res.sxx_med_dbfs[..., sub].max()),
        "p50_column_db": float(np.median(res.sxx_dbfs[..., sub])),
    }))
    return 0


@_on_device
def cmd_resume(args) -> int:
    """Re-run a saved session exactly (dataset + full request tuple: any
    STI is reproducible from its request because samples are absolutely
    indexed)."""
    from pyspectrogram_tpu_torch.display import save_sti_png
    from pyspectrogram_tpu_torch.models.sti import StiPipeline
    from pyspectrogram_tpu_torch.runtime import checkpoint

    sess = checkpoint.load_session(args.session)
    ds = _open(args.dataset or sess["dataset_dir"])
    cfg = sess["config"]
    # the saved absolute frame bounds keep the rerun exact even on a
    # capture that has GROWN since the save
    res = StiPipeline(ds, cfg, device=args.device).compute(
        sample_span=sess.get("sample_bounds"))
    out = save_sti_png(
        args.out, res.freqs, res.times, res.sxx_dbfs[..., args.subchannel],
        colorrange=cfg.color_range_db, freqrange_khz=cfg.freq_window_khz,
        renderer=args.renderer, device=args.device,
    )
    print(json.dumps({
        "png": out, "shape": list(res.sxx_dbfs.shape),
        "config": {"nfft": cfg.nfft, "nint": cfg.nint, "ntime": cfg.ntime,
                   "mode": cfg.mode},
        "frame_start0": int(res.frame_starts[0]),
    }))
    return 0


@_on_device
def cmd_psd(args) -> int:
    from pyspectrogram_tpu_torch.display import save_psd_csv
    from pyspectrogram_tpu_torch.models.sti import StiPipeline

    res = StiPipeline(_open(args.dataset), _config_from(args),
                      device=args.device).compute()
    out = save_psd_csv(args.out, res.freqs, res.sxx_med_dbfs[:, args.subchannel])
    print(json.dumps({"csv": out, "nbins": len(res.freqs)}))
    return 0


@_on_device
def cmd_filter(args) -> int:
    from pyspectrogram_tpu_torch.io import DigitalRFWriter
    from pyspectrogram_tpu_torch.ops.filters import filter_signal, save_wav

    ds = _open(args.dataset)
    chan = args.channel or ds.channels[0]
    lo, hi = ds.bnds[chan.split(":")[0]]
    x = ds.read(lo, hi - lo + 1, chan)
    if x.ndim == 2:
        x = x[:, args.subchannel]
    cutoff = args.cutoff[0] if len(args.cutoff) == 1 else tuple(args.cutoff)
    sr = ds.sr_dict[chan.split(":")[0]]
    y = filter_signal(x, float(sr), args.kind, cutoff, nfft=args.nfft,
                      device=args.device)
    w = DigitalRFWriter(
        args.out, f"{chan.split(':')[0]}_filtered", np.complex64,
        start_global_index=lo,
        sample_rate_numerator=sr.numerator,
        sample_rate_denominator=sr.denominator,
    )
    w.rf_write(y.astype(np.complex64))
    result = {"out": str(args.out), "n_samples": len(y)}
    if args.wav:
        result["wav"] = save_wav(args.wav, y, int(sr))
    print(json.dumps(result))
    return 0


@_on_device
def cmd_stream(args) -> int:
    """Incremental streaming: prefetch blocks from disk, push them through
    the STI ring on the device, save the final waterfall + median PSD."""
    from pyspectrogram_tpu_torch.display import save_sti_png
    from pyspectrogram_tpu_torch.io import sample_to_datetime
    from pyspectrogram_tpu_torch.io.ingest import stream_blocks
    from pyspectrogram_tpu_torch.models.sti import to_device
    from pyspectrogram_tpu_torch.models.streaming import StreamingSti
    from pyspectrogram_tpu_torch.ops.stft import shifted_freqs

    ds = _open(args.dataset)
    chan = (args.channel or ds.channels[0]).split(":")[0]
    lo, hi = ds.bnds[chan]
    nsub = len(ds.chan_2sub[chan])
    sr = ds.sr_dict[chan]
    # --hop < nfft*nint overlaps consecutive columns (overlap-save); each
    # block feeds cols_per_block columns spaced hop samples apart, with
    # the frame_len - hop carry riding between pushes
    hop = args.hop or args.nfft * args.nint
    block_len = hop * args.cols_per_block
    n_blocks = (hi - lo + 1) // block_len
    if n_blocks == 0:
        print(json.dumps({"error": "capture shorter than one block"}))
        return 1

    s = StreamingSti(
        nfft=args.nfft, nint=args.nint, nsub=nsub, block_len=block_len,
        hop=hop, ring_len=args.ring_len, mode=args.mode,
        ref=ds.ref_dict[chan], precision=args.precision, device=args.device,
    )
    state = s.init_state()
    # blocks come read and packed in their storage dtype (int16 copies
    # half the bytes; the ring's power scale folds the dBFS reference);
    # each is copied to the device here, on this thread's stream
    for blk in stream_blocks(ds, chan, lo, block_len, n_blocks):
        state, _ = s.push(state, to_device(blk, s.device), return_db=False)
    ring_db, nvalid = s.snapshot(state)
    freqs = shifted_freqs(args.nfft, sr)
    cols = ring_db[args.ring_len - nvalid:]          # oldest -> newest
    # overlapping hops: the first frame borrows the (zero) initial carry,
    # so column k's frame starts carry_len samples BEFORE lo + k*hop
    first_col_sample = (lo - (s.frame_len - s.hop)
                        + (int(state.total_cols) - nvalid) * s.hop)
    times = np.asarray([
        sample_to_datetime(first_col_sample + k * s.hop, sr)
        for k in range(nvalid)
    ])
    out = save_sti_png(
        args.out, freqs, times, cols[..., args.subchannel, :].T,
        colorrange=tuple(args.crange) if args.crange else (-110.0, -40.0),
        renderer=args.renderer, device=args.device,
    )
    print(json.dumps({
        "png": out,
        "columns": int(state.total_cols),
        "ring_columns": nvalid,
        "peak_dbfs": float(s.median_psd(state)[args.subchannel].max()),
    }))
    return 0


@_on_device
def cmd_watch(args) -> int:
    """Live viewer, headless: run the streaming processor loop against a
    (possibly growing) capture, printing one status line per refresh and
    saving the final waterfall (the reference GUI's live mode without Qt;
    reference: drfProc.py:239-241, 291-293)."""
    from pyspectrogram_tpu_torch.display import save_sti_png, save_tile_png
    from pyspectrogram_tpu_torch.runtime import (
        ProcessorCallbacks,
        SpectrogramProcessor,
    )

    last = {}

    def on_iter(e):
        peak = float(e.sxx_med_dbfs[:, args.subchannel].max())
        ngap = int((~e.mask).sum()) if e.mask is not None else 0
        print(f"# iter {e.i}: {len(e.times)} cols, "
              f"peak {peak:6.1f} dBFS, "
              f"span {np.datetime_as_string(e.times[0], unit='s')[11:]} .. "
              f"{np.datetime_as_string(e.times[-1], unit='s')[11:]}"
              + (f", {ngap} gap cols" if ngap else ""),
              file=sys.stderr)
        last["e"] = e

    # the live loop runs the on-device display path: every refresh reads
    # back a uint8 tile + the median PSD, never the float spectra
    cfg = _config_from(args).replace(stream_seconds=args.window_s,
                                     display_tile=True)
    proc = SpectrogramProcessor(
        "streaming", args.dataset, tab_id=0, config=cfg,
        callbacks=ProcessorCallbacks(on_iterated=on_iter),
        streaming_sleep=args.refresh_s,
        max_iterations=args.iterations, device=args.device,
    )
    if not proc.is_running:
        print(json.dumps({"error": proc.reason.describe()}))
        return 1
    if args.resume:
        try:
            proc.preload_live_state(args.resume)
        except (ValueError, KeyError, OSError) as err:
            print(json.dumps({"error": f"cannot resume {args.resume}: "
                                       f"{err}"}))
            return 1
    try:
        proc.run()
    except KeyboardInterrupt:
        proc.abort()
    ckpt = None
    if args.checkpoint:
        try:
            ckpt = str(proc.save_live_state(args.checkpoint))
        except ValueError as err:  # e.g. zero completed iterations
            print(f"# checkpoint not written: {err}", file=sys.stderr)
    e = last.get("e")
    if e is None:
        print(json.dumps({"error": "no iterations completed"}))
        return 1
    if e.tile is not None:
        # final frame straight from the last device tile (host = LUT only)
        out = save_tile_png(args.out, e.tile[:, args.subchannel, :])
    else:
        out = save_sti_png(
            args.out, e.freqs, e.times, e.sxx_dbfs[..., args.subchannel],
            colorrange=cfg.color_range_db, freqrange_khz=cfg.freq_window_khz,
            renderer=args.renderer, device=args.device,
        )
    print(json.dumps({
        "png": out, "iterations": e.i + 1,
        "latency": proc.latency_stats(),
        **({"checkpoint": ckpt} if ckpt else {}),
    }))
    return 0


@_on_device
def cmd_gui(args) -> int:
    """Launch the interactive viewer (the reference's `python drfview.py`
    entry, reference: drfview.py:1760-1763) on ``--device``."""
    from pyspectrogram_tpu_torch.clients import gui as gui_mod

    try:
        gui_mod.require_qt()
    except ImportError as err:
        print(json.dumps({"error": str(err)}))
        return 1
    return gui_mod.main(args.device)


@_on_device
def cmd_bench(args) -> int:
    """The port's STI throughput (bench.bench_sti) at --nfft/--nint/--ntime
    on ``--device``: the JAX command's keys plus the card's name and power
    limit."""
    from pyspectrogram_tpu_torch import bench

    sps, p50, p99 = bench.bench_sti(nfft=args.nfft, nint=args.nint,
                                    ntime=args.ntime, iters=args.iters,
                                    device=args.device)
    print(json.dumps({"samples_per_sec": sps, "p50_s": p50, "p99_s": p99,
                      "card": bench.card_of(args.device)}))
    return 0


#: synth --dtype choices: the float default plus the raw integer layouts
#: real receivers record (int16 exercises the folded dBFS scale and the
#: half-byte device transfers end-to-end)
SYNTH_DTYPES = {
    "complex64": np.complex64,
    "int16": np.dtype([("r", np.int16), ("i", np.int16)]),
    "float32": np.float32,
}


def cmd_synth(args) -> int:
    from pyspectrogram_tpu_torch.io.synthetic import write_capture

    meta = write_capture(
        args.out, channel=args.channel or "ch0", kind=args.kind,
        n_samples=args.n_samples,
        sample_rate_numerator=args.sample_rate,
        num_subchannels=args.nsub,
        dtype=SYNTH_DTYPES[args.dtype],
        freqs_hz=args.freqs if args.freqs else None,
        noise_rms=args.noise_rms,
    )
    print(json.dumps(meta))
    return 0


def _add_common(p):
    p.add_argument("--channel", default=None, help="chan or chan:sub")
    p.add_argument("--subchannel", type=int, default=0)
    p.add_argument("--nfft", type=int, default=1024)
    p.add_argument("--nint", type=int, default=1)
    p.add_argument("--ntime", type=int, default=100)
    p.add_argument("--mode", choices=["welch", "parity"], default="welch")
    p.add_argument("--precision",
                   choices=["exact", "balanced", "display"],
                   default="exact",
                   help="DFT numerics: exact (~1e-5 dB), balanced "
                        "(~7e-4 dB, faster), display (~0.12 dB, fastest)")
    p.add_argument("--window", default="kaiser",
                   choices=["kaiser", "hann", "hamming", "blackman", "boxcar"])
    p.add_argument("--kaiser-beta", type=float, default=1.7)
    p.add_argument("--crange", type=float, nargs=2, metavar=("MIN", "MAX"))
    p.add_argument("--frange", type=float, nargs=2, metavar=("KHZ_MIN", "KHZ_MAX"))
    p.add_argument("--tstart", type=float, help="start time (s since epoch)")
    p.add_argument("--tend", type=float, help="end time (s since epoch)")


def _add_device(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to compute on (default: cuda; with "
                        "no CUDA device the command refuses to run)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pstpu-torch",
        description="Digital RF spectrograms on PyTorch + CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="describe a Digital RF dataset")
    p.add_argument("dataset")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("sti", help="render an STI waterfall PNG")
    p.add_argument("dataset")
    p.add_argument("--out", default="sti.png")
    p.add_argument("--npz", default=None, help="also dump arrays to .npz")
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "matplotlib", "pixels"])
    p.add_argument("--save-session", default=None,
                   help="persist the request tuple for exact resume")
    p.add_argument("--t0", type=float, default=None,
                   help="save only columns from T0 seconds into the result")
    p.add_argument("--t1", type=float, default=None,
                   help="save only columns up to T1 seconds into the result")
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_sti)

    p = sub.add_parser(
        "sti-batch",
        help="render STIs for several datasets in ONE device launch")
    p.add_argument("datasets", nargs="+")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "matplotlib", "pixels"])
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_sti_batch)

    p = sub.add_parser("resume", help="re-run a saved session exactly")
    p.add_argument("session")
    p.add_argument("--dataset", default=None,
                   help="override the saved dataset path")
    p.add_argument("--out", default="resumed.png")
    p.add_argument("--subchannel", type=int, default=0)
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "matplotlib", "pixels"])
    _add_device(p)
    p.set_defaults(fn=cmd_resume)

    p = sub.add_parser("psd", help="save the median PSD as CSV")
    p.add_argument("dataset")
    p.add_argument("--out", default="psd.csv")
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_psd)

    p = sub.add_parser("filter", help="spectral filter -> new DRF channel")
    p.add_argument("dataset")
    p.add_argument("--out", required=True, help="output DRF top dir")
    p.add_argument("--kind", required=True,
                   choices=["lowpass", "highpass", "bandpass", "bandstop"])
    p.add_argument("--cutoff", type=float, nargs="+", required=True,
                   help="Hz (1 value) or band lo hi (2 values)")
    p.add_argument("--channel", default=None)
    p.add_argument("--subchannel", type=int, default=0)
    p.add_argument("--nfft", type=int, default=1024)
    p.add_argument("--wav", default=None,
                   help="also write the regenerated signal as 16-bit WAV")
    _add_device(p)
    p.set_defaults(fn=cmd_filter)

    p = sub.add_parser("stream", help="incremental STI via the device ring")
    p.add_argument("dataset")
    p.add_argument("--out", default="stream.png")
    p.add_argument("--channel", default=None)
    p.add_argument("--subchannel", type=int, default=0)
    p.add_argument("--nfft", type=int, default=1024)
    p.add_argument("--nint", type=int, default=1)
    p.add_argument("--mode", choices=["welch", "parity"], default="welch")
    p.add_argument("--precision", default="exact",
                   choices=["exact", "balanced", "display"],
                   help="DFT numerics tier for the live ring")
    p.add_argument("--cols-per-block", type=int, default=8)
    p.add_argument("--ring-len", type=int, default=512)
    p.add_argument("--hop", type=int, default=None,
                   help="column hop in samples (< nfft*nint overlaps "
                        "columns, overlap-save; default nfft*nint = "
                        "contiguous)")
    p.add_argument("--crange", type=float, nargs=2)
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "matplotlib", "pixels"])
    _add_device(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("watch", help="live streaming viewer (headless)")
    p.add_argument("dataset")
    p.add_argument("--out", default="watch.png")
    p.add_argument("--window-s", type=float, default=30.0,
                   help="trailing window span (reference streamtime)")
    p.add_argument("--refresh-s", type=float, default=0.08)
    p.add_argument("--iterations", type=int, default=None,
                   help="stop after N refreshes (default: run until Ctrl-C)")
    p.add_argument("--hop", type=int, default=None,
                   help="live column hop in samples (< nfft*nint overlaps "
                        "columns; default nfft*nint = contiguous)")
    _add_common(p)
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "matplotlib", "pixels"])
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write the mid-stream state (ring + read cursor) "
                        "here when the loop ends")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="continue a previous --checkpoint stream instead "
                        "of cold-starting the trailing window")
    _add_device(p)
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("gui", help="launch the interactive Qt viewer")
    _add_device(p)
    p.set_defaults(fn=cmd_gui)

    p = sub.add_parser("synth", help="write a synthetic capture")
    p.add_argument("--out", required=True)
    p.add_argument("--kind", default="tone", choices=["tone", "chirp", "noise"])
    p.add_argument("--channel", default="ch0")
    p.add_argument("--n-samples", type=int, default=1 << 18)
    p.add_argument("--sample-rate", type=int, default=1_000_000)
    p.add_argument("--nsub", type=int, default=1)
    p.add_argument("--freqs", type=float, nargs="+", default=None)
    p.add_argument("--noise-rms", type=float, default=0.0)
    p.add_argument("--dtype", default="complex64",
                   choices=sorted(SYNTH_DTYPES))
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("bench", help="throughput benchmark")
    p.add_argument("--nfft", type=int, default=4096)
    p.add_argument("--nint", type=int, default=4)
    p.add_argument("--ntime", type=int, default=128)
    p.add_argument("--iters", type=int, default=None,
                   help="calls per reading (default: enough for 20 ms)")
    _add_device(p)
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout consumer closed early (e.g. `pstpu-torch info | head`):
        # exit quietly like a well-behaved unix tool
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
