"""The PyTorch port's StiPipeline (CPU) against the JAX package's on the
same Digital RF captures, each package reading them with its own reader
and config (port_pairs)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from port_pairs import jax_config, jax_dataset
from pyspectrogram_tpu.models import sti as jsti
from pyspectrogram_tpu_torch.io import RFDataset
from pyspectrogram_tpu_torch.io.memory import MemoryDataset
from pyspectrogram_tpu_torch.models import sti
from pyspectrogram_tpu_torch.utils.config import SpectrogramConfig

REPO = Path(__file__).resolve().parents[1]
LIN = dict(rtol=2e-4, atol=1e-6)


def _db_close(got, want, floor_db=60.0, atol=1e-4):
    """dB agreement on bins within ``floor_db`` of their column's peak
    (axis 0 is frequency in the reference layout); the rest of a tone
    capture's spectrum is float32 FFT rounding of a -100 dBFS floor."""
    peak = want.max(axis=0, keepdims=True)
    keep = want >= peak - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=atol, rtol=0)


CONFIGS = [
    dict(nfft=256, nint=1, ntime=8),
    dict(nfft=512, nint=2, ntime=40),
    dict(nfft=512, nint=3, ntime=40, mode="parity"),
]


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("display_tile", [False, True])
@pytest.mark.parametrize("cfg_kw", CONFIGS)
@pytest.mark.parametrize("capture", ["tone_capture", "int16_capture"])
def test_compute_matches_jax(request, monkeypatch, capture, cfg_kw,
                             display_tile, prefetch):
    top, _ = request.getfixturevalue(capture)
    ds = RFDataset(top)
    cfg = SpectrogramConfig(display_tile=display_tile,
                            color_range_db=(-90.0, 0.0), **cfg_kw)
    if prefetch:
        monkeypatch.setattr(sti, "PREFETCH_MIN_BYTES", 0)
    got = sti.StiPipeline(ds, cfg, device="cpu").compute()
    want = jsti.StiPipeline(jax_dataset(ds), jax_config(cfg)).compute()
    assert got.iteration == want.iteration == 0
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    np.testing.assert_array_equal(got.frame_starts, want.frame_starts)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.sample_rate == want.sample_rate
    assert got.sxx_med_dbfs.shape == want.sxx_med_dbfs.shape
    _db_close(got.sxx_med_dbfs, want.sxx_med_dbfs)
    if display_tile:
        assert got.sxx_dbfs is None and want.sxx_dbfs is None
        np.testing.assert_array_equal(got.plot_freqs, want.plot_freqs)
        d = np.abs(got.tile.astype(int) - want.tile.astype(int))
        assert got.tile.dtype == np.uint8 and d.max() <= 1
        assert np.count_nonzero(d) <= 1e-3 * d.size
    else:
        assert got.tile is None and got.plot_freqs is None
        assert got.sxx_dbfs.shape == want.sxx_dbfs.shape
        _db_close(got.sxx_dbfs, want.sxx_dbfs)
        np.testing.assert_array_equal(got.sxx_time_major.shape,
                                      want.sxx_time_major.shape)


def test_compute_peak_and_request_key(tone_capture):
    """The tone sits at its frequency at ~0 dBFS; the request key and the
    iteration count behave as the JAX pipeline's."""
    top, meta = tone_capture
    ds = RFDataset(top)
    cfg = SpectrogramConfig(nfft=512, nint=2, ntime=40)
    pipe = sti.StiPipeline(ds, cfg, device="cpu")
    jcfg = jax_config(cfg)
    jpipe = jsti.StiPipeline(jax_dataset(ds), jcfg)
    # the key leads with its package's config; the rest is plain data
    key, jkey = pipe.request_key(cfg), jpipe.request_key(jcfg)
    assert jax_config(key[0]) == jkey[0] and key[1:] == jkey[1:]
    assert pipe.channel_of(cfg) == jpipe.channel_of(jcfg)
    lo, _ = ds.bnds[ds.channels[0]]
    r0, r1 = pipe.compute(), pipe.compute(sample_span=(lo, lo + 40_000))
    np.testing.assert_array_equal(
        r1.frame_starts,
        jpipe.compute(sample_span=(lo, lo + 40_000)).frame_starts)
    assert (r0.iteration, r1.iteration) == (0, 1)
    for r in (r0, r1):
        for s in range(2):
            med = r.sxx_med_dbfs[:, s]
            assert abs(med.max()) < 0.1
            assert r.freqs[med.argmax()] == pytest.approx(
                meta["freqs_hz"][s], abs=1e6 / 512)


@pytest.mark.parametrize("capture", ["tone_capture", "int16_capture"])
def test_assemble_device_block_equals_jax(request, capture):
    top, _ = request.getfixturevalue(capture)
    ds = RFDataset(top)
    jds = jax_dataset(ds)
    chan = ds.channels[0]
    lo, hi = ds.bnds[chan]
    for isub in (None, 0):
        for n_st in (ds.sti_frame_starts(lo, hi, 256, 2, 12),
                     ds.sti_frame_starts(lo, lo + 4000, 256, 1, 6),
                     np.asarray([lo, lo + 9000, hi - 512])):
            got = sti.assemble_device_block(ds, chan, isub, n_st, 512)
            want = jsti.assemble_device_block(jds, chan, isub, n_st, 512)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_prefetch_block_equals_host_block(tone_capture):
    top, _ = tone_capture
    ds = RFDataset(top)
    chan = ds.channels[0]
    lo, hi = ds.bnds[chan]
    n_st = ds.sti_frame_starts(lo, hi, 256, 2, 11)
    dev, starts, mask = sti.assemble_device_block_prefetch(
        ds, chan, None, n_st, 512, torch.device("cpu"), n_chunks=3)
    pm, starts_w, mask_w = sti.assemble_device_block(ds, chan, None, n_st, 512)
    np.testing.assert_array_equal(dev.numpy(), pm)
    np.testing.assert_array_equal(starts, starts_w)
    np.testing.assert_array_equal(mask, mask_w)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("capture", ["tone_capture", "int16_capture"])
def test_memory_dataset_matches_capture(request, monkeypatch, capture,
                                        prefetch):
    """The same samples served from memory give the HDF5 capture's
    request, bit for bit: reads, frame starts, times and spectra."""
    top, _ = request.getfixturevalue(capture)
    ds = RFDataset(top)
    chan = ds.channels[0]
    lo, hi = ds.bnds[chan]
    mem = MemoryDataset(ds.reader.read_vector_raw(lo, hi - lo + 1, chan),
                        ds.sr_dict[chan], channel=chan, start=lo,
                        ref=ds.ref_dict[chan])
    assert mem.bnds == ds.bnds and mem.time_bnds == ds.time_bnds
    assert mem.channels == ds.channels and mem.chan_entries == ds.chan_entries
    raw, mask = mem.reader.read_vector_raw(lo - 5, 20, chan, return_mask=True)
    want_raw, want_mask = ds.reader.read_vector_raw(lo - 5, 20, chan,
                                                    return_mask=True)
    np.testing.assert_array_equal(raw, want_raw)
    np.testing.assert_array_equal(mask, want_mask)
    if prefetch:
        monkeypatch.setattr(sti, "PREFETCH_MIN_BYTES", 0)
    cfg = SpectrogramConfig(nfft=512, nint=2, ntime=40, channel=f"{chan}:0")
    for c in (cfg, cfg.replace(channel=None)):
        got = sti.StiPipeline(mem, c, device="cpu").compute()
        want = sti.StiPipeline(ds, c, device="cpu").compute()
        for f in ("times", "freqs", "frame_starts", "mask", "sxx_dbfs",
                  "sxx_med_dbfs"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("capture", ["tone_capture", "int16_capture"])
def test_memory_dataset_read_matches_capture(request, capture):
    """RFDataset.read on the samples served from memory: dBFS-scaled
    complex128, whole or one subchannel, zeros past the written span."""
    top, _ = request.getfixturevalue(capture)
    ds = RFDataset(top)
    chan = ds.channels[0]
    lo, hi = ds.bnds[chan]
    mem = MemoryDataset(ds.reader.read_vector_raw(lo, hi - lo + 1, chan),
                        ds.sr_dict[chan], channel=chan, start=lo,
                        ref=ds.ref_dict[chan])
    for entry in (chan, *ds.chan_entries):
        for st, n in ((lo, 4096), (hi - 100, 300), (lo - 7, 50)):
            got, want = mem.read(st, n, entry), ds.read(st, n, entry)
            assert got.dtype == want.dtype == np.complex128
            np.testing.assert_array_equal(got, want)


def test_cuda_device_raises_without_gpu(tone_capture):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    ds = RFDataset(tone_capture[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sti.StiPipeline(ds, SpectrogramConfig(), device="cuda")


def test_port_never_imports_jax(tmp_path):
    """Importing the port (its clients included), writing a capture with
    its writer and running a request (prefetch branch included), a
    streaming push, a live tick, a merged scheduler cycle, a streaming
    processor, a filter and a CLI ``sti`` leaves jax and the JAX package
    out of the process; a fresh interpreter, since this one already holds
    both."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import pyspectrogram_tpu_torch
        import pyspectrogram_tpu_torch.clients.cli as cli
        import pyspectrogram_tpu_torch.clients.gui
        import pyspectrogram_tpu_torch.display.render
        import pyspectrogram_tpu_torch.display.tile
        import pyspectrogram_tpu_torch.io.ingest
        import pyspectrogram_tpu_torch.io.memory
        import pyspectrogram_tpu_torch.kernels._build
        import pyspectrogram_tpu_torch.kernels.big_cuda
        import pyspectrogram_tpu_torch.kernels.median_cuda
        import pyspectrogram_tpu_torch.kernels.stream_cuda
        import pyspectrogram_tpu_torch.kernels.sti_cuda
        import pyspectrogram_tpu_torch.models.sti as sti
        import pyspectrogram_tpu_torch.models.streaming as streaming
        import pyspectrogram_tpu_torch.ops.filters as filters
        import pyspectrogram_tpu_torch.ops.plain
        import pyspectrogram_tpu_torch.ops.stft
        import pyspectrogram_tpu_torch.ops.windows
        import pyspectrogram_tpu_torch.runtime.checkpoint
        import pyspectrogram_tpu_torch.runtime.live as live
        import pyspectrogram_tpu_torch.models.batch as batch
        import pyspectrogram_tpu_torch.runtime as runtime
        import pyspectrogram_tpu_torch.runtime.signals
        import pyspectrogram_tpu_torch.utils.profiling as profiling
        assert "jax" not in sys.modules, "import loaded jax"
        from pyspectrogram_tpu_torch.io import RFDataset
        from pyspectrogram_tpu_torch.io.synthetic import write_capture
        write_capture({str(tmp_path)!r}, channel="c", n_samples=1 << 14,
                      num_subchannels=2)
        sti.PREFETCH_MIN_BYTES = 0
        cfg = pyspectrogram_tpu_torch.SpectrogramConfig(nfft=256, ntime=40,
                                                        display_tile=True)
        r = sti.StiPipeline(RFDataset({str(tmp_path)!r}), cfg, "cpu").compute()
        assert r.tile.shape[:2] == (40, 2)
        s = streaming.StreamingSti(nfft=256, nsub=2, block_len=512, hop=128,
                                   ring_len=8, device="cpu")
        st, cols = s.push(s.init_state(), np.ones((4, 512), np.float32))
        assert cols.shape == (4, 2, 256)
        eng = live.LiveStreamEngine(RFDataset({str(tmp_path)!r}),
                                    cfg.replace(stream_seconds=0.002,
                                                hop=128), "cpu")
        assert eng.tick(cfg).tile.shape[1] == 2
        batch.BATCH_PREFETCH_MIN_BYTES = 0
        sched = runtime.SharedRefreshScheduler(autostart=False)
        tabs = [runtime.SpectrogramProcessor(
            "written", {str(tmp_path)!r}, i, cfg, scheduler=sched,
            device="cpu").start() for i in range(2)]
        timer = profiling.StageTimer()
        with timer.stage("cycle"):
            sched.tick_once()
        assert (sched.merged_launches, sched.merged_requests) == (1, 2)
        live_tab = runtime.SpectrogramProcessor(
            "streaming", {str(tmp_path)!r}, 2,
            cfg.replace(stream_seconds=0.002), max_iterations=1,
            device="cpu")
        live_tab.run()
        assert live_tab.has_live_state
        y = filters.filter_signal(np.ones(4096, np.complex64), 1e6,
                                  "lowpass", 1e5, nfft=256, device="cpu")
        assert y.shape == (4096,)
        assert cli.main(["sti", {str(tmp_path)!r}, "--nfft", "256",
                         "--ntime", "8", "--renderer", "pixels", "--out",
                         {str(tmp_path / "sti.png")!r}, "--device",
                         "cpu"]) == 0
        assert "jax" not in sys.modules, "a request loaded jax"
        assert not [m for m in sys.modules
                    if m.split(".")[0] == "pyspectrogram_tpu"], sys.modules
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
