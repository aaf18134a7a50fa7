"""The port's pstpu-torch CLI (``--device cpu``) against the JAX package's
pstpu on the same captures: the flows of tests/test_cli.py without the
bench.py ones.

Tolerances (ROADMAP Queue 3): frame axes, shapes, counts and file layouts
equal; dB within 1e-4 dB on bins within 60 dB of each column's peak (the
peaks included); ``p50_column_db``, a median over every bin where most sit
at a pure tone's float32 rounding floor, within 0.05 dB; uint8 pixels
within one level on <= 0.1% of them; filtered samples within 1e-5 on the
fully covered interior.
"""

import json

import numpy as np
import pytest
import torch

from pyspectrogram_tpu.clients import cli as jcli
from pyspectrogram_tpu.io import RFDataset
from pyspectrogram_tpu_torch.clients import cli
from pyspectrogram_tpu_torch.io.memory import MemoryDataset

DEV = ("--device", "cpu")


def _run(capsys, main, *argv):
    rc = main([str(a) for a in argv])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def _db_close(got, want, floor_db=60.0, atol=1e-4):
    keep = want >= want.max(axis=0, keepdims=True) - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=atol, rtol=0)


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _near_png(a, b):
    pa, pb = _png(a), _png(b)
    assert pa.shape == pb.shape
    assert np.count_nonzero((pa != pb).any(-1)) <= 1e-3 * pa[..., 0].size


def _synth(capsys, out, *extra, n=65536, freqs=(125000,)):
    rc, meta = _run(capsys, cli.main, "synth", "--out", out, "--kind",
                    "tone", "--n-samples", n, "--sample-rate", "1000000",
                    "--freqs", *freqs, *extra)
    assert rc == 0
    return meta


@pytest.fixture(scope="module")
def cap(tmp_path_factory):
    """A two-subchannel tone capture (125 kHz and -250 kHz) with a noise
    floor, written through the JAX package's writer."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    top = tmp_path_factory.mktemp("cli_cap")
    write_capture(top, channel="ch0", kind="tone", n_samples=1 << 16,
                  sample_rate_numerator=1_000_000, num_subchannels=2,
                  freqs_hz=[125_000.0, -250_000.0], noise_rms=1e-3)
    return top


def test_synth_info_match_jax(tmp_path, capsys):
    meta = _synth(capsys, tmp_path / "cap")
    assert meta["channel"] == "ch0"
    rc = cli.main(["info", str(tmp_path / "cap")])
    info = json.loads(capsys.readouterr().out)        # indented JSON
    jcli.main(["info", str(tmp_path / "cap")])
    assert rc == 0 and info == json.loads(capsys.readouterr().out)
    assert info["ch0"]["entries"] == ["ch0:0"]


def test_sti_and_npz_match_jax(cap, tmp_path, capsys):
    argv = ("--nfft", "512", "--ntime", "12", "--renderer", "pixels")
    rc, got = _run(capsys, cli.main, "sti", cap, "--out", tmp_path / "p.png",
                   "--npz", tmp_path / "p.npz", *argv, *DEV)
    _, want = _run(capsys, jcli.main, "sti", cap, "--out",
                   tmp_path / "j.png", "--npz", tmp_path / "j.npz", *argv)
    assert rc == 0 and got["shape"] == want["shape"] == [512, 12, 2]
    assert abs(got["peak_dbfs"]) < 0.1
    assert got["peak_dbfs"] == pytest.approx(want["peak_dbfs"], abs=1e-4)
    assert got["p50_column_db"] == pytest.approx(want["p50_column_db"],
                                                 abs=0.05)
    _near_png(got["png"], want["png"])
    a, b = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(a["freqs"], b["freqs"])
    np.testing.assert_array_equal(a["times"], b["times"])
    _db_close(a["sxx_dbfs"], b["sxx_dbfs"])
    _db_close(a["sxx_med_dbfs"], b["sxx_med_dbfs"])


def test_sti_subsets_match_jax(cap, tmp_path, capsys):
    """--t0/--t1 crop the PNG rows and the npz columns; the npz keeps
    every bin unless --frange is given — as the JAX CLI does."""
    argv = ("--nfft", "512", "--ntime", "12", "--renderer", "pixels")
    for tag, extra in (("half", ("--t0", "0", "--t1", "0.03")),
                       ("fr", ("--frange", "-100", "100"))):
        for main, who in ((cli.main, "p"), (jcli.main, "j")):
            dev = DEV if who == "p" else ()
            _run(capsys, main, "sti", cap, "--out",
                 tmp_path / f"{who}{tag}.png", "--npz",
                 tmp_path / f"{who}{tag}.npz", *argv, *extra, *dev)
        _near_png(tmp_path / f"p{tag}.png", tmp_path / f"j{tag}.png")
        a = np.load(tmp_path / f"p{tag}.npz")
        b = np.load(tmp_path / f"j{tag}.npz")
        assert a["sxx_dbfs"].shape == b["sxx_dbfs"].shape
        np.testing.assert_array_equal(a["times"], b["times"])
        np.testing.assert_array_equal(a["freqs"], b["freqs"])
    assert 0 < np.load(tmp_path / "phalf.npz")["sxx_dbfs"].shape[1] < 12
    assert np.all(np.abs(np.load(tmp_path / "pfr.npz")["freqs"]) <= 100e3)


def test_psd_matches_jax(cap, tmp_path, capsys):
    argv = ("--nfft", "256", "--ntime", "40", "--subchannel", "1")
    rc, got = _run(capsys, cli.main, "psd", cap, "--out", tmp_path / "p.csv",
                   *argv, *DEV)
    _, want = _run(capsys, jcli.main, "psd", cap, "--out",
                   tmp_path / "j.csv", *argv)
    assert rc == 0 and got["nbins"] == want["nbins"] == 256
    a = np.loadtxt(got["csv"], delimiter=",", skiprows=1)
    b = np.loadtxt(want["csv"], delimiter=",", skiprows=1)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    _db_close(a[:, 1], b[:, 1])
    assert b[np.argmax(a[:, 1]), 0] == pytest.approx(-250e3, abs=1e6 / 256)


def test_one_sided_time_bounds(cap, tmp_path, capsys):
    rc, a = _run(capsys, cli.main, "sti", cap, "--out", tmp_path / "a.png",
                 "--nfft", "256", "--ntime", "6", "--renderer", "pixels",
                 "--tstart", "1451661840.005", *DEV)
    _, b = _run(capsys, jcli.main, "sti", cap, "--out", tmp_path / "b.png",
                "--nfft", "256", "--ntime", "6", "--renderer", "pixels",
                "--tstart", "1451661840.005")
    assert rc == 0 and a["peak_dbfs"] > -5.0
    assert a["peak_dbfs"] == pytest.approx(b["peak_dbfs"], abs=1e-4)
    rc, _ = _run(capsys, cli.main, "psd", cap, "--out", tmp_path / "c.csv",
                 "--nfft", "256", "--ntime", "6", "--tend",
                 "1451661840.02", *DEV)
    assert rc == 0


@pytest.mark.parametrize("collide", [False, True])
def test_sti_batch_matches_jax(tmp_path, capsys, collide):
    """One merged launch of 3 captures; same-basename datasets get
    distinct files and a missing --out-dir is created."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    dirs = [tmp_path / (f"day{i}/capture" if collide else f"d{i}")
            for i in range(3)]
    for i, d in enumerate(dirs):
        write_capture(d, channel=f"c{i}", kind="tone", n_samples=1 << 14,
                      sample_rate_numerator=1_000_000,
                      freqs_hz=[125_000.0 * (i + 1)])
    argv = ("--nfft", "512", "--ntime", "8", "--renderer", "pixels")
    rc, got = _run(capsys, cli.main, "sti-batch", *dirs, "--out-dir",
                   tmp_path / "new" / "p", *argv, *DEV)
    _, want = _run(capsys, jcli.main, "sti-batch", *dirs, "--out-dir",
                   tmp_path / "new" / "j", *argv)
    assert rc == 0 and got["batched"] == want["batched"] == 3
    assert len({r["png"] for r in got["results"]}) == 3
    for g, w in zip(got["results"], want["results"]):
        assert g["dataset"] == w["dataset"]
        assert g["png"].split("/")[-1] == w["png"].split("/")[-1]
        assert abs(g["peak_dbfs"]) < 0.01
        assert g["peak_dbfs"] == pytest.approx(w["peak_dbfs"], abs=1e-4)
        _near_png(g["png"], w["png"])


@pytest.mark.parametrize("hop", [None, 128])
def test_stream_matches_jax(tmp_path, capsys, hop):
    _synth(capsys, tmp_path / "cap", freqs=(-250000,))
    argv = ("--nfft", "256", "--cols-per-block", "4", "--ring-len", "64",
            "--renderer", "pixels") + (("--hop", hop) if hop else ())
    rc, got = _run(capsys, cli.main, "stream", tmp_path / "cap", "--out",
                   tmp_path / "p.png", *argv, *DEV)
    _, want = _run(capsys, jcli.main, "stream", tmp_path / "cap", "--out",
                   tmp_path / "j.png", *argv)
    assert rc == 0
    assert got["columns"] == want["columns"] == 65536 // (hop or 256)
    assert got["ring_columns"] == want["ring_columns"] == 64
    assert abs(got["peak_dbfs"]) < 0.1
    assert got["peak_dbfs"] == pytest.approx(want["peak_dbfs"], abs=1e-4)
    _near_png(got["png"], want["png"])


def test_stream_int16_matches_jax(tmp_path, capsys):
    """A raw int16 capture streams unconverted: the 2^14 tone lands at
    20*log10(2^-1.5) = -9.03 dBFS against the 2^15.5 reference."""
    meta = _synth(capsys, tmp_path / "cap16", "--dtype", "int16")
    assert meta["scale"] == 2 ** 14
    argv = ("--nfft", "512", "--renderer", "pixels")
    rc, got = _run(capsys, cli.main, "stream", tmp_path / "cap16", "--out",
                   tmp_path / "p.png", *argv, *DEV)
    _, want = _run(capsys, jcli.main, "stream", tmp_path / "cap16", "--out",
                   tmp_path / "j.png", *argv)
    assert rc == 0 and got["peak_dbfs"] == pytest.approx(-9.031, abs=0.05)
    assert got["peak_dbfs"] == pytest.approx(want["peak_dbfs"], abs=1e-4)


def test_stream_refusals(tmp_path, capsys):
    _synth(capsys, tmp_path / "cap", n=16384)
    with pytest.raises(ValueError, match="hop"):
        cli.main(["stream", str(tmp_path / "cap"), "--out",
                  str(tmp_path / "x.png"), "--nfft", "256", "--hop", "512",
                  *DEV])
    rc, res = _run(capsys, cli.main, "stream", tmp_path / "cap", "--nfft",
                   "4096", "--cols-per-block", "8", *DEV)
    assert rc == 1 and res == {"error": "capture shorter than one block"}


@pytest.mark.parametrize("hop", [None, 128])
def test_watch_matches_jax(tmp_path, capsys, hop):
    _synth(capsys, tmp_path / "cap", n=131072, freqs=(50000,))
    argv = ("--nfft", "256", "--ntime", "8", "--window-s", "0.05",
            "--refresh-s", "0.0", "--iterations", "3", "--renderer",
            "pixels") + (("--hop", hop) if hop else ())
    rc, got = _run(capsys, cli.main, "watch", tmp_path / "cap", "--out",
                   tmp_path / "p.png", *argv, *DEV)
    _, want = _run(capsys, jcli.main, "watch", tmp_path / "cap", "--out",
                   tmp_path / "j.png", *argv)
    assert rc == 0 and got["iterations"] == want["iterations"] == 3
    assert got["latency"]["n"] == want["latency"]["n"] == 3
    assert set(got) == set(want)
    _near_png(got["png"], want["png"])


def test_watch_checkpoint_resume_crosses_packages(tmp_path, capsys):
    """watch --checkpoint writes the stream state; --resume continues it,
    from the port's file or the JAX CLI's, in either package."""
    _synth(capsys, tmp_path / "cap", n=131072, freqs=(50000,))
    argv = ("--nfft", "256", "--ntime", "8", "--window-s", "0.05",
            "--refresh-s", "0.0", "--iterations", "2", "--renderer",
            "pixels")
    rc, res = _run(capsys, cli.main, "watch", tmp_path / "cap", "--out",
                   tmp_path / "w1.png", *argv, "--checkpoint",
                   tmp_path / "p.ckpt", *DEV)
    assert rc == 0 and res["checkpoint"].endswith(".npz")
    _, jres = _run(capsys, jcli.main, "watch", tmp_path / "cap", "--out",
                   tmp_path / "j1.png", *argv, "--checkpoint",
                   tmp_path / "j.ckpt")
    for i, ck in enumerate((res["checkpoint"], jres["checkpoint"])):
        rc, res2 = _run(capsys, cli.main, "watch", tmp_path / "cap", "--out",
                        tmp_path / f"w{i}.png", *argv, "--resume", ck, *DEV)
        assert rc == 0 and res2["iterations"] == 2
        assert "checkpoint" not in res2
    rc, jres2 = _run(capsys, jcli.main, "watch", tmp_path / "cap", "--out",
                     tmp_path / "j2.png", *argv, "--resume",
                     res["checkpoint"])
    assert rc == 0 and jres2["iterations"] == 2
    rc, bad = _run(capsys, cli.main, "watch", tmp_path / "cap", *argv,
                   "--resume", tmp_path / "missing.npz", *DEV)
    assert rc == 1 and "cannot resume" in bad["error"]


def test_filter_and_wav_match_jax(tmp_path, capsys):
    _synth(capsys, tmp_path / "cap", n=32768, freqs=(300000,))
    argv = ("--kind", "lowpass", "--cutoff", "100000", "--nfft", "512")
    rc, got = _run(capsys, cli.main, "filter", tmp_path / "cap", "--out",
                   tmp_path / "pf", *argv, "--wav", tmp_path / "pa", *DEV)
    _, want = _run(capsys, jcli.main, "filter", tmp_path / "cap", "--out",
                   tmp_path / "jf", *argv, "--wav", tmp_path / "ja")
    assert rc == 0 and got["n_samples"] == want["n_samples"]
    ys = []
    for top in (tmp_path / "pf", tmp_path / "jf"):
        ds = RFDataset(top)
        chan = ds.channels[0]
        lo, hi = ds.bnds[chan]
        ys.append(ds.read(lo, hi - lo + 1, chan))
    assert ds.channels == ["ch0_filtered"]
    np.testing.assert_allclose(ys[0][512:-512], ys[1][512:-512], atol=1e-5)
    assert np.abs(ys[0][512:-512]).max() < 1e-2    # the tone is cut
    from scipy.io import wavfile

    rate, data = wavfile.read(got["wav"])
    assert got["wav"].endswith(".wav") and rate == 1_000_000
    assert len(data) == len(wavfile.read(want["wav"])[1])


def test_session_save_and_resume_match_jax(tmp_path, capsys):
    """resume re-runs the saved request exactly, even after the capture
    grew; the port reads the JAX CLI's session file and the JAX CLI the
    port's."""
    from pyspectrogram_tpu.io.synthetic import tone_signal
    from pyspectrogram_tpu.io.writer import DigitalRFWriter

    _synth(capsys, tmp_path / "cap", n=32768, freqs=(100000,))
    argv = ("--nfft", "512", "--ntime", "10", "--renderer", "pixels")
    rc, a = _run(capsys, cli.main, "sti", tmp_path / "cap", "--out",
                 tmp_path / "a.png", *argv, "--save-session",
                 tmp_path / "p.npz", *DEV)
    _run(capsys, jcli.main, "sti", tmp_path / "cap", "--out",
         tmp_path / "ja.png", *argv, "--save-session", tmp_path / "j.npz")
    assert rc == 0
    w = DigitalRFWriter(tmp_path / "cap", "ch0", np.complex64,
                        start_global_index=1451661840 * 1_000_000 + 32768,
                        sample_rate_numerator=1_000_000,
                        file_cadence_millisecs=1000,
                        subdir_cadence_secs=3600)
    w.rf_write(tone_signal(32768, 1_000_000, [100000.0]).astype(np.complex64))
    runs = []
    for main, sess, dev in ((cli.main, "p", DEV), (cli.main, "j", DEV),
                            (jcli.main, "p", ())):
        rc, r = _run(capsys, main, "resume", tmp_path / f"{sess}.npz",
                     "--out", tmp_path / f"r{len(runs)}.png", "--renderer",
                     "pixels", *dev)
        assert rc == 0
        runs.append(r)
    for r in runs:
        assert r["config"] == {"nfft": 512, "nint": 1, "ntime": 10,
                               "mode": "welch"}
        assert r["shape"] == a["shape"]
        assert r["frame_start0"] == runs[0]["frame_start0"]
    _near_png(runs[0]["png"], runs[2]["png"])


def test_rejects_bad_args(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main(["sti"])  # missing dataset
    with pytest.raises(SystemExit):
        cli.main(["filter", str(tmp_path), "--out", "x", "--kind", "nope",
                  "--cutoff", "1", *DEV])


def test_gui_headless_errors_as_json(capsys):
    rc, res = _run(capsys, cli.main, "gui", *DEV)
    assert rc == 1 and "PyQt5" in res["error"]


def test_bench_is_not_ported_yet(capsys):
    rc, res = _run(capsys, cli.main, "bench")
    assert rc == 1 and "no bench" in res["error"]


@pytest.mark.parametrize("argv", [
    ("sti", "D"), ("psd", "D"), ("sti-batch", "D", "D"), ("stream", "D"),
    ("watch", "D"), ("filter", "D", "--out", "x", "--kind", "lowpass",
                     "--cutoff", "1"), ("resume", "S"), ("gui",),
    ("sti", "D", "--device", "cuda")])
def test_no_cuda_is_a_json_error(argv, capsys):
    """Without a CUDA device a computing command prints a JSON error and
    exits 1 before it touches its arguments: it never carries on on the
    CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc, res = _run(capsys, cli.main, *argv)
    assert rc == 1 and res == {"error": cli.NO_CUDA}


def test_parser_takes_an_opened_dataset(cap, tmp_path, capsys):
    """build_parser() parses real argv; an opened RFDataset (here a
    MemoryDataset of the capture's samples) set in place of the path
    gives the path's result."""
    ds = RFDataset(cap)
    chan = ds.channels[0]
    lo, hi = ds.bnds[chan]
    mem = MemoryDataset(ds.reader.read_vector_raw(lo, hi - lo + 1, chan),
                        ds.sr_dict[chan], channel=chan, start=lo,
                        ref=ds.ref_dict[chan])
    argv = ["sti", "PATH", "--nfft", "512", "--ntime", "12", "--renderer",
            "pixels", *DEV]
    args = cli.build_parser().parse_args(argv)
    args.dataset, args.out = mem, str(tmp_path / "m.png")
    assert args.fn(args) == 0
    got = json.loads(capsys.readouterr().out)
    _, want = _run(capsys, cli.main, *(a if a != "PATH" else cap
                                       for a in argv),
                   "--out", tmp_path / "p.png")
    assert got["shape"] == want["shape"]
    assert got["peak_dbfs"] == want["peak_dbfs"]
    np.testing.assert_array_equal(_png(got["png"]), _png(want["png"]))
    args = cli.build_parser().parse_args(
        ["sti-batch", "A", "B", "--out-dir", str(tmp_path / "b"),
         "--nfft", "512", "--ntime", "8", "--renderer", "pixels", *DEV])
    args.datasets = [mem, mem]
    assert args.fn(args) == 0
    res = json.loads(capsys.readouterr().out)
    assert [r["dataset"] for r in res["results"]] == [chan, chan]
    assert len({r["png"] for r in res["results"]}) == 2
