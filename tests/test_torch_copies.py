"""The port's own copies of the JAX package's host modules, pinned to the
originals.

The port imports nothing of pyspectrogram_tpu, so it carries copies of the
modules it needs (utils, io, native ingest, colormaps, the host halves of
display.render and display.tile, the Qt resolver and headless kit, and a
few CLI helpers). Each copy is the original with the import paths changed:

- the source of every verbatim copy, and of every copied function or
  class, equals the original's once the import paths are mapped back and
  the docstring note naming the original is dropped;
- the public constants, dataclass fields and functions give the original's
  results on the same numpy inputs (time conversions, resolve_time_span,
  the colormap LUTs, freq_crop_decimate, quantize_params, the tile specs,
  the native ingest against its numpy fallback);
- a capture written by the port's writer reads bit-equal through the JAX
  reader, and the reverse;
- the port's headless widget kit runs the viewer window's smoke path.
"""

import argparse
import dataclasses
import datetime
import inspect
import re
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from pyspectrogram_tpu.clients import _qt_headless as jkit
from pyspectrogram_tpu.clients import cli as jcli
from pyspectrogram_tpu.display import colormap as jcolormap
from pyspectrogram_tpu.display import render as jrender
from pyspectrogram_tpu.display import tile as jtile
from pyspectrogram_tpu.io import reader as jreader
from pyspectrogram_tpu.io import synthetic as jsynthetic
from pyspectrogram_tpu.io import time_util as jtime_util
from pyspectrogram_tpu.kernels import gemm_fft as jgemm_fft
from pyspectrogram_tpu.native import ingest as jingest
from pyspectrogram_tpu.parallel import big_sti as jbig_sti
from pyspectrogram_tpu.parallel import dist_fft as jdist_fft
from pyspectrogram_tpu.parallel import mesh as jpmesh
from pyspectrogram_tpu.parallel import sharded as jsharded
from pyspectrogram_tpu.utils import config as jconfig
from pyspectrogram_tpu.utils import errors as jerrors
from pyspectrogram_tpu_torch.clients import _qt_headless as kit
from pyspectrogram_tpu_torch.clients import cli, gui
from pyspectrogram_tpu_torch.display import colormap, render, tile
from pyspectrogram_tpu_torch.io import reader, synthetic, time_util
from pyspectrogram_tpu_torch.kernels import gemm_fft
from pyspectrogram_tpu_torch.native import ingest
from pyspectrogram_tpu_torch.parallel import big_sti, dist_fft
from pyspectrogram_tpu_torch.parallel import mesh as pmesh
from pyspectrogram_tpu_torch.parallel import sharded
from pyspectrogram_tpu_torch.utils import config, errors

REPO = Path(__file__).resolve().parents[1]
#: modules the port copies whole, as paths under either package
VERBATIM = ["utils/config.py", "utils/errors.py", "utils/log.py",
            "io/time_util.py", "io/drf_format.py", "io/reader.py",
            "io/fastread.py", "io/writer.py", "io/synthetic.py",
            "display/colormap.py", "clients/qt_backend.py",
            "clients/_qt_headless.py"]
#: the one line by which a copied io module reaches HDF5
HDF5_IMPORT = "from pyspectrogram_tpu_torch.io import hdf5 as h5py"
NOTE = re.compile(r"\n\nCopy of pyspectrogram_tpu/[\w/]+\.py: the port "
                  r"imports nothing of that\npackage\.\n")


def _as_original(text: str) -> str:
    """Port source with the import paths mapped back to the JAX package's
    (the port's own HDF5 layer back to h5py) and the docstring note that
    names the original dropped."""
    return NOTE.sub("\n", text).replace(HDF5_IMPORT, "import h5py").replace(
        "pyspectrogram_tpu_torch", "pyspectrogram_tpu")


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_is_the_original(rel):
    port = (REPO / "pyspectrogram_tpu_torch" / rel).read_text()
    assert NOTE.search(port), "the docstring names the original"
    orig = (REPO / "pyspectrogram_tpu" / rel).read_text()
    assert _as_original(port) == orig


@pytest.mark.parametrize("port_obj,jax_obj", [
    (render.freq_crop_decimate, jrender.freq_crop_decimate),
    (render.quantize_params, jrender.quantize_params),
    (render.resample_colors, jrender.resample_colors),
    (render.apply_lut, jrender.apply_lut),
    (render.save_tile_png, jrender.save_tile_png),
    (render.save_psd_csv, jrender.save_psd_csv),
    (render.save_result_npz, jrender.save_result_npz),
    (tile.TileSpec, jtile.TileSpec),
    (tile.make_tile_spec, jtile.make_tile_spec),
    (tile.tile_freqs, jtile.tile_freqs),
    (cli.cmd_info, jcli.cmd_info),
    (cli._config_from, jcli._config_from),
    (cli.cmd_synth, jcli.cmd_synth),
    (cli._add_common, jcli._add_common),
    (ingest.assemble_plane_major, jingest.assemble_plane_major),
    (ingest.to_complex64, jingest.to_complex64),
    (ingest.deinterleave_plane_major, jingest.deinterleave_plane_major),
    (ingest._load, jingest._load),
    (ingest._build, jingest._build),
    (pmesh.pad_to_multiple, jpmesh.pad_to_multiple),
    (pmesh.pad_starts, jpmesh.pad_starts),
    (pmesh.pad_contiguous_block, jpmesh.pad_contiguous_block),
    (dist_fft.split_for_devices, jdist_fft.split_for_devices),
    (dist_fft.reference_order, jdist_fft.reference_order),
    (big_sti.frames_to_x2, jbig_sti.frames_to_x2),
    (big_sti.to_freq_order, jbig_sti.to_freq_order),
    (gemm_fft.FFTPlan, jgemm_fft.FFTPlan),
    (gemm_fft.dft_mat, jgemm_fft.dft_mat),
    (gemm_fft.twiddle_mat, jgemm_fft.twiddle_mat),
    (gemm_fft.split_factors, jgemm_fft.split_factors),
    (gemm_fft.make_plan, jgemm_fft.make_plan),
    (gemm_fft.gemm_fft_numpy, jgemm_fft.gemm_fft_numpy),
], ids=lambda o: getattr(o, "__qualname__", ""))
def test_copied_piece_is_the_original(port_obj, jax_obj):
    """Functions and classes copied into modules of the port's own."""
    assert _as_original(inspect.getsource(port_obj)) == \
        inspect.getsource(jax_obj)


def test_native_ingest_source_and_build_are_the_ports_own():
    src = REPO / "pyspectrogram_tpu_torch" / "native" / "pstpu_ingest.cpp"
    assert ingest._SRC == src
    assert src.read_bytes() == (REPO / "pyspectrogram_tpu" / "native"
                                / "pstpu_ingest.cpp").read_bytes()
    assert ingest._cache_dir() == REPO / "build" / "native"


def _public(mod):
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", mod.__name__) in (mod.__name__,
                                                           None)}


@pytest.mark.parametrize("mods", [(config, jconfig), (errors, jerrors),
                                  (time_util, jtime_util),
                                  (colormap, jcolormap)],
                         ids=lambda m: m[0].__name__)
def test_public_names_constants_and_fields(mods):
    mod, jmod = mods
    names, jnames = _public(mod), _public(jmod)
    assert sorted(names) == sorted(jnames)
    for name, v in names.items():
        jv = jnames[name]
        if inspect.isfunction(v):
            assert inspect.signature(v) == inspect.signature(jv), name
        elif dataclasses.is_dataclass(v):
            assert [(f.name, f.default, str(f.type))
                    for f in dataclasses.fields(v)] == [
                (f.name, f.default, str(f.type))
                for f in dataclasses.fields(jv)], name
        elif isinstance(v, type) and issubclass(v, Exception):
            assert [b.__name__ for b in v.__mro__] == \
                [b.__name__ for b in jv.__mro__], name
        elif not isinstance(v, type):
            assert v == jv, name


@pytest.mark.parametrize("sub", ["ops", "models"])
def test_package_exports_are_the_jax_packages(sub):
    """The port's ops and models export the JAX package's names, each a
    callable or class of the port, and the top level has its
    ``__version__`` and ``TerminateReason``."""
    import importlib

    import pyspectrogram_tpu as jpkg
    import pyspectrogram_tpu_torch as pkg

    mod = importlib.import_module(f"pyspectrogram_tpu_torch.{sub}")
    jmod = importlib.import_module(f"pyspectrogram_tpu.{sub}")
    assert mod.__all__ == jmod.__all__
    for name in mod.__all__:
        v = getattr(mod, name)
        assert callable(v) and v.__module__.startswith(
            "pyspectrogram_tpu_torch."), name
    assert pkg.__version__ == jpkg.__version__
    assert pkg.TerminateReason is errors.TerminateReason
    assert [(m.name, m.value) for m in pkg.TerminateReason] == [
        (m.name, m.value) for m in jpkg.TerminateReason]
    assert {n for n in dir(jpkg) if not n.startswith("_")
            and not inspect.ismodule(getattr(jpkg, n))} <= set(dir(pkg))


@pytest.mark.parametrize("sub", ["parallel", "kernels"])
def test_parallel_and_kernels_exports_are_the_jax_packages(sub):
    """The port's parallel exports the JAX package's names; its kernels
    export the JAX package's but for the Pallas kernel's own
    (make_pallas_sti_psd, pallas_supported, to_plane_major)."""
    import importlib

    mod = importlib.import_module(f"pyspectrogram_tpu_torch.{sub}")
    jmod = importlib.import_module(f"pyspectrogram_tpu.{sub}")
    pallas = {"make_pallas_sti_psd", "pallas_supported", "to_plane_major"}
    assert mod.__all__ == [n for n in jmod.__all__ if n not in pallas]
    for name in mod.__all__:
        v = getattr(mod, name)
        if callable(v):
            assert v.__module__.startswith("pyspectrogram_tpu_torch."), name
        else:
            assert v == getattr(jmod, name), name
    assert sharded.GATHERED_MEDIAN_MAX_BYTES == \
        jsharded.GATHERED_MEDIAN_MAX_BYTES


def test_parallel_and_gemm_copies_give_the_originals_results():
    """The copied numpy helpers of parallel.mesh, parallel.dist_fft,
    parallel.big_sti and kernels.gemm_fft on the same inputs."""
    rng = np.random.default_rng(2)
    for n, m in ((13, 4), (16, 4), (1, 3)):
        assert pmesh.pad_to_multiple(n, m) == jpmesh.pad_to_multiple(n, m)
    starts = np.arange(13, dtype=np.int32) * 7
    for a, b in zip(pmesh.pad_starts(starts, 4),
                    jpmesh.pad_starts(starts, 4)):
        np.testing.assert_array_equal(a, b)
    pm = rng.standard_normal((4, 13 * 64)).astype(np.float32)
    for a, b in zip(pmesh.pad_contiguous_block(pm, 13, 64, 4),
                    jpmesh.pad_contiguous_block(pm, 13, 64, 4)):
        np.testing.assert_array_equal(a, b)
    for nfft, ndev in ((1 << 12, 4), (1 << 20, 8), (1 << 9, 2)):
        assert dist_fft.split_for_devices(nfft, ndev) == \
            jdist_fft.split_for_devices(nfft, ndev)
    for bad in ((1000, 2), (256, 32)):
        with pytest.raises(ValueError) as e:
            dist_fft.split_for_devices(*bad)
        with pytest.raises(ValueError) as je:
            jdist_fft.split_for_devices(*bad)
        assert str(e.value) == str(je.value)
    xm = rng.standard_normal((8, 16))
    np.testing.assert_array_equal(dist_fft.reference_order(xm),
                                  jdist_fft.reference_order(xm))
    frames = rng.standard_normal((3, 2, 2, 2 * 128)).astype(np.float32)
    np.testing.assert_array_equal(big_sti.frames_to_x2(frames, 128, 2, 8, 16),
                                  jbig_sti.frames_to_x2(frames, 128, 2, 8, 16))
    km = rng.standard_normal((3, 2, 8, 16))
    np.testing.assert_array_equal(big_sti.to_freq_order(km),
                                  jbig_sti.to_freq_order(km))
    for n in (8, 128):
        np.testing.assert_array_equal(gemm_fft.dft_mat(n), jgemm_fft.dft_mat(n))
    np.testing.assert_array_equal(gemm_fft.twiddle_mat(8, 16, 256),
                                  jgemm_fft.twiddle_mat(8, 16, 256))
    for nfft in (256, 1 << 16, 1 << 20):
        assert gemm_fft.split_factors(nfft) == jgemm_fft.split_factors(nfft)
    xr, xi = (rng.standard_normal((2, 1024)).astype(np.float32)
              for _ in range(2))
    for nfft in (256, 4096, 1 << 16):
        for a, b in zip(gemm_fft.make_plan(nfft), jgemm_fft.make_plan(nfft)):
            np.testing.assert_array_equal(a, b)
    plan, jplan = gemm_fft.make_plan(1024), jgemm_fft.make_plan(1024)
    for a, b in zip(gemm_fft.gemm_fft_numpy(xr, xi, plan),
                    jgemm_fft.gemm_fft_numpy(xr, xi, jplan)):
        np.testing.assert_array_equal(a, b)


def test_config_validation_and_time_spans():
    for kw in (dict(nfft=16), dict(nint=0), dict(ntime=1), dict(mode="x"),
               dict(precision="fast"), dict(color_range_db=(0.0, -1.0)),
               dict(hop=0), dict(time_span=(2.0, 1.0)),
               dict(time_span=("a", None)), dict(time_span=3.0)):
        with pytest.raises(ValueError) as e:
            config.SpectrogramConfig(**kw)
        with pytest.raises(ValueError) as je:
            jconfig.SpectrogramConfig(**kw)
        assert str(e.value) == str(je.value)
    bounds = (10.0, 20.0)
    for span in (None, (None, None), (11.0, None), (None, 19.5),
                 (12.0, 13.0)):
        assert config.resolve_time_span(span, bounds) == \
            jconfig.resolve_time_span(span, bounds)
    cfg = config.SpectrogramConfig(nfft=512, hop=256, time_span=(1.0, None))
    assert dataclasses.asdict(cfg.replace(ntime=7)) == dataclasses.asdict(
        jconfig.SpectrogramConfig(nfft=512, hop=256, time_span=(1.0, None),
                                  ntime=7))
    assert [(r.name, int(r), r.describe()) for r in errors.TerminateReason] \
        == [(r.name, int(r), r.describe()) for r in jerrors.TerminateReason]


RATES = [1_000_000, Fraction(100_000, 3), Fraction(1, 7), 250_000]


@pytest.mark.parametrize("rate", RATES, ids=str)
def test_time_conversions(rate):
    samples = [0, 1, 12_345_678, 1_451_661_840 * 1_000_000 + 17,
               2 ** 61 + 3]
    # the ones that fall before the year 9999 at this rate
    dated = [s for s in samples if Fraction(s) / Fraction(rate) < 2 ** 37]
    for s in samples:
        assert time_util.sample_to_time(s, rate) == \
            jtime_util.sample_to_time(s, rate)
    for s in dated:
        assert time_util.sample_to_datetime(s, rate) == \
            jtime_util.sample_to_datetime(s, rate)
    for t in (0, 1.5, 1451661840.25, Fraction(3, 7),
              datetime.datetime(2016, 1, 1, 14, 44, 0, 123456)):
        assert time_util.time_to_sample(t, rate) == \
            jtime_util.time_to_sample(t, rate)
    arr = np.asarray(dated, np.int64)
    np.testing.assert_array_equal(time_util.samples_to_datetime64(arr, rate),
                                  jtime_util.samples_to_datetime64(arr, rate))
    num, den = Fraction(rate).numerator, Fraction(rate).denominator
    for s in samples:
        ms = time_util.sample_to_millisecond(s, num, den)
        assert ms == jtime_util.sample_to_millisecond(s, num, den)
        assert time_util.millisecond_to_sample_ceil(ms, num, den) == \
            jtime_util.millisecond_to_sample_ceil(ms, num, den)


def test_colormap_luts():
    for n in (2, 100, 256, 500):
        np.testing.assert_array_equal(colormap.viridis_colors(n),
                                      jcolormap.viridis_colors(n))
        np.testing.assert_array_equal(colormap.spectral_legacy_colors(n),
                                      jcolormap.spectral_legacy_colors(n))
    for name, n in (("viridis", None), ("legacy", None),
                    ("spectral_legacy", 64)):
        c = colormap.get_colormap(name, n)
        np.testing.assert_array_equal(c, jcolormap.get_colormap(name, n))
        np.testing.assert_array_equal(colormap.rgba_lut(c),
                                      jcolormap.rgba_lut(c))
    np.testing.assert_array_equal(colormap.quantize_levels((-110.0, -40.0), 7),
                                  jcolormap.quantize_levels((-110.0, -40.0), 7))
    with pytest.raises(ValueError, match="unknown colormap"):
        colormap.get_colormap("jet")


@pytest.mark.parametrize("nfft,frange,max_nfreqs", [
    (1024, (-1e9, 1e9), 2 ** 15), (4096, (-120.0, 250.0), 300),
    (65536, (-300.0, 350.0), 2 ** 15), (256, (-1e5, -9e4), 64)])
def test_render_and_tile_host_helpers(nfft, frange, max_nfreqs):
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1e-6))
    for a, b in zip(render.freq_crop_decimate(freqs, frange, max_nfreqs),
                    jrender.freq_crop_decimate(freqs, frange, max_nfreqs)):
        np.testing.assert_array_equal(a, b)
    for crange, npoints in (((-110.0, -40.0), 256), ((-90.0, -55.5), 100)):
        np.testing.assert_array_equal(
            render.quantize_params(crange, npoints),
            jrender.quantize_params(crange, npoints))
        spec = tile.make_tile_spec(freqs, frange, crange, max_nfreqs, npoints)
        jspec = jtile.make_tile_spec(freqs, frange, crange, max_nfreqs,
                                     npoints)
        if jspec is None:
            assert spec is None
            continue
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        assert dataclasses.asdict(spec.crop_key()) == \
            dataclasses.asdict(jspec.crop_key())
        np.testing.assert_array_equal(spec.qparams, jspec.qparams)
        np.testing.assert_array_equal(tile.tile_freqs(spec, freqs),
                                      jtile.tile_freqs(jspec, freqs))
        db = np.random.default_rng(nfft).uniform(
            -130.0, -20.0, (3, 2, nfft)).astype(np.float32)
        np.testing.assert_array_equal(tile.tile_from_db(db, spec),
                                      jtile.tile_from_db(db, jspec))
    cdata = colormap.get_colormap("legacy")
    levels = np.random.default_rng(1).integers(0, 256, (5, 7)).astype(np.uint8)
    np.testing.assert_array_equal(render.apply_lut(levels, cdata),
                                  jrender.apply_lut(levels, cdata))
    np.testing.assert_array_equal(render.resample_colors(cdata, 37),
                                  jrender.resample_colors(cdata, 37))


def _spans(rng):
    n, nsub = 3000, 2
    c64 = (rng.standard_normal((n, nsub))
           + 1j * rng.standard_normal((n, nsub))).astype(np.complex64)
    out = [c64]
    for t in (np.int16, np.int32):
        d = np.zeros((n, nsub), np.dtype([("r", t), ("i", t)]))
        d["r"] = rng.integers(-2 ** 14, 2 ** 14, (n, nsub))
        d["i"] = rng.integers(-2 ** 14, 2 ** 14, (n, nsub))
        out.append(d)
    return out


def test_native_ingest_against_its_numpy_fallback():
    """The port's C++ ingest (built into the checkout's build directory)
    equals its numpy fallback and the JAX package's ingest."""
    assert ingest.native_available() == jingest.native_available()
    rng = np.random.default_rng(3)
    starts = np.asarray([0, 17, 1000, 2000 - 256], np.int64)
    for span in _spans(rng):
        got = ingest.assemble_plane_major(span, starts, 1000)
        np.testing.assert_array_equal(
            got, jingest.assemble_plane_major(span, starts, 1000))
        if span.dtype == np.complex64:
            fallback = ingest._assemble_pm_numpy(
                span, starts, 1000, np.empty_like(got))
        elif span.dtype["r"] == np.int16:
            ri = span.view(np.int16).reshape(span.shape[0], 2, 2)
            fallback = ingest._assemble_pm_numpy_planes(
                ri, starts, 1000, np.empty_like(got))
        else:
            fallback = ingest._assemble_pm_numpy(
                ingest.to_complex64(span), starts, 1000, np.empty_like(got))
        np.testing.assert_array_equal(got, fallback)
        np.testing.assert_array_equal(ingest.to_complex64(span),
                                      jingest.to_complex64(span))
    x = _spans(rng)[0]
    planes = ingest.deinterleave_plane_major(x)
    np.testing.assert_array_equal(planes, jingest.deinterleave_plane_major(x))
    ri = x.view(np.float32).reshape(x.shape[0], 2, 2)
    np.testing.assert_array_equal(planes[0], ri[:, 0, 0])
    np.testing.assert_array_equal(planes[3], ri[:, 1, 1])
    with pytest.raises(ValueError, match="out of span"):
        ingest.assemble_plane_major(x, np.asarray([2990]), 64)


CAPTURES = [
    dict(kind="tone", num_subchannels=2, noise_rms=1e-3),
    dict(kind="chirp", dtype=np.dtype([("r", np.int16), ("i", np.int16)]),
         gap=(20_000, 3_000)),
    dict(kind="noise", sample_rate_numerator=100_000,
         sample_rate_denominator=3, file_cadence_millisecs=100,
         subdir_cadence_secs=1),
]


def _same_reads(a, b):
    """Two RFDatasets over one capture: state and every read equal."""
    assert a.channels == b.channels
    assert a.sr_dict == b.sr_dict and a.ref_dict == b.ref_dict
    assert a.bnds == b.bnds and a.time_bnds == b.time_bnds
    assert a.chan_entries == b.chan_entries
    for chan in a.channels:
        assert a.reader.get_properties(chan) == b.reader.get_properties(chan)
        lo, hi = a.bnds[chan]
        for st, n in ((lo - 50, hi - lo + 101), (lo + 1234, 5000)):
            ra, ma = a.reader.read_vector_raw(st, n, chan, return_mask=True)
            rb, mb = b.reader.read_vector_raw(st, n, chan, return_mask=True)
            assert ra.dtype == rb.dtype
            np.testing.assert_array_equal(ra, rb)
            np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(a.read(lo, 4096, f"{chan}:0"),
                                      b.read(lo, 4096, f"{chan}:0"))
        for x, y in zip(a.read_sti(lo, chan, hi, 256, 2, 9),
                        b.read_sti(lo, chan, hi, 256, 2, 9)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", CAPTURES, ids=lambda k: k["kind"])
def test_captures_cross_read(tmp_path, kw):
    """A capture the port's writer wrote reads bit-equal through the JAX
    reader, and one the JAX writer wrote through the port's; each equals
    its twin from the other writer."""
    kw = dict(n_samples=40_000, **kw)
    meta = synthetic.write_capture(tmp_path / "port", **kw)
    assert meta == jsynthetic.write_capture(tmp_path / "jax", **kw)
    for top in ("port", "jax"):
        _same_reads(reader.RFDataset(tmp_path / top),
                    jreader.RFDataset(tmp_path / top))
    _same_reads(reader.RFDataset(tmp_path / "port"),
                jreader.RFDataset(tmp_path / "jax"))
    # the pooled byte-range path and h5py read the same samples
    _same_reads(reader.RFDataset(tmp_path / "port", io_workers=0),
                reader.RFDataset(tmp_path / "port"))


def test_cli_helpers_parse_like_the_originals():
    argv = ["--nfft", "512", "--nint", "3", "--ntime", "50", "--mode",
            "parity", "--window", "hann", "--crange", "-100", "-20",
            "--frange", "-50", "50", "--tstart", "1.5", "--channel",
            "ch0:1"]
    parsed = []
    for add in (cli._add_common, jcli._add_common):
        ap = argparse.ArgumentParser()
        add(ap)
        parsed.append((vars(ap.parse_args(argv)), vars(ap.parse_args([]))))
    assert parsed[0] == parsed[1]
    args = argparse.Namespace(**parsed[0][0])
    assert dataclasses.asdict(cli._config_from(args)) == \
        dataclasses.asdict(jcli._config_from(args))
    assert cli.SYNTH_DTYPES == jcli.SYNTH_DTYPES


def test_headless_kit_runs_the_window_smoke_path(tmp_path, monkeypatch):
    """The port's copy of the widget kit, on its own: the viewer window
    builds on it, a tab renames and starts over a capture through canned
    dialog answers, draws one frame, stops, and the window closes."""
    assert sorted(n for n in vars(kit) if not n.startswith("__")) == \
        sorted(n for n in vars(jkit) if not n.startswith("__"))
    assert gui.HEADLESS and gui.QtWidgets is kit.QtWidgets
    jsynthetic.write_capture(tmp_path / "cap", n_samples=1 << 15,
                             num_subchannels=2)
    monkeypatch.setattr(gui.MainWindow, "_last_dir_file",
                        lambda self: tmp_path / "last_dir.txt")
    monkeypatch.setattr(kit.QMessageBox, "journal", [])
    monkeypatch.setattr(kit.QMessageBox, "answer", kit.QMessageBox.Yes)
    monkeypatch.setattr(kit.QFileDialog, "existing_directory",
                        str(tmp_path / "cap"))
    monkeypatch.setattr(kit.QInputDialog, "text_answer", ("smoke", True))
    win = gui.MainWindow(device="cpu", figure_kit=gui.recording_figure_kit)
    win.scheduler.autostart = False
    assert isinstance(win, kit.QMainWindow)
    menu = win.menuBar().menus[0]
    menu.actions[1].trigger()                          # Rename Tab
    assert win.tabs.tabText(0) == "smoke"
    st = win.states[1]
    st.nfft.setValue(256)
    st.start_btn.click()
    assert st.processor is not None and st.processor.is_running
    win.scheduler.tick_once()
    assert st.last is not None and st.last.tile is not None
    assert [c[0] for c in st.sti_ax.calls][0] == "pcolormesh"
    st.stop_btn.click()
    st.processor.join(10)
    assert not st.processor.is_running
    assert kit.QMessageBox.journal == [] and win.close()


# ------------------------------------------- the JAX package's stray names
def test_prefetch_feeder_is_the_jax_feeder():
    """io.ingest.PrefetchFeeder: the JAX feeder's signature, items in
    order, a producer's error raised at the consumer after the items
    before it, close() and the context manager; ``device_put`` copies to
    the CUDA device; stream_blocks returns one, as the JAX module's does."""
    import torch

    from pyspectrogram_tpu.io import ingest as jio
    from pyspectrogram_tpu_torch.io import ingest as io

    sig, jsig = (inspect.signature(c.__init__) for c in (
        io.PrefetchFeeder, jio.PrefetchFeeder))
    assert [(p.name, p.default) for p in sig.parameters.values()] == \
        [(p.name, p.default) for p in jsig.parameters.values()]
    assert inspect.signature(io.stream_blocks).parameters.keys() == \
        inspect.signature(jio.stream_blocks).parameters.keys()

    def boom(i):
        if i == 2:
            raise RuntimeError("io failed")
        return i

    for feeder in (io.PrefetchFeeder, jio.PrefetchFeeder):
        assert list(feeder(lambda i: i * 10, 5, depth=2,
                           device_put=False)) == [0, 10, 20, 30, 40]
        got = []
        with pytest.raises(RuntimeError, match="io failed"):
            for item in feeder(boom, 5, depth=1, device_put=False):
                got.append(item)
        assert got == [0, 1]
        made = []

        def counting(i):
            made.append(i)
            return i

        with feeder(counting, 100, depth=1, device_put=False) as f:
            first = next(iter(f))
        n_closed = len(made)
        time.sleep(0.5)
        # closed: the worker made at most the item ahead and stopped
        assert first == 0 and n_closed <= 3 and len(made) == n_closed
    # the worker's copy under device_put=True (to the current CUDA device;
    # here to the CPU): every array of the item, nested ones too
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    item = io._put((a + 1, {"k": a}, "tag"), torch.device("cpu"))
    assert isinstance(item[0], torch.Tensor)
    np.testing.assert_array_equal(item[0].numpy(), a + 1)
    assert isinstance(item[1]["k"], torch.Tensor) and item[2] == "tag"


def test_quantize_tile_db_is_the_jax_epilogue():
    """display.tile.quantize_tile_db: crop, decimate, quantize dBFS to the
    uint8 tile, the JAX function's levels on the same values, with the
    spec's colour range or a qparams override."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(4)
    db = rng.uniform(-130.0, 10.0, (5, 2, 1024)).astype(np.float32)
    freqs = np.fft.fftshift(np.fft.fftfreq(1024, 1e-6))
    spec = tile.make_tile_spec(freqs, (-200.0, 150.0), (-110.0, -20.0))
    jspec = jtile.make_tile_spec(freqs, (-200.0, 150.0), (-110.0, -20.0))
    other = tile.make_tile_spec(freqs, (-200.0, 150.0), (-90.0, 0.0))
    for qp in (None, other.qparams):
        got = tile.quantize_tile_db(torch.from_numpy(db), spec, qp).numpy()
        want = np.asarray(jtile.quantize_tile_db(jnp.asarray(db), jspec, qp))
        assert got.dtype == np.uint8 and got.shape == (5, 2, spec.plot_n)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tile.tile_from_db(torch.from_numpy(db),
                                                    spec),
                                  tile.tile_from_db(db, spec))


@pytest.mark.parametrize("mode,nint", [("welch", 2), ("parity", 3)])
def test_make_xla_psd_is_the_plain_psd(mode, nint):
    """ops.stft.make_xla_psd: the JAX factory's signature and, on the same
    samples and starts, its linear power (float32 FFTs: 1e-5 of the
    peak); it is ops.plain.psd_torch with the knobs bound."""
    import jax.numpy as jnp
    import torch

    from pyspectrogram_tpu.ops import stft as jstft
    from pyspectrogram_tpu_torch.ops import plain, stft

    assert inspect.signature(stft.make_xla_psd) == \
        inspect.signature(jstft.make_xla_psd)
    rng = np.random.default_rng(6)
    pm = rng.standard_normal((4, 64 * nint * 6 + 40)).astype(np.float32)
    starts = np.linspace(0, pm.shape[1] - 64 * nint, 6).astype(np.int32)
    kw = dict(nfft=64, nint=nint, mode=mode, window="hann", ref=2.0)
    got = stft.make_xla_psd(**kw)(torch.from_numpy(pm),
                                  torch.from_numpy(starts)).numpy()
    want = np.asarray(jstft.make_xla_psd(**kw)(jnp.asarray(pm),
                                               jnp.asarray(starts)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    np.testing.assert_array_equal(got, plain.psd_torch(
        torch.from_numpy(pm), torch.from_numpy(starts), **kw).numpy())


def test_median_over_time_takes_allow_pallas(monkeypatch):
    """ops.stft.median_over_time takes the JAX keyword allow_pallas, and
    either value goes through kernel B2's wrapper (the port has no plain
    route on a card: B2 equals np.median bit for bit, as JAX's plain
    route does); on these CPU tensors the wrapper takes its plain
    version."""
    import jax.numpy as jnp
    import torch

    from pyspectrogram_tpu.ops import stft as jstft
    from pyspectrogram_tpu_torch.kernels import median_cuda
    from pyspectrogram_tpu_torch.ops import stft

    assert [(p.name, p.default) for p in inspect.signature(
        stft.median_over_time).parameters.values()] == [
        (p.name, p.default) for p in inspect.signature(
            jstft.median_over_time).parameters.values()]
    p = np.random.default_rng(8).exponential(size=(40, 2, 64)).astype(
        np.float32)
    want = np.median(p, axis=0)
    calls = []
    b2 = median_cuda.median_over_time_cuda

    def counted(*a, **k):
        calls.append(1)
        return b2(*a, **k)

    monkeypatch.setattr(median_cuda, "median_over_time_cuda", counted)
    for allow in (True, False):
        got = stft.median_over_time(torch.from_numpy(p),
                                    allow_pallas=allow).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(
            jstft.median_over_time(jnp.asarray(p), allow_pallas=allow)))
    assert len(calls) == 2