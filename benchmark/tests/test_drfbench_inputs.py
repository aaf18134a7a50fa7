"""Samples and traffic repeat exactly from a seed; the reference agrees
with a direct numpy.fft; the top-level-name guard."""

import json

import numpy as np
import pytest
import torch

from drfbench import capture, guard, spec
from drfbench.browse import Browse
from reference import sti as ref

BIG_SEED = (1 << 31) + 987654321


def _config(name="drf_1msps_c64_2sub"):
    bench = spec.load_benchmark(waiting=True)
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((spec.ROOT / entry["file"]).read_text())


@pytest.mark.parametrize("seed", [0, 12345, BIG_SEED])
def test_samples_repeat_from_the_seed(seed):
    conf = _config()
    a = capture.signal_of(conf, seed)
    b = capture.signal_of(conf, seed)
    x = a.blocks(3, 4)
    assert x.shape == (4 * a.block_rows, 2) and x.dtype == np.complex64
    np.testing.assert_array_equal(x, b.blocks(3, 4))
    # a block is the same whether made alone or among others
    np.testing.assert_array_equal(x[a.block_rows:2 * a.block_rows],
                                  b.block(4))
    other = capture.signal_of(conf, seed + 1).blocks(3, 4)
    assert not np.array_equal(x, other)


def test_live_recorder_blocks_continue_the_capture():
    conf = _config("drf_1msps_c64_2sub_live")
    sig = capture.signal_of(conf, BIG_SEED)
    assert sig.block_rows == conf["recorder"]["block_rows"]
    whole = sig.blocks(0, 6)
    np.testing.assert_array_equal(whole[5 * sig.block_rows:], sig.block(5))


@pytest.mark.parametrize("seed", [5, BIG_SEED])
@pytest.mark.parametrize("spans", [None, [None, 10, 1]])
def test_traffic_repeats_from_the_seed(seed, spans, tmp_path):
    """The cell's own traffic (``spans`` None), and a mix of spans as a
    later traffic file may give one."""
    cell = spec.cell(spec.load_benchmark(waiting=True), "browse.headline")
    if spans is not None:
        cell["traffic"]["spans"] = spans

    def first(n, s):
        drv = Browse(cell, s, "cpu", tmp_path, None)
        it = drv.schedule()
        return [next(it) for _ in range(n)]

    a, b = first(30, seed), first(30, seed)
    assert a == b
    spans = cell["traffic"]["spans"]
    if spans == [None]:
        # every request is the viewer's default view, whatever the seed
        assert a == first(30, seed + 1) == [(None, None)] * 30
        return
    assert a != first(30, seed + 1)
    # every round of len(spans) requests takes each span once
    for r in range(0, 30, len(spans)):
        assert sorted(map(str, (k for k, _ in a[r:r + len(spans)]))) == \
            sorted(map(str, spans))


def _numpy_psd(x, starts, nfft, nint, beta):
    """The periodogram written out with numpy.fft alone."""
    w = np.kaiser(nfft + 1, beta)[:-1]
    out = []
    for s in starts:
        segs = x[s:s + nfft * nint].T.reshape(x.shape[1], nint, nfft)
        X = np.fft.fft(segs * w, axis=-1)
        p = (np.abs(X) ** 2 / w.sum() ** 2).mean(axis=1)
        out.append(np.fft.fftshift(p, axes=-1))
    return np.stack(out)


def test_reference_matches_numpy_fft():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5000, 2)) + 1j * rng.standard_normal(
        (5000, 2))).astype(np.complex64)
    starts = ref.frame_starts(0, 5000, 64, 3, 9)
    np.testing.assert_array_equal(
        starts, np.linspace(0, 5000 - 192, 9, dtype=int))
    got = ref.psd_columns(x, starts, nfft=64, nint=3, beta=1.7)
    want = _numpy_psd(x.astype(np.complex128), starts, 64, 3, 1.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    med = ref.median_time(got).numpy()
    np.testing.assert_allclose(med, np.median(want, axis=0), rtol=1e-12)
    db = ref.dbfs(got, 1e-15)
    np.testing.assert_allclose(db.numpy(), 10 * np.log10(want + 1e-15),
                               rtol=1e-12)
    freqs = ref.shifted_freqs(64, 1e6)
    bins = ref.tile_bins(freqs, (-200.0, 300.0))
    assert (freqs[bins] >= -2e5).all() and (freqs[bins] <= 3e5).all()
    lv = ref.tile_levels(db, bins, (-30.0, 10.0)).numpy()
    q = np.clip(np.round((10 * np.log10(want + 1e-15)[..., bins] + 30.0)
                         * 255 / 40.0), 0, 255)
    np.testing.assert_array_equal(lv, q.astype(np.uint8))


def test_reference_times_and_samples():
    sr = 1_000_000
    s = 1451661840 * sr + 123457
    assert ref.time_to_sample(s / sr, sr) in (s, s - 1)
    assert ref.start_times_us([s, s + 1], sr).tolist() == [s, s + 1]
    assert ref.start_times_us([3], 2_000_000).tolist() == [2]   # 1.5 -> 2


def test_control_is_bfloat16_rounded():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4096, 1)) * 0.3).astype(np.complex64)
    starts = np.asarray([0, 1024, 2048])
    full = ref.psd_columns(x, starts, nfft=1024, nint=1, beta=1.7)
    low = ref.psd_columns(x, starts, nfft=1024, nint=1, beta=1.7,
                          precision="bf16")
    assert low.dtype == torch.float32
    assert torch.equal(low, low.to(torch.bfloat16).to(torch.float32))
    gap = (ref.dbfs(low.double(), 1e-15) - ref.dbfs(full, 1e-15)).abs()
    assert 1e-3 < float(gap.max()) < 30


@pytest.mark.parametrize("names, bad", [
    (["jax"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax.numpy", "jaxlib.xla_client"]),
    (["pyspectrogram_tpu", "pyspectrogram_tpu.ops.stft"],
     ["pyspectrogram_tpu", "pyspectrogram_tpu.ops.stft"]),
    (["pyspectrogram_tpu_torch", "pyspectrogram_tpu_torch.io.hdf5",
      "jaxtyping", "pyspectrogram_tpu2", "numpy"], []),
])
def test_guard_compares_whole_top_level_names(names, bad):
    assert guard.forbidden(names) == bad


def test_guard_passes_this_process_without_jax(monkeypatch):
    import sys

    for name in [n for n in sys.modules if guard.forbidden([n])]:
        monkeypatch.delitem(sys.modules, name)
    guard.check("now")
    monkeypatch.setitem(sys.modules, "pyspectrogram_tpu", object())
    with pytest.raises(guard.GuardError, match="pyspectrogram_tpu"):
        guard.check("now")
