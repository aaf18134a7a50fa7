"""The port's viewer GUI (``MainWindow(device="cpu")``, on the headless
widget kit) against the JAX package's GUI on the same captures: the
compute-bearing flows of tests/test_gui.py.

Each flow drives both windows the same way and holds the port tab's last
payload against the JAX tab's: times, frequency axes and masks equal; dB
within 1e-4 dB on bins within 60 dB of each column's peak; uint8 tiles
within one level on <= 0.1% of pixels (ROADMAP Queue 3).
"""

import time

import numpy as np
import pytest

from pyspectrogram_tpu.clients import gui as jgui
from pyspectrogram_tpu.clients._qt_headless import (
    QFileDialog,
    QInputDialog,
    QMessageBox,
)
from pyspectrogram_tpu.io import RFDataset
from pyspectrogram_tpu.io.synthetic import tone_signal
from pyspectrogram_tpu.io.writer import DigitalRFWriter
from pyspectrogram_tpu_torch.clients import gui

SR = 100_000


@pytest.fixture(autouse=True)
def _dialog_state(tmp_path, monkeypatch):
    """Reset the headless kit's canned dialog answers and keep the
    last-used directory inside the test's tmp dir, for both windows."""
    QMessageBox.journal = []
    QMessageBox.answer = QMessageBox.Yes
    QFileDialog.existing_directory = ""
    QFileDialog.save_file_name = ("", "")
    QFileDialog.save_file_queue = []
    QFileDialog.open_file_name = ("", "")
    QInputDialog.double_answer = (0.0, False)
    QInputDialog.text_answer = ("", False)
    for mod in (gui, jgui):
        monkeypatch.setattr(mod.MainWindow, "_last_dir_file",
                            lambda self: tmp_path / "last_dir.txt")
    yield


def _windows():
    """(port window, JAX window), each with a hand-driven scheduler."""
    wins = gui.MainWindow(device="cpu"), jgui.MainWindow()
    for w in wins:
        w.scheduler.autostart = False
    return wins


def _wait(pred, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _start(win, top, tab_id=1, **widgets):
    st = win.states[tab_id]
    for name, v in widgets.items():
        getattr(st, name).setValue(v)
    QFileDialog.existing_directory = str(top)
    st.start_btn.click()
    return st


def _stop(st):
    st.stop_btn.click()
    assert _wait(lambda: not st.processor.is_running)
    st.processor.join(10)


def _db_close(got, want, floor_db=60.0, atol=1e-4):
    keep = want >= want.max(axis=0, keepdims=True) - floor_db
    np.testing.assert_allclose(got[keep], want[keep], atol=atol, rtol=0)


def assert_payload_match(g, w):
    for f in ("times", "freqs", "mask", "plot_freqs"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    _db_close(g.sxx_med_dbfs, w.sxx_med_dbfs)
    assert (g.tile is None) == (w.tile is None)
    if w.tile is None:
        _db_close(g.sxx_dbfs, w.sxx_dbfs)
    else:
        d = np.abs(g.tile.astype(int) - w.tile.astype(int))
        assert g.tile.dtype == np.uint8 and d.max() <= 1
        assert np.count_nonzero(d) <= 1e-3 * d.size


def _live_capture(path, n=40_000):
    """A 12.5 kHz tone at 100 kS/s with a -60 dB noise floor (seeded), so
    no pixel quantizes a float32 rounding floor."""
    w = DigitalRFWriter(path, "live", np.complex64,
                        start_global_index=1_451_661_840 * SR,
                        sample_rate_numerator=SR, file_cadence_millisecs=100,
                        subdir_cadence_secs=1)
    x = tone_signal(n, SR, [12_500.0])                 # (n, 1)
    rng = np.random.default_rng(n)
    x = x + 1e-3 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape)) / np.sqrt(2)
    w.rf_write(x.astype(np.complex64))
    return w


def test_written_tab_matches_jax(tone_capture):
    """A written tab at ntime 100: the scheduler's cycle delivers the
    display tile, the window draws it, and the payload is the JAX
    tab's."""
    top, meta = tone_capture
    wins = _windows()
    sts = [_start(w, top, ntime=100) for w in wins]
    for w in wins:
        w.scheduler.tick_once()
    port, jax_ = sts
    assert port.processor.device.type == "cpu"
    assert port.last is not None and port.last.i == 0
    assert port.last.tile is not None and port.last.sxx_dbfs is None
    assert_payload_match(port.last, jax_.last)
    assert port.specs.text() == jax_.specs.text()
    assert port.chan_combo.currentText() == meta["channel"]
    assert len(port.psd_ax.lines) == 2 and len(port.sti_ax.collections) == 1
    med = port.last.sxx_med_dbfs
    for s, f in enumerate(meta["freqs_hz"]):
        assert abs(med[:, s].max()) < 0.1
        assert port.last.freqs[med[:, s].argmax()] == pytest.approx(
            f, abs=1e6 / port.nfft.value())
    for st in sts:
        _stop(st)
    assert all(w.close() for w in wins)


def test_live_tab_matches_jax(tmp_path):
    """A live tab over a static capture: its own thread, the incremental
    engine, the trailing window's tile — the JAX tab's payload."""
    _live_capture(tmp_path / "cap")
    wins = _windows()
    sts = []
    for w in wins:
        st = w.states[1]
        st.live_check.setChecked(True)
        st.window_s.setValue(0.1)
        st.nfft.setValue(256)
        sts.append(_start(w, tmp_path / "cap"))
    port, jax_ = sts
    assert port.processor.config.streaming and port.processor._thread
    assert all(_wait(lambda s=s: s.last is not None) for s in sts)
    for st in sts:
        _stop(st)
    assert port.save_state.isEnabled() and port.save_btn.isEnabled()
    assert_payload_match(port.last, jax_.last)
    assert abs(port.last.sxx_med_dbfs.max()) < 0.1
    assert all(w.close() for w in wins)


def test_save_subtab_artifacts_match_jax(tone_capture, tmp_path):
    """The save sub-tab's PNG, .npz and CSV with a time subset: the tile
    tab recomputes at full resolution on a worker thread; the files hold
    what the JAX window's do."""
    top, _ = tone_capture
    wins = _windows()
    sts = [_start(w, top, ntime=100) for w in wins]
    for w, st in zip(wins, sts):
        w.scheduler.tick_once()
        _stop(st)
        assert st.save_btn.isEnabled()
        st.save_subset.click()
        st.save_t0.setValue(0.0)
        st.save_t1.setValue(st.save_t1.maximum() / 2)
        st.save_npz.click()
        st.save_csv.click()
    # the PNG is matplotlib's contour render on the host, in both
    # windows the JAX function's; only the port's window writes one
    sts[1].save_spectro.click()
    outs = {}
    for tag, st in zip(("port", "jax"), sts):
        outs[tag] = [tmp_path / f"{tag}.{ext}" for ext in ("png", "npz",
                                                          "csv")]
        QFileDialog.save_file_queue = [(str(p), "") for p in outs[tag]
                                       if tag == "port" or p.suffix != ".png"]
        st.save_btn.click()
        st.save_thread.join(120)
        assert _wait(lambda: st.save_btn.isEnabled())
        assert st.save_btn.text() == "Save File(s)…"
    assert QMessageBox.journal == []
    (ppng, pnpz, pcsv), (jpng, jnpz, jcsv) = outs["port"], outs["jax"]
    assert ppng.stat().st_size > 1000 and not jpng.exists()
    a, b = np.load(pnpz), np.load(jnpz)
    assert 0 < a["sxx_dbfs"].shape[1] < 100
    for f in ("freqs", "times"):
        np.testing.assert_array_equal(a[f], b[f])
    _db_close(a["sxx_dbfs"], b["sxx_dbfs"])
    _db_close(a["sxx_med_dbfs"], b["sxx_med_dbfs"])
    ca = np.loadtxt(pcsv, delimiter=",", skiprows=1)
    cb = np.loadtxt(jcsv, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(ca[:, 0], cb[:, 0])
    _db_close(ca[:, 1], cb[:, 1])
    assert all(w.close() for w in wins)


def test_multi_tab_merged_launch_matches_jax(tone_capture):
    """Three same-shape written tabs: one merged launch per cycle, a
    static cycle recomputes nothing, a settings change recomputes one tab
    solo; every tab's frame is the JAX window's."""
    top, _ = tone_capture
    wins = _windows()
    for w in wins:
        w.new_tab()
        w.new_tab()
        for t in (1, 2, 3):
            _start(w, top, tab_id=t, ntime=100)
        w.scheduler.tick_once()
    port, jax_ = wins
    for w in wins:
        assert (w.scheduler.merged_launches, w.scheduler.merged_requests,
                w.scheduler.solo_launches) == (1, 3, 0)
    for t in (1, 2, 3):
        assert_payload_match(port.states[t].last, jax_.states[t].last)
        assert len(port.states[t].sti_ax.collections) == 1
    for w in wins:
        w.scheduler.tick_once()
        assert w.scheduler.merged_launches == 1
        assert all(w.states[t].processor.skipped_recomputes == 1
                   for t in (1, 2, 3))
        w.states[2].nfft.setValue(512)
        w.pull_settings(2)
        w.scheduler.tick_once()
        assert (w.scheduler.merged_launches, w.scheduler.solo_launches) \
            == (1, 1)
    assert_payload_match(port.states[2].last, jax_.states[2].last)
    for w in wins:
        for t in (1, 2, 3):
            w.states[t].processor.abort()
        assert w.close()


def test_live_state_resume_crosses_packages(tmp_path):
    """The save sub-tab's stream state (live runs only) resumes through
    the resume button in a fresh window, adopting the checkpoint's knobs;
    a state the JAX window saved resumes in the port's too."""
    _live_capture(tmp_path / "cap")
    states = []
    for tag, win in (("port", gui.MainWindow(device="cpu")),
                     ("jax", jgui.MainWindow())):
        st = win.states[1]
        st.live_check.setChecked(True)
        st.window_s.setValue(0.1)
        st.nfft.setValue(256)
        st.hop_w.setValue(128)
        _start(win, tmp_path / "cap")
        assert _wait(lambda: st.last is not None)
        _stop(st)
        st.save_spectro.setChecked(False)
        st.save_state.setChecked(True)
        ck = tmp_path / f"{tag}_state.npz"
        QFileDialog.save_file_queue = [(str(ck), "")]
        st.save_btn.click()
        st.save_thread.join(60)
        assert _wait(lambda: st.save_btn.isEnabled()) and ck.exists()
        states.append((ck, st.processor._live.engine.next_sample))
        assert win.close()
    for ck, next_sample in states:
        win = gui.MainWindow(device="cpu")
        st = win.states[1]
        QFileDialog.open_file_name = (str(ck), "")
        QFileDialog.existing_directory = str(tmp_path / "cap")
        st.resume_btn.click()
        assert st.processor is not None and st.processor.config.streaming
        assert st.nfft.value() == 256 and st.hop_w.value() == 128
        assert st.live_check.isChecked()
        eng = st.processor._live.engine
        assert eng is not None and eng.next_sample >= next_sample
        _stop(st)
        assert win.close()


def test_tab_and_thread_caps_match_jax(tone_capture):
    """MAX_TABS tabs at most (the 8th warns); with every tab running, a
    start on a stopped one warns that the threads are busy."""
    top, _ = tone_capture
    assert gui.MAX_TABS == jgui.MAX_TABS == 7
    win = gui.MainWindow(device="cpu")
    win.scheduler.autostart = False
    menu = win.menuBar().menus[0]
    assert [a.text() for a in menu.actions] == ["New Tab", "Rename Tab",
                                                "Close Tab"]
    for _ in range(gui.MAX_TABS):
        menu.actions[0].trigger()
    assert win.tabs.count() == gui.MAX_TABS
    assert QMessageBox.journal[-1][2] == "Maximum number of tabs reached."
    for t in win.states:
        _start(win, top, tab_id=t, nfft=256, ntime=100)
    assert all(s.processor.is_running for s in win.states.values())
    win.scheduler.tick_once()
    assert (win.scheduler.merged_launches,
            win.scheduler.merged_requests) == (1, gui.MAX_TABS)
    # 6 running: tab 1 may start again; then all 7 run and one more
    # start is refused
    st1 = win.states[1]
    st1.processor.abort()
    assert sum(s.processor.is_running
               for s in win.states.values()) == gui.MAX_TABS - 1
    n_warn = len(QMessageBox.journal)
    win.start_processor(1)
    assert st1.processor.is_running and len(QMessageBox.journal) == n_warn
    win.start_processor(1)
    assert QMessageBox.journal[-1][2] == "All processing threads are busy."
    for s in win.states.values():
        s.processor.abort()
    assert win.close()


def test_main_window_requires_a_device():
    with pytest.raises(TypeError):
        gui.MainWindow()
    if gui.HEADLESS:
        with pytest.raises(ImportError, match="PyQt5"):
            gui.require_qt()


def test_recording_figure_kit_keeps_the_drawn_frame(tone_capture):
    """A window given the recording kit (for machines without matplotlib)
    draws each frame into its recorders: the waterfall call carries the
    payload's tile, the PSD one line per subchannel. ``open_dataset``
    hands the processor an opened dataset for the chosen directory."""
    top, _ = tone_capture
    win = gui.MainWindow(device="cpu", figure_kit=gui.recording_figure_kit,
                         open_dataset=RFDataset)
    win.scheduler.autostart = False
    st = _start(win, top, ntime=100)
    assert isinstance(st.processor.ds, RFDataset)
    win.scheduler.tick_once()
    assert st.last is not None and st.last.tile is not None
    names = [c[0] for c in st.sti_ax.calls]
    assert names == ["pcolormesh", "set_xlabel"]
    args, kw = st.sti_ax.calls[0][1:]
    np.testing.assert_array_equal(args[2], st.last.tile[:, 0, :])
    np.testing.assert_array_equal(args[0], st.last.plot_freqs * 1e-3)
    assert kw["vmax"] == 255
    assert [c[0] for c in st.psd_ax.calls].count("plot") == 2
    assert ("draw_idle", (), {}) in st.canvas.calls
    _stop(st)
    assert win.close()
