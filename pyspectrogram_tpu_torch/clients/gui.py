"""PyQt5 GUI client of the PyTorch + CUDA port — the port of
pyspectrogram_tpu/clients/gui.py: the same window, tabs, save sub-tab and
resume flow over the port's runtime and renderer, with every processor's
device work on the window's ``device``.

Replicates the reference viewer's UI behavior (reference: drfview.py
RunProgram, rows 7-15 of SURVEY.md section 2):
* tabbed main window with New/Rename/Close tab (Ctrl+N/R/X,
  reference: drfview.py:187-207);
* per-tab controls: start/stop, channel + subchannel combos, time-range
  sliders (0..10000 mapped onto dataset bounds), color min/max, FFT
  length, integrations, STI time points, frequency window, "Update
  Settings" (reference: drfview.py:362-539);
* live median-PSD panel (all subchannels, selected one highlighted) above
  the STI waterfall with time ascending upward (reference:
  drfview.py:1296-1321, README.md:11);
* save sub-tab at reference parity: artifact checkboxes, a Save-subset
  checkbox gating Start/End time fields, save-specific color/frequency
  ranges, per-artifact file dialogs (reference: drfview.py:589-734,
  1389-1527) — plus .npz and median-PSD CSV artifacts (README wishlist);
* last-used directory persistence (reference: drfview.py:1113-1125).

Intentional fixes over the reference (SURVEY.md section 2 quirks list):
invalid frequency ranges restore the old *frequency* range (the reference
restored the color range, drfview.py:909); the save tab's time range
tracks the latest result instead of a never-updated maxtime=0
(drfview.py:248); error strings no longer reference audio files.

All compute stays in the framework; the GUI only consumes
``ProcessorCallbacks`` payloads, re-marshalled onto the Qt main thread.
The interactive entry point requires the optional [gui] extra
(PyQt5 + matplotlib); without it the same classes run on the port's
copy of the headless widget kit (clients._qt_headless, resolved by
clients.qt_backend), which is how the GUI is tested. The plots need
matplotlib (:func:`figure_kit`), unless the window is given
:func:`recording_figure_kit`.
"""

from __future__ import annotations

import sys
from pathlib import Path

from pyspectrogram_tpu_torch.clients.qt_backend import (
    FigureCanvas,
    HEADLESS,
    NavigationToolbar2QT,
    QT_IMPORT_ERROR,
    Qt,
    QtCore,
    QtWidgets,
    pyqtSignal,
)

import numpy as np

from pyspectrogram_tpu_torch.display import save_sti_png
from pyspectrogram_tpu_torch.runtime import (
    Iterated,
    ProcessorCallbacks,
    SharedRefreshScheduler,
    SpectrogramProcessor,
    StatsUpdated,
    Terminated,
)
from pyspectrogram_tpu_torch.utils.config import (
    MAX_PLOT_FREQS,
    NFFT_RANGE,
    NINT_RANGE,
    NTIME_RANGE,
    SpectrogramConfig,
)
from pyspectrogram_tpu_torch.utils.errors import TerminateReason

SLIDER_STEPS = 10_000  # time sliders 0..10000 (reference: drfview.py:392-439)
MAX_TABS = 7           # concurrent processors cap (reference: drfview.py:178)


def require_qt():
    if HEADLESS:
        raise ImportError(
            "The interactive GUI requires PyQt5 and matplotlib: pip "
            f"install 'pyspectrogram-tpu[gui]' (import error: "
            f"{QT_IMPORT_ERROR})"
        )


def figure_kit():
    """(Figure, ScalarMappable, Normalize, FigureCanvas): matplotlib's
    plot classes and the Qt binding's (or the headless kit's) canvas, the
    tab's plots. Imported when a tab is built, so this module imports
    without matplotlib (an optional extra); :class:`MainWindow` takes
    another kit of the same shape."""
    try:
        from matplotlib.cm import ScalarMappable
        from matplotlib.colors import Normalize
        from matplotlib.figure import Figure
    except ImportError as err:
        raise ImportError(
            "the viewer needs matplotlib: pip install "
            f"'pyspectrogram-tpu[gui]' (import error: {err})") from err
    return Figure, ScalarMappable, Normalize, FigureCanvas


class Drawn:
    """A figure, axes, mappable or canvas of :func:`recording_figure_kit`:
    each call on it is kept in ``calls`` as (name, args, kwargs) and
    returns a new Drawn; ``cla()`` clears them, as it clears an axes."""

    def __init__(self, *args, **kwargs):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            if name == "cla":
                self.calls.clear()
            else:
                self.calls.append((name, args, kwargs))
            return Drawn()

        return call

    def __getitem__(self, key):
        return Drawn()


def recording_figure_kit():
    """A figure kit that keeps what each tab draws instead of rendering
    it: the window runs on the headless widget kit where matplotlib is
    not installed, and a tab's drawn frame is read from its
    ``sti_ax.calls`` and ``psd_ax.calls``."""
    return Drawn, Drawn, Drawn, Drawn


class CustomToolbar(NavigationToolbar2QT):
    """Nav toolbar restricted to the reference's tool subset
    (reference: drfview.py:1744-1754)."""

    toolitems = [
        t for t in NavigationToolbar2QT.toolitems
        if t[0] in ("Home", "Back", "Forward", "Pan", "Zoom", "Save")
    ]

class _Bridge(QtCore.QObject):
    """Marshals worker-thread callbacks onto the Qt main thread."""

    iterated = pyqtSignal(object)
    stats = pyqtSignal(object)
    terminated = pyqtSignal(object)

    def callbacks(self) -> ProcessorCallbacks:
        return ProcessorCallbacks(
            on_iterated=self.iterated.emit,
            on_stats=self.stats.emit,
            on_terminated=self.terminated.emit,
        )


class _SaveBridge(QtCore.QObject):
    """Completion signal for the save worker thread (the artifact writes
    — and, in tile mode, the full-resolution recompute — must not block
    the Qt event loop)."""

    done = pyqtSignal(object)  # Exception | None

class TabState:
    def __init__(self):
        self.processor: SpectrogramProcessor | None = None
        self.bridge: _Bridge | None = None
        self.config = SpectrogramConfig()
        self.last: Iterated | None = None
        self.time_bounds = None
        self.subchan = 0

class MainWindow(QtWidgets.QMainWindow):
    def __init__(self, *, device, figure_kit=figure_kit, open_dataset=None):
        """``device`` ("cuda", "cpu", ...) runs every tab's processor, and
        so the shared scheduler's merged launches; ``figure_kit`` gives
        each tab its plot classes (see :func:`figure_kit`);
        ``open_dataset``, when given, maps the chosen directory to what
        the processor opens (an opened RFDataset such as
        io.memory.MemoryDataset)."""
        super().__init__()
        self.device = device
        self.figure_kit = figure_kit
        self.open_dataset = open_dataset
        self.setWindowTitle("pyspectrogram-tpu viewer (PyTorch)")
        self.tabs = QtWidgets.QTabWidget()
        self.setCentralWidget(self.tabs)
        self.states: dict[int, TabState] = {}
        self._tab_seq = 0
        # universal settings (reference wishlist README.md:18): apply
        # to every tab; persisted per user
        self.refresh_s = 0.1
        # one refresh loop for ALL written-mode tabs: same-shape tabs
        # merge into one batched device launch per cycle instead of the
        # reference's N independent worker threads (runtime.scheduler;
        # reference: drfview.py:177-178)
        self.scheduler = SharedRefreshScheduler(self.refresh_s)
        self._build_menu()
        self.new_tab()
        self.showMaximized()

    # ---------------------------------------------------------- menu
    def _build_menu(self):
        m = self.menuBar().addMenu("&File")
        for label, keys, fn in [
            ("New Tab", "Ctrl+N", self.new_tab),
            ("Rename Tab", "Ctrl+R", self.rename_tab),
            ("Close Tab", "Ctrl+X", self.close_tab),
        ]:
            act = QtWidgets.QAction(label, self)
            act.setShortcut(keys)
            act.triggered.connect(fn)
            m.addAction(act)
        s = self.menuBar().addMenu("&Settings")
        act = QtWidgets.QAction("Refresh rate…", self)
        act.triggered.connect(self._set_refresh_rate)
        s.addAction(act)

    def _set_refresh_rate(self):
        val, ok = QtWidgets.QInputDialog.getDouble(
            self, "Universal settings", "GUI refresh interval (s):",
            self.refresh_s, 0.01, 10.0, 2)
        if ok:
            self.refresh_s = val
            self.scheduler.refresh_s = val
            for st in self.states.values():
                if st.processor:
                    st.processor.written_sleep = val
                    st.processor.streaming_sleep = val

    # ---------------------------------------------------------- tabs
    def new_tab(self):
        if self.tabs.count() >= MAX_TABS:
            self._warn("Maximum number of tabs reached.")
            return
        self._tab_seq += 1
        tab_id = self._tab_seq
        st = TabState()
        self.states[tab_id] = st
        w = self._build_tab(tab_id, st)
        self.tabs.addTab(w, f"Tab {tab_id}")
        self.tabs.setCurrentWidget(w)

    def rename_tab(self):
        i = self.tabs.currentIndex()
        name, ok = QtWidgets.QInputDialog.getText(
            self, "Rename Tab", "New name:")
        if ok and name:
            self.tabs.setTabText(i, name)

    def close_tab(self):
        i = self.tabs.currentIndex()
        w = self.tabs.widget(i)
        tab_id = w.property("tab_id")
        st = self.states.pop(tab_id, None)
        if st and st.processor and st.processor.is_running:
            st.processor.abort()
        self.tabs.removeTab(i)

    # ------------------------------------------------------- tab UI
    def _build_tab(self, tab_id: int, st: TabState) -> QtWidgets.QWidget:
        w = QtWidgets.QWidget()
        w.setProperty("tab_id", tab_id)
        layout = QtWidgets.QHBoxLayout(w)

        Figure, ScalarMappable, Normalize, FigureCanvas = self.figure_kit()
        fig = Figure(figsize=(8, 8))
        gs = fig.add_gridspec(4, 5)
        st.psd_ax = fig.add_subplot(gs[0, :-1])
        st.sti_ax = fig.add_subplot(gs[1:, :])
        # dBFS-labeled colorbar beside the waterfall
        # (reference: drfview.py:1367-1387)
        st.mappable = ScalarMappable(
            norm=Normalize(*st.config.color_range_db), cmap="viridis")
        st.colorbar = fig.colorbar(st.mappable, ax=st.sti_ax,
                                   label="dBFS")
        st.canvas = FigureCanvas(fig)
        left = QtWidgets.QVBoxLayout()
        left.addWidget(CustomToolbar(st.canvas, w))
        left.addWidget(st.canvas)
        layout.addLayout(left, stretch=3)

        panel = QtWidgets.QFormLayout()
        st.start_btn = QtWidgets.QPushButton("Start")
        st.stop_btn = QtWidgets.QPushButton("Stop")
        st.stop_btn.setEnabled(False)
        row = QtWidgets.QHBoxLayout()
        row.addWidget(st.start_btn)
        row.addWidget(st.stop_btn)
        panel.addRow(row)

        st.chan_combo = QtWidgets.QComboBox()
        st.sub_combo = QtWidgets.QComboBox()
        panel.addRow("Channel", st.chan_combo)
        panel.addRow("Subchannel", st.sub_combo)

        # live mode toggle (the reference hardcodes usetype="written",
        # drfview.py:172-174; live streaming is its README wishlist item,
        # README.md:16): a streaming tab runs the incremental engine
        # (runtime.live) against a growing capture over a trailing window
        st.live_check = QtWidgets.QCheckBox("Live (streaming)")
        st.window_s = QtWidgets.QDoubleSpinBox()
        st.window_s.setRange(0.1, 86_400.0)
        st.window_s.setDecimals(1)
        st.window_s.setValue(st.config.stream_seconds)
        panel.addRow(st.live_check)
        panel.addRow("Live window (s)", st.window_s)
        # overlap-save column hop for live tabs (SpectrogramConfig.hop):
        # 0 = contiguous columns (the default); a smaller hop overlaps
        # consecutive columns by nfft*nint - hop samples
        st.hop_w = QtWidgets.QSpinBox()
        st.hop_w.setRange(0, NFFT_RANGE[1])
        st.hop_w.setValue(0)
        panel.addRow("Live hop (samples, 0=contig)", st.hop_w)
        # counterpart of the save sub-tab's stream-state artifact: pick a
        # saved state, adopt its shape knobs, continue the stream
        st.resume_btn = QtWidgets.QPushButton("Resume live from state…")
        st.resume_btn.clicked.connect(
            lambda: self.start_processor(tab_id, resume_state=True))
        panel.addRow(st.resume_btn)

        st.tmin = QtWidgets.QSlider(Qt.Horizontal)
        st.tmax = QtWidgets.QSlider(Qt.Horizontal)
        for s, v in ((st.tmin, 0), (st.tmax, SLIDER_STEPS)):
            s.setRange(0, SLIDER_STEPS)
            s.setValue(v)
        panel.addRow("Time min", st.tmin)
        panel.addRow("Time max", st.tmax)

        st.cmin = QtWidgets.QSpinBox()
        st.cmin.setRange(-200, 0)
        st.cmin.setValue(int(st.config.color_range_db[0]))
        st.cmax = QtWidgets.QSpinBox()
        st.cmax.setRange(-150, 0)
        st.cmax.setValue(int(st.config.color_range_db[1]))
        panel.addRow("Color min (dBFS)", st.cmin)
        panel.addRow("Color max (dBFS)", st.cmax)

        st.nfft = QtWidgets.QSpinBox()
        st.nfft.setRange(*NFFT_RANGE)
        st.nfft.setValue(st.config.nfft)
        st.nint = QtWidgets.QSpinBox()
        st.nint.setRange(*NINT_RANGE)
        st.nint.setValue(st.config.nint)
        st.ntime = QtWidgets.QSpinBox()
        st.ntime.setRange(max(NTIME_RANGE[0], 100), NTIME_RANGE[1])
        st.ntime.setValue(max(st.config.ntime, 100))
        panel.addRow("FFT length", st.nfft)
        panel.addRow("Integrations", st.nint)
        panel.addRow("STI time points", st.ntime)

        st.fmin = QtWidgets.QSpinBox()
        st.fmin.setRange(-1000, 1000)
        st.fmin.setValue(int(st.config.freq_window_khz[0]))
        st.fmax = QtWidgets.QSpinBox()
        st.fmax.setRange(-1000, 1000)
        st.fmax.setValue(int(st.config.freq_window_khz[1]))
        panel.addRow("Freq min (kHz)", st.fmin)
        panel.addRow("Freq max (kHz)", st.fmax)

        st.update_btn = QtWidgets.QPushButton("Update Settings")
        panel.addRow(st.update_btn)
        st.specs = QtWidgets.QLabel("")
        panel.addRow(st.specs)

        # save sub-tab (reference: drfview.py:589-734): artifact
        # checkboxes, a time-range subset gate, and save-specific
        # color/frequency ranges independent of the live view
        save_box = QtWidgets.QGroupBox("Save")
        sv = QtWidgets.QFormLayout()
        st.save_spectro = QtWidgets.QCheckBox("Save spectrogram (PNG)")
        st.save_npz = QtWidgets.QCheckBox("Save arrays (.npz)")
        st.save_csv = QtWidgets.QCheckBox("Save median PSD (CSV)")
        # live runs only: persist the ring + read cursor so `pstpu watch
        # --resume` (or a later live tab) continues this exact stream
        st.save_state = QtWidgets.QCheckBox("Save stream state (live resume)")
        st.save_state.setEnabled(False)
        sv.addRow(st.save_spectro)
        sv.addRow(st.save_npz)
        sv.addRow(st.save_csv)
        sv.addRow(st.save_state)

        st.save_subset = QtWidgets.QCheckBox("Save subset")
        sv.addRow(st.save_subset)
        st.save_t0 = QtWidgets.QDoubleSpinBox()
        st.save_t1 = QtWidgets.QDoubleSpinBox()
        for wdg in (st.save_t0, st.save_t1):
            # ranges track the latest result (intentional fix of the
            # reference's never-updated maxtime=0, drfview.py:248)
            wdg.setRange(0, 0)
            wdg.setSingleStep(0.05)
            wdg.setDecimals(2)
        sv.addRow("Start time (s)", st.save_t0)
        sv.addRow("End time (s)", st.save_t1)
        # End time follows the newest result until the USER edits it —
        # an explicit flag, not value==maximum inference (which silently
        # re-enabled following for a user who pinned End time to exactly
        # the present span)
        st.save_t1_user = False
        st.save_t1_programmatic = False

        def _t1_edited(_v):
            if not st.save_t1_programmatic:
                st.save_t1_user = True

        st.save_t1.valueChanged.connect(_t1_edited)

        st.save_cmin = QtWidgets.QDoubleSpinBox()
        st.save_cmin.setRange(-200, 0)
        st.save_cmin.setValue(float(st.config.color_range_db[0]))
        st.save_cmax = QtWidgets.QDoubleSpinBox()
        st.save_cmax.setRange(-150, 0)
        st.save_cmax.setValue(float(st.config.color_range_db[1]))
        sv.addRow("Color min", st.save_cmin)
        sv.addRow("Color max", st.save_cmax)
        st.save_fmin = QtWidgets.QSpinBox()
        st.save_fmin.setRange(-1000, 1000)
        st.save_fmin.setValue(int(st.config.freq_window_khz[0]))
        st.save_fmax = QtWidgets.QSpinBox()
        st.save_fmax.setRange(-1000, 1000)
        st.save_fmax.setValue(int(st.config.freq_window_khz[1]))
        sv.addRow("Frequency min (kHz)", st.save_fmin)
        sv.addRow("Frequency max (kHz)", st.save_fmax)

        st.save_btn = QtWidgets.QPushButton("Save File(s)…")
        st.save_btn.setEnabled(False)
        sv.addRow(st.save_btn)
        save_box.setLayout(sv)
        panel.addRow(save_box)

        # checkbox gating (reference updatesavespectrobox /
        # updatesavesubsetbox, drfview.py:1393-1415)
        def _gate_spectro(on: bool):
            for wdg in (st.save_cmin, st.save_cmax,
                        st.save_fmin, st.save_fmax):
                wdg.setEnabled(on)

        def _gate_subset(on: bool):
            st.save_t0.setEnabled(on)
            st.save_t1.setEnabled(on)

        st.save_spectro.toggled.connect(_gate_spectro)
        st.save_subset.toggled.connect(_gate_subset)
        st.save_spectro.setChecked(True)
        st.save_subset.setChecked(False)
        _gate_subset(False)

        right = QtWidgets.QWidget()
        right.setLayout(panel)
        layout.addWidget(right, stretch=1)

        st.start_btn.clicked.connect(lambda: self.start_processor(tab_id))
        st.stop_btn.clicked.connect(lambda: self.stop_processor(tab_id))
        st.update_btn.clicked.connect(lambda: self.pull_settings(tab_id))
        st.save_btn.clicked.connect(lambda: self.save_files(tab_id))
        st.save_thread = None
        st.save_bridge = _SaveBridge()  # worker -> main thread completion
        st.save_bridge.done.connect(lambda e: self._on_save_done(tab_id, e))
        st.sub_combo.currentIndexChanged.connect(
            lambda i: self._set_subchan(tab_id, i))
        st.chan_combo.currentTextChanged.connect(
            lambda name: self._set_channel(tab_id, name))
        return w

    # --------------------------------------------------- processor
    def _last_dir_file(self) -> Path:
        return Path.home() / ".pstpu_last_dir"

    def start_processor(self, tab_id: int, resume_state: bool = False):
        st = self.states[tab_id]
        running = sum(
            1 for s in self.states.values()
            if s.processor and s.processor.is_running
        )
        if running >= MAX_TABS:
            self._warn("All processing threads are busy.")
            return
        if st.hop_w.value() > st.nfft.value() * st.nint.value():
            # same guard as pull_settings: the config would refuse this
            # hop, and a ValueError must not escape the clicked slot
            self._warn("Hop must not exceed FFT length x integrations.")
            return
        state_path = sig = None
        if resume_state:
            # adopt the checkpoint's shape knobs (header-only read), then
            # run the normal start flow in streaming mode and preload the
            # ring before the loop starts
            from pyspectrogram_tpu_torch.runtime import checkpoint

            state_path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Resume stream state", "", "NumPy archive (*.npz)")
            if not state_path:
                return
            try:
                meta = checkpoint.peek_stream_meta(state_path)
                if meta.get("kind") != "live_stream":
                    self._warn("Not a live-stream state file.")
                    return
                sig = meta["signature"]
                if len(sig) == 8:
                    # pre-hop checkpoints (<= round 4) were always
                    # contiguous: effective hop = nfft*nint
                    sig = list(sig) + [int(sig[0]) * int(sig[1])]
                # touch every field the adoption below needs, so a foreign
                # npz with a plausible header fails HERE (one dialog) and
                # not mid-start with widgets already mutated
                (int(sig[0]), int(sig[1]), float(sig[6]), float(sig[7]),
                 int(sig[8]))
            except (ValueError, KeyError, OSError, IndexError,
                    TypeError) as e:
                # same guarded preload as the CLI's cmd_watch: a corrupt,
                # truncated, or foreign .npz must report, not escape the
                # Qt clicked slot
                self._warn(f"Cannot read stream state: {e}")
                return
        last = ""
        f = self._last_dir_file()
        if f.exists():
            last = f.read_text().strip()
        drfdir = QtWidgets.QFileDialog.getExistingDirectory(
            self, "Select Digital RF directory", last)
        if not drfdir:
            return
        f.write_text(drfdir)
        if sig is not None:
            # adopt the checkpoint's widget-visible knobs only now that
            # every cancellable dialog is behind us — a Cancel on the
            # directory picker must leave the user's knob values intact
            st.nfft.setValue(int(sig[0]))
            st.nint.setValue(int(sig[1]))
            st.window_s.setValue(float(sig[6]))
            # the signature stores the EFFECTIVE hop (= nfft*nint for
            # contiguous streams) — mirror it into the widget so a later
            # Update Settings doesn't silently reset the resumed shape.
            # Contiguous maps to the widget's 0, NOT the literal
            # nfft*nint: a big frame's effective hop can exceed the
            # spinbox range and a clamped value would silently turn the
            # resumed stream into an overlap-save one.
            hop_eff = int(sig[8])
            frame = int(sig[0]) * int(sig[1])
            # a genuinely-overlapped hop on a big frame (nfft*nint >
            # NFFT_RANGE[1]) exceeds the default spinbox max — widen the
            # range BEFORE adopting it, or setValue clamps and the next
            # Update Settings rebuilds the ring with a DIFFERENT overlap
            # than the checkpointed stream
            st.hop_w.setRange(0, max(st.hop_w.maximum(), frame))
            st.hop_w.setValue(0 if hop_eff == frame else hop_eff)
            st.live_check.setChecked(True)

        st.bridge = _Bridge()
        st.bridge.iterated.connect(
            lambda p: self.on_iterated(tab_id, p))
        st.bridge.stats.connect(lambda p: self.on_stats(tab_id, p))
        st.bridge.terminated.connect(
            lambda p: self.on_terminated(tab_id, p))
        datasource = ("streaming" if st.live_check.isChecked()
                      else "written")
        cfg = self._config_from_widgets(st)
        if sig is not None:
            # non-widget knobs ride in from the checkpoint signature
            # (runtime.live._signature order). stream_seconds and eps are
            # adopted into the CONFIG directly, not via widgets: the
            # window_s spinbox's min/decimals would mangle values it
            # cannot represent (0.02 -> 0.1) and the strict signature
            # compare would then refuse the state; eps has no widget.
            window = tuple(sig[3]) if isinstance(sig[3], list) else sig[3]
            cfg = cfg.replace(mode=sig[2], window=window, precision=sig[4],
                              channel=sig[5],
                              stream_seconds=float(sig[6]),
                              eps=float(sig[7]),
                              # column hop (overlap-save) has no widget;
                              # the signature stores the effective value
                              hop=int(sig[8]))
        if self.open_dataset is not None:
            drfdir = self.open_dataset(drfdir)
        st.processor = SpectrogramProcessor(
            datasource, drfdir, tab_id, cfg,
            callbacks=st.bridge.callbacks(),
            # written tabs share the refresh scheduler so same-shape tabs
            # batch into one device launch; streaming tabs keep their own
            # thread (the processor decides, runtime.processor.start)
            scheduler=self.scheduler, device=self.device,
        )
        if not st.processor.is_running:
            return  # terminated already emitted with the reason
        if state_path:
            try:
                st.processor.preload_live_state(state_path)
            except (ValueError, KeyError, OSError) as err:
                self._warn(f"Cannot resume stream state: {err}")
                st.processor.abort()  # resets buttons via on_terminated
                return
        st.chan_combo.clear()
        st.chan_combo.addItems(st.processor.chan_listing)
        st.sub_combo.clear()
        chan = st.processor.chan_listing[0]
        nsub = len(st.processor.ds.chan_2sub[chan])
        st.sub_combo.addItems([str(i) for i in range(nsub)])
        st.processor.start()
        st.start_btn.setEnabled(False)
        st.resume_btn.setEnabled(False)
        st.stop_btn.setEnabled(True)
        st.save_btn.setEnabled(False)
        # a pinned End time is a per-run decision: a NEW run's span has
        # nothing to do with the previous run's pin, so re-engage
        # follow-the-newest until the user edits it again this run
        st.save_t1_user = False
        # mode is per-run: the incremental ring's lifecycle is the
        # processor's (a stop releases it; a new start builds a fresh one)
        st.live_check.setEnabled(False)

    def stop_processor(self, tab_id: int):
        st = self.states[tab_id]
        if st.processor:
            st.processor.abort()

    def _set_subchan(self, tab_id: int, i: int):
        st = self.states[tab_id]
        st.subchan = max(0, i)
        if st.last is not None:
            self._redraw(st)

    def _set_channel(self, tab_id: int, name: str):
        """Channel switch: repopulate subchannels and retarget the
        processor (the reference repopulates combos on start only,
        drfview.py:1186-1194; live switching is an improvement)."""
        st = self.states[tab_id]
        if not name or st.processor is None:
            return
        nsub = len(st.processor.ds.chan_2sub.get(name, []))
        if nsub == 0:
            return
        st.sub_combo.blockSignals(True)
        st.sub_combo.clear()
        st.sub_combo.addItems([str(i) for i in range(nsub)])
        st.sub_combo.blockSignals(False)
        st.subchan = 0
        st.processor.select_channel(name)

    # ----------------------------------------------------- settings
    def _config_from_widgets(self, st: TabState) -> SpectrogramConfig:
        return st.config.replace(
            nfft=st.nfft.value(), nint=st.nint.value(),
            ntime=st.ntime.value(),
            color_range_db=(st.cmin.value(), st.cmax.value()),
            freq_window_khz=(st.fmin.value(), st.fmax.value()),
            stream_seconds=st.window_s.value(),
            hop=st.hop_w.value() or None,
            # live view renders from on-device uint8 tiles: crop,
            # decimation and color quantization run inside the device
            # program and only the tile + median PSD are read back
            display_tile=True,
        )

    def pull_settings(self, tab_id: int):
        """GUI -> processor settings push with validation + revert
        (reference: drfview.py:849-958; frange revert bug fixed)."""
        st = self.states[tab_id]
        old = st.config
        if st.cmax.value() <= st.cmin.value():
            st.cmin.setValue(int(old.color_range_db[0]))
            st.cmax.setValue(int(old.color_range_db[1]))
            self._warn("Maximum color value must exceed the minimum.")
            return
        if st.fmax.value() <= st.fmin.value():
            st.fmin.setValue(int(old.freq_window_khz[0]))
            st.fmax.setValue(int(old.freq_window_khz[1]))
            self._warn("Maximum frequency must exceed the minimum.")
            return
        if st.hop_w.value() > st.nfft.value() * st.nint.value():
            st.hop_w.setValue(int(old.hop or 0))
            self._warn("Hop must not exceed FFT length x integrations.")
            return
        st.config = self._config_from_widgets(st)
        if st.processor and st.processor.is_running:
            tb = st.processor.ds.time_bnds
            span = tb[1] - tb[0]
            st.processor.update_settings(
                nfft=st.config.nfft, nint=st.config.nint,
                ntime=st.config.ntime,
                bnd_beg=tb[0] + span * st.tmin.value() / SLIDER_STEPS,
                bnd_end=tb[0] + span * st.tmax.value() / SLIDER_STEPS,
                # the display epilogue runs ON DEVICE in tile mode, so the
                # color range and frequency window must reach the worker's
                # config too (color changes reuse the compiled program —
                # the range is a runtime operand, see TileSpec.crop_key)
                color_range_db=st.config.color_range_db,
                freq_window_khz=st.config.freq_window_khz,
                # live tabs: window/hop changes rebuild the ring (shape
                # knobs in the live signature, runtime.live)
                stream_seconds=st.config.stream_seconds,
                hop=st.config.hop,
            )

    # -------------------------------------------------------- slots
    def on_stats(self, tab_id: int, p: StatsUpdated):
        st = self.states.get(tab_id)
        if st is None:
            return
        st.time_bounds = p.time_bounds
        sr = float(p.sample_rate)
        nyq_khz = sr / 2e3
        for wdg in (st.fmin, st.fmax):
            wdg.setRange(int(-nyq_khz), int(nyq_khz))
        df = sr / p.nfft
        st.specs.setText(
            f"fs={sr:,.0f} Hz  Nyquist={sr/2:,.0f} Hz\n"
            f"NFFT={p.nfft}  Δf={df:,.2f} Hz"
        )

    def on_iterated(self, tab_id: int, p: Iterated):
        st = self.states.get(tab_id)
        if st is None:
            return
        st.last = p
        # the save sub-tab's time-subset range tracks the latest result
        # (intentional fix of the reference's maxtime=0 bug,
        # drfview.py:248,1434): spinboxes span [0, result duration]
        span_s = float((p.times[-1] - p.times[0])
                       / np.timedelta64(1, "s")) if len(p.times) else 0.0
        # programmatic updates must not set the user-edited flag (the
        # setRange clamp also fires valueChanged)
        st.save_t1_programmatic = True
        try:
            st.save_t0.setRange(0.0, span_s)
            st.save_t1.setRange(0.0, span_s)
            if not st.save_t1_user:  # follow newest until the user edits
                st.save_t1.setValue(span_s)
        finally:
            st.save_t1_programmatic = False
        if st.processor is not None and not st.processor.is_running:
            # the run's sole frame is delivered AFTER Terminated when the
            # user stops during the first in-flight compute
            # (processor.run keeps it rather than dropping the run's only
            # result) — on_terminated saw last=None, so re-arm Save now
            st.save_btn.setEnabled(self._save_allowed(st))
        self._redraw(st)

    def _save_allowed(self, st: TabState) -> bool:
        """Save is armed only when there is a result, no run is active,
        and no save worker is still in flight (a second worker would race
        the first on the target files and the tile-mode recompute)."""
        saving = st.save_thread is not None and st.save_thread.is_alive()
        running = st.processor is not None and st.processor.is_running
        return not saving and not running and st.last is not None

    def on_terminated(self, tab_id: int, p: Terminated):
        st = self.states.get(tab_id)
        if st is None:
            return
        st.start_btn.setEnabled(True)
        st.resume_btn.setEnabled(True)
        st.stop_btn.setEnabled(False)
        st.save_btn.setEnabled(self._save_allowed(st))
        st.live_check.setEnabled(True)
        st.save_state.setEnabled(
            st.processor is not None and st.processor.has_live_state)
        if p.reason != TerminateReason.OK:
            self._warn(p.detail or p.reason.describe())

    # --------------------------------------------------------- draw
    def _redraw(self, st: TabState):
        p = st.last
        nsub = p.sxx_med_dbfs.shape[1]
        # clamp against the RESULT's subchannel count: a channel switch
        # repopulates the sub combo before the new channel's first
        # Iterated lands (a whole request later), and indexing the stale
        # result with the new combo's index would raise out of the Qt slot
        sub = min(st.subchan, nsub - 1)
        f_khz = p.freqs * 1e-3
        st.psd_ax.cla()
        for i in range(nsub):
            lw = 4 if i == sub else 1
            st.psd_ax.plot(f_khz, p.sxx_med_dbfs[:, i], linewidth=lw,
                           label=f"sub chan: {i}")
        st.psd_ax.legend(loc="upper right", fontsize=7)
        st.psd_ax.set_ylabel("dBFS")

        st.sti_ax.cla()
        crange = st.config.color_range_db
        if p.tile is not None:
            # on-device display path: the payload already carries the
            # cropped/decimated/quantized uint8 levels — render them
            # directly (level k of npoints == the same viridis color the
            # float path picks for its dB value)
            st.sti_ax.pcolormesh(
                p.plot_freqs * 1e-3, p.times, p.tile[:, sub, :],
                cmap="viridis", vmin=0, vmax=255, shading="auto",
            )
        else:
            # float fallback: decimate to the plot cap before pcolormesh
            from pyspectrogram_tpu_torch.display import freq_crop_decimate

            idx, plotf = freq_crop_decimate(
                p.freqs, st.config.freq_window_khz, MAX_PLOT_FREQS)
            st.sti_ax.pcolormesh(
                plotf * 1e-3, p.times, p.sxx_dbfs[idx, :, sub].T,
                cmap="viridis", vmin=crange[0], vmax=crange[1],
                shading="auto",
            )
        st.sti_ax.set_xlabel("Frequency (kHz)")
        st.mappable.set_clim(*crange)
        st.canvas.draw_idle()

    def save_files(self, tab_id: int):
        """Save File(s): one dialog per checked artifact, all driven from
        the save sub-tab's own ranges + optional time subset (reference
        savefiles, drfview.py:1417-1457; extended with .npz and PSD CSV
        from the reference README wishlist)."""
        st = self.states[tab_id]
        if st.last is None:
            return
        if st.save_thread is not None and st.save_thread.is_alive():
            # belt-and-braces (the button is disabled while saving): a
            # second worker would race the first on the target files
            self._warn("A save is already in progress.")
            return
        if st.processor and st.processor.is_running:
            # belt-and-braces: the button is only enabled after the
            # processor terminates (reference: drfview.py:1343), and the
            # tile-mode branch below runs pipeline.compute on the GUI
            # thread — unsafe concurrently with the worker's compute loop
            self._warn("Stop the processor before saving.")
            return
        want_png = st.save_spectro.isChecked()
        want_npz = st.save_npz.isChecked()
        want_csv = st.save_csv.isChecked()
        want_state = (st.save_state.isChecked()
                      and st.save_state.isEnabled())
        if not (want_png or want_npz or want_csv or want_state):
            self._warn("Select at least one artifact to save.")
            return
        names = {}
        for key, on, caption, flt in [
            ("png", want_png, "Save Spectrogram", "Image (*.png)"),
            ("npz", want_npz, "Save Arrays", "NumPy archive (*.npz)"),
            ("csv", want_csv, "Save Median PSD", "CSV (*.csv)"),
            ("state", want_state, "Save Stream State",
             "NumPy archive (*.npz)"),
        ]:
            if not on:
                continue
            fname, _ = QtWidgets.QFileDialog.getSaveFileName(
                self, caption, "", flt)
            if fname:
                names[key] = fname
        if not names:
            return
        # capture everything on the GUI thread; the writes — and in tile
        # mode the full-resolution recompute — run on a worker so the
        # event loop stays live.
        # Progress state = disabled button with "Saving…" (no wait
        # cursor: the loop keeps serving redraws/menus meanwhile).
        subset = st.save_subset.isChecked()
        t0_s, t1_s = st.save_t0.value(), st.save_t1.value()
        crange = (st.save_cmin.value(), st.save_cmax.value())
        frange = (st.save_fmin.value(), st.save_fmax.value())
        subchan = st.subchan
        last = st.last
        processor = st.processor
        st.save_btn.setEnabled(False)
        st.save_btn.setText("Saving…")

        def work():
            try:
                if processor is not None:
                    # is_running flips False at stop time, but the worker
                    # loop may still be finishing an in-flight compute;
                    # wait it out HERE — off the GUI thread — so the
                    # tile-mode recompute below never runs concurrently
                    # with it
                    processor.join()
                self._write_artifacts(names, last, processor, subset,
                                      t0_s, t1_s, crange, frange, subchan,
                                      self.device)
            except Exception as e:  # surfaced via the bridge
                st.save_bridge.done.emit(e)
            else:
                st.save_bridge.done.emit(None)

        import threading

        st.save_thread = threading.Thread(target=work, daemon=True)
        st.save_thread.start()

    @staticmethod
    def _write_artifacts(names, last, processor, subset, t0_s, t1_s,
                         crange, frange, subchan, device):
        """Worker-thread body: (re)compute if needed + write artifacts."""
        if "state" in names:
            # ring + read cursor of the live run (LiveStreamEngine.save);
            # resumable via `pstpu watch --resume` / preload_live_state
            processor.save_live_state(names["state"])
        array_artifacts = set(names) - {"state"}
        freqs, times, sxx = last.freqs, last.times, last.sxx_dbfs
        med = last.sxx_med_dbfs
        if sxx is None and not array_artifacts:
            return  # stream-state-only save: no recompute needed
        if sxx is None:
            # live view runs in display-tile mode (floats never left the
            # device); the save pipeline wants full-resolution spectra,
            # so recompute this one request with readback — and use that
            # result's own axes (settings may have changed since the
            # displayed payload)
            res = processor.pipeline.compute(
                processor.config.replace(display_tile=False))
            freqs, times, sxx, med = (res.freqs, res.times,
                                      res.sxx_dbfs, res.sxx_med_dbfs)
        timerange = None
        if subset:
            # subset spinboxes are seconds into the result
            timerange = (
                times[0] + np.timedelta64(int(t0_s * 1e6), "us"),
                times[0] + np.timedelta64(int(t1_s * 1e6), "us"),
            )
        keepf = (freqs * 1e-3 >= frange[0]) & (freqs * 1e-3 <= frange[1])
        if "png" in names:
            save_sti_png(
                names["png"], freqs, times, sxx[..., subchan],
                colorrange=crange, freqrange_khz=frange,
                timerange=timerange, device=device,
            )
        if "npz" in names:
            from pyspectrogram_tpu_torch.display import save_result_npz

            save_result_npz(names["npz"], freqs, times, sxx, med,
                            timerange=timerange, freqrange_khz=frange)
        if "csv" in names:
            from pyspectrogram_tpu_torch.display import save_psd_csv

            # the CSV honors the save sub-tab's frequency range like the
            # PNG/npz artifacts (it silently wrote full-band before)
            save_psd_csv(names["csv"], freqs[keepf], med[keepf, subchan])

    def _on_save_done(self, tab_id: int, err):
        st = self.states.get(tab_id)
        if st is None:
            return
        st.save_btn.setText("Save File(s)…")
        # the save is over when done fires, but the worker thread object
        # may still be momentarily alive — drop it so _save_allowed sees
        # an idle saver. The button stays stop-gated like the reference's
        # (drfview.py:1343), not re-armed mid-run.
        st.save_thread = None
        st.save_btn.setEnabled(self._save_allowed(st))
        if err is not None:
            self._warn(f"Save failed: {err}")

    # ------------------------------------------------------- dialogs
    def _warn(self, text: str):
        QtWidgets.QMessageBox.warning(self, "Warning", text)

    def closeEvent(self, event):
        reply = QtWidgets.QMessageBox.question(
            self, "Exit", "Close all tabs and exit?",
            QtWidgets.QMessageBox.Yes | QtWidgets.QMessageBox.No)
        if reply != QtWidgets.QMessageBox.Yes:
            event.ignore()
            return
        for st in self.states.values():
            if st.processor and st.processor.is_running:
                st.processor.abort()
        # signal-only: an in-flight cycle may hold a long request and the
        # close must not freeze on it (daemon thread)
        self.scheduler.stop(wait=False)
        event.accept()


def main(device="cuda") -> int:  # pragma: no cover
    require_qt()
    app = QtWidgets.QApplication(sys.argv)
    win = MainWindow(device=device)
    win.show()
    return app.exec_()


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
