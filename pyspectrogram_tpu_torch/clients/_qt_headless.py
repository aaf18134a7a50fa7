"""Headless Qt-compatible widget kit.

The reference viewer is a PyQt5 desktop app that was only ever verified by
eye (SURVEY.md section 4: the reference has no tests at all). This module
provides a pure-Python implementation of the exact Qt API subset
``clients.gui`` uses — signals, widgets with real value/range/enabled
state, layouts, dialogs as monkeypatchable statics — so the FULL GUI logic
(settings round-trip, Nyquist clamping, slider->bounds mapping, redraw,
save pipeline, close confirmation) executes and is tested headlessly, with
matplotlib rendering through the real Agg canvas. With PyQt5 installed,
``clients.qt_backend`` resolves to the real bindings instead and none of
this is used.

Semantics follow Qt where the GUI depends on them:
* ``QSpinBox.setRange``/``QSlider.setRange`` clamp the current value;
* ``QComboBox.addItems`` emits ``currentIndexChanged``/``currentTextChanged``
  when it establishes a current item; ``clear`` emits index -1 if items
  existed; ``blockSignals`` suppresses emission;
* ``QMainWindow.close`` runs ``closeEvent`` with an accept/ignore event;
* signal emission is synchronous (no event loop) — worker-thread callbacks
  run inline, which is what the headless tests want — but slot execution
  is SERIALIZED under one re-entrant lock: on real Qt every slot runs on
  the single GUI thread, so two slots never mutate widget/canvas state
  concurrently, and a worker's inline delivery here must not either
  (observed otherwise: a scheduler-tick redraw interleaving with a
  main-thread redraw left doubled matplotlib artists).

Copy of pyspectrogram_tpu/clients/_qt_headless.py: the port imports nothing of that
package.
"""

from __future__ import annotations

import threading
from typing import Callable, List

# Models the single GUI thread: all slot invocations (whatever thread
# emits) run mutually exclusive. Re-entrant because slots emit further
# signals synchronously (e.g. a clicked handler that calls setValue).
SLOT_LOCK = threading.RLock()


# --------------------------------------------------------------- signals
class _BoundSignal:
    def __init__(self):
        self._handlers: List[tuple] = []  # (fn, max positional args)

    def connect(self, fn: Callable) -> None:
        # PyQt trims emitted arguments to the slot's arity (a zero-arg
        # lambda may connect to clicked(bool)); mirror that.
        import inspect

        maxargs = None
        try:
            params = inspect.signature(fn).parameters.values()
            if not any(p.kind == p.VAR_POSITIONAL for p in params):
                maxargs = sum(
                    1 for p in params
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                )
        except (ValueError, TypeError):
            pass
        self._handlers.append((fn, maxargs))

    def disconnect(self, fn: Callable = None) -> None:
        if fn is None:
            self._handlers.clear()
        else:
            self._handlers = [h for h in self._handlers if h[0] is not fn]

    def emit(self, *args) -> None:
        with SLOT_LOCK:
            for fn, maxargs in list(self._handlers):
                fn(*(args if maxargs is None else args[:maxargs]))


class pyqtSignal:
    """Class-attribute descriptor yielding one bound signal per instance,
    like PyQt5's pyqtSignal."""

    def __init__(self, *types):
        self._name = None

    def __set_name__(self, owner, name):
        self._name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        key = "__sig_" + (self._name or str(id(self)))
        sig = obj.__dict__.get(key)
        if sig is None:
            sig = _BoundSignal()
            obj.__dict__[key] = sig
        return sig


class QObject:
    def __init__(self, parent=None):
        self._parent = parent


# ------------------------------------------------------------- constants
class Qt:
    Horizontal = 1
    Vertical = 2
    WaitCursor = 3


# --------------------------------------------------------------- widgets
class QWidget(QObject):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._props = {}
        self._layout = None
        self._enabled = True
        self._visible = False
        self._block_signals = False

    # properties / layout
    def setProperty(self, name, value):
        self._props[name] = value

    def property(self, name):
        return self._props.get(name)

    def setLayout(self, layout):
        self._layout = layout

    def layout(self):
        return self._layout

    # state
    def setEnabled(self, on: bool):
        self._enabled = bool(on)

    def isEnabled(self) -> bool:
        return self._enabled

    def blockSignals(self, block: bool) -> bool:
        old = self._block_signals
        self._block_signals = bool(block)
        return old

    def signalsBlocked(self) -> bool:
        return self._block_signals

    # visibility (no real windowing)
    def show(self):
        self._visible = True

    def showMaximized(self):
        self._visible = True

    def hide(self):
        self._visible = False

    def isVisible(self) -> bool:
        return self._visible

    def setWindowTitle(self, title: str):
        self._props["windowTitle"] = title

    def windowTitle(self) -> str:
        return self._props.get("windowTitle", "")


class QLabel(QWidget):
    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text

    def setText(self, text: str):
        self._text = text

    def text(self) -> str:
        return self._text


class QPushButton(QWidget):
    clicked = pyqtSignal(bool)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text

    def text(self) -> str:
        return self._text

    def setText(self, text: str) -> None:
        self._text = str(text)

    def click(self):
        if self._enabled and not self._block_signals:
            self.clicked.emit(False)


class _RangedValueWidget(QWidget):
    """Shared value/range behavior of QSpinBox/QSlider/QDoubleSpinBox:
    setRange clamps the current value (Qt semantics the Nyquist-clamp and
    save-subset logic rely on). ``_cast`` picks the value type."""

    valueChanged = pyqtSignal(int)
    _cast = int

    def __init__(self, parent=None):
        super().__init__(parent)
        self._min, self._max = self._cast(0), self._cast(99)
        self._value = self._cast(0)

    def setRange(self, lo, hi):
        self._min, self._max = self._cast(lo), self._cast(hi)
        self.setValue(self._value)

    def minimum(self):
        return self._min

    def maximum(self):
        return self._max

    def setSingleStep(self, step):
        self._step = self._cast(step)

    def setValue(self, v):
        v = min(max(self._cast(v), self._min), self._max)
        changed = v != self._value
        self._value = v
        if changed and not self._block_signals:
            self.valueChanged.emit(v)

    def value(self):
        return self._value


class QSpinBox(_RangedValueWidget):
    pass


class QDoubleSpinBox(_RangedValueWidget):
    """Float-valued spinbox with Qt's clamp-on-setRange semantics (the
    save sub-tab's time-subset fields rely on ranges that track the
    latest result)."""

    valueChanged = pyqtSignal(float)
    _cast = float

    def setDecimals(self, d):
        self._decimals = int(d)


class QCheckBox(QWidget):
    clicked = pyqtSignal(bool)
    toggled = pyqtSignal(bool)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._checked = False

    def text(self) -> str:
        return self._text

    def setChecked(self, on: bool):
        on = bool(on)
        changed = on != self._checked
        self._checked = on
        if changed and not self._block_signals:
            self.toggled.emit(on)

    def isChecked(self) -> bool:
        return self._checked

    def click(self):
        """User click: flips the state, emits toggled then clicked
        (Qt ordering)."""
        if not self._enabled or self._block_signals:
            return
        self._checked = not self._checked
        self.toggled.emit(self._checked)
        self.clicked.emit(self._checked)


class QGroupBox(QWidget):
    def __init__(self, title: str = "", parent=None):
        super().__init__(parent)
        self._title = title

    def title(self) -> str:
        return self._title


class QSlider(_RangedValueWidget):
    def __init__(self, orientation=Qt.Horizontal, parent=None):
        super().__init__(parent)
        self._orientation = orientation


class QComboBox(QWidget):
    currentIndexChanged = pyqtSignal(int)
    currentTextChanged = pyqtSignal(str)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._items: List[str] = []
        self._index = -1

    def clear(self):
        had = bool(self._items)
        self._items = []
        self._index = -1
        if had and not self._block_signals:
            self.currentIndexChanged.emit(-1)
            self.currentTextChanged.emit("")

    def addItems(self, items):
        self._items.extend(str(i) for i in items)
        if self._index == -1 and self._items:
            self._index = 0
            if not self._block_signals:
                self.currentIndexChanged.emit(0)
                self.currentTextChanged.emit(self._items[0])

    def addItem(self, item):
        self.addItems([item])

    def count(self) -> int:
        return len(self._items)

    def itemText(self, i: int) -> str:
        return self._items[i]

    def currentIndex(self) -> int:
        return self._index

    def currentText(self) -> str:
        return self._items[self._index] if 0 <= self._index < len(self._items) else ""

    def setCurrentIndex(self, i: int):
        if not 0 <= i < len(self._items) or i == self._index:
            return
        self._index = i
        if not self._block_signals:
            self.currentIndexChanged.emit(i)
            self.currentTextChanged.emit(self._items[i])


# --------------------------------------------------------------- layouts
class _Layout:
    def __init__(self, parent: QWidget = None):
        self.items = []
        if parent is not None:
            parent.setLayout(self)

    def addWidget(self, w, stretch: int = 0, **kw):
        self.items.append(w)

    def addLayout(self, l, stretch: int = 0):
        self.items.append(l)

    def widgets(self):
        """All widgets in this layout subtree (test convenience)."""
        out = []
        for it in self.items:
            if isinstance(it, _Layout):
                out.extend(it.widgets())
            else:
                out.append(it)
        return out


class QHBoxLayout(_Layout):
    pass


class QVBoxLayout(_Layout):
    pass


class QFormLayout(_Layout):
    def addRow(self, label_or_widget, widget=None):
        if widget is None:
            self.items.append(label_or_widget)
        else:
            self.items.append((label_or_widget, widget))

    def widgets(self):
        out = []
        for it in self.items:
            it = it[1] if isinstance(it, tuple) else it
            if isinstance(it, _Layout):
                out.extend(it.widgets())
            else:
                out.append(it)
        return out


# ----------------------------------------------------- menus and actions
class QAction(QObject):
    triggered = pyqtSignal(bool)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._shortcut = None

    def setShortcut(self, keys: str):
        self._shortcut = keys

    def shortcut(self):
        return self._shortcut

    def text(self):
        return self._text

    def trigger(self):
        self.triggered.emit(False)


class _Menu:
    def __init__(self, title: str):
        self.title = title
        self.actions = []

    def addAction(self, action: QAction):
        self.actions.append(action)


class _MenuBar:
    def __init__(self):
        self.menus = []

    def addMenu(self, title: str) -> _Menu:
        m = _Menu(title)
        self.menus.append(m)
        return m


# ----------------------------------------------------------- tab widget
class QTabWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._tabs: List[QWidget] = []
        self._titles: List[str] = []
        self._current = -1

    def addTab(self, w: QWidget, title: str) -> int:
        self._tabs.append(w)
        self._titles.append(title)
        if self._current == -1:
            self._current = 0
        return len(self._tabs) - 1

    def removeTab(self, i: int):
        del self._tabs[i]
        del self._titles[i]
        self._current = min(self._current, len(self._tabs) - 1)

    def count(self) -> int:
        return len(self._tabs)

    def widget(self, i: int) -> QWidget:
        return self._tabs[i]

    def currentIndex(self) -> int:
        return self._current

    def setCurrentWidget(self, w: QWidget):
        self._current = self._tabs.index(w)

    def setCurrentIndex(self, i: int):
        self._current = i

    def setTabText(self, i: int, text: str):
        self._titles[i] = text

    def tabText(self, i: int) -> str:
        return self._titles[i]


# ------------------------------------------------------------ main window
class _CloseEvent:
    def __init__(self):
        self.accepted = True

    def accept(self):
        self.accepted = True

    def ignore(self):
        self.accepted = False


class QMainWindow(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._menubar = _MenuBar()
        self._central = None

    def menuBar(self) -> _MenuBar:
        return self._menubar

    def setCentralWidget(self, w: QWidget):
        self._central = w

    def centralWidget(self) -> QWidget:
        return self._central

    def close(self) -> bool:
        ev = _CloseEvent()
        self.closeEvent(ev)
        if ev.accepted:
            self.hide()
        return ev.accepted

    def closeEvent(self, event):  # default: accept
        event.accept()


# ---------------------------------------------------------------- dialogs
class QMessageBox:
    Yes = 0x4000
    No = 0x10000
    Ok = 0x400

    #: test hook — records (kind, title, text) of every dialog shown
    journal: List[tuple] = []
    #: test hook — canned answer for question()
    answer = Yes

    @classmethod
    def warning(cls, parent, title, text, *a, **k):
        cls.journal.append(("warning", title, text))
        return cls.Ok

    @classmethod
    def question(cls, parent, title, text, buttons=None, *a, **k):
        cls.journal.append(("question", title, text))
        return cls.answer


class QInputDialog:
    #: test hooks — canned (value, ok) responses
    double_answer = (0.0, False)
    text_answer = ("", False)

    @classmethod
    def getDouble(cls, parent, title, label, value=0.0, mn=0.0, mx=1.0,
                  decimals=1, **k):
        v, ok = cls.double_answer
        return (min(max(v, mn), mx), ok)

    @classmethod
    def getText(cls, parent, title, label, **k):
        return cls.text_answer


class QFileDialog:
    #: test hooks — canned responses
    existing_directory = ""
    save_file_name = ("", "")
    #: test hook — FIFO of answers for flows that open several save
    #: dialogs in one action (the save sub-tab's Save File(s));
    #: drained before falling back to save_file_name
    save_file_queue: List[tuple] = []
    open_file_name = ("", "")

    @classmethod
    def getExistingDirectory(cls, parent=None, caption="", directory="", **k):
        return cls.existing_directory

    @classmethod
    def getOpenFileName(cls, parent=None, caption="", directory="",
                        filter="", **k):
        return cls.open_file_name

    @classmethod
    def getSaveFileName(cls, parent=None, caption="", directory="",
                        filter="", **k):
        if cls.save_file_queue:
            return cls.save_file_queue.pop(0)
        return cls.save_file_name


class QApplication(QObject):
    _instance = None
    override_cursors: List = []

    def __init__(self, argv=None):
        super().__init__()
        QApplication._instance = self

    @classmethod
    def instance(cls):
        return cls._instance

    @classmethod
    def setOverrideCursor(cls, cursor):
        cls.override_cursors.append(cursor)

    @classmethod
    def restoreOverrideCursor(cls):
        if cls.override_cursors:
            cls.override_cursors.pop()

    def exec_(self) -> int:
        raise RuntimeError(
            "the headless Qt kit has no event loop; install PyQt5 to run "
            "the interactive viewer"
        )


# ------------------------------------------------- module-shaped exports
class _Namespace:
    def __init__(self, **kw):
        self.__dict__.update(kw)


QtCore = _Namespace(QObject=QObject, Qt=Qt, pyqtSignal=pyqtSignal)
QtWidgets = _Namespace(
    QApplication=QApplication,
    QMainWindow=QMainWindow,
    QTabWidget=QTabWidget,
    QWidget=QWidget,
    QHBoxLayout=QHBoxLayout,
    QVBoxLayout=QVBoxLayout,
    QFormLayout=QFormLayout,
    QPushButton=QPushButton,
    QComboBox=QComboBox,
    QSlider=QSlider,
    QSpinBox=QSpinBox,
    QDoubleSpinBox=QDoubleSpinBox,
    QCheckBox=QCheckBox,
    QGroupBox=QGroupBox,
    QLabel=QLabel,
    QAction=QAction,
    QInputDialog=QInputDialog,
    QFileDialog=QFileDialog,
    QMessageBox=QMessageBox,
)


# --------------------------------------------- matplotlib canvas/toolbar
def _agg_canvas():
    from matplotlib.backends.backend_agg import FigureCanvasAgg

    class HeadlessCanvas(FigureCanvasAgg, QWidget):
        """Real Agg rendering, widget-shaped for layouts."""

        def __init__(self, figure=None):
            FigureCanvasAgg.__init__(self, figure)
            QWidget.__init__(self)

    return HeadlessCanvas


try:
    FigureCanvas = _agg_canvas()
except Exception:  # matplotlib absent: give layouts a plain widget
    FigureCanvas = QWidget


class NavigationToolbar2QT(QWidget):
    """Toolbar stand-in carrying the canonical matplotlib tool list, so
    CustomToolbar's subset filter (reference: drfview.py:1744-1754) is
    exercised for real."""

    try:
        from matplotlib.backend_bases import NavigationToolbar2 as _NT2

        toolitems = list(_NT2.toolitems)
    except Exception:
        toolitems = [
            ("Home", "", "", "home"), ("Back", "", "", "back"),
            ("Forward", "", "", "forward"), (None, None, None, None),
            ("Pan", "", "", "pan"), ("Zoom", "", "", "zoom"),
            (None, None, None, None), ("Subplots", "", "", "subplots"),
            ("Save", "", "", "save_figure"),
        ]

    def __init__(self, canvas, parent=None):
        super().__init__(parent)
        self.canvas = canvas
