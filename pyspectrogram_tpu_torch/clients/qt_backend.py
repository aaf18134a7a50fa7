"""Qt binding resolver for the GUI client.

Resolves to real PyQt5 (+ the Qt5Agg matplotlib backend) when installed;
otherwise to the headless widget kit (``_qt_headless``) so the complete
GUI logic still runs — and is testable — without a display server or Qt.
``HEADLESS`` tells callers which world they are in; the interactive entry
point (``gui.main``) requires the real bindings.

Copy of pyspectrogram_tpu/clients/qt_backend.py: the port imports nothing of that
package.
"""

from __future__ import annotations

QT_IMPORT_ERROR = None

try:  # pragma: no cover - exercised only where PyQt5 is installed
    from PyQt5 import QtCore, QtWidgets                       # noqa: F401
    from PyQt5.QtCore import Qt, pyqtSignal                   # noqa: F401
    from matplotlib.backends.backend_qt5agg import (          # noqa: F401
        FigureCanvasQTAgg as FigureCanvas,
        NavigationToolbar2QT,
    )

    HEADLESS = False
except Exception as e:
    QT_IMPORT_ERROR = e
    from pyspectrogram_tpu_torch.clients._qt_headless import (      # noqa: F401
        FigureCanvas,
        NavigationToolbar2QT,
        Qt,
        QtCore,
        QtWidgets,
        pyqtSignal,
    )

    HEADLESS = True
