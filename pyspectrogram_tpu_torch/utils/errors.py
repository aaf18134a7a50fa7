"""Typed error/terminate codes for the processing runtime.

The reference communicates worker-loop termination through integer reason
codes emitted on a Qt ``terminated`` signal (reference: drfProc.py:354-361)
and maps them to user-facing text in the GUI (reference: drfview.py:1349-1361).
Codes 2 and 5 in the reference are vestigial audio-era codes with no producer;
they are intentionally not reproduced here.

Copy of pyspectrogram_tpu/utils/errors.py: the port imports nothing of that
package.
"""

from __future__ import annotations

import enum


class TerminateReason(enum.IntEnum):
    """Why a processor loop stopped.

    Values match the reference's integer codes so clients of the original
    tool see identical semantics (reference: drfProc.py:245-246, 260-262,
    323-327, 347-352).
    """

    OK = 0                # user-requested stop (reference: drfProc.py:347-352)
    MISSING_PATH = 1      # dataset dir does not exist (reference: drfProc.py:245-246)
    #: init barrier timed out (reference: drfProc.py:260-262). No
    #: producer here: the processor initializes synchronously (clients
    #: read chan_listing right after construction), so the reference's
    #: worker-side init barrier cannot fire; kept so the code space maps
    #: 1:1 for clients that switch on integer reasons.
    INIT_TIMEOUT = 3
    LOOP_EXCEPTION = 4    # unhandled exception in the loop (reference: drfProc.py:323-327)

    def describe(self) -> str:
        return _DESCRIPTIONS[self]


_DESCRIPTIONS = {
    TerminateReason.OK: "Processing stopped by user.",
    TerminateReason.MISSING_PATH: "The selected Digital RF directory does not exist.",
    TerminateReason.INIT_TIMEOUT: "The processor failed to initialize in time.",
    TerminateReason.LOOP_EXCEPTION: "An unexpected error interrupted processing.",
}


class PySpectrogramTPUError(Exception):
    """Base class for all framework errors."""


class DataGapError(PySpectrogramTPUError):
    """A requested sample range is not fully present in the dataset."""


class ChannelNotFoundError(PySpectrogramTPUError, KeyError):
    """Unknown channel or channel:subchannel entry."""


class FormatError(PySpectrogramTPUError):
    """Malformed Digital RF directory/file."""
