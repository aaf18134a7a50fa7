"""Structured logging.

The reference has no logging at all — bare prints and traceback dumps
(reference: drfview.py:1135, drfProc.py:327; SURVEY.md section 5). This
module provides one stdlib-logging-based structured logger used across the
runtime: human-readable lines by default, single-line JSON with
``PSTPU_LOG_JSON=1`` (for log aggregation in production).

Copy of pyspectrogram_tpu/utils/log.py: the port imports nothing of that
package.
"""

from __future__ import annotations

import json
import logging
import os
import time


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


class _HumanFormatter(logging.Formatter):
    """Appends the structured fields to the human line; JSON mode keeps
    the msg key clean (fields as top-level keys only) so aggregation can
    group on it."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        extra = getattr(record, "fields", None)
        return f"{base} {extra}" if extra else base


def get_logger(name: str = "pstpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        if os.environ.get("PSTPU_LOG_JSON") == "1":
            h.setFormatter(_JsonFormatter())
        else:
            h.setFormatter(_HumanFormatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("PSTPU_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger


def log_event(logger: logging.Logger, msg: str,
              level: int = logging.INFO, **fields) -> None:
    """Log with structured fields: appended to the human line, emitted
    as top-level JSON keys (never inside msg) in JSON mode."""
    logger.log(level, msg, extra={"fields": fields})
