"""Logging with the reference's ``[MDET]`` line prefix.

Lines go through ``logging`` (logger ``mdet_torch``) to whatever
``sys.stdout`` is current when they are emitted, so redirection and capture
keep working after the first log call.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(message)s"
_ROOT = "mdet_torch"
_CONFIGURED = False


class _CurrentStdout:
    """File-like proxy that always writes to the *current* ``sys.stdout``."""

    def write(self, s: str) -> int:
        return sys.stdout.write(s)

    def flush(self) -> None:
        sys.stdout.flush()


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    handler = logging.StreamHandler(_CurrentStdout())
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    level = os.environ.get("MDET_LOG_LEVEL", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    _configure()
    if name == _ROOT or name.startswith(_ROOT + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT}.{name}")


def log(msg: str, *args, tag: str = "MDET") -> None:
    """Print one reference-style tagged line: ``[MDET] msg``."""
    get_logger().info(f"[{tag}] {msg}", *args)
