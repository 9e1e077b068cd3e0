"""Thin logging shim so modules share a consistent format (port of
``src/repro/utils/log.py``; the root logger is ``repro_torch``)."""
from __future__ import annotations

import logging
import sys

_CONFIGURED = False


def get_logger(name: str = "repro_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s",
                              datefmt="%H:%M:%S"))
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(name)
