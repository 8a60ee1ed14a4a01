"""Colored, rank-aware console logging (reference utils/print_fn.py)."""
from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",    # cyan
    logging.INFO: "\033[32m",     # green
    logging.WARNING: "\033[33m",  # yellow
    logging.ERROR: "\033[31m",    # red
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        rank = int(os.environ.get("NEURECON_RANK", "0"))
        color = _COLORS.get(record.levelno, "")
        prefix = f"{color}[rank{rank}][{record.filename}:{record.lineno}]{_RESET}"
        return f"{prefix} {record.getMessage()}"


class _MasterOnlyFilter(logging.Filter):
    """Only the master process prints at < WARNING level."""

    def filter(self, record):
        if int(os.environ.get("NEURECON_RANK", "0")) == 0:
            return True
        return record.levelno >= logging.WARNING


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("neurecon_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_ColorFormatter())
        handler.addFilter(_MasterOnlyFilter())
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("NEURECON_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger


log = _build_logger()
