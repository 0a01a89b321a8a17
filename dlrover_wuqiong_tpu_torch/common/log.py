"""Single logging module.

Parity: a copy of dlrover_wuqiong_tpu/common/log.py (stdlib only): one
``dwt`` logger on stderr, level from ``DWT_LOG_LEVEL``.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


def _build_logger(name: str = "dwt") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    level = os.getenv("DWT_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


default_logger = _build_logger()


def get_logger(name: str) -> logging.Logger:
    logger = default_logger.getChild(name)
    return logger
