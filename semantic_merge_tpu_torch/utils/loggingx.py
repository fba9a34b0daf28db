"""The port's package logger, as the JAX package's ``utils/loggingx.py``:
one logger, ``semantic_merge_tpu_torch`` (every module's
``logging.getLogger(__name__)`` is its child), with a plain
``LEVEL message`` stream format on stderr whose level comes from
``SEMMERGE_LOG`` (default ``INFO``; names case-insensitively or numbers;
an invalid value falls back to ``INFO`` with a warning).
"""
from __future__ import annotations

import logging
import os

logger = logging.getLogger("semantic_merge_tpu_torch")

if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
    logger.addHandler(_handler)

_raw_level = os.environ.get("SEMMERGE_LOG", "INFO")
try:
    # Accept names case-insensitively and numeric levels ("10").
    logger.setLevel(int(_raw_level) if _raw_level.isdigit()
                    else _raw_level.upper())
except (ValueError, TypeError):
    # An invalid value must degrade, not raise at import time and kill
    # every entry point (SEMMERGE_LOG=verbose used to do exactly that).
    logger.setLevel(logging.INFO)
    logger.warning("invalid SEMMERGE_LOG=%r; falling back to INFO",
                   _raw_level)
