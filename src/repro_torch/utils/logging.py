"""Minimal structured logger (stdout, no deps); the port's copy of
``repro/utils/logging.py``.

* ``REPRO_LOG_LEVEL`` selects the level (``DEBUG``/``INFO``/``WARNING``/... or
  a numeric level) at handler-install time.
* Handler install is idempotent and lock-guarded: concurrent ``get_logger``
  calls for the same name configure exactly one handler.
* ``log_kv`` emits the structured ``event key=value ...`` lines that mirror
  the span tags in the obs JSONL, so grep joins console logs with traces;
  ``format_kv`` gives the JAX package's strings for the same keys.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading

_FMT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_LOCK = threading.Lock()
_SENTINEL = "_repro_configured"


def _env_level() -> int:
    name = os.environ.get("REPRO_LOG_LEVEL", "INFO").strip().upper()
    if name.isdigit():
        return int(name)
    return getattr(logging, name, logging.INFO)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, _SENTINEL, False):  # fast path, no lock
        return logger
    with _LOCK:
        if not getattr(logger, _SENTINEL, False):
            if not logger.handlers:
                handler = logging.StreamHandler(sys.stdout)
                handler.setFormatter(logging.Formatter(_FMT,
                                                       datefmt="%H:%M:%S"))
                logger.addHandler(handler)
            logger.setLevel(_env_level())
            logger.propagate = False
            setattr(logger, _SENTINEL, True)
    return logger


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, str) and (" " in v or "=" in v or not v):
        return json.dumps(v)
    return str(v)


def format_kv(event: str, **kv) -> str:
    """``event key=value ...``: one flat greppable line per record."""
    return " ".join([event] + [f"{k}={_fmt_val(v)}" for k, v in kv.items()])


def log_kv(logger: logging.Logger, event: str, level: int = logging.INFO,
           **kv) -> None:
    """Structured line with the same keys a span/metric would carry."""
    if logger.isEnabledFor(level):
        logger.log(level, "%s", format_kv(event, **kv))
