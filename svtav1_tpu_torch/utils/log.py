"""Leveled logging; copy of ``svtav1_tpu/utils/log.py``.

The reference's svt_log (EbLog.c): levels debug..fatal, the threshold
picked at import by the SVT_LOG environment variable (0..4 or a level's
name; default info), each line "Svt[level] <seconds since import>s tag:
message" on stderr.
"""

from __future__ import annotations

import os
import sys
import time

DEBUG = 0
INFO = 1
WARN = 2
ERROR = 3
FATAL = 4

_NAMES = {DEBUG: "debug", INFO: "info", WARN: "warn", ERROR: "error",
          FATAL: "fatal"}
_BY_NAME = {v: k for k, v in _NAMES.items()}


def _threshold() -> int:
    v = os.environ.get("SVT_LOG", "").strip().lower()
    if not v:
        return INFO
    if v in _BY_NAME:
        return _BY_NAME[v]
    try:
        return max(DEBUG, min(FATAL, int(v)))
    except ValueError:
        return INFO


_level = _threshold()
_t0 = time.perf_counter()


def set_level(level: int) -> None:
    global _level
    _level = level


def get_level() -> int:
    return _level


def log(level: int, tag: str, msg: str, *args) -> None:
    if level < _level:
        return
    if args:
        msg = msg % args
    t = time.perf_counter() - _t0
    print(f"Svt[{_NAMES.get(level, '?')}] {t:8.3f}s {tag}: {msg}",
          file=sys.stderr)


def debug(tag: str, msg: str, *args) -> None:
    log(DEBUG, tag, msg, *args)


def info(tag: str, msg: str, *args) -> None:
    log(INFO, tag, msg, *args)


def warn(tag: str, msg: str, *args) -> None:
    log(WARN, tag, msg, *args)


def error(tag: str, msg: str, *args) -> None:
    log(ERROR, tag, msg, *args)
