"""Leveled stderr logger (ref: src/utils/logger.h:8-41).

Unlike the reference — whose leveled logger exists but is bypassed by ~150
bare fprintf sites (SURVEY §2.7) — this one is the single logging path for
the framework. Level from NT_LOG (error|warn|info|debug), default info.
"""
from __future__ import annotations

import os
import sys
import time

LEVELS = {"error": 0, "warn": 1, "info": 2, "debug": 3}
_level = LEVELS.get(os.environ.get("NT_LOG", "info").lower(), 2)


def set_level(name: str):
    global _level
    _level = LEVELS.get(name.lower(), _level)


def _log(lvl: str, msg: str):
    if LEVELS[lvl] <= _level:
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}] {lvl.upper():<5} {msg}", file=sys.stderr, flush=True)


def error(msg: str):
    _log("error", msg)


def warn(msg: str):
    _log("warn", msg)


def info(msg: str):
    _log("info", msg)


def debug(msg: str):
    _log("debug", msg)
