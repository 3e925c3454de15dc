"""Stall watchdog: bound the cost of a hung device call (port of
sage2_tpu/utils/watchdog.py).

A device call that never returns (a hung kernel, a lost device) would
otherwise hold a long streamed run forever. A Python-level timeout
cannot interrupt a blocked C++ call (signal handlers only run between
bytecodes), so the watchdog is a daemon thread that hard-exits the PROCESS (os._exit) when no heartbeat
arrived for ``timeout_s`` — converting an unbounded hang into a
bounded, clearly-diagnosed failure the caller can retry.

Heartbeats (``touch``) are placed at every streamed-chunk boundary and
every metrics event, so any forward progress keeps the process alive;
only a genuinely stuck call (or a single kernel build longer than the
timeout: set it above the longest build) trips it. Off unless ``start()`` is called (or SAGE2_WATCHDOG_SECS is
set and ``start_from_env`` runs).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

_EXIT_CODE = 42

_last: float = time.monotonic()
_note: str = "startup"
_thread: Optional[threading.Thread] = None
_timeout: Optional[float] = None


def touch(note: str = "") -> None:
    """Record forward progress (cheap; safe without start())."""
    global _last, _note
    _last = time.monotonic()
    if note:
        _note = note


def start(timeout_s: float) -> None:
    """Arm the watchdog: if no touch() for ``timeout_s``, print a
    diagnosis and os._exit(42). Idempotent (re-arming updates the
    timeout)."""
    global _thread, _timeout
    _timeout = float(timeout_s)
    touch("armed")
    if _thread is not None and _thread.is_alive():
        return

    def _watch():
        while True:
            t = _timeout
            if t is None:
                return
            idle = time.monotonic() - _last
            if idle > t:
                print(
                    f"[sage2 watchdog] NO PROGRESS for {idle:.0f}s "
                    f"(> {t:.0f}s timeout); last heartbeat: {_note!r}. "
                    f"A device call is likely stalled. Exiting "
                    f"{_EXIT_CODE} so the caller can retry on a fresh "
                    f"process.",
                    file=sys.stderr, flush=True,
                )
                os._exit(_EXIT_CODE)
            time.sleep(min(10.0, t / 4))

    _thread = threading.Thread(target=_watch, daemon=True,
                               name="sage2-watchdog")
    _thread.start()


def stop() -> None:
    global _timeout
    _timeout = None


def start_from_env() -> None:
    """Arm from SAGE2_WATCHDOG_SECS if set (used by long-running
    scripts; tests and library use stay un-watched by default)."""
    v = os.environ.get("SAGE2_WATCHDOG_SECS")
    if v:
        start(float(v))
