"""The port's wall clock, behind an injectable stopwatch.

The serving engine reads time only through ``EngineConfig.clock``, whose
default is ``DEFAULT_CLOCK`` from here; launcher timing goes through
``Timer`` and the front end's real-time nap through ``sleep``. So serve/
and launch/ never name a wall-clock function themselves, and tests
inject a fake clock for deterministic runs.
"""
from __future__ import annotations

import time
from typing import Callable

DEFAULT_CLOCK: Callable[[], float] = time.perf_counter


class Timer:
    """A stopwatch over an injectable clock: ``elapsed()`` since
    construction."""

    def __init__(self, clock: Callable[[], float] = DEFAULT_CLOCK):
        self.clock = clock
        self._t0 = clock()

    def elapsed(self) -> float:
        return self.clock() - self._t0


def sleep(seconds: float) -> None:
    """Nap the calling thread: the front end's idle gap before the next
    arrival on a real clock."""
    time.sleep(seconds)
