"""Preemption-safe training: SIGTERM -> checkpoint -> clean exit (port of
dldkd_tpu/utils/preemption.py).

A signal flag is polled once per training step; on preemption train.py
saves a FULL resume checkpoint (params + optimizer + epoch + generator
state, the layout `--resume` restores) and exits cleanly. The checkpoint
records the interrupted epoch as not yet done, so `--resume` replays that
epoch from its start with the mid-epoch parameters: bounded duplicate
work (< 1 epoch), never lost work.

`agree_should_stop` is the single-process case; agreeing across processes
belongs to multi-GPU training (ROADMAP A14).
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


def agree_should_stop(local_flag: bool) -> bool:
    """The stop decision every process shares; with one process, the
    local flag."""
    return bool(local_flag)


class PreemptionGuard:
    """Latches SIGTERM (and optionally other signals) into a poll flag.

    Usage:
        with PreemptionGuard() as guard:
            for batch in loader:
                step(...)
                if guard.should_stop:
                    save_checkpoint(...)
                    break

    Signal handlers only install in the main thread (Python restriction);
    elsewhere the guard is inert and `should_stop` stays False.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._stop = threading.Event()
        self._prev = {}
        self._installed = False

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self) -> None:
        """Manually latch the flag (tests, cooperative shutdown)."""
        self._stop.set()

    def _handler(self, signum, frame):
        self._stop.set()

    def install(self) -> "PreemptionGuard":
        """Install for the remainder of the process (the CLIs); the
        context-manager form restores previous handlers instead."""
        return self.__enter__()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self._installed = False
        return None
