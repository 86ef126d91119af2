"""Preemption-safe training: SIGTERM -> checkpoint -> clean exit (port of
dldkd_tpu/utils/preemption.py).

A signal flag is polled once per training step; on preemption train.py
saves a FULL resume checkpoint (params + optimizer + epoch + generator
state, the layout `--resume` restores) and exits cleanly. The checkpoint
records the interrupted epoch as not yet done, so `--resume` replays that
epoch from its start with the mid-epoch parameters: bounded duplicate
work (< 1 epoch), never lost work.

In a data-parallel run (`torchrun`, parallel/) `agree_should_stop` makes
every process take the same stop decision at the same step: a process that
left the step loop alone would strand the others in the next collective.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


def agree_should_stop(local_flag: bool, group=None) -> bool:
    """The stop decision every process of `group` shares: an all-reduce
    MAX of the local flags (any process flagged -> every process stops),
    as dldkd_tpu/utils/preemption.py:22-38 agrees over an allgather.
    Without a group, or in a group of one, the local flag."""
    if group is None:
        return bool(local_flag)
    import torch
    import torch.distributed as dist

    if dist.get_world_size(group) == 1:
        return bool(local_flag)
    from dldkd_tpu_torch.parallel.multihost import collective_device

    flag = torch.tensor([int(bool(local_flag))], dtype=torch.int32,
                        device=collective_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


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
