"""Preemption-safe training: turn SIGTERM/SIGINT into a clean checkpoint + exit.

The port's own copy of `speechless_tpu/train/preemption.py`. Accelerator capacity is
routinely preempted (spot/defragmentation), and the scheduler's notice is a SIGTERM. The reference dies mid-epoch and loses everything since the last save
(its resume also silently reset Adam moments, `net.py:541-576`); here the signal sets a
flag that the epoch loop checks at the next epoch boundary, writes a full checkpoint
(weights + optimizer state + step), and returns — so `train_or_resume` continues from
the preempted epoch with bit-identical optimizer state.

A second signal falls through to the previous handler (normally: kill), so an operator
can still force-quit a hung run.
"""
import signal
import threading
from typing import Optional

from ..utils.tools import log

_HANDLED = (signal.SIGTERM, signal.SIGINT)


class GracefulShutdown:
    """Context manager that converts termination signals into a polled flag.

    Signal handlers can only be installed from the main thread; elsewhere (e.g. a test
    harness thread) this degrades to an inert flag, never raising.
    """

    def __init__(self):
        self.requested = False
        self.signal_name: Optional[str] = None
        self._previous = {}

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for signum in _HANDLED:
                self._previous[signum] = signal.signal(signum, self._handle)
        return self

    def __exit__(self, *exc_info) -> None:
        for signum, previous in self._previous.items():
            signal.signal(signum, previous)
        self._previous.clear()

    def _handle(self, signum, frame) -> None:
        if self.requested:
            # Second signal: defer to the original disposition (force-quit path).
            previous = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, previous)
            if callable(previous):
                previous(signum, frame)
            else:
                signal.raise_signal(signum)
            return
        self.requested = True
        self.signal_name = signal.Signals(signum).name
        log("{} received — will checkpoint at the next epoch boundary and exit "
            "(send again to force-quit).".format(self.signal_name))
