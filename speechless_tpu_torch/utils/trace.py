"""The program's own spans and counters, kept only while a `torch.profiler` session
records in this process (on any of its threads).

    with trace.span("transcribe.dispatch"):
        ...
    trace.count("transcribe.samples", 16 * 65536)

A span is a `torch.profiler.record_function` range, so it shows in the profiler's trace
beside the device's work, and also a record kept here: its name, its start and end in
`time.time_ns` (the clock kineto stamps its host events with, so the two line up), its
id, and the id of the span that encloses it on the same thread (its parent). A counter
sums host numbers, or 0-d device tensors on the device, read back once in `snapshot`:
recording adds no wait for the card. `snapshot` returns what was kept.

The store holds one profiler session: the first span or count of a session empties
what an earlier one left (a session counts as new once `recording` has read the profiler
off since the store last filled). It keeps at most `SPAN_LIMIT` spans, about ten times
what the benchmark's 20 s serving window records, and counts the ones it drops; `clear`
empties it.

With no profiler recording, `span` returns one shared null context and `count` returns
at once: a guard of about 0.1 µs, where an unguarded `record_function` costs ~11 µs.
The guard reads the flag PyTorch's profilers set for the whole process while they run,
so a thread the session does not trace (by default it traces the thread that started
it) still keeps its spans here; its `record_function` ranges then show in the trace only
with ``experimental_config=_ExperimentalConfig(profile_all_threads=True)``.
"""
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, TypeVar

import torch
from torch.autograd import profiler as _profiler

SPAN_LIMIT = 50_000

_OFF = contextlib.nullcontext()
_END = object()
_ids = itertools.count()
_open = threading.local()  # each thread's stack of open span ids
T = TypeVar("T")


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[dict] = []
        self.dropped = 0
        self.host: Dict[str, float] = {}
        self.device: Dict[str, torch.Tensor] = {}
        self.stale = False  # the profiler was seen off: the next session starts empty

    def reset(self):
        self.spans.clear()
        self.host.clear()
        self.device.clear()
        self.dropped = 0
        self.stale = False


_store = _Store()


class _Span:
    __slots__ = ("name", "annotation", "id", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        kept = {"name": self.name, "start_ns": self.start, "end_ns": end, "id": self.id,
                "parent": self.parent}
        with _store.lock:
            if len(_store.spans) < SPAN_LIMIT:
                _store.spans.append(kept)
            else:
                _store.dropped += 1
        self.annotation.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether a profiler session records in this process now. The first True after a
    False starts a new session's store."""
    if not _profiler._is_profiler_enabled:
        _store.stale = True
        return False
    if _store.stale:
        with _store.lock:
            if _store.stale:
                _store.reset()
    return True


def span(name: str):
    """A context that records ``name`` over its body while a profiler records."""
    if not recording():
        return _OFF
    return _Span(name)


def spans_over(name: str, items: Iterable[T]) -> Iterator[T]:
    """``items`` one by one, each produced inside a span ``name``; so is the last
    ``next``, which finds them spent."""
    items = iter(items)
    while True:
        with span(name):
            item = next(items, _END)
        if item is _END:
            return
        yield item


def count(name: str, value) -> None:
    """Add ``value`` (a host number, or a 0-d tensor summed on its device) to counter
    ``name`` while a profiler records. Building a device ``value`` costs a launch, so a
    caller guards that with `recording`."""
    if not recording():
        return
    with _store.lock:
        if isinstance(value, torch.Tensor):
            total = _store.device.get(name)
            value = value.detach()
            _store.device[name] = value if total is None else total + value
        else:
            _store.host[name] = _store.host.get(name, 0) + value


def snapshot() -> dict:
    """``{"spans": [...], "counters": {name: total}, "dropped_spans": n}``: the kept
    spans in the order they started, and each counter's total (device totals read
    back here)."""
    with _store.lock:
        spans = sorted(_store.spans, key=lambda kept: (kept["start_ns"], kept["id"]))
        counters = dict(_store.host)
        device = dict(_store.device)
        dropped = _store.dropped
    for name, total in device.items():
        counters[name] = counters.get(name, 0) + total.item()
    return {"spans": spans, "counters": counters, "dropped_spans": dropped}


def clear() -> None:
    with _store.lock:
        _store.reset()
