"""Reduce a `torch.profiler` trace of the window to what the per-layer metrics read.

The events are read once from the profiler's raw results, in memory; no trace file is
written. Device time is the union of the device events' intervals (kernels, copies,
sets) inside the window, the ``bench/window`` span on the trace's own clock. An idle
gap is named by the innermost benchmark span (``bench/<name>``) open on the host at its
middle.
"""
import re
from typing import Dict, List, Tuple

TOP = 10  # entries of each breakdown list


def _times(event) -> Tuple[int, int]:
    if hasattr(event, "start_ns"):
        return event.start_ns(), event.start_ns() + event.duration_ns()
    start = int(event.start_us() * 1000)
    return start, start + int(event.duration_us() * 1000)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(start, end) for start, end in merged]


def summarize(profiler, record) -> dict:
    spans, device = [], []
    for event in profiler.profiler.kineto_results.events():
        name = event.name()
        start, end = _times(event)
        if name.startswith("bench/"):
            if event.device_type().name == "CPU":
                spans.append((name[len("bench/"):], start, end))
            continue
        if event.device_type().name == "CUDA" and not (
                hasattr(event, "is_user_annotation") and event.is_user_annotation()):
            device.append((name, start, end))
    windows = [(start, end) for name, start, end in spans if name == "window"]
    if not windows:
        raise RuntimeError("the trace holds no bench/window span")
    w_start, w_end = windows[0]
    kernels: Dict[str, List[float]] = {}
    intervals = []
    for name, start, end in device:
        start, end = max(start, w_start), min(end, w_end)
        if end <= start:
            continue
        intervals.append((start, end))
        entry = kernels.setdefault(name, [0.0, 0])
        entry[0] += (end - start) / 1e9
        entry[1] += 1
    busy = _union(intervals)
    gaps, cursor = [], w_start
    for start, end in busy + [(w_end, w_end)]:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    inner = sorted(((name, start, end) for name, start, end in spans if name != "window"),
                   key=lambda span: span[2] - span[1])

    def host_at(moment: int) -> str:
        for name, start, end in inner:  # shortest first: the innermost open span
            if start <= moment < end:
                return name
        return "between calls"

    named_gaps = sorted(((host_at((start + end) // 2), (end - start) / 1e9)
                         for start, end in gaps), key=lambda gap: -gap[1])
    top_ops = sorted(kernels.items(), key=lambda item: -item[1][0])[:TOP]
    return {"window_s": (w_end - w_start) / 1e9,
            "busy_s": sum(end - start for start, end in busy) / 1e9,
            "kernels": kernels,
            "gap_count": len(gaps),
            "breakdown": {"device_ops": [[_short(name), seconds]
                                         for name, (seconds, _) in top_ops],
                          "idle_gaps": [[name, seconds]
                                        for name, seconds in named_gaps[:TOP]]}}


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."


def layer_seconds(record, layer: dict) -> Tuple[float, int]:
    """Summed device seconds and launches of the kernels whose names match one of
    ``layer["kernels"]`` (regular expressions, searched)."""
    patterns = [re.compile(pattern) for pattern in layer["kernels"]]
    seconds, launches = 0.0, 0
    for name, (time_s, count) in record.trace["kernels"].items():
        if any(pattern.search(name) for pattern in patterns):
            seconds += time_s
            launches += count
    return seconds, launches
