"""What the program itself recorded in a traced window: the spans and counters of
`speechless_tpu_torch/utils/trace.py`, which the port keeps only while a profiler records,
one session at a time, so in a benchmark run they cover the traced window alone.

A port without that module records nothing: every reader here then returns None, and
the metric is left out of the line.
"""
from collections import defaultdict
from typing import Dict, List, Optional


def snapshot() -> Optional[dict]:
    try:
        from speechless_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def children(spans: list) -> dict:
    """Each span id's child spans, in the order they started."""
    by_parent = defaultdict(list)
    for kept in spans:
        by_parent[kept["parent"]].append(kept)
    return by_parent


def length_ns(kept: dict) -> int:
    return kept["end_ns"] - kept["start_ns"]


def window_share(record, seconds: float) -> float:
    """``seconds`` as a share (%) of the window's length on the trace's clock."""
    return 100.0 * seconds / record.trace["window_s"]


def pad_share(total: str, own: str) -> Optional[float]:
    """The padded share (%) of counter ``total``: one less ``own`` over it."""
    recorded = snapshot()
    if recorded is None or not recorded["counters"].get(total):
        return None
    counters = recorded["counters"]
    return 100.0 * (1.0 - counters[own] / counters[total])


def stage_seconds(spans: List[dict]) -> Dict[str, dict]:
    """Per span name: ``count``, ``total_s`` and ``self_s`` (each span's length less the
    part of it its child spans cover)."""
    below = children(spans)
    stages: Dict[str, dict] = {}
    for kept in spans:
        covered, cursor = 0, kept["start_ns"]
        for child in sorted(below[kept["id"]], key=lambda c: (c["start_ns"], c["end_ns"])):
            start = max(child["start_ns"], cursor)
            if child["end_ns"] > start:
                covered += child["end_ns"] - start
                cursor = child["end_ns"]
        stage = stages.setdefault(kept["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0})
        stage["count"] += 1
        stage["total_s"] += length_ns(kept) / 1e9
        stage["self_s"] += (length_ns(kept) - covered) / 1e9
    return stages
