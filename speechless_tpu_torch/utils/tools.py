"""Small, dependency-free helpers shared by every layer.

The port's own copy of `speechless_tpu/utils/tools.py`. Covers the utility surface of
the original speechless `tools.py`:
assertion helpers, grouping/pagination, run-name timestamps, and the shared "results" logger.
"""
import logging
import sys
from collections import Counter
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, TypeVar

E = TypeVar("E")
K = TypeVar("K")
V = TypeVar("V")


def single(sequence: List[E]) -> E:
    """Return the only element of ``sequence``; fail if it does not have exactly one."""
    if len(sequence) != 1:
        raise AssertionError(f"expected exactly one element, got {len(sequence)}")
    return sequence[0]


def single_or_none(sequence: List[E]) -> Optional[E]:
    """Return the only element of ``sequence``, ``None`` if empty; fail on more than one."""
    if len(sequence) > 1:
        raise AssertionError(f"expected at most one element, got {len(sequence)}")
    return sequence[0] if sequence else None


def read_text(path: Path, encoding: Optional[str] = None) -> str:
    return Path(path).read_text(encoding=encoding)


def write_text(path: Path, text: str, encoding: Optional[str] = None) -> None:
    Path(path).write_text(text, encoding=encoding)


def mkdir(directory: Path) -> None:
    Path(directory).mkdir(parents=True, exist_ok=True)


def home_directory() -> Path:
    return Path.home()


def name_without_extension(file: Path) -> str:
    return Path(file).stem


def extension(file: Path) -> str:
    return Path(file).suffix


def distinct(sequence: Iterable[E]) -> List[E]:
    return list(dict.fromkeys(sequence))  # dicts are insertion-ordered since py3.7


def count_summary(sequence: Iterable[E]) -> str:
    """Histogram of ``sequence`` as a ``"item: count"`` string, most frequent first."""
    return ", ".join(f"{item}: {count}" for item, count in Counter(sequence).most_common())


def group(iterable: Iterable[E], key: Callable[[E], K],
          value: Callable[[E], V] = lambda x: x) -> Dict[K, Tuple[V, ...]]:
    """Bucket ``iterable`` by ``key``; returned dict is ordered by sorted key."""
    buckets: Dict[K, List[V]] = {}
    for element in iterable:
        buckets.setdefault(key(element), []).append(value(element))
    return {k: tuple(buckets[k]) for k in sorted(buckets)}


def timestamp() -> str:
    """Second-resolution local-time run name, e.g. ``20260816-142233``."""
    return datetime.now().strftime("%Y%m%d-%H%M%S")


def duplicates(sequence: Iterable[E]) -> List[E]:
    """Distinct items occurring more than once, in first-occurrence order."""
    seen: Counter = Counter()
    result: List[E] = []
    for item in sequence:
        seen[item] += 1
        if seen[item] == 2:
            result.append(item)
    return result


def average_or_nan(numbers: List[float]) -> float:
    return sum(numbers) / len(numbers) if numbers else float("nan")


def paginate(sequence: List[E], page_size: int) -> Iterator[List[E]]:
    """Split ``sequence`` into consecutive chunks of ``page_size`` (last may be short)."""
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    for start in range(0, len(sequence), page_size):
        yield sequence[start:start + page_size]


def _results_logger() -> logging.Logger:
    lg = logging.getLogger("results")
    lg.setLevel(logging.INFO)
    if not lg.handlers:  # idempotent under re-import
        stdout_handler = logging.StreamHandler(sys.stdout)
        stdout_handler.setLevel(logging.INFO)
        lg.addHandler(stdout_handler)
    return lg


logger = _results_logger()


def log(obj: Any) -> None:
    logger.info(str(obj))
