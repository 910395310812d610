"""The run of one cell: find its files by name, set up, time the window, read the
metrics, check the outputs, print the result line.

Everything that belongs to one configuration, traffic mix, metric or layer lives in a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's widths, the precision it states, its source;
* ``traffic/<traffic>.json``: the mix's parameters and its ``driver``;
* ``drivers/<driver>.py``: ``setup(context) -> cell``, where ``cell`` has ``window(record,
  seconds)``, ``finish(record)``, ``release()`` and ``check(record) -> [(name, value)]``;
* ``limits/<workload>.json``: the limit of each number the check compares;
* ``metrics/<metric>.py``: ``read(record) -> float or None`` (None: nothing to read,
  the metric is left out of the line);
* ``layers/<layer>.json``: the device kernels of a layer, by name pattern.
"""
import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "speechless_tpu")


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / (name + ".json")).read_text())


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (metric names hold dots)."""
    path = BENCH / kind / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_{}_{}".format(kind, name.replace(".", "_").replace("-", "_")), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones untraced, its
    per-layer ones traced. A metric without ``workloads`` belongs to every cell (a
    per-layer one: every cell that reports the end-to-end metric it moves)."""
    end_to_end = [m for m in manifest["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    if not trace:
        return end_to_end
    reported = {m["name"] for m in end_to_end}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of `FORBIDDEN_MODULES`, compared
    whole (``speechless_tpu_torch`` is not ``speechless_tpu``)."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN_MODULES)


class Record:
    """What a run leaves for the metric readers: set-up stages, host spans, the
    window, the driver's counts, and the trace summary."""

    def __init__(self, workload: str, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, started: float):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.seconds, self.traced = seed, seconds, trace
        self.started = started
        self.stages: Dict[str, float] = {}
        self._stage_end = started
        self.spans: List[Tuple[str, float, float]] = []
        self.window: Optional[Tuple[float, float]] = None
        self.setup_s: Optional[float] = None
        self.work: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.trace: Optional[dict] = None

    def stage(self, name: str) -> None:
        """Close the set-up stage ``name`` (it ran since the previous stage ended)."""
        now = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + now - self._stage_end
        self._stage_end = now

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around a call into the program; in a traced run it is also a
        `torch.profiler.record_function` (``bench/<name>``), on the trace's clock."""
        annotation = contextlib.nullcontext()
        if self.traced:
            import torch

            annotation = torch.profiler.record_function("bench/" + name)
        start = time.perf_counter()
        with annotation:
            try:
                yield
            finally:
                self.spans.append((name, start, time.perf_counter()))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             started: float, overrides: Optional[dict] = None,
             fault: Optional[str] = None) -> Tuple[dict, list, object]:
    """One run of ``workload`` on ``device``: the result object (without its checks),
    the checks as ``(name, value, limit)`` and the driver's cell (released).
    ``overrides`` replace traffic parameters and ``fault`` plants a fault in the timed
    path: both only for the CPU tests and `calibrate.py`."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit("unknown workload {!r}; BENCHMARK.json has {}".format(
            workload, sorted(cells)))
    cell_spec = cells[workload]
    config = load_json("configs", cell_spec["config"])
    traffic = dict(load_json("traffic", cell_spec["traffic"]), **(overrides or {}))
    limits = load_json("limits", workload)
    record = Record(workload, config, traffic, seed, seconds, trace, started)
    driver = load_module("drivers", traffic["driver"])

    import torch

    import speechless_tpu_torch  # noqa: F401
    record.stage("import")
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    record.stage("cuda_start")
    cell = driver.setup(dict(record=record, device=torch.device(device), seed=seed,
                             fault=fault))
    record.setup_s = time.perf_counter() - started
    log("setup_s {:.3f} split: {}".format(record.setup_s, ", ".join(
        "{} {:.3f}".format(name, value) for name, value in record.stages.items())))

    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if on_card else []))
        profiler.start()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    with record.span("window"):
        cell.window(record, seconds)
        if on_card:
            torch.cuda.synchronize()
    record.window = (start, time.perf_counter())
    if profiler is not None:
        profiler.stop()
        from . import trace as trace_summary

        record.trace = trace_summary.summarize(profiler, record)
        del profiler
        log("traced window: {:.4f} s by the host's clock, {:.4f} s on the trace's".format(
            record.window_s, record.trace["window_s"]))
    cell.finish(record)

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                   if on_card else 0}
    if record.trace is not None:
        device_info["busy_s"] = record.trace["busy_s"]
        device_info["window_s"] = record.trace["window_s"]

    metrics = {}
    for metric in cell_metrics(manifest, workload, trace):
        value = load_module("metrics", metric["name"]).read(record)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    cell.release()
    if on_card:
        torch.cuda.empty_cache()
    check_start = time.perf_counter()
    checks = [(name, value, limits[name]) for name, value in cell.check(record)]
    log("reference check took {:.3f} s".format(time.perf_counter() - check_start))
    result = {"correct": all(value <= limit for _, value, limit in checks),
              "attempted": record.attempted, "failed": record.failed,
              "metrics": metrics, "device": device_info}
    if record.trace is not None:
        result["breakdown"] = record.trace["breakdown"]
    return result, checks, cell


def main(args, started: float) -> int:
    import torch

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log("no result: the cell needs {} CUDA device(s), this machine has {}".format(
            chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
        return 2
    log("card: {}".format(power_limit()))
    result, checks, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 "cuda:0", started)
    loaded = forbidden_modules()
    if loaded:
        log("no result: the run loaded {}".format(", ".join(loaded)))
        return 3
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    for name, value, limit in checks:
        log("check {}: {!r} (limit {!r}){}".format(
            name, value, limit, "" if value <= limit else "  FAILED"))
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0

