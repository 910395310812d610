"""Run one cell of the benchmark of `speechless_tpu_torch` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json`` -> ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix (``benchmark/traffic/<traffic>.json``),
whose ``driver`` is the timed loop (``benchmark/drivers/<driver>.py``). The run makes its
inputs and weights from ``--seed`` on the card, warms up, measures for ``--seconds``,
checks the window's outputs against the plain reference (``benchmark/reference/``) and
prints one JSON line last on standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics (read from a `torch.profiler` trace of the window)
with ``--trace 1``. Without a CUDA device, or with fewer than the cell asks for, it exits
with code 2 and prints no result.
"""
import time

STARTED = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core

    sys.exit(core.main(parse(), STARTED))
