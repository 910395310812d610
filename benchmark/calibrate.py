"""Read the numbers a cell's check compares, for setting their limits: the program's on
many seeds, the lower-precision control's and each planted fault's on a few, all in one
process (set-up is paid per seed, the card's start once).

    python3 benchmark/calibrate.py --workload <name> --seeds 12 --control-seeds 3 \
        --fault-seeds 3 [--faults unchanged_state half_batch] [--seconds 2] [--first-seed N]

One JSON line per reading goes to standard output and to
``chiprun_out/calibrate-<workload>.jsonl``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--faults", nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_001)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import core

    driver = core.load_module("drivers", core.load_json("traffic", {
        w["name"]: w for w in json.loads((ROOT / "BENCHMARK.json").read_text())[
            "workloads"]}[args.workload]["traffic"])["driver"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = (out_dir / "calibrate-{}.jsonl".format(args.workload)).open("a")

    def emit(kind, seed, numbers, **more):
        line = json.dumps(dict(kind=kind, workload=args.workload, seed=seed,
                               numbers={name: value for name, value in numbers}, **more))
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    for index in range(args.seeds):
        seed = args.first_seed + 7919 * index
        result, checks, cell = core.run_cell(args.workload, seed, args.seconds, False,
                                             args.device, time.perf_counter())
        emit("program", seed, [(name, value) for name, value, _ in checks],
             correct=result["correct"])
        if index < args.control_seeds:
            emit("control", seed, driver.control(cell))
        del cell
        torch.cuda.empty_cache()
    for fault in args.faults:
        for index in range(args.fault_seeds):
            seed = args.first_seed + 104729 * (index + 1)
            result, checks, cell = core.run_cell(args.workload, seed, args.seconds, False,
                                                 args.device, time.perf_counter(),
                                                 fault=fault)
            emit("fault:" + fault, seed, [(name, value) for name, value, _ in checks],
                 correct=result["correct"])
            del cell
            torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
