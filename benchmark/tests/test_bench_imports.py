"""What a benchmark run executes loads neither JAX nor the JAX package, and the plain
reference loads nothing of the port. Each check runs in a fresh interpreter (the test
process itself has the JAX package loaded by the repository's conftest)."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL_TRAIN = {"utterances": 12, "bucket_frames": 128, "batch": 2, "steps_per_call": 1,
               "lengths": {"distribution": "normal", "mean_s": 0.6, "sd_s": 0.1,
                           "min_s": 0.4, "max_s": 0.9}}


def run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    loaded = run(
        "import sys, json, time; sys.path.insert(0, '.')\n"
        "import pkgutil, importlib\n"
        "from benchmark.harness import core\n"
        "import benchmark.harness, benchmark.reference, benchmark.drivers\n"
        "for package in (benchmark.harness, benchmark.reference, benchmark.drivers):\n"
        "    for info in pkgutil.iter_modules(package.__path__):\n"
        "        importlib.import_module(package.__name__ + '.' + info.name)\n"
        "for path in sorted((core.BENCH / 'metrics').glob('*.py')):\n"
        "    core.load_module('metrics', path.stem)\n"
        "core.run_cell('train-mel-en-resident', 7, 0.1, True, 'cpu', time.perf_counter(),"
        " overrides={!r})\n"
        "import speechless_tpu_torch.serving, speechless_tpu_torch.serving_http\n"
        "print(json.dumps(core.forbidden_modules()))".format(SMALL_TRAIN))
    assert loaded == []


def test_the_reference_loads_nothing_of_the_port():
    loaded = run(
        "import sys, json; sys.path.insert(0, '.')\n"
        "import benchmark.reference.w2l, benchmark.reference.train, "
        "benchmark.reference.serve, benchmark.reference.beam, benchmark.reference.lm, "
        "benchmark.reference.mel\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('speechless_tpu_torch', 'speechless_tpu', 'jax'))))")
    assert loaded == []


def test_forbidden_names_are_compared_whole():
    from benchmark.harness import core

    sys.modules.setdefault("speechless_tpu_torch_lookalike", sys)
    assert "speechless_tpu_torch_lookalike" not in core.forbidden_modules()
    assert all(name.split(".")[0] in core.FORBIDDEN_MODULES
               for name in core.forbidden_modules())
