"""The harness run end to end on the CPU at a small size (its look for a card skipped):
a sound run comes out correct, each fault planted in the timed path, and the training
cells' lower-precision control, come out not correct under the cells' own limits."""
import json
import time

import pytest

from benchmark.harness import core

TRAIN = {"utterances": 40, "bucket_frames": 256, "batch": 4, "steps_per_call": 2,
         "lengths": {"distribution": "normal", "mean_s": 1.2, "sd_s": 0.3, "min_s": 0.5,
                     "max_s": 2.0}}
LM = dict(core.load_json("traffic", "test-clean-batch")["lm"], vocabulary=300,
          sentences=400)
SERVE_LENGTHS = {"distribution": "lognormal", "median_s": 1.5, "sigma": 0.3,
                 "min_s": 1.0, "max_s": 2.5}
SMALL = {
    "train-mel-en-resident": TRAIN,
    "train-mel-de-freeze8": TRAIN,
    "serve-mel-en-batch": {"utterances": 6, "check_requests": 3, "lengths": SERVE_LENGTHS,
                           "lm": LM},
}
FAULTS = {"train": ["unchanged_state", "half_batch"],
          "serve": ["altered_answer", "half_batch"]}
WORKLOADS = {w["name"]: w for w in json.loads((core.ROOT / "BENCHMARK.json").read_text())[
    "workloads"]}
CELLS = list(WORKLOADS)


def driver_of(cell):
    return core.load_module("drivers", core.load_json(
        "traffic", WORKLOADS[cell]["traffic"])["driver"])


def run(cell, fault=None):
    result, checks, driven = core.run_cell(cell, 20240601, 1.0, False, "cpu",
                                           time.perf_counter(), overrides=SMALL[cell],
                                           fault=fault)
    return result, checks, driven


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, checks, _ = run(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(cell, fault) for cell in CELLS
                                        for fault in FAULTS[cell.split("-")[0]]])
def test_a_fault_is_not_correct(cell, fault):
    result, checks, _ = run(cell, fault)
    assert not result["correct"], checks


def test_a_mis_scaled_lm_weight_is_not_correct():
    """The LM beam's fault: its LM scores scaled by 1 / ln 10 (a log-base slip). A
    sampled transcript moves only on some seeds, at this size as at the cell's own;
    this seed is one where it does."""
    overrides = dict(SMALL["serve-mel-en-batch"], utterances=8, check_requests=8)
    result, checks, _ = core.run_cell("serve-mel-en-batch", 7, 1.0, False, "cpu",
                                      time.perf_counter(), overrides=overrides,
                                      fault="lm_weight_x0.434")
    assert not result["correct"], checks
    assert dict((name, value) for name, value, _ in checks)["beam_gap"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("train")])
def test_the_fp8_control_fails_a_limit(cell):
    _, checks, driven = run(cell)
    limits = core.load_json("limits", cell)
    numbers = dict(driver_of(cell).control(driven))
    assert any(numbers[name] > limit for name, limit in limits.items()), numbers


@pytest.mark.chip
@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("serve")])
def test_the_tf32_control_fails_a_limit_on_the_card(cell, card):
    result, checks, driven = core.run_cell(cell, 20240602, 1.0, False, card,
                                           time.perf_counter(), overrides=SMALL[cell])
    limits = core.load_json("limits", cell)
    numbers = dict(driver_of(cell).control(driven))
    assert any(numbers[name] > limit for name, limit in limits.items()), numbers
