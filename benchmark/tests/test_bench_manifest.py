"""BENCHMARK.json against the contract's characters and against the files it names."""
import json
import re
from pathlib import Path

from benchmark.harness import core

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
END_TO_END = {"setup_s", "train_utt_per_s", "audio_s_per_s"}


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = [entry["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for entry in MANIFEST[key]]
    assert all(NAME.match(name) for name in names)
    assert len(set(names)) == len(names)
    for metric in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for text in [w["why"] for w in MANIFEST["workloads"] + MANIFEST["configs"]] + \
            [m["layer"] for m in MANIFEST["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_metrics_and_bounds():
    assert {m["name"] for m in MANIFEST["end_to_end"]} == END_TO_END
    for metric in MANIFEST["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    reported = {w["name"]: {m["name"] for m in MANIFEST["end_to_end"]
                            if w["name"] in m.get("workloads", [w["name"]])}
                for w in MANIFEST["workloads"]}
    for metric in MANIFEST["per_layer"]:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        for cell in metric["workloads"]:
            assert metric["moves"] in reported[cell]
    for cell, metrics in reported.items():
        assert "setup_s" in metrics and len(metrics) >= 2
        assert core.cell_metrics(MANIFEST, cell, True)


def test_every_name_finds_its_files():
    for config in MANIFEST["configs"]:
        assert (ROOT / config["file"]).is_file()
        assert core.load_json("configs", config["name"])["name"] == config["name"]
    for cell in MANIFEST["workloads"]:
        traffic = core.load_json("traffic", cell["traffic"])
        assert (core.BENCH / "drivers" / (traffic["driver"] + ".py")).is_file()
        assert core.load_json("limits", cell["name"])
        assert cell["chips"] == 1
    for metric in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(core.load_module("metrics", metric["name"]).read)
    for layer in ("ctc", "lm_span"):
        assert core.load_json("layers", layer)["kernels"]


def test_run_seconds_fits_the_check_budget_at_24_cells():
    seconds = MANIFEST["run_seconds"]
    assert 1 <= seconds <= 51
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200
