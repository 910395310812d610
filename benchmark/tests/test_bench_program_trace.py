"""The readers of the program's own spans and counters (`harness/program_trace.py`): each
on a synthetic snapshot, left out where the program records nothing, and a traced run
of each cell on the CPU at a small size, whose padding shares must equal what the
cell's own inputs give."""
import json
import time

import pytest
import torch

from benchmark.harness import core, program_trace
from benchmark.harness.core import Record
from test_bench_faults import SMALL

MS = 1_000_000
WORKLOADS = [w["name"] for w in json.loads((core.ROOT / "BENCHMARK.json").read_text())[
    "workloads"]]


def kept(name, start_ms, end_ms, id_, parent):
    return {"name": name, "start_ns": start_ms * MS, "end_ns": end_ms * MS, "id": id_,
            "parent": parent}


STAGES = (("transcribe.copy", 1), ("transcribe.model", 4), ("transcribe.decode", 3),
          ("transcribe.fetch", 20))  # ms each; the text's 2 ms of a dispatch are no span


def dispatch(id_, parent, start_ms):
    """A dispatch of 30 ms at ``start_ms``, its stages one after another."""
    spans, cursor = [kept("transcribe.dispatch", start_ms, start_ms + 30, id_, parent)], \
        start_ms
    for offset, (name, length) in enumerate(STAGES):
        spans.append(kept(name, cursor, cursor + length, id_ + 1 + offset, id_))
        cursor += length
    return spans


SNAPSHOT = {
    "spans": [kept("transcribe.batch", 0, 100, 0, None),
              kept("transcribe.group", 0, 5, 1, 0), *dispatch(2, 0, 5),
              kept("transcribe.group", 35, 45, 8, 0), *dispatch(9, 0, 45),
              kept("transcribe.group", 75, 76, 15, 0)],
    "counters": {"transcribe.samples": 4 * 65536, "transcribe.samples_own": 3 * 65536,
                 "train.frames": 64 * 3072, "train.frames_own": 48 * 3072},
    "dropped_spans": 0}


def record():
    r = Record("cell", {}, {}, 1, 10.0, True, 0.0)
    r.window = (0.0, 0.3)
    r.trace = {"window_s": 0.2, "busy_s": 0.1, "kernels": {}}
    return r


def read(name):
    return core.load_module("metrics", name).read(record())


def test_readers_on_a_synthetic_snapshot(monkeypatch):
    monkeypatch.setattr(program_trace, "snapshot", lambda: SNAPSHOT)
    # 100 ms of batch less two dispatches' 28 ms from copy start to fetch end, over 200.
    assert read("starved_share.batch") == pytest.approx(100 * 44 / 200)
    assert read("issue_share.batch") == pytest.approx(100 * 16 / 200)
    assert read("group_share.batch") == pytest.approx(100 * 16 / 200)
    assert read("pad_share.batch") == pytest.approx(25.0)
    assert read("pad_share.train") == pytest.approx(25.0)


@pytest.mark.parametrize("recorded", [None, {"spans": [], "counters": {},
                                             "dropped_spans": 0}])
def test_readers_leave_out_what_the_program_did_not_record(monkeypatch, recorded):
    """A port without the tracer (None) or a window without these spans and counters:
    each metric is left out of the line, never 0."""
    monkeypatch.setattr(program_trace, "snapshot", lambda: recorded)
    for name in ("starved_share.batch", "issue_share.batch", "group_share.batch",
                 "pad_share.batch", "pad_share.train"):
        assert read(name) is None


def test_stage_seconds_splits_self_time():
    spans = [{"name": "a", "start_ns": 0, "end_ns": 100, "id": 0, "parent": None},
             {"name": "b", "start_ns": 10, "end_ns": 40, "id": 1, "parent": 0},
             {"name": "b", "start_ns": 30, "end_ns": 60, "id": 2, "parent": 0},
             {"name": "c", "start_ns": 15, "end_ns": 20, "id": 3, "parent": 1}]
    stages = program_trace.stage_seconds(spans)
    assert stages["a"] == {"count": 1, "total_s": 100e-9, "self_s": 50e-9}
    assert stages["b"]["count"] == 2 and stages["b"]["total_s"] == pytest.approx(60e-9)
    assert stages["b"]["self_s"] == pytest.approx(55e-9)
    assert stages["c"]["self_s"] == pytest.approx(5e-9)


def traced_run(cell):
    """One traced run of ``cell``; the runs of earlier tests in this process, traced or
    not, leave nothing in what its readers read."""
    result, checks, driven = core.run_cell(cell, 2**31 + 77, 1.0, True, "cpu",
                                           time.perf_counter(), overrides=SMALL[cell])
    assert result["correct"], checks
    return result["metrics"], driven


@pytest.mark.parametrize("cell", [c for c in WORKLOADS if c.startswith("train")])
def test_pad_share_train_equals_the_replayed_rows(cell):
    metrics, driven = traced_run(cell)
    replay = torch.Generator(device=driven.device)
    rows, own = len(driven.lengths_host), 0
    for state in driven.sampler_states:
        replay.set_state(state)
        for _ in range(driven.steps):
            picked = torch.randperm(rows, generator=replay, device=driven.device)[
                : driven.batch].cpu().numpy()
            own += int(driven.lengths_host[picked].sum())
    frames = len(driven.sampler_states) * driven.steps * driven.batch * \
        driven.mix["bucket_frames"]
    assert metrics["pad_share.train"]["value"] == 100.0 * (1.0 - own / frames)
    assert not {"starved_share.batch", "issue_share.batch", "group_share.batch",
                "pad_share.batch"} & set(metrics)


def test_the_serving_shares_read_the_clips_own_buckets():
    from benchmark.reference import serve

    metrics, driven = traced_run("serve-mel-en-batch")
    samples = [int(n) for n in driven.serving.samples]
    buckets = [serve.bucket(n) for n in samples]
    assert metrics["pad_share.batch"]["value"] == \
        100.0 * (1.0 - sum(samples) / sum(buckets))
    assert 0 < metrics["starved_share.batch"]["value"] <= \
        metrics["idle_share.batch"]["value"] + 1
    assert 0 < metrics["issue_share.batch"]["value"] < 100
    assert 0 < metrics["group_share.batch"]["value"] < metrics["starved_share.batch"]["value"]
    assert "pad_share.train" not in metrics
