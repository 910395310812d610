"""The port's own spans and counters (`speechless_tpu_torch/utils/trace.py`) on the CPU:
kept only while a `torch.profiler` session records; the Transcriber's dispatch stages
and the resident gather's frame counters; the kept spans against the profiler's own
events on the shared clock; no profiler op in an exported program; and the collective
log kept only inside its recording scope (`parallel/mesh.py`).
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speechless_tpu_torch.data.device_dataset import DeviceDataset
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.parallel.mesh import CollectiveLog
from speechless_tpu_torch.serving import Transcriber
from speechless_tpu_torch.serving_export import export_transcriber
from speechless_tpu_torch.train import trainer
from speechless_tpu_torch.utils import trace

ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")
LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2),
          w2l.ConvSpec("inner_conv_1", 16, 7, 1),
          w2l.ConvSpec("big_conv_1", 24, 32, 1),
          w2l.ConvSpec("big_conv_2", 24, 1, 1),
          w2l.ConvSpec("output_conv", len(ALPHABET) + 1, 1, 1, "linear"))
BUCKETS = (8192, 16384)
# Two groups of two in the first bucket, one in the second (batch size 2).
LENGTHS = (5000, 8192, 12000, 16000, 3000, 7000)
STAGES = ["transcribe.copy", "transcribe.model", "transcribe.decode", "transcribe.fetch"]

TRAIN_LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2),
                w2l.ConvSpec("big_conv_1", 24, 7, 1),
                w2l.ConvSpec("output_conv", 5, 1, 1, "linear"))
FEATURES, ROWS, FRAMES, BATCH, STEPS = 8, 10, 64, 4, 3


def _audios():
    rng = np.random.default_rng(5)
    return [(0.1 * rng.normal(size=n)).astype(np.float32) for n in LENGTHS]


@pytest.fixture(scope="module")
def transcriber():
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    return Transcriber(config, w2l.init_params(config, seed=11), ALPHABET, device="cpu",
                       sample_buckets=BUCKETS)


def _resident():
    rng = np.random.default_rng(7)
    lengths = rng.integers(20, FRAMES + 1, ROWS).astype(np.int32)
    inputs = rng.normal(size=(ROWS, FRAMES, FEATURES)).astype(np.float32)
    inputs[np.arange(FRAMES)[None, :] >= lengths[:, None]] = 0
    labels = rng.integers(0, 4, (ROWS, 8)).astype(np.int32)
    label_lengths = rng.integers(1, 9, ROWS).astype(np.int32)
    labels[np.arange(8)[None, :] >= label_lengths[:, None]] = -1
    dataset = DeviceDataset(*(torch.from_numpy(a) for a in (inputs, lengths, labels,
                                                               label_lengths)))
    config = w2l.Wav2LetterConfig(FEATURES, 5, layers=TRAIN_LAYERS)
    optimizer = trainer.make_optimizer(1e-3)
    state = trainer.init_train_state(config, optimizer, device="cpu")
    indices = torch.from_numpy(np.stack([rng.permutation(ROWS)[:BATCH]
                                         for _ in range(STEPS)]))
    epoch = trainer.make_device_epoch_step(config, optimizer, BATCH, STEPS)
    return epoch, state, dataset, indices


def _run(route, transcriber):
    """Run ``route`` once; returns what its counters should read."""
    if route == "transcribe_batch":
        audios = _audios()
        transcriber.transcribe_batch(audios, batch_size=2)
        groups = list(transcriber._groups(audios, 2))
        return {"transcribe.samples": sum(wavs.size for _, wavs, _ in groups),
                "transcribe.samples_own": sum(int(n.sum()) for _, _, n in groups)}
    epoch, state, dataset, indices = _resident()
    epoch(state, dataset, indices=indices)
    return {"train.frames": STEPS * BATCH * FRAMES,
            "train.frames_own": int(dataset.input_lengths[indices.flatten()].sum())}


def _recorded(route, transcriber):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as profiler:
        expected = _run(route, transcriber)
    recorded = trace.snapshot()
    trace.clear()
    return recorded, expected, profiler


@pytest.mark.parametrize("route", ["transcribe_batch", "resident_epoch"])
def test_nothing_is_kept_with_the_profiler_off(route, transcriber):
    trace.clear()
    _run(route, transcriber)
    assert not trace.recording()
    assert trace.snapshot() == {"spans": [], "counters": {}, "dropped_spans": 0}


@pytest.mark.parametrize("route", ["transcribe_batch", "resident_epoch"])
def test_counters_equal_the_padded_and_own_sums(route, transcriber):
    recorded, expected, _ = _recorded(route, transcriber)
    assert recorded["counters"] == expected


def test_dispatch_spans_nest_and_run_in_order(transcriber):
    recorded, _, _ = _recorded("transcribe_batch", transcriber)
    spans = recorded["spans"]
    assert recorded["dropped_spans"] == 0
    (batch,) = [s for s in spans if s["name"] == "transcribe.batch"]
    assert batch["parent"] is None
    under_batch = [s for s in spans if s["parent"] == batch["id"]]
    # Each group is produced in its own span, and one more finds the generator spent.
    assert [s["name"] for s in under_batch] == ["transcribe.group", "transcribe.dispatch"] \
        * 3 + ["transcribe.group"]
    dispatches = [s for s in under_batch if s["name"] == "transcribe.dispatch"]
    assert len({s["id"] for s in dispatches}) == 3
    for dispatch in dispatches:
        stages = [s for s in spans if s["parent"] == dispatch["id"]]
        assert [s["name"] for s in stages] == STAGES
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(stages, stages[1:]))
        assert dispatch["start_ns"] <= stages[0]["start_ns"]
        assert stages[-1]["end_ns"] <= dispatch["end_ns"] <= batch["end_ns"]
    assert len(spans) == 1 + 4 + 3 * (1 + len(STAGES))


def test_kept_spans_match_the_profilers_events(transcriber):
    recorded, _, profiler = _recorded("transcribe_batch", transcriber)
    events = {}
    for event in profiler.profiler.kineto_results.events():
        if event.device_type().name == "CPU" and event.name().startswith("transcribe."):
            events.setdefault(event.name(), []).append(event.start_ns())
    spans = recorded["spans"]
    assert sorted(s["name"] for s in spans) == sorted(
        name for name, starts in events.items() for _ in starts)
    for kept in spans:
        nearest = min(events[kept["name"]], key=lambda start: abs(start - kept["start_ns"]))
        assert abs(nearest - kept["start_ns"]) < 500_000, kept


def test_an_export_holds_no_profiler_op(transcriber, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        export_transcriber(transcriber, tmp_path, platforms=("cpu",),
                           sample_buckets=(8192,), batch_sizes=(1, 2))
    trace.clear()
    programs = sorted(tmp_path.glob("*.pt2"))
    assert len(programs) == 2
    for path in programs:
        graph = torch.export.load(str(path)).graph
        targets = [str(node.target) for node in graph.nodes if node.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t], path.name


def test_a_new_profiler_session_starts_an_empty_store():
    """What one session kept stays readable after it ends, until the first span or count
    of the next session (the program ran, with the profiler off, in between)."""
    trace.clear()
    for name, value in (("first", 1), ("second", 2)):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span(name):
                trace.count("n", value)
        assert not trace.recording()
        recorded = trace.snapshot()
        assert [s["name"] for s in recorded["spans"]] == [name]
        assert recorded["counters"] == {"n": value}
    trace.clear()


def test_store_limit_counters_and_clear(monkeypatch):
    trace.clear()
    monkeypatch.setattr(trace, "SPAN_LIMIT", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with trace.span("x"):
                pass
        trace.count("host", 2)
        trace.count("host", 3)
        trace.count("device", torch.tensor(4))
        trace.count("device", torch.tensor(5))
    trace.count("host", 100)  # the profiler is off: not counted
    recorded = trace.snapshot()
    assert len(recorded["spans"]) == 3 and recorded["dropped_spans"] == 2
    assert recorded["counters"] == {"host": 5, "device": 9}
    trace.clear()
    assert trace.snapshot() == {"spans": [], "counters": {}, "dropped_spans": 0}


def test_each_thread_nests_its_own_spans():
    trace.clear()
    inside, release = threading.Event(), threading.Event()

    def serve():
        with trace.span("thread.outer"):
            with trace.span("thread.inner"):
                inside.set()
                release.wait(10)

    with profile(activities=[ProfilerActivity.CPU]):
        worker = threading.Thread(target=serve)
        with trace.span("main.outer"):
            worker.start()
            assert inside.wait(10)
            with trace.span("main.inner"):
                pass
            release.set()
            worker.join(10)
    assert not worker.is_alive()
    spans = {s["name"]: s for s in trace.snapshot()["spans"]}
    trace.clear()
    assert spans["main.inner"]["parent"] == spans["main.outer"]["id"]
    assert spans["thread.inner"]["parent"] == spans["thread.outer"]["id"]
    assert spans["thread.outer"]["parent"] is None


def test_collective_log_keeps_events_only_inside_a_recording_scope():
    log = CollectiveLog()
    log.log("all_reduce", "data", "outside")
    with log.recording() as outer:
        log.log("all_reduce", "data", "first")
        with log.recording() as inner:
            log.log("all_gather", "model", "nested")
        log.log("all_reduce", "data", "second")
    log.log("all_gather", "data", "after")
    assert outer == [("all_reduce", "data", "first"), ("all_reduce", "data", "second")]
    assert inner == [("all_gather", "model", "nested")]
