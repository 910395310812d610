"""Each metric reader on a synthetic record."""
import pytest

from benchmark.harness import core, yardstick
from benchmark.harness.core import Record


def record(**work):
    r = Record("cell", {}, {}, 1, 10.0, True, 0.0)
    r.window = (100.0, 110.0)
    r.setup_s = 31.5
    r.work.update(work)
    r.trace = {"window_s": 10.0, "busy_s": 9.5,
               "kernels": {"ctc_alpha_kernel(float const*)": [0.02, 100],
                           "ctc_beta_grad_kernel": [0.03, 100],
                           "lm_beam_span_kernel": [0.5, 40], "dgrad_engine": [7.0, 10]}}
    return r


def read(name, r):
    return core.load_module("metrics", name).read(r)


def test_end_to_end_readers():
    r = record(utterances=3840, audio_s=20000.0)
    assert read("setup_s", r) == 31.5
    assert read("train_utt_per_s", r) == pytest.approx(384.0)
    assert read("audio_s_per_s", r) == pytest.approx(2000.0)


def test_device_readers():
    r = record(model_flops=989e12 * 10 * 0.05, ctc_bytes=3.35e12 * 0.001, span_bytes=0.0)
    r.window = (100.0, 112.5)  # the host's window; the MFUs read the trace's 10 s
    assert read("mfu.train", r) == pytest.approx(5.0)
    assert read("mfu.batch", r) == pytest.approx(5.0 * 989 / 67)
    assert read("ctc_roofline", r) == pytest.approx(100 * 0.001 / 0.05)
    assert read("lm_span_roofline", r) == 0.0
    for name in ("idle_share.train", "idle_share.batch"):
        assert read(name, r) == pytest.approx(5.0)
    r.trace["kernels"] = {"dgrad_engine": [7.0, 10]}
    assert read("ctc_roofline", r) is None  # nothing to read: left out, never 0
    assert read("lm_span_roofline", r) is None


def test_next_pow2():
    assert yardstick.next_pow2(25) == 32
    assert yardstick.next_pow2(32) == 32
