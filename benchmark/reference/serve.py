"""The serving cells' check: the sampled requests' transcripts and the log-probs their
dispatches computed, against the plain reference on the same audio and weights.

Per sampled request (the longest among them): the reference's features (`mel.py`,
float64) padded to the request's length bucket, the plain stack in IEEE fp32
(`w2l.py`) and log-softmax in float64 give the reference log-probs. The plain LM beam
(`beam.py`, over the ARPA text the program was given, `lm.py`) then decodes the log-probs
the program's own dispatch computed: the beam is a search whose result jumps at ties,
so it follows the program's state from its log-probs, which are checked apart. The
numbers compared:

* ``logprob_gap``: the largest |program - reference| log-prob over the request's
  frames, which holds features, model and softmax;
* ``beam_gap``: how far the served transcript's objective (`beam.objective`: exact CTC
  log-likelihood plus word bonuses, on the program's log-probs) lies below that of the
  plain beam's transcript, 0 where it lies above: the LM beam and the backtrace. The
  two beams sum in other orders and precisions (fp32 on the card, float64 here), so on
  a long request they can part at a near-tie, whose objectives then differ by little;
* ``missing_answers``: requests of the window that never got an answer (limit 0).
"""
import sys

import numpy as np
import torch

from . import beam, mel
from . import w2l as plain
from .lm import Arpa

# The Transcriber's length buckets (feature-frame buckets x 128 samples) and its step
# past the last one: a request is padded to the smallest that holds it.
SAMPLE_BUCKETS = tuple(frames * 128 for frames in (128, 192, 256, 384, 512, 768, 1024,
                                                   1280, 1536, 2048, 3072, 4096))
FALLBACK_MULTIPLE = 65536


def bucket(samples: int) -> int:
    for size in SAMPLE_BUCKETS:
        if samples <= size:
            return size
    return -(-samples // FALLBACK_MULTIPLE) * FALLBACK_MULTIPLE


def valid_frames(samples: int) -> int:
    """Output frames of a clip of ``samples`` samples: feature frames (hop 128) halved by
    the model's stride."""
    return (1 + samples // 128) // 2


def log_probs(serving, index: int, precision: str) -> np.ndarray:
    """The reference's ``(frames, classes)`` float64 log-probs of clip ``index``."""
    audio = serving.clips[index]
    features = torch.from_numpy(mel.features(audio, bucket(len(audio)))).to(
        serving.device, torch.float32)
    with torch.no_grad():
        logits = plain.forward(serving.weights, serving.layers, features[None], precision)
    return logits[0, :valid_frames(len(audio))].to(torch.float64).log_softmax(-1).cpu().numpy()


def decode(serving, lm: Arpa, lp: np.ndarray) -> str:
    s = serving.serve
    return beam.decode(lp, serving.alphabet, lm, s["beam_width"], s["prune_classes"],
                       beam.weights_of(s))


# A served transcript no alignment can produce scores -inf; it reads as this gap.
INFEASIBLE_GAP = 1e9


def beam_gap(serving, lm: Arpa, lp: np.ndarray, served: str) -> float:
    """How far ``served`` lies below the plain beam's transcript of ``lp``."""
    weights = beam.weights_of(serving.serve)
    reference = beam.objective(lp, decode(serving, lm, lp), serving.alphabet, lm, weights)
    gap = reference - beam.objective(lp, served, serving.alphabet, lm, weights)
    return max(0.0, min(gap, INFEASIBLE_GAP))


def compare(serving, served: dict, missing: int) -> list:
    """``served``: sampled clip index -> served transcript (None: never answered)."""
    lm = Arpa(serving.arpa)
    logprob_gap = worst_beam_gap = 0.0
    for index in serving.sample:
        samples = int(serving.samples[index])
        program = serving.observer.saved[samples][:valid_frames(samples)].to(
            torch.float64).cpu().numpy()
        gap = float(np.abs(program - log_probs(serving, index, "fp32")).max())
        logprob_gap = max(logprob_gap, gap)
        if served.get(index) is None:
            continue
        request_gap = beam_gap(serving, lm, program, served[index])
        worst_beam_gap = max(worst_beam_gap, request_gap)
        print("checked clip {}: {} frames, {} characters, log-prob gap {!r}, beam gap "
              "{!r}".format(index, len(program), len(served[index]), gap, request_gap),
              file=sys.stderr)
    return [("logprob_gap", logprob_gap), ("beam_gap", worst_beam_gap),
            ("missing_answers", missing)]


def control(serving, precision: str) -> list:
    """The reference computed in ``precision`` in the program's place: its log-probs
    against the fp32 reference's, and its transcripts judged on the fp32 log-probs."""
    lm = Arpa(serving.arpa)
    logprob_gap = worst_beam_gap = 0.0
    for index in serving.sample:
        lp = log_probs(serving, index, "fp32")
        lower = log_probs(serving, index, precision)
        logprob_gap = max(logprob_gap, float(np.abs(lower - lp).max()))
        worst_beam_gap = max(worst_beam_gap, beam_gap(serving, lm, lp,
                                                      decode(serving, lm, lower)))
    return [("logprob_gap", logprob_gap), ("beam_gap", worst_beam_gap),
            ("missing_answers", 0)]
