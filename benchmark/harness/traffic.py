"""Inputs made from the seed, for every traffic mix: utterance lengths, the resident
corpus, audio and the word LM's text.

Lengths are the quantiles of the mix's distribution, the same set for every seed; the
seed only orders them (and fills the features, labels and audio). So two seeds give
the card the same work in another order.
"""
import statistics
from pathlib import Path
from typing import List

import numpy as np

SAMPLE_RATE = 16000
HOP = 128


def length_seconds(spec: dict, count: int) -> np.ndarray:
    """``count`` utterance lengths in seconds: the quantiles ``(i + 0.5) / count`` of a
    ``normal`` (``mean_s``, ``sd_s``) or ``lognormal`` (``median_s``, ``sigma``)
    distribution, clipped to [``min_s``, ``max_s``], ascending."""
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf((i + 0.5) / count) for i in range(count)])
    if spec["distribution"] == "normal":
        seconds = spec["mean_s"] + spec["sd_s"] * z
    elif spec["distribution"] == "lognormal":
        seconds = spec["median_s"] * np.exp(spec["sigma"] * z)
    else:
        raise ValueError("unknown length distribution {!r}".format(spec["distribution"]))
    return np.clip(seconds, spec["min_s"], spec["max_s"])


def distinct_samples(seconds: np.ndarray) -> np.ndarray:
    """Sample counts of ``seconds``, nudged up by single samples until all differ (a
    request is then known by its length)."""
    samples = np.round(seconds * SAMPLE_RATE).astype(np.int64)
    for index in range(1, len(samples)):
        samples[index] = max(samples[index], samples[index - 1] + 1)
    return samples


def permutation(seed: int, count: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(count)


def resident_corpus(traffic: dict, classes: int, seed: int, device):
    """The resident training corpus on ``device``: fp16 features (rows padded to the
    bucket with zeros past each row's frames), int32 frame counts, labels (uniform over
    the ``classes - 1`` non-blank classes, ``labels_per_1024_frames`` of them, -1
    padded to a multiple of 64) and label counts."""
    import torch

    rows, bucket = traffic["utterances"], traffic["bucket_frames"]
    samples = np.round(length_seconds(traffic["lengths"], rows) * SAMPLE_RATE)
    frames = (1 + samples.astype(np.int64) // HOP)[permutation(seed, rows)]
    if frames.max() > bucket:
        raise ValueError("an utterance of {} frames exceeds the {}-frame bucket".format(
            frames.max(), bucket))
    label_counts = np.round(frames * traffic["labels_per_1024_frames"] / 1024).astype(np.int64)
    label_width = -(-int(label_counts.max()) // 64) * 64
    generator = torch.Generator(device=device).manual_seed(seed)
    lengths = torch.from_numpy(frames.astype(np.int32)).to(device)
    label_lengths = torch.from_numpy(label_counts.astype(np.int32)).to(device)
    inputs = torch.empty((rows, bucket, traffic["features"]), dtype=torch.float16,
                         device=device)
    positions = torch.arange(bucket, device=device)
    chunk = traffic.get("chunk_rows", 4096)
    for first in range(0, rows, chunk):
        block = inputs[first:first + chunk]
        block.normal_(generator=generator)
        block.masked_fill_(positions[None, :, None] >= lengths[first:first + chunk, None, None],
                           0.0)
    labels = torch.randint(0, classes - 1, (rows, label_width), generator=generator,
                           device=device, dtype=torch.int32)
    labels.masked_fill_(torch.arange(label_width, device=device)[None]
                        >= label_lengths[:, None], -1)
    return inputs, lengths, labels, label_lengths


def audio_clips(samples: np.ndarray, seed: int, device) -> List[np.ndarray]:
    """One float32 waveform per entry of ``samples``, made on ``device`` in one pass:
    four tones of seeded frequencies and phases under a slow seeded envelope, plus
    noise. Returned as host arrays (the Transcriber takes host audio)."""
    import torch

    generator = torch.Generator(device=device).manual_seed(seed)
    count = len(samples)
    lengths = torch.from_numpy(np.asarray(samples, np.int64)).to(device)
    offsets = torch.cumsum(lengths, 0) - lengths
    clip = torch.repeat_interleave(torch.arange(count, device=device), lengths)
    t = (torch.arange(int(lengths.sum()), device=device) - offsets[clip]).to(
        torch.float32) / SAMPLE_RATE
    uniform = torch.rand((count, 10), generator=generator, device=device)
    frequency = 100.0 + 2900.0 * uniform[:, :4]
    phase = 6.0 * uniform[:, 4:8]
    envelope = 1.0 + 3.0 * uniform[:, 8]
    tones = sum(0.2 * torch.sin(2 * np.pi * frequency[clip, j] * t + phase[clip, j])
                for j in range(4))
    wave = tones * (0.5 + 0.5 * torch.sin(2 * np.pi * envelope[clip] * t))
    wave += 0.05 * torch.randn(wave.shape, generator=generator, device=device)
    host = wave.cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(samples)])
    return [host[bounds[i]:bounds[i + 1]] for i in range(count)]


def lm_sentences(spec: dict, seed: int) -> List[str]:
    """Seeded text over a vocabulary of ``vocabulary`` distinct words (lengths
    ``word_letters`` inclusive, ``letters`` drawn by their ``letter_weights``):
    ``sentences`` sentences of ``sentence_words`` words (inclusive), each word drawn
    by a Zipf law of exponent ``zipf`` over the vocabulary's ranks."""
    rng = np.random.default_rng(seed)
    letters = np.array(list(spec["letters"]))
    weights = np.asarray(spec["letter_weights"], np.float64)
    weights /= weights.sum()
    low, high = spec["word_letters"]
    words, seen = [], set()
    while len(words) < spec["vocabulary"]:
        length = int(rng.integers(low, high + 1))
        word = "".join(rng.choice(letters, size=length, p=weights))
        if word not in seen:
            seen.add(word)
            words.append(word)
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    probabilities = ranks ** -spec["zipf"]
    probabilities /= probabilities.sum()
    low, high = spec["sentence_words"]
    lengths = rng.integers(low, high + 1, size=spec["sentences"])
    drawn = rng.choice(len(words), size=int(lengths.sum()), p=probabilities)
    sentences, cursor = [], 0
    for length in lengths:
        sentences.append(" ".join(words[i] for i in drawn[cursor:cursor + length]))
        cursor += length
    return sentences


def write_lm(spec: dict, seed: int, directory: Path) -> Path:
    """The word trigram of `lm_sentences` as ``directory/lm.arpa`` (frozen builder)."""
    from .arpa_builder import WordNgramEstimator

    estimator = WordNgramEstimator(order=spec["order"])
    for sentence in lm_sentences(spec, seed):
        estimator.add_text(sentence)
    directory.mkdir(parents=True, exist_ok=True)
    return estimator.write_arpa(directory / "lm.arpa")

