"""The host side of serving, shared by the live `serving.Transcriber` and the bundle
loader `serving_export.ExportedTranscriber`: word timestamps from frame tokens, forced
alignment over any backend's posteriors, the grouping of requests into padded batches,
the long-form split and the servable character sets. It imports no model, feature or
decoder module, so that replaying a bundle loads none.
"""
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .text.charsets import english_frequent_characters, german_frequent_characters
from .text.graphemes import CtcGraphemeCodec

# Grapheme sets a model can be served with (the blank is appended after them).
CHARSETS = {"english": english_frequent_characters, "german": german_frequent_characters}


def words_from_frame_tokens(frames: np.ndarray, codec: CtcGraphemeCodec,
                            blank_index: int, seconds_per_frame: float
                            ) -> List[Tuple[str, float, float]]:
    """Word timestamps ``[(word, start_s, end_s), ...]`` from uncollapsed per-frame
    argmax tokens: each word spans its first to last non-blank emission."""
    space = codec.allowed_characters.index(" ") \
        if " " in codec.allowed_characters else -1
    words: List[Tuple[str, float, float]] = []
    chars: List[str] = []
    start_frame = None
    last_frame = 0
    previous = -1
    for f, token in enumerate(np.asarray(frames).tolist()):
        if token != previous and token != blank_index:
            if token == space:
                if chars:
                    words.append(("".join(chars), start_frame * seconds_per_frame,
                                  (last_frame + 1) * seconds_per_frame))
                chars, start_frame = [], None
            else:
                chars.append(codec.decode_graphemes([token], merge_repeated=False))
                if start_frame is None:
                    start_frame = f
                last_frame = f
        previous = token
    if chars:
        words.append(("".join(chars), start_frame * seconds_per_frame,
                      (last_frame + 1) * seconds_per_frame))
    return words


def align_audio(backend, audio: np.ndarray, transcript: str) -> List[dict]:
    """Forced alignment of a known ``transcript`` over any serving backend with
    ``frame_log_probs``, ``codec``, ``blank_index``, ``seconds_per_frame`` and
    ``device``: word timestamps ``[{"word", "start_s", "end_s"}, ...]`` from the
    maximum-score path through the transcript's CTC lattice (`ops/forced_align.py`), run
    on the backend's device. Characters outside the model's alphabet become spaces
    and whitespace runs collapse; a transcript with nothing left raises ValueError
    naming the alphabet, and an empty one gives ``[]``. Raises ValueError when the
    transcript needs more output frames than the audio has."""
    from .ops.forced_align import ctc_forced_align, word_spans_from_alignment

    text = transcript.lower()
    allowed = set(backend.codec.allowed_characters)
    if any(c not in allowed for c in text):
        text = "".join(c if c in allowed else " " for c in text)
        if " " in allowed:
            text = " ".join(text.split())
        else:
            text = text.replace(" ", "")
    if not text:
        if transcript.strip():
            raise ValueError(
                "transcript has no characters in the model alphabet ({!r}); "
                "got {!r}".format(backend.codec.allowed_characters, transcript))
        return []
    tokens = backend.codec.encode(text)
    if not tokens:
        return []
    device = backend.device
    log_probs = backend.frame_log_probs(audio)
    starts, ends, scores = ctc_forced_align(
        torch.from_numpy(np.ascontiguousarray(log_probs[None], np.float32)).to(device),
        torch.tensor([log_probs.shape[0]], device=device),
        torch.tensor([tokens], dtype=torch.int32, device=device),
        torch.tensor([len(tokens)], device=device), blank=backend.blank_index)
    if float(scores[0]) <= -1e29:
        raise ValueError(
            "transcript cannot be aligned: {} labels need more than the "
            "{} output frames available".format(len(tokens), log_probs.shape[0]))
    return word_spans_from_alignment(backend.codec, tokens, starts[0].cpu().numpy(),
                                     ends[0].cpu().numpy(), backend.seconds_per_frame)


def grouped_padded_batches(audios: Sequence[np.ndarray], bucket_fn, batch_size: int,
                           pad_rows: bool = False):
    """Yield ``(indices, wavs, lengths)``: utterances grouped by sample bucket
    (``bucket_fn(num_samples)``), at most ``batch_size`` per group, zero-padded to
    ``(len(indices), bucket)`` float32 with int32 lengths; ``indices`` maps rows back.
    Unlike the JAX package's, a short group is not padded with empty rows unless
    ``pad_rows`` asks for it: there is no compiled program per batch shape to reuse, so
    they would be wasted work. ``pad_rows`` pads every group to ``batch_size`` rows, as
    JAX does, for a model whose results depend on the whole batch (``int8_compute``)."""
    by_bucket: dict = {}
    for index, audio in enumerate(audios):
        by_bucket.setdefault(bucket_fn(len(audio)), []).append(index)
    for bucket, indices in sorted(by_bucket.items()):
        for group_start in range(0, len(indices), batch_size):
            group = indices[group_start:group_start + batch_size]
            rows = batch_size if pad_rows else len(group)
            wavs = np.zeros((rows, bucket), dtype=np.float32)
            lengths = np.zeros(rows, dtype=np.int32)
            for row, index in enumerate(group):
                audio = audios[index]
                wavs[row, :len(audio)] = audio
                lengths[row] = len(audio)
            yield group, wavs, lengths


def split_long_audio(audio: np.ndarray, max_segment_s: float = 30.0,
                     min_silence_s: float = 0.25) -> List[np.ndarray]:
    """Split long audio into <= ``max_segment_s`` segments, cutting at the quietest
    window in the last third of each segment."""
    sample_rate = 16000
    max_samples = int(max_segment_s * sample_rate)
    if len(audio) <= max_samples:
        return [audio]
    window = int(min_silence_s * sample_rate)
    segments: List[np.ndarray] = []
    start = 0
    while start < len(audio):
        end = min(start + max_samples, len(audio))
        if end < len(audio):
            search_from = start + (2 * (end - start)) // 3
            tail = np.abs(audio[search_from:end])
            if len(tail) > window:
                energies = np.convolve(tail, np.ones(window), mode="valid")
                cut = search_from + int(np.argmin(energies)) + window // 2
                if cut > start + window:
                    end = cut
        segments.append(audio[start:end])
        start = end
    return segments
