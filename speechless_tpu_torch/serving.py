"""Inference for serving: a `Transcriber` over a wav2letter checkpoint (port of
`speechless_tpu/serving.py`).

A request runs features -> acoustic model -> log-softmax -> decode on one device, with
the batch grouped by length bucket as in the JAX package. With ``kenlm_directory`` the
decode is the word-LM-fused beam on the beam-step kernel (`ops/device_beam.py`), or with
``lexicon_constrained`` the plain batched beam kept on the LM's vocabulary; without,
greedy. ``max_decoded_length`` is the frame count: CTC emits at most one grapheme per
frame, so nothing is truncated. `transcribe_nbest` runs the plain batched beam's n-best
search (`ops/decode_beam.py`), `align_audio` the forced alignment of a known transcript
(`ops/forced_align.py`). ``quantize_weights`` serves every route from int8 weights, and
``int8_compute`` runs the big convs as int8 products too (`models/wav2letter.py`).
A request runs the tensor functions `_transcribe`, `_frame_log_probs` and
`_frame_tokens`, which take the model's weights as an argument: an export bundle
(`serving_export.py`) traces these same functions, so the two cannot drift.

Parallel serving (`parallel/`): with a ``mesh`` every rank holds the whole model and is
given the same requests, as every process of a JAX multi-controller program is; a
batched route (`transcribe_batch`, `frame_log_probs_batch`, `frame_tokens_batch`)
pads each group to ``batch_size`` rows, and each rank runs features, the model and the
decode on its data rank's rows, then the results are all-gathered in row order. The
single-utterance routes run whole on every rank. `transcribe_long_audio(
sequence_parallel=True)` splits one recording's time axis over the mesh's data ranks
(`parallel/sequence.py`) and decodes the gathered posteriors on every rank.
"""
import dataclasses
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.batching import DEFAULT_TIME_BUCKETS
from .features import audio_io
from .features.spectrogram import features_batch
from .models import wav2letter as w2l
from .ops.decode import greedy_decode
from .ops.decode_beam import beam_search_nbest
from .ops.device_beam import beam_search_decode_device
from .serving_host import (CHARSETS, align_audio, grouped_padded_batches,  # noqa: F401
                           split_long_audio, words_from_frame_tokens)
from .text.graphemes import CtcGraphemeCodec

# Requests pad to the smallest bucket of samples (feature-frame buckets * 128) that
# holds them, and past the last bucket to a multiple of 65536 samples, as the JAX
# Transcriber does.
_FALLBACK_MULTIPLE = 65536


class Transcriber:
    """Serve transcriptions from wav2letter parameters (the JAX package's layout)."""

    def __init__(self, config: w2l.Wav2LetterConfig, params: w2l.Params,
                 allowed_characters: List[str], *, device,
                 sample_buckets: Sequence[int] = tuple(b * 128 for b in DEFAULT_TIME_BUCKETS),
                 kenlm_directory: Optional[Path] = None,
                 beam_width: int = 25,
                 lm_weight: float = 0.8,
                 word_count_weight: float = 0.0,
                 valid_word_count_weight: float = 2.3,
                 prune_classes: Optional[int] = 8,
                 quantize_weights: bool = False,
                 int8_compute: bool = False,
                 lexicon_constrained: bool = False,
                 mesh=None):
        """``device``: where the model, the LM tables and every request run.
        ``kenlm_directory``: serve LM-fused beam transcriptions with the ARPA model in
        that directory (its tables live on ``device``). ``lexicon_constrained``:
        restrict that beam to vocabulary words (character extensions stay on the trie,
        spaces only end complete words); requires ``kenlm_directory``.

        ``quantize_weights``: serve from int8 per-channel weights (`models/quantize.py`),
        kept int8 on the device and dequantized in each forward. ``int8_compute``: also
        run the big convs as int8 products with per-tensor activation scales (implies
        ``quantize_weights``). Since that scale spans the whole batch, the batched
        routes then pad a short group with empty rows to ``batch_size``, as the JAX
        package does, so that a group gives JAX's results. Params already in the int8
        layout are served as they are.

        ``mesh``: data-parallel batched serving over a `parallel.mesh.make_mesh` mesh
        (see the module docstring): every rank calls the same routes with the same
        audio, and ``batch_size`` must divide over the mesh's data axis."""
        if lexicon_constrained and kenlm_directory is None:
            raise ValueError("lexicon_constrained requires kenlm_directory (the "
                             "vocabulary trie rides in the word LM)")
        if int8_compute:
            quantize_weights = True
            config = dataclasses.replace(config, int8_compute=True)
        if quantize_weights:
            from .models.quantize import quantize_params_int8

            params = quantize_params_int8(params)
        self.quantized = quantize_weights
        self.int8_compute = int8_compute
        self.lexicon_constrained = lexicon_constrained
        self.config = config
        self.device = torch.device(device)
        self.params = params  # the JAX layout, as served (what an export bundle writes)
        self.model = w2l.build_model(config, params, device=self.device)
        self.codec = CtcGraphemeCodec(allowed_characters)
        self.sample_buckets = tuple(sorted(sample_buckets))
        self.word_lm = None
        self._host_word_lm = None
        if kenlm_directory is not None:
            from .lm.device_lm import build_device_word_lm
            from .lm.ngram import load_language_model

            arpa = load_language_model(Path(kenlm_directory), prefer_native=False)
            if arpa is None:
                raise FileNotFoundError(
                    "No ARPA language model in {}".format(kenlm_directory))
            self._host_word_lm = build_device_word_lm(arpa, allowed_characters)
            self.word_lm = self._host_word_lm.to(self.device)
        self._word_lms = {self.device.type: self.word_lm}
        self.mesh = mesh
        self._decoder = dict(beam_width=beam_width, lm_weight=lm_weight,
                             word_count_weight=word_count_weight,
                             valid_word_count_weight=valid_word_count_weight,
                             prune_classes=prune_classes)

    @staticmethod
    def from_checkpoint(net_directory: Path, epoch: int, allowed_characters: List[str], *,
                        device, mel_frequency_count: int = 128,
                        kenlm_directory: Optional[Path] = None,
                        quantize_weights: bool = False,
                        int8_compute: bool = False,
                        lexicon_constrained: bool = False,
                        **config_kwargs) -> "Transcriber":
        from .train.checkpoint import load_params

        config = w2l.Wav2LetterConfig(
            input_size_per_time_step=mel_frequency_count,
            grapheme_set_size=len(allowed_characters) + 1, **config_kwargs)
        return Transcriber(config, load_params(net_directory, epoch), allowed_characters,
                           device=device, kenlm_directory=kenlm_directory,
                           quantize_weights=quantize_weights, int8_compute=int8_compute,
                           lexicon_constrained=lexicon_constrained)

    @property
    def beam_width(self) -> int:
        """The decoder's beam width: also the upper bound for ``transcribe_nbest``."""
        return self._decoder["beam_width"]

    @property
    def blank_index(self) -> int:
        return self.config.grapheme_set_size - 1

    @property
    def samples_per_frame(self) -> int:
        """Input samples per output frame: the 128-sample hop times the stride ratio."""
        return 128 * self.config.input_to_prediction_length_ratio

    @property
    def seconds_per_frame(self) -> float:
        return self.samples_per_frame / 16000.0

    @property
    def has_batched_programs(self) -> bool:
        """Whether `transcribe_batch` serves multi-utterance dispatches: always, for a
        live transcriber (the JAX CLI asks this of every backend)."""
        return True

    def _groups(self, audios: Sequence[np.ndarray], batch_size: int):
        return grouped_padded_batches(audios, self._bucket, batch_size,
                                      pad_rows=self.int8_compute or self.mesh is not None)

    def _data_rows(self, rows: int) -> slice:
        """This data rank's rows of a batched dispatch of ``rows`` (all of them without
        a mesh)."""
        if self.mesh is None:
            return slice(None)
        from .parallel.mesh import DATA_AXIS, axis_size, batch_rows

        if rows % axis_size(self.mesh, DATA_AXIS):
            raise ValueError(
                "batch size {} does not divide the mesh's data parallelism {}; pick a "
                "divisible batch_size for DP-sharded serving".format(
                    rows, axis_size(self.mesh, DATA_AXIS)))
        return batch_rows(self.mesh, rows)

    def _gather_rows(self, local: list) -> list:
        """Every data rank's per-row results, concatenated in row order."""
        if self.mesh is None:
            return local
        import torch.distributed as dist

        from .parallel.mesh import DATA_AXIS, axis_group, axis_size, collectives

        parts = [None] * axis_size(self.mesh, DATA_AXIS)
        collectives.events.append(("all_gather_object", DATA_AXIS, "served rows"))
        dist.all_gather_object(parts, local, group=axis_group(self.mesh, DATA_AXIS))
        return [row for part in parts for row in part]

    def _bucket(self, num_samples: int) -> int:
        for bucket in self.sample_buckets:
            if num_samples <= bucket:
                return bucket
        return -(-num_samples // _FALLBACK_MULTIPLE) * _FALLBACK_MULTIPLE

    def _padded(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        wavs = np.zeros((1, self._bucket(len(audio))), dtype=np.float32)
        wavs[0, :len(audio)] = audio
        return wavs, np.asarray([len(audio)], np.int32)

    @property
    def weights(self) -> dict:
        """The model's tensors by name: the weights argument of the tensor functions
        (`_frame_log_probs`), which an export takes as program inputs."""
        return {**dict(self.model.named_parameters()), **dict(self.model.named_buffers())}

    def word_lm_on(self, device: torch.device):
        """The word LM's tables on ``device``'s type (None without an LM): the
        transcriber's own on its device, a copy made once on another (an export for
        another platform)."""
        if device.type not in self._word_lms:
            self._word_lms[device.type] = self._host_word_lm.to(device)
        return self._word_lms[device.type]

    def _frame_log_probs(self, weights: dict, wavs: torch.Tensor, lengths: torch.Tensor):
        """Features -> model -> log-softmax on the inputs' device: ``(log_probs (B, T,
        C), valid frames (B,))``. ``weights`` are the model's tensors by name
        (`self.weights`, or an export's program inputs)."""
        features, frame_counts = features_batch(wavs, lengths)
        logits = torch.func.functional_call(self.model, weights, (features,))
        return (torch.log_softmax(logits, dim=-1),
                w2l.prediction_lengths(self.config, frame_counts))

    def _frame_tokens(self, weights: dict, wavs: torch.Tensor, lengths: torch.Tensor):
        """Per-frame argmax tokens ``(B, T) int32`` (uncollapsed) and valid frames."""
        log_probs, counts = self._frame_log_probs(weights, wavs, lengths)
        return log_probs.argmax(dim=-1).to(torch.int32), counts

    def _decode(self, log_probs: torch.Tensor, counts: torch.Tensor):
        """``(tokens (B, T) int32, counts (B,), confidence (B,))`` from log posteriors:
        the word-LM beam (`ops/device_beam.py`) or greedy. The confidence is the mean
        per-frame max posterior over the real frames."""
        in_range = torch.arange(log_probs.shape[1], device=log_probs.device)[None, :] \
            < counts[:, None]
        frame_max = torch.exp(log_probs.max(dim=-1).values)
        confidence = (torch.where(in_range, frame_max, 0.0).sum(dim=1)
                      / torch.clamp(counts, min=1))
        if self.word_lm is not None:
            tokens, counts = beam_search_decode_device(
                log_probs, counts, blank=self.blank_index,
                word_lm=self.word_lm_on(log_probs.device),
                lexicon_constrained=self.lexicon_constrained,
                max_decoded_length=log_probs.shape[1], **self._decoder)
        else:
            tokens, counts = greedy_decode(log_probs, counts, self.blank_index)
        return tokens, counts, confidence

    def _transcribe(self, weights: dict, wavs: torch.Tensor, lengths: torch.Tensor):
        """The whole request as one tensor function, ``(weights, wavs (B, S), lengths
        (B,)) -> (tokens, counts, confidence)``: what an export bundle's programs hold
        and `_transcribe_rows` runs."""
        return self._decode(*self._frame_log_probs(weights, wavs, lengths))

    def _log_probs(self, wavs: np.ndarray, lengths: np.ndarray):
        """`_frame_log_probs` of a host batch with this transcriber's weights."""
        return self._frame_log_probs(self.weights, torch.from_numpy(wavs).to(self.device),
                                     torch.from_numpy(lengths).to(self.device))

    @torch.inference_mode()
    def _transcribe_rows(self, wavs: np.ndarray, lengths: np.ndarray,
                         batched: bool = False) -> List[Tuple[str, float]]:
        """``(text, confidence)`` per row; a ``batched`` dispatch under a mesh runs this
        data rank's rows and gathers the others'."""
        rows = self._data_rows(len(wavs)) if batched else slice(None)
        tokens, counts, confidence = self._decode(*self._log_probs(wavs[rows],
                                                                   lengths[rows]))
        tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
        results = [(self.codec.decode_graphemes(tokens[row, :int(counts[row])].tolist(),
                                                merge_repeated=False), float(score))
                   for row, score in enumerate(confidence.cpu().numpy())]
        return self._gather_rows(results) if batched else results

    def transcribe_audio(self, audio: np.ndarray) -> str:
        """Transcribe a mono 16 kHz float32 waveform."""
        return self.transcribe_audio_with_confidence(audio)[0]

    def transcribe_audio_with_confidence(self, audio: np.ndarray) -> Tuple[str, float]:
        """``(text, confidence)``; confidence is the mean per-frame max posterior."""
        return self._transcribe_rows(*self._padded(audio))[0]

    def transcribe_file(self, path: Path, sample_rate: int = 16000) -> str:
        """Transcribe a wav or FLAC file (decoded, downmixed and resampled to
        ``sample_rate``)."""
        return self.transcribe_audio(audio_io.load_audio(path, sample_rate))

    def transcribe_audio_with_timestamps(self, audio: np.ndarray
                                         ) -> List[Tuple[str, float, float]]:
        """Word timestamps ``[(word, start_s, end_s), ...]`` from the greedy frame
        decisions: each word spans its first to last non-blank emission."""
        return words_from_frame_tokens(self.frame_tokens(audio), self.codec,
                                       self.blank_index, self.seconds_per_frame)

    def transcribe_batch(self, audios: Sequence[np.ndarray],
                         batch_size: int = 16) -> List[Tuple[str, float]]:
        """Transcribe many waveforms, ``batch_size`` per dispatch within each length
        bucket. Returns ``(text, confidence)`` per input, in input order."""
        results: List[Optional[Tuple[str, float]]] = [None] * len(audios)
        for group, wavs, lengths in self._groups(audios, batch_size):
            for index, result in zip(group, self._transcribe_rows(wavs, lengths,
                                                                  batched=True)):
                results[index] = result
        return results

    @torch.inference_mode()
    def frame_log_probs(self, audio: np.ndarray) -> np.ndarray:
        """Per-frame log posteriors ``(frames, classes)`` for ``audio`` (uncollapsed)."""
        log_probs, counts = self._log_probs(*self._padded(audio))
        return log_probs[0, :int(counts[0])].cpu().numpy()

    def frame_tokens(self, audio: np.ndarray) -> np.ndarray:
        """Per-frame argmax grapheme indices (uncollapsed) for ``audio``."""
        return self.frame_log_probs(audio).argmax(axis=-1)

    @torch.inference_mode()
    def frame_log_probs_batch(self, audios: Sequence[np.ndarray],
                              batch_size: int = 16) -> List[np.ndarray]:
        """Per-frame log posteriors for many windows, ``batch_size`` per dispatch within
        each length bucket (the multi-stream streaming path), grouped as
        `transcribe_batch` groups. One trimmed ``(frames, classes)`` array per input, in
        input order."""
        results: List[Optional[np.ndarray]] = [None] * len(audios)
        for group, wavs, lengths in self._groups(audios, batch_size):
            rows = self._data_rows(len(wavs))
            log_probs, counts = self._log_probs(wavs[rows], lengths[rows])
            log_probs, counts = log_probs.cpu().numpy(), counts.cpu().numpy()
            trimmed = self._gather_rows([log_probs[row, :int(counts[row])]
                                         for row in range(len(counts))])
            for row, index in enumerate(group):
                results[index] = trimmed[row]
        return results

    def frame_tokens_batch(self, audios: Sequence[np.ndarray],
                           batch_size: int = 16) -> List[np.ndarray]:
        """Uncollapsed per-frame argmax tokens for many windows in batched dispatches;
        one trimmed frame array per input, in input order."""
        return [log_probs.argmax(axis=-1)
                for log_probs in self.frame_log_probs_batch(audios, batch_size)]

    @property
    def supports_posteriors(self) -> bool:
        """This backend serves per-frame posteriors (the predicate the streaming pools
        ask before opening beam-partial sessions)."""
        return True

    def warm_up(self, durations_s: Optional[Sequence[float]] = None) -> None:
        """Run every sample bucket once (or the given durations) before serving, so
        the first requests pay no kernel build or allocator growth."""
        lengths = ([int(d * 16000) for d in durations_s] if durations_s is not None
                   else list(self.sample_buckets))
        for length in lengths:
            self.transcribe_audio(np.zeros(length, np.float32))

    def transcribe_long_audio(self, audio: np.ndarray, max_segment_s: float = 30.0,
                              min_silence_s: float = 0.25,
                              sequence_parallel: bool = False, mesh=None) -> str:
        """Transcribe arbitrarily long audio: by default segmented at its quietest
        windows, each segment transcribed alone and the texts joined.

        ``sequence_parallel=True`` (or an explicit ``mesh``): the whole recording at
        once, its time axis split over the mesh's data ranks (`parallel/sequence.py`),
        no segmentation. The recording is padded to a multiple of
        ``_SP_BUCKET_SAMPLES`` (30 s), then features, the split forward, the gathered
        log-probs, and the decode on every rank: the word-LM beam with the frame count
        as its length cap, or greedy without an LM. ``mesh`` defaults to a
        data-parallel mesh over the world (one process: the plain forward). Every rank
        calls it with the same audio."""
        if sequence_parallel or mesh is not None:
            return self._transcribe_long_sequence_parallel(audio, mesh)
        texts = [self.transcribe_audio(segment) for segment in
                 split_long_audio(audio, max_segment_s, min_silence_s)]
        return " ".join(text for text in texts if text)

    _SP_BUCKET_SAMPLES = 30 * 16000  # long-form recordings pad to 30 s multiples

    @torch.inference_mode()
    def _transcribe_long_sequence_parallel(self, audio: np.ndarray, mesh=None) -> str:
        from .parallel.mesh import world_mesh
        from .parallel.sequence import sequence_parallel_log_probs

        if mesh is None:
            mesh = world_mesh(self.device.type)
        length = len(audio)
        bucket = max(self._SP_BUCKET_SAMPLES,
                     -(-length // self._SP_BUCKET_SAMPLES) * self._SP_BUCKET_SAMPLES)
        wav = torch.zeros((1, bucket), dtype=torch.float32)
        wav[0, :length] = torch.from_numpy(np.asarray(audio, np.float32))
        features, frame_counts = features_batch(
            wav.to(self.device), torch.tensor([length], dtype=torch.int32,
                                              device=self.device))
        if mesh is None:
            log_probs = torch.log_softmax(self.model(features), dim=-1)
        else:
            log_probs = sequence_parallel_log_probs(self.model, features, mesh)
        counts = w2l.prediction_lengths(self.config, frame_counts)
        if self.word_lm is not None:
            tokens, counts = beam_search_decode_device(
                log_probs, counts, blank=self.blank_index,
                word_lm=self.word_lm_on(log_probs.device),
                lexicon_constrained=self.lexicon_constrained,
                max_decoded_length=log_probs.shape[1], **self._decoder)
        else:
            tokens, counts = greedy_decode(log_probs, counts, self.blank_index)
        tokens = tokens[0, :int(counts[0])].cpu().numpy()
        return self.codec.decode_graphemes(tokens.tolist(), merge_repeated=False)

    @torch.inference_mode()
    def transcribe_nbest(self, audio: np.ndarray, nbest: int = 5
                         ) -> List[Tuple[str, float]]:
        """The ``nbest`` most probable transcriptions with their total path scores
        (acoustic log prob + weighted LM terms when serving with a language model),
        descending. Runs the plain batched beam's n-best search on the one padded
        utterance, with its default cap of 256 graphemes, as the JAX package's n-best
        program does. Returns up to ``nbest`` ``(text, score)`` pairs: fewer when the
        search holds fewer live prefixes (very short audio)."""
        log_probs, logit_lengths = self._log_probs(*self._padded(audio))
        decoder = self._decoder
        tokens, counts, scores = beam_search_nbest(
            log_probs, logit_lengths, blank=self.blank_index, nbest=nbest,
            beam_width=decoder["beam_width"], word_lm=self.word_lm,
            lm_weight=decoder["lm_weight"] if self.word_lm is not None else 0.0,
            word_count_weight=decoder["word_count_weight"],
            valid_word_count_weight=decoder["valid_word_count_weight"],
            prune_classes=decoder["prune_classes"],
            lexicon_constrained=self.lexicon_constrained)
        tokens, counts, scores = (x[0].cpu().numpy() for x in (tokens, counts, scores))
        hypotheses, seen_texts = [], set()
        for i in range(tokens.shape[0]):
            if scores[i] <= -1e29:
                continue  # a dead beam: fewer live prefixes than asked for
            text = self.codec.decode_graphemes(tokens[i, :int(counts[i])].tolist(),
                                               merge_repeated=False)
            # Beams are distinct prefixes (hash merge); this guards 32-bit collisions.
            if text not in seen_texts:
                seen_texts.add(text)
                hypotheses.append((text, float(scores[i])))
        return hypotheses

    def align_audio(self, audio: np.ndarray, transcript: str) -> List[dict]:
        """Forced alignment: word timestamps ``[{"word", "start_s", "end_s"}, ...]``
        for a known transcript (the module function `align_audio`, on this
        transcriber's device). Raises ValueError when the transcript cannot be
        aligned."""
        return align_audio(self, audio, transcript)

    def measure_latency(self, duration_s: float = 4.0, iterations: int = 20
                        ) -> Tuple[float, float]:
        """``(p50, p95)`` seconds of a single-utterance `transcribe_audio` request on
        seeded audio (``RandomState(0)``), after one untimed call. Each timed call ends
        with its result on the host, so it covers the device's work."""
        audio = (0.1 * np.random.RandomState(0).randn(int(duration_s * 16000))
                 ).astype(np.float32)
        self.transcribe_audio(audio)
        times = []
        for _ in range(iterations):
            start = time.perf_counter()
            self.transcribe_audio(audio)
            times.append(time.perf_counter() - start)
        return float(np.percentile(times, 50)), float(np.percentile(times, 95))
