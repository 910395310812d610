"""Export bundles: serialized `torch.export` serving programs and the weights (port of
`speechless_tpu/serving_export.py`).

`export_transcriber` traces the live `serving.Transcriber`'s tensor functions (features
-> acoustic model -> log-softmax -> greedy or word-LM beam decode, one program per
length bucket and batch size) with `torch.export` and writes each program, the weights
and a JSON manifest to a directory. `ExportedTranscriber` replays them with no model
code: it imports neither the model, nor the features, nor the decoders, nor the
`Transcriber`, only the custom operators of the port's kernels (`ops/library.py`), which
a program calls, so a serving fleet can pin a bundle while the training code moves on.
An LM-fused program launches the span kernel and the backtrace kernel, as the live path
does.

The weights are program inputs, as the JAX package's programs take ``params``: each
program file holds the graph and its constants (the DFT and mel matrices, the word
LM's tables), and the weights are written once, in the checkpoint format of
`train/checkpoint.py` (the JAX layout, readable by either package). The manifest maps
each program input to its checkpoint layer and key (`models/wav2letter.py::
jax_layout_sources`), so the loader rebuilds the inputs without the model.

A traced program bakes in its device (tensors made inside the functions, the LM's
tables), so a bundle holds one file per program and platform, ``cuda`` or ``cpu``:
loading on another platform raises. The TF32 flags are process state that no graph
records: the loader runs every program under `precision.ieee_fp32`, as the live path
runs its features and model.

Bundle layout::

    <dir>/manifest.json                          characters, buckets, platforms, format
    <dir>/weights-epoch0.npz                     the weights (checkpoint format)
    <dir>/program-<bucket>.<platform>.pt2        wavs (1, bucket) -> tokens, confidence
    <dir>/program-<bucket>-b<B>.<platform>.pt2   the same for B utterances
    <dir>/frames-<bucket>.<platform>.pt2         per-frame argmax tokens (streaming)
    <dir>/posteriors-<bucket>.<platform>.pt2     per-frame log posteriors (streaming)
    <dir>/feed.<platform>.pt2                    the device-stream pool's feed
"""
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .ops import library  # noqa: F401  (registers the operators the programs call)
from .precision import ieee_fp32
from .serving_host import grouped_padded_batches, split_long_audio
from .text.graphemes import CtcGraphemeCodec
from .utils.tools import log, mkdir

FORMAT_VERSION = 1
FORMAT = "torch.export"
PLATFORMS = ("cuda", "cpu")
_MANIFEST = "manifest.json"


class _Replayed:
    """A loaded program, called with TF32 off (`precision.ieee_fp32`): no graph records
    the flags, and the live path turns them off where it computes."""

    def __init__(self, module):
        self.module = module

    def __call__(self, *args):
        with ieee_fp32():
            return self.module(*args)


class _Program(torch.nn.Module):
    """A tensor function as the module `torch.export` traces."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


def export_program(fn, args: tuple, path: Path, dynamic: Optional[tuple] = None) -> int:
    """Trace ``fn(*args)`` with `torch.export` (no autograd, TF32 off; ``dynamic``: the
    dynamic dimensions of each argument) and save the program to ``path``, without its
    example inputs (the weights among them); returns its size in bytes."""
    with torch.no_grad(), ieee_fp32():
        exported = torch.export.export(_Program(fn), args, dynamic_shapes=(
            None if dynamic is None else (dynamic,)))
    exported.example_inputs = None
    torch.export.save(exported, str(path))
    return path.stat().st_size


def _check_platforms(platforms: Sequence[str]) -> tuple:
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError("platforms must be among {} (a torch.export program bakes in "
                         "its device), got {}".format(", ".join(PLATFORMS),
                                                      list(platforms)))
    return platforms


def export_transcriber(transcriber, directory: Path,
                       platforms: Optional[Sequence[str]] = None,
                       sample_buckets: Optional[Sequence[int]] = None,
                       batch_sizes: Sequence[int] = (1,),
                       streaming: bool = False,
                       device_streaming: Optional[dict] = None) -> Path:
    """Write an export bundle for ``transcriber`` (a `serving.Transcriber`).

    ``platforms``: ``("cuda",)``, ``("cpu",)`` or both (default: the transcriber's
    device type); a program is traced on each platform's device, so a ``cuda`` bundle
    is exported on the card. ``sample_buckets`` defaults to the transcriber's own
    buckets; pass a subset to bound the bundle's size.

    ``batch_sizes``: also export batched programs, one per (bucket, B) pair with
    B > 1, for `ExportedTranscriber.transcribe_batch`; must include 1.

    ``streaming``: also export the per-frame argmax and log-posterior programs
    (``frame_tokens``, ``frame_log_probs``), for streaming sessions, beam partials and
    forced alignment on the bundle.

    ``device_streaming``: a (possibly empty) dict of
    `serving_device_stream.export_feed_program` arguments (``window_s``,
    ``chunk_cap_s``, ``max_sessions``, ``max_batch``, ``posteriors``, ``post_rows``):
    exports the device-resident pool's feed, whose dimensions are baked into its
    shapes and recorded in the manifest; None skips it."""
    from .models.wav2letter import jax_layout_sources
    from .train.checkpoint import save_checkpoint

    platforms = _check_platforms(platforms or (transcriber.device.type,))
    directory = Path(directory)
    buckets = tuple(sorted(sample_buckets or transcriber.sample_buckets))
    unknown = set(buckets) - set(transcriber.sample_buckets)
    if unknown:
        raise ValueError("sample_buckets {} are not buckets of this transcriber ({})"
                         .format(sorted(unknown), transcriber.sample_buckets))
    batch_sizes = tuple(sorted(set(batch_sizes)))
    if any(b < 1 for b in batch_sizes) or 1 not in batch_sizes:
        raise ValueError("batch_sizes must be positive and include 1 (the "
                         "single-utterance programs); got {}".format(batch_sizes))
    sources = jax_layout_sources(transcriber.params)
    if list(sources) != list(transcriber.weights):
        raise ValueError("the transcriber's weights {} are not its params' layout {}"
                         .format(list(transcriber.weights), list(sources)))
    mkdir(directory)
    feed_spec = None
    for platform in platforms:
        device = torch.device(platform)
        weights = {name: tensor.detach().to(device)
                   for name, tensor in transcriber.weights.items()}
        transcriber.word_lm_on(device)  # the tables exist before the trace reads them
        for bucket in buckets:
            for batch in batch_sizes:
                name = "program-{}{}".format(bucket, "-b{}".format(batch) if batch > 1
                                             else "")
                size = export_program(
                    transcriber._transcribe,
                    (weights, torch.zeros((batch, bucket), device=device),
                     torch.full((batch,), bucket, dtype=torch.int32, device=device)),
                    directory / "{}.{}.pt2".format(name, platform))
                log("exported bucket {} batch {} for {} ({} KiB)".format(
                    bucket, batch, platform, size // 1024))
            if streaming:
                # Per-frame argmax tokens (streaming sessions, timestamps) and log
                # posteriors (forced alignment, beam partials).
                example = (weights, torch.zeros((1, bucket), device=device),
                           torch.full((1,), bucket, dtype=torch.int32, device=device))
                for name, fn in (("frames", transcriber._frame_tokens),
                                 ("posteriors", transcriber._frame_log_probs)):
                    export_program(fn, example, directory / "{}-{}.{}.pt2".format(
                        name, bucket, platform))
        if device_streaming is not None:
            from .serving_device_stream import export_feed_program

            fn, args, dynamic, feed_spec = export_feed_program(
                transcriber, device=device, **device_streaming)
            size = export_program(fn, (weights,) + args,
                                  directory / "feed.{}.pt2".format(platform),
                                  dynamic=({name: None for name in weights},) + dynamic)
            log("exported device-stream feed program for {} (window={} max_sessions={}, "
                "{} KiB)".format(platform, feed_spec["window"], feed_spec["max_sessions"],
                                 size // 1024))

    save_checkpoint(directory, epoch=0, params=transcriber.params)
    (directory / _MANIFEST).write_text(json.dumps({
        "format_version": FORMAT_VERSION,
        "format": FORMAT,
        "allowed_characters": list(transcriber.codec.allowed_characters),
        "sample_buckets": list(buckets),
        "batch_sizes": list(batch_sizes),
        "platforms": list(platforms),
        "lm_fused": transcriber.word_lm is not None,
        "quantized": bool(transcriber.quantized),
        "streaming": bool(streaming),
        "streaming_posteriors": bool(streaming),
        "device_streaming": feed_spec,
        "samples_per_frame": transcriber.samples_per_frame,
        "blank_index": transcriber.blank_index,
        "weights": {name: [layer, key, list(axes) if axes else None]
                    for name, (layer, key, axes) in sources.items()},
    }, indent=2))
    return directory


class ExportedTranscriber:
    """Serve from an export bundle with no model code, on ``device`` (default the
    card; ``"cpu"`` for a bundle exported for the CPU).

    The surface of `serving.Transcriber` that a bundle can serve: every call pads to an
    exported bucket and runs one replayed program."""

    def __init__(self, directory: Path, device="cuda:0"):
        from .train.checkpoint import load_params

        directory = Path(directory)
        manifest = json.loads((directory / _MANIFEST).read_text())
        if manifest["format_version"] > FORMAT_VERSION:
            raise ValueError("bundle format {} is newer than this loader ({})"
                             .format(manifest["format_version"], FORMAT_VERSION))
        if manifest.get("format") != FORMAT:
            raise ValueError(
                "{} is not a torch.export bundle (its manifest names no format {!r}): a "
                "JAX package bundle of StableHLO programs does not load here; export "
                "one with `python -m speechless_tpu_torch export`".format(directory,
                                                                         FORMAT))
        self.device = torch.device(device)
        platform = self.device.type
        if platform not in manifest["platforms"]:
            raise ValueError("bundle exported for platforms {}, not {}: re-export with "
                             "platforms including {!r}".format(manifest["platforms"],
                                                               platform, platform))
        self.manifest = manifest
        self.codec = CtcGraphemeCodec(list(manifest["allowed_characters"]))
        self.sample_buckets = tuple(manifest["sample_buckets"])
        self.batch_sizes = tuple(manifest.get("batch_sizes", [1]))
        params = load_params(directory, epoch=0)
        self.weights = {
            name: torch.from_numpy(np.ascontiguousarray(
                np.asarray(params[layer][key]).transpose(axes) if axes
                else np.asarray(params[layer][key]))).to(self.device)
            for name, (layer, key, axes) in manifest["weights"].items()}

        def load(name: str):
            return _Replayed(torch.export.load(
                str(directory / "{}.{}.pt2".format(name, platform))).module())

        self._programs = {bucket: load("program-{}".format(bucket))
                          for bucket in self.sample_buckets}
        self._batch_programs = {
            (bucket, batch): load("program-{}-b{}".format(bucket, batch))
            for bucket in self.sample_buckets for batch in self.batch_sizes if batch > 1}
        self._frame_programs = {bucket: load("frames-{}".format(bucket))
                                for bucket in self.sample_buckets
                                } if manifest.get("streaming") else {}
        self._posterior_programs = {bucket: load("posteriors-{}".format(bucket))
                                    for bucket in self.sample_buckets
                                    } if manifest.get("streaming_posteriors") else {}
        # Device-resident streaming (`serving_device_stream.DeviceStreamingPool` reads
        # these two attributes): the feed program and the pool dimensions baked into it.
        self.device_feed_spec = manifest.get("device_streaming")
        self.device_feed_program = load("feed") if self.device_feed_spec else None

    @property
    def supports_posteriors(self) -> bool:
        """Whether `frame_log_probs` is servable: bundles exported without
        ``streaming=True`` hold no posterior programs. The predicate the streaming
        pools and ``align`` ask."""
        return bool(self._posterior_programs)

    @property
    def samples_per_frame(self) -> int:
        return self.manifest["samples_per_frame"]

    @property
    def blank_index(self) -> int:
        return self.manifest["blank_index"]

    @property
    def seconds_per_frame(self) -> float:
        """Duration of one output frame at 16 kHz."""
        return self.samples_per_frame / 16000.0

    @property
    def has_batched_programs(self) -> bool:
        """Whether `transcribe_batch` can run: a bundle carries only the batch sizes it
        was exported with."""
        return any(batch > 1 for batch in self.batch_sizes)

    def replay(self, program, wavs: np.ndarray, lengths: np.ndarray):
        """One program on a host batch ``(B, bucket)`` float32, ``(B,)`` int32, on this
        bundle's device with TF32 off, in inference mode as the live path runs; returns
        the program's device tensors."""
        with torch.inference_mode():
            return program(self.weights, torch.from_numpy(wavs).to(self.device),
                           torch.from_numpy(lengths).to(self.device))

    def _bucket(self, length: int, hint: str = "") -> int:
        bucket = next((b for b in self.sample_buckets if length <= b), None)
        if bucket is None:
            raise ValueError("audio of {} samples exceeds the largest exported bucket "
                             "({}){}".format(length, self.sample_buckets[-1], hint))
        return bucket

    def _single(self, programs, audio: np.ndarray, hint: str = ""):
        bucket = self._bucket(len(audio), hint)
        wavs = np.zeros((1, bucket), np.float32)
        wavs[0, :len(audio)] = audio
        return self.replay(programs[bucket], wavs, np.asarray([len(audio)], np.int32))

    def transcribe_audio(self, audio: np.ndarray) -> str:
        """Transcribe a mono 16 kHz float32 waveform."""
        return self.transcribe_audio_with_confidence(audio)[0]

    def transcribe_audio_with_confidence(self, audio: np.ndarray):
        """``(text, confidence)``, as `serving.Transcriber.transcribe_audio_with_
        confidence`. Unlike the live transcriber, a bundle holds only its exported
        buckets: longer audio raises."""
        tokens, counts, confidence = self._single(
            self._programs, audio, "; re-export with a larger sample_buckets entry or "
                                   "segment the audio")
        tokens = tokens[0, :int(counts[0])].cpu().numpy()
        return (self.codec.decode_graphemes(tokens.tolist(), merge_repeated=False),
                float(confidence[0]))

    def transcribe_file(self, path: Path, sample_rate: int = 16000) -> str:
        from .features import audio_io

        return self.transcribe_audio(audio_io.load_audio(path, sample_rate))

    def transcribe_long_audio(self, audio: np.ndarray, max_segment_s: float = 30.0,
                              min_silence_s: float = 0.25) -> str:
        """Long-form transcription: the live transcriber's silence segmentation, with
        segments also capped at the largest exported bucket."""
        max_segment_s = min(max_segment_s, self.sample_buckets[-1] / 16000.0)
        texts = [self.transcribe_audio(segment) for segment in
                 split_long_audio(audio, max_segment_s, min_silence_s)]
        return " ".join(text for text in texts if text)

    def frame_tokens(self, audio: np.ndarray) -> np.ndarray:
        """Per-frame argmax tokens (uncollapsed) from the streaming programs."""
        if not self._frame_programs:
            raise ValueError("bundle has no streaming programs; re-export with "
                             "streaming=True")
        frames, counts = self._single(self._frame_programs, audio)
        return frames[0, :int(counts[0])].cpu().numpy()

    def frame_log_probs(self, audio: np.ndarray) -> np.ndarray:
        """Per-frame log posteriors ``(frames, classes)``, as `serving.Transcriber.
        frame_log_probs`: forced alignment and beam partials on a bundle."""
        if not self._posterior_programs:
            raise ValueError("bundle has no posterior programs; re-export with "
                             "streaming=True")
        log_probs, counts = self._single(self._posterior_programs, audio)
        return log_probs[0, :int(counts[0])].cpu().numpy()

    def align_audio(self, audio: np.ndarray, transcript: str) -> List[dict]:
        """Forced alignment of a known transcript (`serving_host.align_audio`) over the
        bundle's posteriors."""
        from .serving_host import align_audio

        return align_audio(self, audio, transcript)

    def transcribe_batch(self, audios: Sequence[np.ndarray]):
        """``(text, confidence)`` per input, in input order, from the batched programs:
        utterances grouped by bucket, the largest exported batch size per dispatch,
        short groups padded with empty rows to it."""
        batched = [b for b in self.batch_sizes if b > 1]
        if not batched:
            raise ValueError("bundle has no batched programs; re-export with "
                             "batch_sizes=(1, N)")
        batch_size = max(batched)
        results: List[Optional[tuple]] = [None] * len(audios)
        for group, wavs, lengths in grouped_padded_batches(audios, self._bucket,
                                                           batch_size, pad_rows=True):
            tokens, counts, confidences = self.replay(
                self._batch_programs[(wavs.shape[1], batch_size)], wavs, lengths)
            tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
            confidences = confidences.cpu().numpy()
            for row, index in enumerate(group):
                text = self.codec.decode_graphemes(
                    tokens[row, :int(counts[row])].tolist(), merge_repeated=False)
                results[index] = (text, float(confidences[row]))
        return results
