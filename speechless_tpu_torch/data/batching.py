"""Batch generation (port of `speechless_tpu/data/batching.py`): reference-compatible
random batching, static-shape bucketing and a background prefetch thread.

* `LabeledSpectrogramBatchGenerator` keeps the reference surface (preview, training and
  test batches, a multiprocessing cache fill);
* `pad_to_bucket` rounds the padded time dimension up to a small set of bucket
  boundaries and the label length to a multiple, so that a run sees few shapes (cuDNN
  picks its algorithms once per shape);
* `Prefetcher` overlaps the host's feature loading and padding (and, in the facade, the
  host-to-device copies) with device compute.

* `ShardedBatchGenerator` feeds one rank of a multi-process run: every rank draws the
  same global batch and keeps its data rank's slice, with the global batch's bucket
  hints (`HintedBatch`), so that all ranks pad to the same shapes.

The module imports no torch when it is imported: the cache-fill workers, which are
spawned and import this module for their task, load only the numpy feature path.
`Batch` comes from `train/trainer.py` inside the functions that build one.
"""
from __future__ import annotations

import itertools
import multiprocessing
import random
import threading
from pathlib import Path
from queue import Empty, Full, Queue
from typing import TYPE_CHECKING, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..features.example import CachedLabeledSpectrogram, LabeledSpectrogram
from ..text.graphemes import GraphemeCodec
from ..utils.tools import log, mkdir, paginate

if TYPE_CHECKING:
    from ..train.trainer import Batch

# Time buckets in frames: a geometric ~1.3x progression keeps padding waste under ~15 %
# per batch while bounding the distinct shapes. Frame counts above the last bucket round
# up to a multiple of 512.
DEFAULT_TIME_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 3072, 4096)
LABEL_BUCKET_MULTIPLE = 64
# Cache-fill worker processes at most: each is a spawned interpreter, and a host with
# very many cores gains nothing from more than this.
MAX_CACHE_WORKERS = 16


def _cache_spectrogram(labeled_spectrogram: CachedLabeledSpectrogram) -> None:
    labeled_spectrogram.z_normalized_transposed_spectrogram()


def _repair_spectrogram(labeled_spectrogram: CachedLabeledSpectrogram) -> None:
    labeled_spectrogram.repair_cached_file_if_incorrect()


class LabeledSpectrogramBatchGenerator:
    """Reference-compatible batch source over disk-cached spectrograms.

    ``bucket_training_batches=True`` draws each training batch from one duration bucket
    (near-equal-population contiguous ranges of sorted durations) instead of uniformly
    from the whole corpus: every example keeps the same marginal sampling probability,
    but a batch of like-length utterances pads to its own bucket's time boundary.
    Training batches draw from the global `random` in the JAX package's order, so that
    ``random.seed(n)`` before either package trains gives both the same batches.
    """

    def __init__(self, corpus, spectrogram_cache_directory: Path, batch_size: int = 64,
                 bucket_training_batches: bool = False):
        mkdir(spectrogram_cache_directory)
        self.batch_size = batch_size
        self.bucket_training_batches = bucket_training_batches
        self.spectrogram_cache_directory = Path(spectrogram_cache_directory)
        self.labeled_training_spectrograms = [
            CachedLabeledSpectrogram(e, spectrogram_cache_directory=spectrogram_cache_directory)
            for e in corpus.training_examples]
        self.labeled_test_spectrograms = [
            CachedLabeledSpectrogram(e, spectrogram_cache_directory=spectrogram_cache_directory)
            for e in corpus.test_examples]
        self.labeled_spectrograms = (self.labeled_training_spectrograms +
                                     self.labeled_test_spectrograms)

    def preview_batch(self) -> List[LabeledSpectrogram]:
        return self.labeled_spectrograms[:self.batch_size]

    def _duration_buckets(self) -> List[List[LabeledSpectrogram]]:
        """Contiguous near-equal-population duration buckets, each >= 2x batch size."""
        def duration(s: CachedLabeledSpectrogram) -> float:
            probed = getattr(s.original, "duration_in_s", 0.0)
            return probed if probed > 0.0 else float("inf")  # failed probes: last bucket

        ordered = sorted(self.labeled_training_spectrograms, key=duration)
        bucket_count = max(1, min(8, len(ordered) // (2 * self.batch_size)))
        edges = np.linspace(0, len(ordered), bucket_count + 1).astype(int)
        return [ordered[edges[i]:edges[i + 1]] for i in range(bucket_count)]

    def training_batches(self) -> Iterator[List[LabeledSpectrogram]]:
        if not self.bucket_training_batches:
            while True:
                yield random.sample(self.labeled_training_spectrograms, self.batch_size)
        buckets = self._duration_buckets()
        weights = [len(bucket) for bucket in buckets]
        while True:
            bucket = random.choices(buckets, weights=weights)[0]
            yield random.sample(bucket, self.batch_size)

    def test_batches(self) -> Iterable[List[LabeledSpectrogram]]:
        return paginate(self.labeled_test_spectrograms, self.batch_size)

    def fill_cache(self, repair_incorrect: bool = False) -> None:
        """Parallel feature precompute (the reference's `corpus.py:231-245`) in spawned
        worker processes, at most `MAX_CACHE_WORKERS` of them: the parent may hold a CUDA
        context and threads, which a fork must not copy, and a spawned worker imports
        only this module's numpy feature path."""
        total = len(self.labeled_spectrograms)
        not_yet_cached = [s for s in self.labeled_spectrograms if not s.is_cached()]
        to_calculate = self.labeled_spectrograms if repair_incorrect else not_yet_cached
        log("Filling cache with {} spectrograms: {} already cached, {} to calculate.".format(
            total, total - len(not_yet_cached), len(to_calculate)))
        if not to_calculate:
            return
        workers = max(1, min(multiprocessing.cpu_count(), MAX_CACHE_WORKERS,
                             len(to_calculate)))
        worker = _repair_spectrogram if repair_incorrect else _cache_spectrogram
        with multiprocessing.get_context("spawn").Pool(processes=workers) as pool:
            results = [pool.apply_async(worker, (s,)) for s in to_calculate]
            pool.close()
            pool.join()
            failures = sum(1 for r in results if not r.successful())
        if failures:
            log("Cache fill: {} examples failed.".format(failures))


class HintedBatch(list):
    """A batch slice carrying the global batch's bucket hints ``(min_frames,
    min_label_length)``, which `batch_from_spectrograms` consumes so that every rank
    pads to the same shapes."""

    def __init__(self, items, bucket_hints):
        super().__init__(items)
        self.bucket_hints = bucket_hints


class ShardedBatchGenerator(LabeledSpectrogramBatchGenerator):
    """Per-rank input sharding for multi-process training.

    Every rank draws the same global batch per step (a `random.Random` seeded by the
    seed and the step) and keeps its data rank's disjoint slice, so the slices
    concatenate to the global batch whatever the rank count. ``training_batches``
    yields `HintedBatch`es whose bucket hints come from the global batch.
    ``host_id``/``host_count`` (JAX's names) are the data rank and the data
    parallelism: given, or else the rank and size of the initialized world, the data
    axis of the facade's default mesh. Under a mesh with a model axis they must be its
    data rank and size, so that the ranks of one model group take the same slice:
    `Configuration.train` passes the model's mesh.
    """

    def __init__(self, corpus, spectrogram_cache_directory: Path, batch_size: int = 64,
                 host_id: Optional[int] = None, host_count: Optional[int] = None,
                 seed: int = 42, bucket_training_batches: bool = False):
        super().__init__(corpus, spectrogram_cache_directory, batch_size,
                         bucket_training_batches=bucket_training_batches)
        if host_id is None or host_count is None:
            host_id, host_count = _world_rank_and_size()
        if batch_size % host_count != 0:
            raise ValueError("batch_size {} must divide evenly across {} hosts".format(
                batch_size, host_count))
        self.host_id = host_id
        self.host_count = host_count
        self.seed = seed

    def training_batches(self, hop_length: int = 128,
                         sample_rate: int = 16000) -> Iterator[HintedBatch]:
        """This rank's slice as a `HintedBatch` whose ``(min_frames,
        min_label_length)`` hints come from the global batch: frames from the duration
        probes (an upper bound, so only padding can differ), label lengths from the raw
        labels."""
        per_host = self.batch_size // self.host_count

        def frame_hint(s: CachedLabeledSpectrogram) -> int:
            duration = s.original.duration_in_s
            if duration <= 0.0:
                # A failed header probe reads 0.0 s; the exact feature length keeps the
                # ranks' buckets equal.
                return s.z_normalized_transposed_spectrogram().shape[0]
            return 1 + (int(duration * sample_rate) + hop_length) // hop_length

        # The bucket choice and the sample both come from the step's seeded generator,
        # and the buckets from the (identical) corpus, so the ranks stay consistent.
        buckets = self._duration_buckets() if self.bucket_training_batches else None
        weights = [len(bucket) for bucket in buckets] if buckets else None
        step = 0
        while True:
            rand = random.Random("{}:{}".format(self.seed, step))
            if buckets is not None:
                global_batch = rand.sample(rand.choices(buckets, weights=weights)[0],
                                           self.batch_size)
            else:
                global_batch = rand.sample(self.labeled_training_spectrograms,
                                           self.batch_size)
            min_frames = max(frame_hint(s) for s in global_batch)
            min_label_length = max(len(s.label) for s in global_batch)
            yield HintedBatch(
                global_batch[self.host_id * per_host:(self.host_id + 1) * per_host],
                (min_frames, min_label_length))
            step += 1


def _world_rank_and_size() -> Tuple[int, int]:
    """The rank and size of the initialized world (one process: 0 and 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def bucket_length(length: int, buckets: Sequence[int] = DEFAULT_TIME_BUCKETS,
                  fallback_multiple: int = 512) -> int:
    """Smallest bucket >= length; beyond the table, round up to a multiple."""
    for bucket in buckets:
        if length <= bucket:
            return bucket
    return ((length + fallback_multiple - 1) // fallback_multiple) * fallback_multiple


def pad_to_bucket(spectrograms: List[np.ndarray], labels: List[str], codec: GraphemeCodec,
                  time_buckets: Sequence[int] = DEFAULT_TIME_BUCKETS,
                  label_multiple: int = LABEL_BUCKET_MULTIPLE,
                  min_frames: int = 0, min_label_length: int = 0) -> Batch:
    """A statically shaped host `Batch` (numpy fields) from per-utterance (time, mel)
    features: features zero-padded to the time bucket, labels encoded and -1-padded to
    a multiple of ``label_multiple``. ``min_frames``/``min_label_length`` floor the
    bucket choice."""
    from ..train.trainer import Batch

    batch_size = len(spectrograms)
    input_lengths = np.array([s.shape[0] for s in spectrograms], dtype=np.int32)
    t_max = bucket_length(max(int(input_lengths.max()), min_frames), time_buckets)
    feature_dim = spectrograms[0].shape[1]
    inputs = np.zeros((batch_size, t_max, feature_dim), dtype=np.float32)
    for i, s in enumerate(spectrograms):
        inputs[i, : s.shape[0]] = s

    encoded = codec.encode_label_batch(labels)
    label_lengths = (encoded >= 0).sum(axis=1).astype(np.int32) if encoded.size \
        else np.zeros(batch_size, np.int32)
    label_extent = max(encoded.shape[1], min_label_length)
    u_max = max(((label_extent + label_multiple - 1) // label_multiple) * label_multiple,
                label_multiple)
    padded_labels = -np.ones((batch_size, u_max), dtype=np.int32)
    padded_labels[:, : encoded.shape[1]] = encoded

    return Batch(inputs=inputs, input_lengths=input_lengths,
                 labels=padded_labels, label_lengths=label_lengths)


# Raw-wave inputs bucket on sample counts: the frame buckets times the 128-sample feature
# hop, so that a corpus buckets alike whether fed as mel frames or as samples.
RAW_WAVE_SAMPLE_BUCKETS = tuple(b * 128 for b in DEFAULT_TIME_BUCKETS)


def batch_from_spectrograms(batch: List[LabeledSpectrogram], codec: GraphemeCodec,
                            raw_wave: bool = False, **kwargs) -> Tuple[Batch, List[str]]:
    """Load features for a list of `LabeledSpectrogram`s and bucket-pad them. Returns the
    host `Batch` and the expected transcripts. ``raw_wave=True`` feeds ``(samples, 1)``
    z-normalized waveforms on the sample-count buckets instead of mel frames (the
    ``use_raw_wave_input`` model family). A batch with ``bucket_hints`` ``(frames,
    labels)`` floors the buckets at them (frames times 128 for raw waves)."""
    hints = getattr(batch, "bucket_hints", None)
    if hints is not None:
        scale = 128 if raw_wave else 1
        kwargs.setdefault("min_frames", hints[0] * scale)
        kwargs.setdefault("min_label_length", hints[1])
    if raw_wave:
        kwargs.setdefault("time_buckets", RAW_WAVE_SAMPLE_BUCKETS)
        spectrograms = [s.z_normalized_raw_wave() for s in batch]
    else:
        spectrograms = [s.z_normalized_transposed_spectrogram() for s in batch]
    labels = [s.label for s in batch]
    return pad_to_bucket(spectrograms, labels, codec, **kwargs), labels


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """Stack host batches on a new leading steps axis (the input of
    `trainer.make_multi_step`). Batches may come from different buckets: features are
    zero-padded and labels -1-padded to the group's largest."""
    from ..train.trainer import Batch

    t_max = max(b.inputs.shape[1] for b in batches)
    u_max = max(b.labels.shape[1] for b in batches)

    def pad_inputs(b: Batch) -> np.ndarray:
        if b.inputs.shape[1] == t_max:
            return b.inputs
        padded = np.zeros((b.inputs.shape[0], t_max, b.inputs.shape[2]), b.inputs.dtype)
        padded[:, : b.inputs.shape[1]] = b.inputs
        return padded

    def pad_labels(b: Batch) -> np.ndarray:
        if b.labels.shape[1] == u_max:
            return b.labels
        padded = -np.ones((b.labels.shape[0], u_max), b.labels.dtype)
        padded[:, : b.labels.shape[1]] = b.labels
        return padded

    return Batch(inputs=np.stack([pad_inputs(b) for b in batches]),
                 input_lengths=np.stack([b.input_lengths for b in batches]),
                 labels=np.stack([pad_labels(b) for b in batches]),
                 label_lengths=np.stack([b.label_lengths for b in batches]))


def chunked(iterator: Iterator, size: int) -> Iterator[list]:
    """Group an iterator into lists of ``size`` (a trailing short group is dropped)."""
    while True:
        group = list(itertools.islice(iterator, size))
        if len(group) < size:
            return
        yield group


class Prefetcher:
    """Background-thread preparation of batches, ``depth`` ahead of the consumer.

    Close it (or use it as a context manager) when done: with an infinite source the
    worker would otherwise keep preparing and holding ``depth`` batches for the life of
    the process. An exception in ``prepare`` reaches the consumer."""

    def __init__(self, batch_iterator: Iterator, prepare, depth: int = 2):
        self._iterator = batch_iterator
        self._prepare = prepare
        self._queue: Queue = Queue(maxsize=depth)
        self._done = object()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._iterator:
                if self._stopped.is_set():
                    return
                prepared = self._prepare(item)
                while not self._stopped.is_set():
                    try:
                        self._queue.put(prepared, timeout=0.1)
                        break
                    except Full:
                        continue
                if self._stopped.is_set():
                    return
        except Exception as e:  # surface worker errors to the consumer
            self._queue.put(e)
        self._queue.put(self._done)

    def close(self):
        """Stop the worker and drop any buffered batches."""
        self._stopped.set()
        try:
            while True:
                self._queue.get_nowait()
        except Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item
