"""The device-resident training corpus (port of `speechless_tpu/data/device_dataset.py`):
the whole feature set lives in device memory and each step samples its batch there, so
an epoch copies no feature or label byte from the host.

* `pack_dataset` pads the corpus once on the host (numpy) into rectangular arrays with
  the host batcher's rules: features zero-padded to the bucket of the corpus's longest
  utterance (`batching.bucket_length`), labels -1-padded to a multiple of
  `LABEL_BUCKET_MULTIPLE`; bitwise the JAX package's packing;
* `build_device_dataset` loads every cached feature, packs it and copies it to the
  device once (features as fp16 when the model computes in bf16, half the bytes), after
  checking that it fits the device's free memory: a corpus that does not fit raises, and
  never falls back to the host pipeline. For the raw-wave model family it packs
  ``(samples, 1)`` z-normalized waveforms on the sample-count buckets instead (16 kHz
  audio is ~32 KB a second in fp16);
* `trainer.make_device_epoch_step` samples each step's rows on the device without
  replacement within the batch and gathers them with `index_select`.

The JAX package's mesh branch (corpus rows sharded over the data axis) waits for the
port's parallelism (ROADMAP.md, item 13). Nothing here imports torch at module level:
the cache-fill workers import this package and must stay free of CUDA state.
"""
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from ..features.example import LabeledSpectrogram
from ..text.graphemes import GraphemeCodec
from .batching import DEFAULT_TIME_BUCKETS, LABEL_BUCKET_MULTIPLE, bucket_length

# Headroom left free on the device beside the corpus: the model, its activations, the
# optimizer state and the allocator's slack at the published width and batch 64.
DEVICE_HEADROOM_BYTES = 8 << 30


class DeviceDataset(NamedTuple):
    """The corpus as rectangular arrays (the `trainer.Batch` fields with a corpus-sized
    leading axis): numpy after `pack_dataset`, tensors on one device after
    `build_device_dataset`."""
    inputs: object          # (N, T_max, F) features, fp32 (fp16 under bf16 compute)
    input_lengths: object   # (N,) int32 valid frame counts
    labels: object          # (N, U_max) int32, -1 padded
    label_lengths: object   # (N,) int32

    @property
    def example_count(self) -> int:
        return self.inputs.shape[0]

    def nbytes(self) -> int:
        return sum(field.nbytes if isinstance(field, np.ndarray)
                   else field.numel() * field.element_size() for field in self)


def pack_dataset(spectrograms: Sequence[np.ndarray], labels: Sequence[str],
                 codec: GraphemeCodec,
                 time_buckets: Sequence[int] = DEFAULT_TIME_BUCKETS,
                 label_multiple: int = LABEL_BUCKET_MULTIPLE,
                 dtype: np.dtype = np.float32) -> DeviceDataset:
    """Pad per-utterance (time, mel) features and transcripts into host arrays (the
    padding rules of `batching.pad_to_bucket`, applied corpus-wide)."""
    input_lengths = np.array([s.shape[0] for s in spectrograms], np.int32)
    t_max = bucket_length(int(input_lengths.max()), time_buckets)
    feature_dim = spectrograms[0].shape[1]
    inputs = np.zeros((len(spectrograms), t_max, feature_dim), dtype)
    for i, s in enumerate(spectrograms):
        inputs[i, : s.shape[0]] = s

    encoded = codec.encode_label_batch(list(labels))
    label_lengths = (encoded >= 0).sum(axis=1).astype(np.int32) if encoded.size \
        else np.zeros(len(spectrograms), np.int32)
    u_max = max(((encoded.shape[1] + label_multiple - 1) // label_multiple)
                * label_multiple, label_multiple)
    padded_labels = -np.ones((len(spectrograms), u_max), np.int32)
    padded_labels[:, : encoded.shape[1]] = encoded
    return DeviceDataset(inputs=inputs, input_lengths=input_lengths,
                         labels=padded_labels, label_lengths=label_lengths)


def check_fits(nbytes: int, device) -> None:
    """Raise `MemoryError` unless ``nbytes`` plus `DEVICE_HEADROOM_BYTES` fit in the free
    memory of ``device`` (a CUDA device; the CPU is not checked)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return
    free, total = torch.cuda.mem_get_info(device)
    if nbytes + DEVICE_HEADROOM_BYTES > free:
        raise MemoryError(
            "the corpus takes {:.0f} MB and training {:.0f} MB more, but {} has {:.0f} MB "
            "free of {:.0f} MB: train through the host pipeline (device_resident=False)"
            .format(nbytes / 1e6, DEVICE_HEADROOM_BYTES / 1e6, device, free / 1e6,
                    total / 1e6))


def build_device_dataset(labeled_spectrograms: List[LabeledSpectrogram],
                         codec: GraphemeCodec, device, compute_dtype=None,
                         time_buckets: Sequence[int] = DEFAULT_TIME_BUCKETS,
                         raw_wave: bool = False) -> Tuple[DeviceDataset, float]:
    """Load every cached feature, pack it and place it on ``device``. Returns the
    dataset and its resident megabytes. Features travel as fp16 when ``compute_dtype``
    is bf16 (numpy has no bf16; the model casts them). ``raw_wave=True`` packs
    ``(samples, 1)`` waveforms on `batching.RAW_WAVE_SAMPLE_BUCKETS` (unless other
    ``time_buckets`` are given). Raises `MemoryError` before any copy when the corpus
    does not fit (`check_fits`)."""
    import torch

    if raw_wave:
        from .batching import RAW_WAVE_SAMPLE_BUCKETS
        if time_buckets is DEFAULT_TIME_BUCKETS:
            time_buckets = RAW_WAVE_SAMPLE_BUCKETS
        spectrograms = [s.z_normalized_raw_wave() for s in labeled_spectrograms]
    else:
        spectrograms = [s.z_normalized_transposed_spectrogram()
                        for s in labeled_spectrograms]
    labels = [s.label for s in labeled_spectrograms]
    dtype = np.float16 if compute_dtype == torch.bfloat16 else np.float32
    host = pack_dataset(spectrograms, labels, codec, time_buckets=time_buckets, dtype=dtype)
    megabytes = host.nbytes() / 1e6
    check_fits(host.nbytes(), device)
    return DeviceDataset(*(torch.from_numpy(field).to(device) for field in host)), megabytes
