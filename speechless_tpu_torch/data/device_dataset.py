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

Under a mesh (`parallel/mesh.py`) the corpus rows are split over the data ranks by
default, so D data ranks hold D times one card's corpus: rank d keeps rows
``[d * N / D, (d + 1) * N / D)``, N padded to a multiple of D by repeating leading rows
(a slight oversampling of those, as in JAX). Sampling stays global: every rank draws
the same indices, gathers the rows it owns (zeros elsewhere), and one all-reduce over
the data group per field gives every rank the whole global batch, equal to the
replicated layout's; the trainer then keeps its data rank's slice
(`ShardedDeviceDataset`, `trainer.make_device_epoch_step`). The all-reduce moves the
global batch, a few rows a step, against a D-fold residency.

Nothing here imports torch at module level: the cache-fill workers import this package
and must stay free of CUDA state.
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

    def gather(self, rows) -> tuple:
        """The fields' ``rows`` (int64 indices on the fields' device)."""
        return tuple(field.index_select(0, rows) for field in self)


class ShardedDeviceDataset:
    """A corpus whose rows are split over the data ranks of a mesh: ``local`` (a
    `DeviceDataset` on this rank's device) holds rows ``[offset, offset +
    local.example_count)`` of ``example_count``. `gather` is a collective over the data
    group: every rank of it calls it with the same indices."""

    def __init__(self, local: DeviceDataset, offset: int, example_count: int, group):
        self.local = local
        self.offset = offset
        self.example_count = example_count
        self.group = group

    @property
    def inputs(self):
        return self.local.inputs

    def nbytes(self) -> int:
        return self.local.nbytes()

    def gather(self, rows) -> tuple:
        """The fields' global ``rows`` on every rank: each rank's own rows, zeros
        elsewhere, summed over the data group."""
        import torch

        from ..parallel.mesh import DATA_AXIS, all_reduce

        owned = (rows >= self.offset) & (rows < self.offset + self.local.example_count)
        local_rows = torch.where(owned, rows - self.offset, 0)
        fields = []
        for field in self.local:
            picked = field.index_select(0, local_rows)
            mask = owned.view(-1, *([1] * (picked.dim() - 1)))
            picked = torch.where(mask, picked, torch.zeros((), dtype=picked.dtype,
                                                           device=picked.device))
            fields.append(all_reduce(picked, self.group, DATA_AXIS, "resident rows"))
        return tuple(fields)


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
                         raw_wave: bool = False, mesh=None) -> Tuple[DeviceDataset, float]:
    """Load every cached feature, pack it and place it on ``device``. Returns the
    dataset and its resident megabytes (the global footprint; a rank holds that over
    the data parallelism when split). Features travel as fp16 when ``compute_dtype``
    is bf16 (numpy has no bf16; the model casts them). ``raw_wave=True`` packs
    ``(samples, 1)`` waveforms on `batching.RAW_WAVE_SAMPLE_BUCKETS` (unless other
    ``time_buckets`` are given). Under a ``mesh`` the rows are split over its data
    ranks (a `ShardedDeviceDataset`; see the module docstring); without one every
    rank holds them all. Raises `MemoryError` before any copy when this rank's rows do
    not fit (`check_fits`)."""
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
    if mesh is None:
        megabytes = host.nbytes() / 1e6
        check_fits(host.nbytes(), device)
        return DeviceDataset(*(torch.from_numpy(field).to(device) for field in host)), \
            megabytes
    from ..parallel.mesh import DATA_AXIS, axis_group, axis_rank, axis_size

    data_size = axis_size(mesh, DATA_AXIS)
    remainder = host.example_count % data_size
    if remainder:
        pad = data_size - remainder
        host = DeviceDataset(*(np.concatenate([f, f[:pad]], axis=0) for f in host))
    rows = host.example_count // data_size
    offset = axis_rank(mesh, DATA_AXIS) * rows
    local = DeviceDataset(*(field[offset:offset + rows] for field in host))
    check_fits(local.nbytes(), device)
    local = DeviceDataset(*(torch.from_numpy(np.ascontiguousarray(field)).to(device)
                            for field in local))
    return (ShardedDeviceDataset(local, offset, host.example_count,
                                 axis_group(mesh, DATA_AXIS)), host.nbytes() / 1e6)
