"""The corpus pipeline (port of `speechless_tpu/data`): corpora and splits, LibriSpeech
and German parsing, the synthetic corpus writer, batching over the spectrogram cache and
the device-resident corpus. Only `device_dataset.py` imports torch, inside the call that
places a corpus on a device."""
from .batching import (HintedBatch, LabeledSpectrogramBatchGenerator, Prefetcher,
                       ShardedBatchGenerator, batch_from_spectrograms, bucket_length,
                       pad_to_bucket)
from .corpus import ComposedCorpus, Corpus, ParsingException, Phase, TrainingTestSplit
from .device_dataset import DeviceDataset, build_device_dataset, pack_dataset
from .german import (GermanClarinCorpus, GermanVoxforgeCorpus, UmlautDecoder,
                     clarin_corpora_sorted_by_size, german_corpus, german_frequent_characters)
from .librispeech import (LibriSpeechCorpus, dev_clean, english_corpus,
                          english_frequent_characters, minimal_english_corpus)

__all__ = ["Corpus", "ComposedCorpus", "TrainingTestSplit", "Phase", "ParsingException",
           "LabeledSpectrogramBatchGenerator", "ShardedBatchGenerator", "HintedBatch",
           "Prefetcher", "pad_to_bucket", "bucket_length",
           "batch_from_spectrograms", "DeviceDataset", "build_device_dataset", "pack_dataset",
           "LibriSpeechCorpus", "dev_clean", "english_corpus", "minimal_english_corpus",
           "english_frequent_characters", "GermanClarinCorpus", "GermanVoxforgeCorpus",
           "UmlautDecoder", "clarin_corpora_sorted_by_size", "german_corpus",
           "german_frequent_characters"]
