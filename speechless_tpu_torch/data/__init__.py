"""The corpus pipeline (port of `speechless_tpu/data`): corpora and splits, LibriSpeech
parsing, the synthetic corpus writer, and batching over the spectrogram cache. Nothing
here imports torch. `german.py` and `device_dataset.py` are not ported yet (ROADMAP.md,
item 9)."""
from .batching import (LabeledSpectrogramBatchGenerator, Prefetcher, batch_from_spectrograms,
                       bucket_length, pad_to_bucket)
from .corpus import ComposedCorpus, Corpus, ParsingException, Phase, TrainingTestSplit
from .librispeech import (LibriSpeechCorpus, dev_clean, english_corpus,
                          english_frequent_characters, minimal_english_corpus)

__all__ = ["Corpus", "ComposedCorpus", "TrainingTestSplit", "Phase", "ParsingException",
           "LabeledSpectrogramBatchGenerator", "Prefetcher", "pad_to_bucket", "bucket_length",
           "batch_from_spectrograms", "LibriSpeechCorpus", "dev_clean", "english_corpus",
           "minimal_english_corpus", "english_frequent_characters"]
