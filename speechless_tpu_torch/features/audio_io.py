"""Request audio decoding (jax-free port of `speechless_tpu/features/audio_io.py:28-90`):
wav bytes or files via scipy, polyphase resampling. Results are mono float32 in
[-1, 1]."""
import io
from fractions import Fraction
from pathlib import Path
from typing import Tuple

import numpy as np


def _normalize_pcm(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64 wavs
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    return audio


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an in-memory wav payload to (mono float32, sample_rate)."""
    import scipy.io.wavfile as wavfile

    sample_rate, pcm = wavfile.read(io.BytesIO(data))
    return _normalize_pcm(pcm), int(sample_rate)


def resample(audio: np.ndarray, original_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling (band-limited), mono float32 in/out."""
    if original_rate == target_rate:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    ratio = Fraction(target_rate, original_rate)
    return resample_poly(audio.astype(np.float64), ratio.numerator,
                         ratio.denominator).astype(np.float32)


def load_audio(path: Path, sample_rate: int = 16000) -> np.ndarray:
    """Read a wav file as mono float32 at ``sample_rate``. FLAC, which the JAX package
    decodes with its native extension, is not ported yet (ROADMAP.md, item 13)."""
    path = Path(path)
    if path.suffix.lower() != ".wav":
        raise ValueError("unsupported audio format {} (the port reads wav; FLAC is not "
                         "ported yet, ROADMAP.md item 13)".format(path))
    audio, rate = decode_wav_bytes(path.read_bytes())
    return resample(audio, rate, sample_rate)
