"""Host audio decode and encode (jax-free port of `speechless_tpu/features/audio_io.py`):
wav bytes or files via scipy, FLAC via the port's C++ decoder (``native/flac.cpp``,
built with g++ at first use), header probes via the stdlib `wave` module and the FLAC
STREAMINFO block, polyphase resampling, 16-bit PCM wav writing. Results are mono
float32 in [-1, 1].
"""
import io
import struct
import wave
from fractions import Fraction
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.tools import log


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


def _decode_wav(path: Path) -> Tuple[np.ndarray, int]:
    """Decode a PCM wav file to (float32 (channels averaged), sample_rate)."""
    import scipy.io.wavfile as wavfile

    sample_rate, data = wavfile.read(str(path))
    return _normalize_pcm(data), int(sample_rate)


def _decode_flac(path: Path) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file with the native decoder (built on first use; a failed build
    raises)."""
    from ..native import library

    return library().decode_flac(str(path))


def decode_audio(path: Path) -> Tuple[np.ndarray, int]:
    """Decode an audio file to (mono float32, original sample rate). Supports wav and
    flac."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".flac":
        return _decode_flac(path)
    if suffix == ".wav":
        return _decode_wav(path)
    raise ValueError("Unsupported audio format: {}".format(path))


def resample(audio: np.ndarray, original_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling (band-limited), mono float32 in/out."""
    if original_rate == target_rate:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    ratio = Fraction(target_rate, original_rate)
    return resample_poly(audio.astype(np.float64), ratio.numerator,
                         ratio.denominator).astype(np.float32)


def load_audio(path: Path, sample_rate: int = 16000) -> np.ndarray:
    """Load + mono-downmix + resample; the `librosa.load(path, sr=...)` equivalent."""
    audio, original_rate = decode_audio(path)
    return resample(audio, original_rate, sample_rate)


def _flac_streaminfo(path: Path) -> Tuple[int, int]:
    """Parse (sample_rate, total_samples) from a FLAC STREAMINFO header. Raises
    ValueError for anything malformed, truncated files included."""
    with Path(path).open("rb") as f:
        header = f.read(26)
    if len(header) < 26 or header[:4] != b"fLaC":
        raise ValueError("Not a valid FLAC file: {}".format(path))
    bits = struct.unpack(">Q", header[18:26])[0]
    sample_rate = bits >> 44
    total_samples = bits & ((1 << 36) - 1)
    if sample_rate == 0:
        raise ValueError("Invalid FLAC sample rate in {}".format(path))
    return int(sample_rate), int(total_samples)


def file_sample_rate(path: Path) -> int:
    """Read the sample rate from the container header without decoding samples."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        with wave.open(str(path), "rb") as f:
            return f.getframerate()
    if suffix == ".flac":
        return _flac_streaminfo(path)[0]
    raise ValueError("Unsupported audio format: {}".format(path))


def probe_duration_in_s(path: Path) -> float:
    """Duration from the container header; 0 on failure (the reference degrades the
    same way)."""
    path = Path(path)
    try:
        suffix = path.suffix.lower()
        if suffix == ".wav":
            with wave.open(str(path), "rb") as f:
                return f.getnframes() / f.getframerate()
        if suffix == ".flac":
            sample_rate, total_samples = _flac_streaminfo(path)
            return total_samples / sample_rate
        raise ValueError("Unsupported audio format")
    except Exception as e:
        log("Failed to get duration of {}: {}".format(path, e))
        return 0.0


def write_wav(path: Path, audio: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono float32 audio as 16-bit PCM wav."""
    import scipy.io.wavfile as wavfile

    clipped = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    wavfile.write(str(path), sample_rate, (clipped * 32767.0).astype(np.int16))
