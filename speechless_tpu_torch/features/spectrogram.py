"""Mel power-level spectrogram features (port of `speechless_tpu/features/spectrogram.py`).

    wav -> reflect pad -> hann frames -> |rfft|^2 -> dB with floor -150
        -> mel filterbank matmul -> z-norm -> (time, mel)

Two paths compute it. `features_batch` runs on tensors: a per-row reflect pad, the DFT
as one fp32 matmul and a masked z-norm per row, in IEEE fp32 with TF32 off
(`precision.ieee_fp32`), the counterpart of the JAX package's `Precision.HIGHEST`; the
trainer and the Transcriber use it. `z_normalized_transposed_spectrogram` is the numpy
host path of one utterance (the `LabeledSpectrogram` contract) that the spectrogram
cache is made from; it equals the JAX package's bit for bit. The mel filterbank is
applied to the dB values (the reference's order), and the z-norm uses the population
std.

The module imports torch only inside the tensor path, so the cache-fill workers, which
import the numpy path alone, never load torch.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 512
HOP_LENGTH = 128
MEL_COUNT = 128
MIN_DECIBEL = -150.0


def hz_to_mel_slaney(frequencies: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(frequencies >= min_log_hz,
                    min_log_mel + np.log(np.maximum(frequencies, min_log_hz)
                                         / min_log_hz) / logstep,
                    frequencies / f_sp)


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), mels * f_sp)


def mel_frequencies(n_mels: int, fmin: float = 0.0, fmax: float = SAMPLE_RATE / 2) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the slaney mel scale (librosa-compatible)."""
    return mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax),
                                        n_mels))


@lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   n_mels: int = MEL_COUNT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape ``(n_mels, 1 + n_fft//2)``."""
    fft_frequencies = np.linspace(0.0, sample_rate / 2, 1 + n_fft // 2)
    mel_f = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(0.0),
                                         hz_to_mel_slaney(sample_rate / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_frequencies[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


@lru_cache(maxsize=None)
def _hann_window(n_fft: int) -> np.ndarray:
    """Periodic (fftbins=True) hann window of length ``n_fft``."""
    k = np.arange(n_fft, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft)


@lru_cache(maxsize=None)
def _dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real/imag rfft bases: two ``(n_fft, 1 + n_fft//2)`` matrices."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(1 + n_fft // 2, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    window = _hann_window(n_fft)[:, None]
    return np.cos(angle) * window, np.sin(angle) * window


def ieee_fp32():
    """`precision.ieee_fp32`, imported when the tensor path first runs."""
    from ..precision import ieee_fp32 as context

    return context()


def frame_count(num_samples: int, hop_length: int = HOP_LENGTH) -> int:
    """Number of STFT frames for a centered transform: ``1 + num_samples // hop``."""
    return 1 + num_samples // hop_length


def _reflect_index(positions: torch.Tensor, lengths: torch.Tensor,
                   max_len: int) -> torch.Tensor:
    """Multi-bounce reflect indices (numpy ``pad(mode='reflect')``) per row length."""
    import torch

    period = torch.clamp(2 * lengths[:, None] - 2, min=1)
    folded = torch.remainder(positions.abs(), period)
    folded = torch.where(folded >= lengths[:, None], period - folded, folded)
    return folded.clamp(0, max_len - 1)


def _reflect_pad_batch(wavs: torch.Tensor, lengths: torch.Tensor, pad: int) -> torch.Tensor:
    """Centered reflect padding with per-row lengths: ``pad`` reflected samples on the
    left, the row, then ``pad`` reflected samples written at each row's own end."""
    import torch

    batch, max_len = wavs.shape
    k = torch.arange(pad, device=wavs.device)[None, :]
    left = wavs.gather(1, _reflect_index(k - pad, lengths, max_len))
    right_at = lengths[:, None] + k
    right = wavs.gather(1, _reflect_index(right_at, lengths, max_len))
    padded = torch.cat([left, wavs, wavs.new_zeros(batch, pad)], dim=1)
    return padded.scatter(1, right_at + pad, right)


def features_batch(wavs: torch.Tensor, lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched feature extraction (n_fft 512, hop 128, 128 slaney mels, 16 kHz).

    Args:
      wavs: ``(batch, max_samples)`` zero-padded float32 audio at 16 kHz.
      lengths: ``(batch,)`` true sample counts.
    Returns:
      ``(features (batch, max_frames, 128) float32, frame_counts (batch,) int32)``;
      frames at or past ``1 + length // 128`` are zero.
    """
    import torch

    wavs = wavs.to(torch.float32)
    lengths = lengths.to(device=wavs.device, dtype=torch.int64)
    batch, max_len = wavs.shape
    max_frames = frame_count(max_len)
    padded = _reflect_pad_batch(wavs, lengths, N_FFT // 2)

    # Framing as n_fft/hop shifted views of the padded rows, then one fp32 matmul.
    frames = torch.cat(
        [padded[:, j * HOP_LENGTH: j * HOP_LENGTH + max_frames * HOP_LENGTH]
         .reshape(batch, max_frames, HOP_LENGTH) for j in range(N_FFT // HOP_LENGTH)],
        dim=2)
    cos_m, sin_m = _dft_matrices(N_FFT)
    kernel = torch.from_numpy(np.concatenate([cos_m, sin_m], axis=1)
                              .astype(np.float32)).to(wavs.device)
    mel_w = torch.from_numpy(mel_filterbank().T.astype(np.float32)).to(wavs.device)
    n_freq = 1 + N_FFT // 2
    with ieee_fp32():
        spectrum = frames @ kernel                          # (B, T, 2 * n_freq)
        power = spectrum[..., :n_freq] ** 2 + spectrum[..., n_freq:] ** 2
        decibel = torch.where(
            power > 0.0,
            torch.clamp(10.0 * torch.log10(torch.clamp(power, min=1e-45)),
                        min=MIN_DECIBEL),
            torch.full_like(power, MIN_DECIBEL))
        mel_db = decibel @ mel_w                            # (B, T, n_mels)

    valid_frames = (1 + lengths // HOP_LENGTH)[:, None, None]
    frame_mask = torch.arange(max_frames, device=wavs.device)[None, :, None] < valid_frames
    count = (valid_frames * MEL_COUNT).to(torch.float32)
    zero = mel_db.new_zeros(())
    mean = torch.where(frame_mask, mel_db, zero).sum(dim=(1, 2), keepdim=True) / count
    var = torch.where(frame_mask, (mel_db - mean) ** 2, zero).sum(
        dim=(1, 2), keepdim=True) / count
    normalized = (mel_db - mean) * torch.rsqrt(torch.clamp(var, min=1e-20))
    return (torch.where(frame_mask, normalized, zero),
            (1 + lengths // HOP_LENGTH).to(torch.int32))


def z_normalized_transposed_spectrogram(wav: np.ndarray, n_fft: int = N_FFT,
                                        hop_length: int = HOP_LENGTH,
                                        n_mels: int = MEL_COUNT,
                                        sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """One utterance's ``(time, mel)`` float32 features in numpy (the host path the
    spectrogram cache is made from). Constant audio gives zeros, not NaNs."""
    level = power_level_spectrogram(np.asarray(wav, dtype=np.float32), n_fft, hop_length)
    mel_db = mel_filterbank(sample_rate, n_fft, n_mels) @ level
    normalized = (mel_db - mel_db.mean()) / max(float(mel_db.std()), 1e-10)
    return normalized.T.astype(np.float32)


def stft_numpy(wav: np.ndarray, n_fft: int = N_FFT, hop_length: int = HOP_LENGTH) -> np.ndarray:
    """Complex STFT ``(1 + n_fft//2, frames)`` with centered reflect padding (host path)."""
    wav = np.asarray(wav, dtype=np.float64)
    pad = n_fft // 2
    padded = np.pad(wav, pad, mode="reflect")
    n_frames = 1 + (len(padded) - n_fft) // hop_length
    strides = (padded.strides[0] * hop_length, padded.strides[0])
    frames = np.lib.stride_tricks.as_strided(padded, shape=(n_frames, n_fft), strides=strides)
    return (np.fft.rfft(frames * _hann_window(n_fft), axis=1)).T


def power_spectrogram(wav: np.ndarray, n_fft: int = N_FFT,
                      hop_length: int = HOP_LENGTH) -> np.ndarray:
    return np.abs(stft_numpy(wav, n_fft, hop_length)) ** 2


def amplitude_spectrogram(wav: np.ndarray, n_fft: int = N_FFT,
                          hop_length: int = HOP_LENGTH) -> np.ndarray:
    return np.abs(stft_numpy(wav, n_fft, hop_length))


def power_level_spectrogram(wav: np.ndarray, n_fft: int = N_FFT,
                            hop_length: int = HOP_LENGTH) -> np.ndarray:
    power = power_spectrogram(wav, n_fft, hop_length)
    with np.errstate(divide="ignore"):
        level = 10.0 * np.log10(power)
    return np.where(power == 0.0, MIN_DECIBEL, np.maximum(level, MIN_DECIBEL))


def to_mel_scale(spectrogram: np.ndarray, sample_rate: int = SAMPLE_RATE,
                 n_fft: int = N_FFT, n_mels: int = MEL_COUNT) -> np.ndarray:
    """Apply the mel filterbank to a ``(freq, time)`` spectrogram of any type."""
    return mel_filterbank(sample_rate, n_fft, n_mels) @ spectrogram
