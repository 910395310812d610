"""Mel features of one utterance in numpy float64: the plain reference of the serving
path's first stage.

wav -> centred reflect padding (n_fft / 2) -> periodic Hann frames (n_fft 512, hop 128)
-> |rfft|^2 -> 10 log10, floored at -150 dB -> slaney mel filterbank (128 bands) over the
dB values -> z-normalised over the valid frames and bands (population deviation); frames
past the utterance, up to its length bucket, are zero.
"""
import numpy as np

SAMPLE_RATE = 16000
N_FFT = 512
HOP = 128
MELS = 128
MIN_DECIBEL = -150.0


def _hz_to_mel(hz):
    hz = np.asarray(hz, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(hz, min_log_hz) / min_log_hz)
                    / logstep, hz / f_sp)


def _mel_to_hz(mel):
    mel = np.asarray(mel, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                    mel * f_sp)


def filterbank() -> np.ndarray:
    """Slaney-normalised triangular filters, ``(MELS, 1 + N_FFT // 2)``."""
    bins = np.linspace(0.0, SAMPLE_RATE / 2, 1 + N_FFT // 2)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), MELS + 2))
    widths = np.diff(edges)
    ramps = edges[:, None] - bins[None, :]
    lower = -ramps[:-2] / widths[:-1, None]
    upper = ramps[2:] / widths[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def features(wave: np.ndarray, bucket_samples: int) -> np.ndarray:
    """``(1 + bucket_samples // HOP, MELS)`` features of ``wave``."""
    wave = np.asarray(wave, np.float64)
    padded = np.pad(wave, N_FFT // 2, mode="reflect")
    count = 1 + len(wave) // HOP
    index = np.arange(N_FFT)[None, :] + HOP * np.arange(count)[:, None]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)
    power = np.abs(np.fft.rfft(padded[index] * window, axis=1)) ** 2
    with np.errstate(divide="ignore"):
        decibel = np.where(power > 0.0, np.maximum(10.0 * np.log10(power), MIN_DECIBEL),
                           MIN_DECIBEL)
    mel = decibel @ filterbank().T
    normalised = (mel - mel.mean()) / max(mel.std(), 1e-10)
    out = np.zeros((1 + bucket_samples // HOP, MELS))
    out[:count] = normalised
    return out
