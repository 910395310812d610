"""SpecAugment (Park et al., arXiv:1904.08779) on feature batches (port of
`speechless_tpu/ops/specaugment.py`).

Each utterance gets ``frequency_mask_count`` bands of mel bins and ``time_mask_count``
spans of frames set to 0.0, which after the features' z-normalization is the mean: the
paper's mean masking. A time mask lies inside the utterance's true length and is at most
``time_mask_fraction`` of it wide, so padding frames stay untouched and short utterances
are never wiped out. The masks are built on the device the batch lies on.

The JAX package draws its uniforms from a JAX key, which torch cannot reproduce. So the
draws are split from the mask construction: `draw` takes them from a `torch.Generator`
(on the batch's device) and `apply_spec_augment` takes either a generator or the draws
themselves, so that a test can hand it JAX's ``u_width``/``u_start`` and get JAX's masks.
"""
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch


@dataclass(frozen=True)
class SpecAugment:
    """The LibriSpeech "LD" policy scaled to 128 mel bins and 8 ms frames."""
    frequency_mask_width: int = 27    # max mel bins per frequency mask (F)
    frequency_mask_count: int = 2     # masks per utterance (mF)
    time_mask_fraction: float = 0.05  # max mask width as a fraction of the length (p)
    time_mask_count: int = 2          # masks per utterance (mT)


class Draws(NamedTuple):
    """The uniforms in [0, 1) that place the masks, each ``(batch, count)`` fp32: JAX's
    ``u_width`` and ``u_start`` of the frequency masks, then of the time masks."""
    frequency_width: torch.Tensor
    frequency_start: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor


def draw(generator: torch.Generator, batch: int, config: SpecAugment, device) -> Draws:
    """One batch's uniforms from ``generator`` (which must live on ``device``)."""
    def uniform(count):
        return torch.rand((batch, count), generator=generator, device=device,
                          dtype=torch.float32)

    return Draws(uniform(config.frequency_mask_count), uniform(config.frequency_mask_count),
                 uniform(config.time_mask_count), uniform(config.time_mask_count))


def _interval_masks(u_width: torch.Tensor, u_start: torch.Tensor, dim: int,
                    limits: torch.Tensor, max_widths: torch.Tensor) -> torch.Tensor:
    """(batch, dim) bool: the union of ``count`` intervals a row, each of width
    ``floor(u_width * (max_width + 1))`` starting at ``floor(u_start * max(limit - width
    + 1, 1))``, in fp32 as the JAX function computes them."""
    widths = torch.floor(u_width * (max_widths[:, None].to(torch.float32) + 1.0))
    starts = torch.floor(u_start * torch.clamp(
        limits[:, None].to(torch.float32) - widths + 1.0, min=1.0))
    positions = torch.arange(dim, dtype=torch.float32, device=u_width.device)[None, None, :]
    inside = (positions >= starts[:, :, None]) & (positions < (starts + widths)[:, :, None])
    return inside.any(dim=1)


def masks(draws: Draws, input_lengths: torch.Tensor, time_dim: int, mel_dim: int,
          config: SpecAugment) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(batch, time_dim)`` time mask and ``(batch, mel_dim)`` frequency mask."""
    batch = input_lengths.shape[0]
    ones = torch.ones((batch,), dtype=torch.int32, device=input_lengths.device)
    frequency = _interval_masks(draws.frequency_width, draws.frequency_start, mel_dim,
                                limits=ones * mel_dim,
                                max_widths=ones * min(config.frequency_mask_width, mel_dim))
    lengths = input_lengths.to(torch.int32)
    time = _interval_masks(draws.time_width, draws.time_start, time_dim, limits=lengths,
                           max_widths=torch.floor(config.time_mask_fraction
                                                  * lengths.to(torch.float32)).to(torch.int32))
    return time, frequency


def apply_spec_augment(inputs: torch.Tensor, input_lengths: torch.Tensor,
                       config: Optional[SpecAugment] = None,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Draws] = None) -> torch.Tensor:
    """``inputs`` (batch, time, mel) with the masked cells set to 0, in its dtype. The
    masks come from ``draws`` when given, else from uniforms drawn from ``generator``."""
    config = config or SpecAugment()
    batch, time_dim, mel_dim = inputs.shape
    if draws is None:
        if generator is None:
            raise ValueError("apply_spec_augment needs a generator or the draws")
        draws = draw(generator, batch, config, inputs.device)
    time, frequency = masks(draws, input_lengths, time_dim, mel_dim, config)
    return inputs.masked_fill(time[:, :, None] | frequency[:, None, :], 0.0)
