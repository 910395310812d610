"""Greedy CTC decoding on tensors (port of `speechless_tpu/ops/decode.py::greedy_decode`),
the `Transcriber`'s route without a language model."""
from typing import Tuple

import torch


def greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor,
                  blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Args: ``log_probs (batch, time, classes)``, ``lengths (batch,)`` valid frames.
    Returns ``tokens (batch, time) int32`` (collapsed symbols front-packed, ``-1``
    padded) and ``counts (batch,) int32``."""
    best = log_probs.argmax(dim=-1).to(torch.int32)            # (B, T)
    batch, t_max = best.shape
    t_range = torch.arange(t_max, device=best.device)[None, :]
    previous = torch.cat([best.new_full((batch, 1), -1), best[:, :-1]], dim=1)
    keep = (best != blank) & (best != previous) & (t_range < lengths.to(best.device)[:, None])
    # Stable front-compaction: sort by (kept ? position : position + T).
    order = torch.argsort(torch.where(keep, t_range, t_range + t_max), dim=1)
    packed = best.gather(1, order)
    counts = keep.sum(dim=1).to(torch.int32)
    return torch.where(t_range < counts[:, None], packed, packed.new_full((), -1)), counts
