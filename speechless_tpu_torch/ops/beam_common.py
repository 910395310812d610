"""Constants and helpers shared by the prefix beams (port of `speechless_tpu/ops/
decode_jax.py::backtrace_tokens/_word_bonuses` and the constants of
`speechless_tpu/ops/decode_pallas.py`), and the backtrace kernel's wrapper
(`beam_backtrace`, CUDA source ``csrc/beam_backtrace.cu``; `backtrace_tokens` is its
plain version).

Prefix hashes are int32 with wraparound (``hash * HASH_MULTIPLIER + (char + 2)``); they
compare as signed int32, so ``DEAD_KEY = INT32_MAX`` sorts after every live prefix.
"""
from typing import Tuple

import torch

from . import _kernels

NEG_INF = -1e30
HASH_MULTIPLIER = 16777619    # FNV-ish
EMPTY_HASH = -2128831035      # 0x811C9DC5 as int32
DEAD_KEY = 2147483647


def next_pow2(value: int) -> int:
    return 1 << max(0, (value - 1)).bit_length()


def backtrace_tokens(parents: torch.Tensor, emit_chars: torch.Tensor, best: torch.Tensor,
                     counts: torch.Tensor, max_decoded_length: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rebuild each row's winning prefix from per-frame backpointers.

    ``parents``/``emit_chars`` are ``(B, T, W)`` records of (parent beam, emitted char or
    -1); ``best`` ``(B,)`` the winning final beams, or ``(B, n)``: n starts a row, each
    walking its row's pointers (an n-best list); ``counts`` of ``best``'s shape, their
    prefix lengths; T must be at least 1. Returns ``tokens (B[, n],
    max_decoded_length) int32`` (-1 padded) and counts."""
    batch, t_max, _ = parents.shape
    beam = best.reshape(batch, -1).to(torch.int64)                     # (B, n)
    path = []
    for t in range(t_max - 1, -1, -1):
        path.append(emit_chars[:, t].gather(1, beam))
        beam = parents[:, t].gather(1, beam).to(torch.int64)
    path_chars = torch.stack(path[::-1], dim=2)                        # (B, n, T)
    t_range = torch.arange(t_max, device=parents.device)
    # Front-compact the emitted characters in time order.
    order = torch.argsort(torch.where(path_chars >= 0, t_range, t_range + t_max), dim=2)
    packed = path_chars.gather(2, order)
    out = torch.arange(max_decoded_length, device=parents.device)
    picked = packed.gather(2, torch.clamp(out, max=t_max - 1).expand(
        packed.shape[:2] + (max_decoded_length,)))
    counts = counts.to(torch.int32)
    tokens = torch.where(out < counts.reshape(picked.shape[:2] + (1,)), picked,
                         picked.new_full((), -1))
    return tokens.to(torch.int32).reshape(best.shape + (max_decoded_length,)), counts


def beam_backtrace(parents: torch.Tensor, emit_chars: torch.Tensor, best: torch.Tensor,
                   counts: torch.Tensor, max_decoded_length: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`backtrace_tokens` through the custom operator ``speechless::beam_backtrace``
    (`library.py`): one launch of the backtrace kernel for CUDA tensors,
    `backtrace_tokens` itself for CPU tensors. Same contract, ``best`` and ``counts``
    ``(B,)`` or ``(B, n)``; ``beam_backtrace.launches`` counts kernel launches (kept by
    `launch_backtrace`, so a replayed export program counts too). A build or launch
    failure raises, as does a shape the kernel refuses (a row whose staging does not
    fit in shared memory)."""
    from . import library

    if parents.device.type not in ("cpu", "cuda"):
        raise ValueError("beam_backtrace runs on CPU or CUDA tensors, got {}".format(
            parents.device))
    if best.shape != counts.shape or best.shape[:1] != parents.shape[:1] or best.dim() > 2:
        raise ValueError("beam_backtrace: best and counts must be (B,) or (B, n)")
    return (library.beam_backtrace(parents, emit_chars, best, counts, max_decoded_length),
            counts.to(torch.int32))


def launch_backtrace(parents: torch.Tensor, emit_chars: torch.Tensor, best: torch.Tensor,
                     counts: torch.Tensor, max_decoded_length: int) -> torch.Tensor:
    """One launch of the backtrace kernel on CUDA tensors (the CUDA body of
    ``speechless::beam_backtrace``): `backtrace_tokens`' tokens. Counts the launch in
    ``beam_backtrace.launches``."""
    if parents.device.type != "cuda":
        raise ValueError("the backtrace kernel runs on CUDA tensors, got {}".format(
            parents.device))
    batch, t_max, lanes = parents.shape
    if t_max < 1:
        raise ValueError("beam_backtrace needs at least one frame")
    parents = parents.to(torch.int32).contiguous()
    emit_chars = emit_chars.to(torch.int32).contiguous()
    if emit_chars.shape != parents.shape or emit_chars.device != parents.device:
        raise ValueError("beam_backtrace: parents and chars must be (B, T, r) on one device")
    starts = best.shape[1] if best.dim() == 2 else 1
    best = best.to(device=parents.device, dtype=torch.int32).contiguous()
    counts = counts.to(device=parents.device, dtype=torch.int32).contiguous()
    tokens = torch.empty(best.shape + (max_decoded_length,), dtype=torch.int32,
                         device=parents.device)
    with torch.cuda.device(parents.device):
        status = _kernels.function("beam_backtrace")(
            *(t.data_ptr() for t in (parents, emit_chars, best, counts, tokens)),
            batch, t_max, lanes, starts, max_decoded_length,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("beam_backtrace kernel launch failed with CUDA error {} "
                           "(T={}, r={}, starts={})".format(status, t_max, lanes, starts))
    beam_backtrace.launches += 1
    return tokens


beam_backtrace.launches = 0


def word_bonuses(word_lm, trie_nodes: torch.Tensor, word_contexts: torch.Tensor,
                 lm_weight: float, word_count_weight: float,
                 valid_word_count_weight: float):
    """Per-beam bonus a space extension would earn now: nothing for an empty word;
    OOV words score as <unk> with no validity bonus. Returns ``(bonus, pending,
    normalized word ids)`` over the flat beams of ``trie_nodes``."""
    from ..lm.device_lm import score_word_device

    pending = trie_nodes != 0
    completed = torch.where(trie_nodes > 0,
                            word_lm.node_word[torch.clamp(trie_nodes, min=0).long()],
                            trie_nodes.new_full((), -1))
    normalized = torch.where(completed >= 0, completed,
                             completed.new_full((), word_lm.unk_id))
    log10_p = score_word_device(word_lm, word_contexts[:, 0], word_contexts[:, 1],
                                normalized)
    bonus = torch.where(pending,
                        lm_weight * log10_p + word_count_weight
                        + valid_word_count_weight * (completed >= 0),
                        log10_p.new_zeros(()))
    return bonus, pending, normalized
