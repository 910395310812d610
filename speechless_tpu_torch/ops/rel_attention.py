"""The Conformer's relative-position attention core on a hand-written Hopper kernel pair.

`rel_attention` takes the block's projections ``q``, ``k``, ``v`` ``(B, T', H, d_k)``, its
position biases ``u`` and ``v`` ``(H, d_k)``, the projected sinusoids ``p`` ``(2T' - 1, H,
d_k)`` (offset ``r`` at row ``T' - 1 - r``, as `models/conformer.py::relative_positions`
lays them out) and each row's valid frames, all on the card, and returns ``(B, T', H,
d_k)``: with ``s = 1 / sqrt(d_k)``, ``qu = q + u`` and ``qv = (q + v) s`` each rounded once
to ``q``'s type,

    S_ij = s (qu_i . k_j) + [qv_i . p_(i-j)]  over the keys j < len,
    O_i  = softmax_j(S_ij) V                  for the queries i < len, 0 past it,

([x]: rounded once to ``q``'s type), the function the library route of
`models/conformer.py` computes with NeMo's ``rel_shift``, a -10000 mask of padded pairs
and SDPA. It launches ``csrc/rel_attention.cu`` (`RelAttention`: the forward kernel, and
in the backward a first pass for ``D = rowsum(dO O)`` then the backward kernel), which
skips the 64 x 64 tiles that lie wholly past a row's length and writes no ``(B, H, T',
T')`` tensor; any other tensor is refused. ``rel_attention.launches`` counts the kernel
entry's calls (one forward, one backward). `rel_attention_reference` is its plain
version, the yardstick of the kernel's checks on the card.

The route (`takes_kernel`): the kernel where the tensors lie on the card, the compute
type is bf16 and ``d_k`` is 64; the Conformer's library route otherwise (the CPU, fp32
compute). `tile_counts` gives what ``conformer.attn_tiles`` and
``conformer.attn_tiles_run`` count.
"""
import math
from typing import Optional, Tuple

import torch

from . import _kernels

HEAD_DIM = 64   # the kernel's d_k
TILE = 64       # its query and key tiles
# The score of a masked pair in the plain version and the Conformer's library route:
# NeMo's INF_VAL, whose exp is exactly 0 beside any valid key's score, and finite, so a
# row with no valid key gives no NaN.
MASK_FILL = -10000.0


def takes_kernel(device: torch.device, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the attention core runs on the kernel (else on the library route)."""
    return device.type == "cuda" and dtype == torch.bfloat16 and head_dim == HEAD_DIM


def tile_counts(lengths: torch.Tensor, frames: int) -> Tuple[int, torch.Tensor]:
    """(rows x the padded grid's 64 x 64 tiles, a 0-d tensor of the tiles the kernel
    runs: the sum of each row's ceil(len / 64)^2), for one head of one block."""
    per_side = -(-frames // TILE)
    own = torch.div(lengths.to(torch.int64) + TILE - 1, TILE, rounding_mode="floor")
    return lengths.shape[0] * per_side * per_side, (own * own).sum()


def rel_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pos_bias_u: torch.Tensor, pos_bias_v: torch.Tensor,
                            p: torch.Tensor, lengths: torch.Tensor,
                            rounding: Optional[torch.dtype] = None,
                            with_lse: bool = False):
    """The plain version of the kernel pair: the whole ``(B, H, T', T')`` score tensor in
    fp32 (fp64 for fp64 inputs), the position term gathered from one product over all
    offsets, masked pairs at `MASK_FILL`, rows past their length zeroed; the result in
    ``q``'s type. ``qu``, ``qv`` and the position term are rounded to ``rounding`` (default
    ``q``'s type), as the kernel rounds them to bf16. Autograd gives its backward. With
    ``with_lse`` also each row's log-sum-exp of its scores over its valid keys ``(B, H,
    T')``, in the score type, 0 past the row's length (as the kernel keeps it)."""
    batch, frames, heads, head_dim = q.shape
    dtype = torch.promote_types(q.dtype, torch.float32)
    rounding = rounding or q.dtype
    scale = 1.0 / math.sqrt(head_dim)
    qu = (q + pos_bias_u).to(rounding).to(dtype)
    qv = ((q + pos_bias_v) * scale).to(rounding).to(dtype)
    content = torch.einsum("bihd,bjhd->bhij", qu, k.to(dtype)) * scale
    every_offset = torch.einsum("bihd,rhd->bhir", qv, p.to(dtype))    # (B, H, T', 2T'-1)
    positions = torch.arange(frames, device=q.device)
    rows = (frames - 1 - positions[:, None] + positions[None, :])    # offset i - j's row
    position = torch.gather(every_offset, 3, rows.expand(batch, heads, frames, frames))
    position = position.to(rounding).to(dtype)
    valid = positions[None, :] < lengths.to(q.device)[:, None]       # (B, T')
    scores = (content + position).masked_fill(~valid[:, None, None, :], MASK_FILL)
    out = torch.einsum("bhij,bjhd->bihd", scores.softmax(-1), v.to(dtype))
    out = out.masked_fill(~valid[:, :, None, None], 0.0).to(q.dtype)
    if not with_lse:
        return out
    return out, scores.logsumexp(-1).masked_fill(~valid[:, None, :], 0.0)


def _check(q, k, v, pos_bias_u, pos_bias_v, p, lengths) -> None:
    batch, frames, heads, head_dim = q.shape
    bf16 = torch.bfloat16
    if not (q.dtype == k.dtype == v.dtype == p.dtype == bf16) or head_dim != HEAD_DIM \
            or k.shape != q.shape or v.shape != q.shape \
            or tuple(p.shape) != (2 * frames - 1, heads, head_dim) \
            or tuple(pos_bias_u.shape) != (heads, head_dim) \
            or tuple(pos_bias_v.shape) != (heads, head_dim) \
            or pos_bias_u.dtype != torch.float32 or pos_bias_v.dtype != torch.float32 \
            or tuple(lengths.shape) != (batch,) or lengths.dtype != torch.int32 \
            or len({t.device for t in (q, k, v, p, pos_bias_u, pos_bias_v, lengths)}) != 1 \
            or not all(t.is_contiguous() for t in (q, k, v, p, pos_bias_u, pos_bias_v,
                                                   lengths)):
        raise ValueError(
            "rel_attention: expected contiguous bf16 q, k, v (B, T, H, {}), p (2T - 1, H, "
            "{}), fp32 u and v (H, {}) and int32 lengths (B,) on one device, got q {} {}, "
            "k {}, v {}, p {} {}, u {} {}, v {} {}, lengths {} {}".format(
                HEAD_DIM, HEAD_DIM, HEAD_DIM, q.dtype, tuple(q.shape), tuple(k.shape),
                tuple(v.shape), p.dtype, tuple(p.shape), pos_bias_u.dtype,
                tuple(pos_bias_u.shape), pos_bias_v.dtype, tuple(pos_bias_v.shape),
                lengths.dtype, tuple(lengths.shape)))


def _launch(q, k, v, pos_bias_u, pos_bias_v, p, lengths, o, o32, lse, dout=None, delta=None,
            qu=None, qv=None, dq=None, dk=None, dv=None, dp=None, du=None, dvb=None) -> None:
    batch, frames, heads, _ = q.shape

    def pointer(tensor):
        return None if tensor is None else tensor.data_ptr()

    with torch.cuda.device(q.device):
        status = _kernels.function("rel_attention")(
            *(pointer(t) for t in (q, k, v, pos_bias_u, pos_bias_v, p, lengths, o, o32, lse,
                                   dout, delta, qu, qv, dq, dk, dv, dp, du, dvb)),
            batch, frames, heads, int(dout is not None),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("rel_attention kernel launch failed with CUDA error {}".format(
            status))
    rel_attention.launches += 1


class RelAttention(torch.autograd.Function):
    """`rel_attention` on the kernel pair; saves q, k, v, u, v, p, the lengths, O's fp32
    copy (``D = rowsum(dO O)`` from the bf16 O put 3-10 % errors into dq on the training
    cell's rows: ``dP - D`` nearly cancels) and each row's log-sum-exp for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, pos_bias_u, pos_bias_v, p, lengths):
        batch, frames, heads, _ = q.shape
        o = torch.empty_like(q)
        o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((batch, heads, frames), dtype=torch.float32, device=q.device)
        _launch(q, k, v, pos_bias_u, pos_bias_v, p, lengths, o, o32, lse)
        ctx.save_for_backward(q, k, v, pos_bias_u, pos_bias_v, p, lengths, o32, lse)
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, pos_bias_u, pos_bias_v, p, lengths, o32, lse = ctx.saved_tensors
        batch, frames, heads, _ = q.shape
        fp32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, **fp32)
        dp = torch.zeros(p.shape, **fp32)
        du = torch.zeros(pos_bias_u.shape, **fp32)
        dvb = torch.zeros(pos_bias_v.shape, **fp32)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        qu, qv = torch.empty_like(q), torch.empty_like(q)
        delta = torch.empty((batch, heads, frames), **fp32)
        _launch(q, k, v, pos_bias_u, pos_bias_v, p, lengths, None, o32, lse,
                grad.contiguous(), delta, qu, qv, dq, dk, dv, dp, du, dvb)
        return dq.to(q.dtype), dk, dv, du, dvb, dp.to(p.dtype), None


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos_bias_u: torch.Tensor, pos_bias_v: torch.Tensor, p: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """`rel_attention_reference`'s function on the kernel pair: CUDA tensors, bf16 q, k, v
    and p with d_k 64, fp32 biases, int32 lengths."""
    if q.device.type != "cuda":
        raise ValueError("rel_attention runs on CUDA tensors, got {}".format(q.device))
    _check(q, k, v, pos_bias_u, pos_bias_v, p, lengths)
    return RelAttention.apply(q, k, v, pos_bias_u, pos_bias_v, p, lengths)


rel_attention.launches = 0
