"""A plain PyTorch model of ``csrc/rel_attention.cu``'s arithmetic, tile by tile, for the
CPU tests: the Conformer's relative-position attention core (see
`speechless_tpu_torch/ops/rel_attention.py` for the function) computed the way the kernel
pair computes it.

* Tiles of ``tile`` queries by ``tile`` keys; a query tile wholly past a row's length
  writes zeros, a key tile wholly past it is never visited, the boundary tile is masked
  element by element.
* The position term of a tile pair ``[i0, i0 + tile) x [j0, j0 + tile)``: one band of the
  ``2 tile - 1`` offsets ``i0 - j0 - (tile - 1) .. i0 - j0 + (tile - 1)`` (zero rows where an
  offset lies outside the table), one product ``qv . band^T`` and the skew: score ``(m,
  n)`` takes band column ``m - n + tile - 1``.
* Online softmax over the key tiles; each row's log-sum-exp is kept.
* The hand-written backward: ``D = rowsum(dO O)``; per key tile, over the query tiles
  below the row's length, S recomputed with its band, ``P = exp(S - LSE)``, ``dV += P^T
  dO``, ``dP = dO V^T``, ``dS = P (dP - D)``, ``dK += s dS^T qu``, ``dqu = s dS K``, ``dX``
  the skew of dS back into band layout, ``dqv = dX band``, ``d(band) = dX^T qv`` summed
  into the offsets' rows; then ``dq = dqu + s dqv``, ``du = sum dqu``, ``dv = s sum dqv``.

Everything in the inputs' type (the tests use fp32); ``qu`` and ``qv`` are rounded to
``q``'s type as the kernel rounds them to bf16.
"""
import math

import torch


def _rows(tensor, first, count):
    """``count`` rows of ``tensor`` from ``first`` (zero rows past its end)."""
    out = tensor.new_zeros((count,) + tuple(tensor.shape[1:]))
    available = max(0, min(count, tensor.shape[0] - first))
    out[:available] = tensor[first:first + available]
    return out


def _band(p_head, i0, j0, tile):
    """Band row ``c`` holds offset ``i0 - j0 + c - (tile - 1)``: p's row ``T' - 1`` less
    that, zero where the row is outside the table."""
    frames = (p_head.shape[0] + 1) // 2
    rows = frames - 1 - (i0 - j0 + torch.arange(2 * tile - 1) - (tile - 1))
    inside = (rows >= 0) & (rows < p_head.shape[0])
    band = p_head.new_zeros((2 * tile - 1, p_head.shape[1]))
    band[inside] = p_head[rows[inside]]
    return band, rows, inside


def _skew_index(tile):
    m = torch.arange(tile)
    return m[:, None] - m[None, :] + tile - 1    # (query m, key n) -> band column


def _scores(qu, qv, k, band, tile, scale):
    return scale * qu @ k.T + torch.gather(qv @ band.T, 1, _skew_index(tile))


def forward(q, k, v, pos_bias_u, pos_bias_v, p, lengths, tile=64):
    """``(O, LSE)``: O ``(B, T', H, d_k)``, zero past each row's length; LSE ``(B, H,
    T')`` each row's log-sum-exp of its scores (0 past its length)."""
    batch, frames, heads, head_dim = q.shape
    scale = 1.0 / math.sqrt(head_dim)
    qu = (q + pos_bias_u).to(q.dtype)
    qv = ((q + pos_bias_v) * scale).to(q.dtype)
    out = torch.zeros_like(q)
    lse = q.new_zeros((batch, heads, frames))
    for b in range(batch):
        length = int(lengths[b])
        for h in range(heads):
            for i0 in range(0, length, tile):
                q_u, q_v = _rows(qu[b, :, h], i0, tile), _rows(qv[b, :, h], i0, tile)
                most = q.new_full((tile,), -math.inf)
                total = q.new_zeros(tile)
                acc = q.new_zeros((tile, head_dim))
                for j0 in range(0, length, tile):
                    band, _, _ = _band(p[:, h], i0, j0, tile)
                    s = _scores(q_u, q_v, _rows(k[b, :, h], j0, tile), band, tile, scale)
                    s = s.masked_fill((j0 + torch.arange(tile) >= length)[None, :], -math.inf)
                    updated = torch.maximum(most, s.max(1).values)
                    weights = torch.exp(s - updated[:, None])
                    rescale = torch.exp(most - updated)
                    total = total * rescale + weights.sum(1)
                    acc = acc * rescale[:, None] + weights @ _rows(v[b, :, h], j0, tile)
                    most = updated
                rows = min(tile, length - i0)
                out[b, i0:i0 + rows, h] = (acc / total[:, None])[:rows]
                lse[b, h, i0:i0 + rows] = (most + torch.log(total))[:rows]
    return out, lse


def backward(q, k, v, pos_bias_u, pos_bias_v, p, lengths, out, lse, grad, tile=64):
    """The gradients ``(dq, dk, dv, du, dv_bias, dp)`` of `forward`'s O for the output
    gradient ``grad``, as the kernel pair forms them."""
    batch, frames, heads, head_dim = q.shape
    scale = 1.0 / math.sqrt(head_dim)
    qu = (q + pos_bias_u).to(q.dtype)
    qv = ((q + pos_bias_v) * scale).to(q.dtype)
    delta = (grad * out).sum(-1)                 # (B, T', H); O is 0 past each length
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dp = torch.zeros_like(p)
    du, dv_bias = torch.zeros_like(pos_bias_u), torch.zeros_like(pos_bias_v)
    skew = _skew_index(tile)
    for b in range(batch):
        length = int(lengths[b])
        for h in range(heads):
            for j0 in range(0, length, tile):
                k_t, v_t = _rows(k[b, :, h], j0, tile), _rows(v[b, :, h], j0, tile)
                dk_t, dv_t = torch.zeros_like(k_t), torch.zeros_like(v_t)
                key_out = j0 + torch.arange(tile) >= length
                for i0 in range(0, length, tile):
                    q_u, q_v = _rows(qu[b, :, h], i0, tile), _rows(qv[b, :, h], i0, tile)
                    d_o = _rows(grad[b, :, h], i0, tile)
                    query_out = i0 + torch.arange(tile) >= length
                    band, band_rows, inside = _band(p[:, h], i0, j0, tile)
                    s = _scores(q_u, q_v, k_t, band, tile, scale)
                    weights = torch.exp(s - _rows(lse[b, h], i0, tile)[:, None])
                    weights = weights.masked_fill(query_out[:, None] | key_out[None, :], 0.0)
                    dv_t += weights.T @ d_o
                    ds = weights * (d_o @ v_t.T - _rows(delta[b, :, h], i0, tile)[:, None])
                    dk_t += scale * ds.T @ q_u
                    d_qu = scale * ds @ k_t
                    d_x = ds.new_zeros((tile, 2 * tile - 1)).scatter_(1, skew, ds)
                    d_qv = d_x @ band
                    dp[band_rows[inside], h] += (d_x.T @ q_v)[inside]
                    rows = min(tile, length - i0)
                    dq[b, i0:i0 + rows, h] += (d_qu + scale * d_qv)[:rows]
                    du[h] += d_qu[:rows].sum(0)
                    dv_bias[h] += scale * d_qv[:rows].sum(0)
                rows = min(tile, frames - j0)
                dk[b, j0:j0 + rows, h] = dk_t[:rows]
                dv[b, j0:j0 + rows, h] = dv_t[:rows]
    return dq, dk, dv, du, dv_bias, dp
