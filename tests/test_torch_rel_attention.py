"""The Conformer's relative-position attention core (`ops/rel_attention.py`) on the CPU.

A plain model of the kernel pair's tile arithmetic (`plain_rel_attention.py`: the band
product and its skew, the skipped tiles, the online softmax, the hand-written backward)
and the kernel's plain version `rel_attention_reference` are held against the library
route the Conformer keeps off the card (`models/conformer.py::library_attention`:
``rel_shift``, the -10000 mask, SDPA's math backend, the zeroed rows), in fp32: the
output and the gradients of q, k, v, u, v and ``linear_pos``'s weight. Tolerances: rtol
1e-4 with an atol of 1e-5 of the tensor's largest value (fp32 on both sides; the sums run
in another order: tiles, the online softmax's rescaling, the band products). The
kernel itself runs only on the card (`chip_smoke.py --attention-only`); the C entry
point's argument list is checked against `_kernels.SIGNATURES` in `test_torch_ctc.py`.
"""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_rel_attention as tiles
from speechless_tpu_torch.models import conformer
from speechless_tpu_torch.ops import rel_attention
from speechless_tpu_torch.utils import trace

HEADS, HEAD_DIM = 2, 64


def close(got, want, what):
    scale = float(want.detach().abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale + 1e-12, msg=what)


def make_inputs(frames, lengths, seed=0):
    """Leaves q, k, v (B, T', H, 64), u and v (H, 64), linear_pos's weight (d, d), and the
    lengths; every value drawn about a nonzero start."""
    generator = torch.Generator().manual_seed(seed)
    shape = (len(lengths), frames, HEADS, HEAD_DIM)
    d = HEADS * HEAD_DIM
    leaves = [torch.randn(shape, generator=generator) for _ in range(3)]
    leaves += [0.5 * torch.randn((HEADS, HEAD_DIM), generator=generator) for _ in range(2)]
    leaves.append(torch.randn((d, d), generator=generator) / math.sqrt(d))
    for leaf in leaves:
        leaf.requires_grad_(True)
    return leaves, torch.tensor(lengths, dtype=torch.int32)


def positions_of(weight, frames):
    table = conformer.relative_positions(frames, weight.shape[0], "cpu")
    return (table @ weight.T).view(2 * frames - 1, HEADS, HEAD_DIM)


def library_route(leaves, lengths):
    q, k, v, u, vb, weight = leaves
    frames = q.shape[1]
    valid = torch.arange(frames)[None, :] < lengths[:, None]
    pair_masked = ~(valid[:, None, :, None] & valid[:, None, None, :])
    return conformer.library_attention(q, k, v, u, vb, positions_of(weight, frames),
                                       pair_masked, ~valid[:, None, :, None], torch.float32)


def gradients(out, leaves, grad):
    return torch.autograd.grad(out, leaves, grad)


NAMES = ("q", "k", "v", "u", "v bias", "linear_pos")
# Lengths 1, tile - 1, tile, tile + 1 and T' in a T' that is not a multiple of the tile;
# a T' of exactly one tile; a row whose length is one more than two tiles.
CASES = [(150, (1, 63, 64, 65, 150)), (64, (64, 1, 33)), (129, (129, 100, 2))]


@pytest.mark.parametrize("frames,lengths", CASES, ids=["ragged", "one-tile", "three-tiles"])
def test_the_tile_model_matches_the_library_route(frames, lengths):
    leaves, lens = make_inputs(frames, lengths)
    want = library_route(leaves, lens)
    grad = torch.randn(want.shape, generator=torch.Generator().manual_seed(7))
    want_grads = gradients(want, leaves, grad)

    q, k, v, u, vb, weight = leaves
    with torch.no_grad():
        p = positions_of(weight, frames)
        out, lse = tiles.forward(q, k, v, u, vb, p, lens)
        close(out, want, "O")
        dq, dk, dv, du, dvb, dp = tiles.backward(q, k, v, u, vb, p, lens, out, lse, grad)
        table = conformer.relative_positions(frames, weight.shape[0], "cpu")
        d_weight = dp.reshape(2 * frames - 1, -1).T @ table
    for name, got, expected in zip(NAMES, (dq, dk, dv, du, dvb, d_weight), want_grads):
        close(got, expected, name)
    for row, own in enumerate(lengths):
        assert torch.equal(out[row, own:], torch.zeros_like(out[row, own:]))
        assert torch.equal(lse[row, :, own:], torch.zeros_like(lse[row, :, own:]))


@pytest.mark.parametrize("frames,lengths", CASES[:2], ids=["ragged", "one-tile"])
def test_the_tile_model_keeps_each_rows_log_sum_exp(frames, lengths):
    leaves, lens = make_inputs(frames, lengths, seed=3)
    q, k, v, u, vb, weight = (leaf.detach() for leaf in leaves)
    p = positions_of(weight, frames)
    _, lse = tiles.forward(q, k, v, u, vb, p, lens)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    qu, qv = q + u, (q + vb) * scale
    offsets = torch.arange(frames)[:, None] - torch.arange(frames)[None, :]
    scores = (torch.einsum("bihd,bjhd->bhij", qu, k) * scale
              + torch.einsum("bihd,ijhd->bhij", qv, p[frames - 1 - offsets]))
    for row, own in enumerate(lengths):
        want = scores[row, :, :own, :own].logsumexp(-1)
        close(lse[row, :, :own], want, "LSE of row {}".format(row))


@pytest.mark.parametrize("frames,lengths", CASES, ids=["ragged", "one-tile", "three-tiles"])
def test_the_plain_version_matches_the_library_route(frames, lengths):
    leaves, lens = make_inputs(frames, lengths, seed=1)
    want = library_route(leaves, lens)
    grad = torch.randn(want.shape, generator=torch.Generator().manual_seed(8))
    q, k, v, u, vb, weight = leaves
    got = rel_attention.rel_attention_reference(q, k, v, u, vb, positions_of(weight, frames),
                                                lens)
    close(got, want, "O")
    for name, got_grad, want_grad in zip(NAMES, gradients(got, leaves, grad),
                                         gradients(want, leaves, grad)):
        close(got_grad, want_grad, name)


@pytest.mark.parametrize("frames,lengths", CASES, ids=["ragged", "one-tile", "three-tiles"])
def test_the_plain_versions_log_sum_exp_is_the_tile_models(frames, lengths):
    """The LSE the checks on the card hold the kernel's to: the plain version's over each
    row's valid keys, 0 past its length, equal to the tile model's online one."""
    leaves, lens = make_inputs(frames, lengths, seed=4)
    q, k, v, u, vb, weight = (leaf.detach() for leaf in leaves)
    p = positions_of(weight, frames)
    _, want = tiles.forward(q, k, v, u, vb, p, lens)
    _, lse = rel_attention.rel_attention_reference(q, k, v, u, vb, p, lens, with_lse=True)
    close(lse, want, "LSE")


def test_the_route_takes_the_kernel_only_on_the_card_in_bf16_at_64():
    cuda = torch.device("cuda")
    assert rel_attention.takes_kernel(cuda, torch.bfloat16, 64)
    assert not rel_attention.takes_kernel(torch.device("cpu"), torch.bfloat16, 64)
    assert not rel_attention.takes_kernel(cuda, torch.float32, 64)
    assert not rel_attention.takes_kernel(cuda, torch.bfloat16, 32)


SMALL = conformer.ConformerConfig(feat_in=12, d_model=128, n_heads=2, n_layers=2,
                                  conv_kernel=7, subsampling_channels=8, grapheme_set_size=6)
# 600, 250 and 9 input frames: 150, 63 and 3 of the padded 150 after subsampling.
INPUT_LENGTHS = (600, 250, 9)


def conformer_batch(config):
    generator = torch.Generator().manual_seed(5)
    inputs = torch.randn((len(INPUT_LENGTHS), 600, config.feat_in), generator=generator)
    lengths = torch.tensor(INPUT_LENGTHS, dtype=torch.int32)
    inputs[torch.arange(600)[None, :] >= lengths[:, None]] = 0.0
    return inputs, lengths


def spy(monkeypatch):
    """Counts the attention core's calls a route; the kernel's route runs the kernel's
    plain version, since the kernel takes only CUDA tensors."""
    calls = {"kernel": 0, "library": 0}
    library = conformer.library_attention

    def on_kernel(*args):
        calls["kernel"] += 1
        return rel_attention.rel_attention_reference(*args)

    def on_library(*args):
        calls["library"] += 1
        return library(*args)

    monkeypatch.setattr(rel_attention, "rel_attention", on_kernel)
    monkeypatch.setattr(conformer, "library_attention", on_library)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_cpu_keeps_the_library_route_and_counts_no_tiles(monkeypatch, dtype):
    config = conformer.ConformerConfig(**{**SMALL.__dict__, "compute_dtype": dtype})
    model = conformer.build_model(config, conformer.init_params(config, 0), device="cpu")
    inputs, lengths = conformer_batch(config)
    calls = spy(monkeypatch)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        model(inputs, input_lengths=lengths)
        counters = trace.snapshot()["counters"]
    assert calls == {"kernel": 0, "library": 2}
    assert "conformer.attn_tiles" not in counters and "conformer.attn_tiles_run" not in counters
    assert counters["conformer.attn_pairs"] == 3 * 150 * 150


def test_the_kernel_route_gives_the_library_routes_model_and_counts_its_tiles(monkeypatch):
    """The kernel's route forced on CPU tensors (`spy` runs the kernel's plain version
    there): the same logits and parameter gradients as the library route, one call a
    block, and the tile counters."""
    params = conformer.init_params(SMALL, 0)
    generator = torch.Generator().manual_seed(2)
    for name, value in params.items():  # every bias and position bias away from 0
        if value.dim() == 1 or "pos_bias" in name:
            params[name] = value + 0.2 * torch.randn(value.shape, generator=generator)
    inputs, lengths = conformer_batch(SMALL)

    def run():
        model = conformer.build_model(SMALL, params, device="cpu")
        logits = model(inputs, input_lengths=lengths)
        logits.square().mean().backward()
        return logits.detach(), {n: p.grad for n, p in model.named_parameters()}

    want_logits, want_grads = run()
    calls = spy(monkeypatch)
    monkeypatch.setattr(rel_attention, "takes_kernel", lambda *args: True)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got_logits, got_grads = run()
        counters = trace.snapshot()["counters"]
    assert calls == {"kernel": 2, "library": 0}
    close(got_logits, want_logits, "logits")
    for name, grad in want_grads.items():
        if name.endswith(("linear_k.bias", "depthwise_conv.bias")):
            continue  # rounding on both routes: see test_torch_conformer.ROUNDING_ONLY
        close(got_grads[name], grad, name)
    # 150, 63 and 3 frames of 150: 3 x 3 x 3 tiles, of which 9 + 1 + 1 run
    assert counters["conformer.attn_tiles"] == 27
    assert counters["conformer.attn_tiles_run"] == 11


def test_tile_counts():
    lengths = torch.tensor([1, 63, 64, 65, 150], dtype=torch.int32)
    tiles_all, tiles_run = rel_attention.tile_counts(lengths, 150)
    assert tiles_all == 5 * 3 * 3
    assert int(tiles_run) == 1 + 1 + 1 + 4 + 9


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((2, 8, HEADS, HEAD_DIM), dtype=torch.bfloat16)
    p = torch.zeros((15, HEADS, HEAD_DIM), dtype=torch.bfloat16)
    bias = torch.zeros((HEADS, HEAD_DIM))
    lengths = torch.tensor([8, 3], dtype=torch.int32)
    rel_attention._check(q, q, q, bias, bias, p, lengths)
    for bad in ({"q": q.float()}, {"p": p[:-1]}, {"u": bias.to(torch.bfloat16)},
                {"lengths": lengths.long()}, {"k": q[:, :, :1]},
                {"q": torch.zeros((2, 8, 4, 32), dtype=torch.bfloat16)}):
        args = {"q": q, "k": q, "v": q, "u": bias, "vb": bias, "p": p, "lengths": lengths}
        args.update(bad)
        with pytest.raises(ValueError, match="rel_attention"):
            rel_attention._check(args["q"], args["k"], args["v"], args["u"], args["vb"],
                                 args["p"], args["lengths"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        rel_attention.rel_attention(q, q, q, bias, bias, p, lengths)
