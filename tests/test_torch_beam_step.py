"""The port's beam step (`speechless_tpu_torch.ops.decode_lm.lm_step_reference`,
the plain twin of the CUDA kernel) and its no-LM beam against the JAX package's
Pallas step kernel (`ops/decode_pallas_lm.py`, interpret mode on the CPU).

Tolerances: one step's integer outputs exact and float outputs within rtol/atol 1e-6
(log1p/exp of two libraries); beam tokens and counts exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.ops import decode_pallas_lm as jax_beam
from speechless_tpu_torch.ops import decode_lm
from speechless_tpu_torch.ops.beam_common import next_pow2

ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")
BLANK = len(ALPHABET)


def _peaky_log_probs(text, peak, rng=None):
    frames = []
    for c in text:
        for symbol in (ALPHABET.index(c), BLANK):
            row = np.zeros(len(ALPHABET) + 1)
            row[symbol] = peak
            frames.append(row)
    logits = np.asarray(frames)
    if rng is not None:
        logits = logits + rng.normal(size=logits.shape) * 1.5
    return logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))


def _batch(texts, seed):
    """Rows alternate peaky and noisy; lengths differ; padding frames are -30."""
    rng = np.random.default_rng(seed)
    rows = [_peaky_log_probs(t, 8.0 if i % 2 == 0 else 3.0, None if i % 2 == 0 else rng)
            for i, t in enumerate(texts)]
    t_max = max(r.shape[0] for r in rows)
    log_probs = np.full((len(rows), t_max, BLANK + 1), -30.0, np.float32)
    for i, r in enumerate(rows):
        log_probs[i, :r.shape[0]] = r
    return log_probs, np.asarray([r.shape[0] for r in rows], np.int32)


LM_TEXTS = ["the cat sat", "a dog ran to the log", "the zzz cat", " the  mat",
            "it's a cat", "dog", "a", "the dog ran to the cat", "the ca", "a log",
            "the mat sat", "cat"]


@pytest.mark.parametrize("width,batch,prune", [(8, 5, 8), (25, 12, 4)])
def test_frames_beam_matches_pallas_frames_beam(width, batch, prune):
    """``prune=4`` at W=25 gives 256 candidate lanes, between the serving 512 and 128."""
    log_probs, lengths = _batch(LM_TEXTS[::-1][:batch], seed=100 + width)
    want = jax_beam.beam_search_decode_pallas_frames(
        jnp.asarray(log_probs), jnp.asarray(lengths), blank=BLANK, beam_width=width,
        max_decoded_length=64, prune_classes=prune)
    got = decode_lm.beam_search_decode_frames(
        torch.from_numpy(log_probs), torch.from_numpy(lengths), BLANK,
        beam_width=width, max_decoded_length=64, prune_classes=prune)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _random_states(rng, batch, r, k, classes, max_len):
    logits = rng.normal(size=(batch, 1, classes)) * 3
    log_probs = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    pb = rng.uniform(-20, 0, (batch, r)).astype(np.float32)
    pnb = rng.uniform(-20, 0, (batch, r)).astype(np.float32)
    dead = rng.random((batch, r)) < 0.3
    pb[dead] = -1e30
    pnb[dead | (rng.random((batch, r)) < 0.2)] = -1e30
    hsh = rng.integers(-2 ** 31, 2 ** 31 - 1, (batch, r)).astype(np.int32)
    hsh[:, 5] = hsh[:, 3]  # duplicate prefixes exercise the merge
    hsh[:, 7] = hsh[:, 3]
    last = rng.integers(-1, classes - 1, (batch, r)).astype(np.int32)
    lens = rng.integers(0, max_len + 1, (batch, r)).astype(np.int32)
    lm = rng.normal(size=(batch, r)).astype(np.float32)
    bonus = rng.normal(size=(batch, r)).astype(np.float32)
    return log_probs, (pb, pnb, hsh, last, lens, lm, bonus)


def test_step_matches_pallas_step_kernel():
    """One frame at the serving shapes (16 rows, r=32, k=8, 29 classes, W=25)."""
    batch, width, k, classes, max_len, space = 16, 25, 8, 29, 40, 26
    r = next_pow2(width)
    n_pad = next_pow2((k + 1) * r)
    log_probs, states = _random_states(np.random.default_rng(0), batch, r, k, classes,
                                       max_len)
    frame = jax_beam._pack_frames(jnp.asarray(log_probs), k, batch)[0]
    step = jax_beam._build_step(batch, r, k, n_pad, classes, classes - 1, width, max_len,
                                space)
    want = step(frame, *states)
    ours = decode_lm.pack_frames(torch.from_numpy(log_probs), k)[0]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(frame)[:, :2 * k + classes])
    got = decode_lm.lm_step_reference(
        ours, *(torch.from_numpy(s) for s in states), k=k, blank=classes - 1,
        beam_width=width, max_decoded_length=max_len, space_index=space)
    for name, g, w in zip("pb pnb hash last len lm idx".split(), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)


def test_lm_step_runs_the_plain_step_on_cpu_tensors():
    batch, width, k, classes = 3, 8, 4, 6
    log_probs, states = _random_states(np.random.default_rng(1), batch, 8, k, classes, 9)
    frame = decode_lm.pack_frames(torch.from_numpy(log_probs), k)[0]
    static = dict(k=k, blank=classes - 1, beam_width=width, max_decoded_length=9,
                  space_index=-2)
    states = [torch.from_numpy(s) for s in states]
    launches = decode_lm.lm_step.launches
    for got, want in zip(decode_lm.lm_step(frame, *states, **static),
                         decode_lm.lm_step_reference(frame, *states, **static)):
        assert torch.equal(got, want)
    assert decode_lm.lm_step.launches == launches  # no kernel on CPU tensors
    with pytest.raises(ValueError, match="CPU or CUDA"):
        decode_lm.lm_step(*(t.to("meta") for t in [frame] + states), **static)


def test_pack_frames_breaks_ties_to_the_lower_class():
    log_probs = torch.tensor([[[-1.0, -0.5, -0.5, -2.0, -0.5]]])
    packed = decode_lm.pack_frames(log_probs, 3)
    assert packed.shape == (1, 1, 2 * 3 + 5)
    np.testing.assert_array_equal(packed[0, 0, 3:6].numpy(), [1.0, 2.0, 4.0])
