"""The port's CTC loss (`speechless_tpu_torch.ops.ctc` and the kernel wrappers of
`ops.ctc_kernels` on CPU tensors) against the JAX package's `ctc_loss` (the `lax.scan`
recursion), `ctc_loss_pallas` (the TPU kernels, in interpret mode as
`tests/test_ctc_pallas.py` runs them) and `torch.nn.functional.ctc_loss`.

Tolerances: loss rtol 1e-5 (fp32 log-sum-exp chains of up to 140 steps, summed in
another order); gradients rtol 1e-4 / atol 1e-5 (the occupancy contraction sums the
states in another order); α on the valid region (t < length, s < 2U+1) atol 1e-5
relative to its magnitude; against `F.ctc_loss` (another algorithm, float64 there) loss
rtol 2e-4 and gradient atol 2e-4, as `tests/test_ctc.py` holds the JAX loss.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speechless_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from speechless_tpu.ops.ctc_pallas import _forward_pallas, ctc_loss_pallas
from speechless_tpu_torch.ops import _kernels, ctc, ctc_kernels

REPO = Path(__file__).resolve().parent.parent


def _log_probs(rng, batch, t_max, classes):
    logits = rng.normal(size=(batch, t_max, classes)) * 2.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def _random_case(seed, batch, t_max, u_max, classes):
    """Feasible rows: label lengths 1..U, frame counts 2U+1..T."""
    rng = np.random.default_rng(seed)
    label_lengths = rng.integers(1, u_max + 1, batch).astype(np.int32)
    lengths = np.array([rng.integers(2 * n + 1, t_max + 1) for n in label_lengths],
                       np.int32)
    labels = np.full((batch, u_max), -1, np.int32)
    for row, n in enumerate(label_lengths):
        labels[row, :n] = rng.integers(0, classes - 1, n)
    return _log_probs(rng, batch, t_max, classes), lengths, labels, label_lengths


def _edge_case(seed=3, t_max=12, classes=5):
    """Rows: random; 1 frame with an empty label; 1 frame with 1 label; adjacent
    repeats; infeasible (4 labels with 2 repeats need 6 frames, it has 5); a zero-frame
    row (last: the scan and the kernels disagree there)."""
    rng = np.random.default_rng(seed)
    labels = np.array([[0, 1, 2, 3], [-1, -1, -1, -1], [2, -1, -1, -1], [1, 1, 3, 3],
                       [0, 0, 2, 2], [3, 1, -1, -1]], np.int32)
    label_lengths = (labels >= 0).sum(1).astype(np.int32)
    lengths = np.array([12, 1, 1, 9, 5, 0], np.int32)
    return _log_probs(rng, len(labels), t_max, classes), lengths, labels, label_lengths


CASES = {
    "random": lambda: _random_case(0, 4, 20, 6, 7),
    "non_aligned_u65": lambda: _random_case(1, 5, 140, 65, 7),
    "edge_rows": _edge_case,
}


def _weights(batch):
    return np.linspace(0.5, 2.0, batch).astype(np.float32)  # grad_out scaling


@functools.lru_cache(maxsize=None)
def _jax_reference(case: str):
    """{"pallas"|"scan": (loss, d(sum(loss * weights))/d(log_probs))}, once per case."""
    log_probs, lengths, labels, label_lengths = CASES[case]()
    blank, weights = log_probs.shape[2] - 1, _weights(len(lengths))
    args = (jnp.asarray(lengths), jnp.asarray(labels), jnp.asarray(label_lengths))
    out = {}
    for name, loss_fn in (("pallas", ctc_loss_pallas), ("scan", jax_ctc_loss)):
        def weighted(x, loss_fn=loss_fn):
            loss = loss_fn(x, *args, blank)
            return jnp.sum(loss * weights), loss
        (_, loss), grad = jax.jit(jax.value_and_grad(weighted, has_aux=True))(
            jnp.asarray(log_probs))
        out[name] = (np.asarray(loss), np.asarray(grad))
    return out


def _port_loss_and_grad(loss_fn, log_probs, lengths, labels, label_lengths, blank, weights):
    x = torch.tensor(log_probs, requires_grad=True)
    loss = loss_fn(x, torch.from_numpy(lengths), torch.from_numpy(labels),
                   torch.from_numpy(label_lengths), blank)
    (loss * torch.from_numpy(weights)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("port_fn", [ctc.ctc_loss, ctc_kernels.ctc_loss],
                         ids=["plain", "kernel_wrapper_on_cpu"])
def test_loss_and_gradient_match_jax(case, port_fn):
    log_probs, lengths, labels, label_lengths = CASES[case]()
    got_loss, got_grad = _port_loss_and_grad(port_fn, log_probs, lengths, labels,
                                             label_lengths, log_probs.shape[2] - 1,
                                             _weights(len(lengths)))
    assert np.isfinite(got_loss).all() and np.isfinite(got_grad).all()
    want_loss, want_grad = _jax_reference(case)["pallas"]
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4, atol=1e-5)
    # The scan recursion agrees wherever a row has frames (it gives 1e30 for none).
    rows = lengths > 0
    scan_loss, scan_grad = _jax_reference(case)["scan"]
    np.testing.assert_allclose(got_loss[rows], scan_loss[rows], rtol=1e-5)
    np.testing.assert_allclose(got_grad[rows], scan_grad[rows], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_alphas_match_the_pallas_forward(case):
    """α of the plain recursion against the Pallas kernel's α (interpret mode) on each
    row's valid region, and the zero-length row's loss is the kernels' one."""
    log_probs, lengths, labels, label_lengths = CASES[case]()
    blank = log_probs.shape[2] - 1
    loss, residuals = jax.jit(_forward_pallas, static_argnums=4)(
        jnp.asarray(log_probs), jnp.asarray(lengths), jnp.asarray(labels),
        jnp.asarray(label_lengths), blank)
    want = np.asarray(residuals[8])  # (T, B', S') alphas
    extended, skip = ctc.extended_labels(torch.from_numpy(labels), blank)
    s_counts = torch.from_numpy(2 * label_lengths + 1)
    got = ctc.alpha_reference(torch.from_numpy(log_probs), torch.from_numpy(lengths),
                              extended, skip, s_counts).numpy()
    for row, (length, states) in enumerate(zip(lengths, s_counts.tolist())):
        frames = max(int(length), 1)  # alpha_0 is written even for a zero-length row
        region_got, region_want = got[:frames, row, :states], want[:frames, row, :states]
        np.testing.assert_allclose(region_got, region_want,
                                   atol=1e-5 * max(1.0, np.abs(region_want).max()), rtol=0)
        # Frozen past the length: every later slice repeats the last one.
        np.testing.assert_array_equal(got[frames:, row], np.broadcast_to(
            got[frames - 1, row], got[frames:, row].shape))
    np.testing.assert_allclose(
        ctc.ctc_loss(torch.from_numpy(log_probs), torch.from_numpy(lengths),
                     torch.from_numpy(labels), torch.from_numpy(label_lengths),
                     blank).numpy(), np.asarray(loss), rtol=1e-5)


def test_betas_give_the_same_log_likelihood_as_alphas():
    """On every feasible row, lse_s(α_t + β_t) is log P(label) at every valid t."""
    log_probs, lengths, labels, label_lengths = _random_case(4, 3, 30, 8, 6)
    blank = 5
    extended, skip = ctc.extended_labels(torch.from_numpy(labels), blank)
    s_counts = torch.from_numpy(2 * label_lengths + 1)
    args = (torch.from_numpy(log_probs), torch.from_numpy(lengths), extended, skip, s_counts)
    alphas, betas = ctc.alpha_reference(*args), ctc.beta_reference(*args)
    final = ctc.final_log_prob(alphas[-1], s_counts)
    for row, length in enumerate(lengths):
        total = torch.logsumexp(alphas[:length, row] + betas[:length, row], dim=1)
        np.testing.assert_allclose(total.numpy(), np.full(length, float(final[row])),
                                   rtol=1e-5)


def test_matches_torch_ctc_loss():
    """Against `F.ctc_loss` (blank = C-1, reduction "none") on feasible rows. Its gradient
    is the one with respect to the pre-softmax logits (softmax minus occupancy), so it
    is held against the gradient of `ctc_loss_from_logits`."""
    rng = np.random.default_rng(7)
    log_probs, lengths, labels, label_lengths = _random_case(7, 5, 40, 10, 8)
    logits = (rng.normal(size=log_probs.shape) * 2).astype(np.float32)
    log_probs = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    lp = torch.tensor(log_probs.transpose(1, 0, 2), dtype=torch.float64, requires_grad=True)
    targets = torch.from_numpy(np.concatenate([r[:n] for r, n in zip(labels, label_lengths)]))
    want = F.ctc_loss(lp, targets.long(), torch.from_numpy(lengths).long(),
                      torch.from_numpy(label_lengths).long(), blank=7, reduction="none")
    want.sum().backward()
    for loss_fn in (ctc.ctc_loss_from_logits, ctc_kernels.ctc_loss_from_logits):
        x = torch.tensor(logits, requires_grad=True)
        got = loss_fn(x, torch.from_numpy(lengths), torch.from_numpy(labels),
                      torch.from_numpy(label_lengths), 7)
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=2e-4)
        np.testing.assert_allclose(x.grad.numpy(), lp.grad.numpy().transpose(1, 0, 2),
                                   atol=2e-4)


def test_extended_labels_match_jax():
    from speechless_tpu.ops.ctc import _extended_labels

    labels = np.array([[1, 1, 2, -1], [3, 0, 3, 3], [-1, -1, -1, -1]], np.int32)
    want_ext, want_skip = _extended_labels(jnp.asarray(labels), 4)
    got_ext, got_skip = ctc.extended_labels(torch.from_numpy(labels), 4)
    np.testing.assert_array_equal(got_ext.numpy(), np.asarray(want_ext))
    np.testing.assert_array_equal(got_skip.numpy(), np.asarray(want_skip))
    assert got_ext.dtype == torch.int32 and got_skip.dtype == torch.bool


def test_wrappers_run_the_plain_versions_on_cpu_and_count_no_launch():
    log_probs, lengths, labels, label_lengths = _random_case(5, 3, 16, 4, 6)
    extended, skip = ctc.extended_labels(torch.from_numpy(labels), 5)
    args = (torch.from_numpy(log_probs), torch.from_numpy(lengths), extended, skip,
            torch.from_numpy(2 * label_lengths + 1))
    before = (ctc_kernels.ctc_alpha.launches, ctc_kernels.ctc_beta.launches)
    assert torch.equal(ctc_kernels.ctc_alpha(*args), ctc.alpha_reference(*args))
    assert torch.equal(ctc_kernels.ctc_beta(*args), ctc.beta_reference(*args))
    assert (ctc_kernels.ctc_alpha.launches, ctc_kernels.ctc_beta.launches) == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ctc_kernels.ctc_alpha(*(a.to("meta") for a in args))


def test_kernel_entry_points_match_their_ctypes_signatures():
    """The C entry point of each CUDA source takes the pointers, ints and floats, in the
    order, that `_kernels.SIGNATURES` declares (the sources are compiled only on the
    card)."""
    ctypes = _kernels.ctypes
    names = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
    for name, argtypes in _kernels.SIGNATURES.items():
        source = (REPO / "speechless_tpu_torch" / "csrc" / (name + ".cu")).read_text()
        match = re.search(r'extern "C" int {}\(([^)]*)\)'.format(name), source)
        assert match, name
        params = [p.strip() for p in match.group(1).split(",")]
        kinds = ["ptr" if "*" in p else p.split()[0] for p in params]
        assert kinds == [names[t] for t in argtypes], name
