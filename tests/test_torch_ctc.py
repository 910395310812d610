"""The port's CTC loss (`speechless_tpu_torch.ops.ctc` and the kernel wrappers of
`ops.ctc_kernels` on CPU tensors) against the JAX package's `ctc_loss` (the `lax.scan`
recursion), `ctc_loss_pallas` (the TPU kernels, in interpret mode as
`tests/test_ctc_pallas.py` runs them) and `torch.nn.functional.ctc_loss`; and plain
models of the CUDA kernels' orders (their thread layout of the states, their per-class
summation of the gradient) against the plain recursions.

Tolerances: loss rtol 1e-5 (fp32 log-sum-exp chains of up to 140 steps, summed in
another order); gradients rtol 1e-4 / atol 1e-5 (the occupancy contraction sums the
states in another order); α on the valid region (t < length, s < 2U+1) atol 1e-5
relative to its magnitude; against `F.ctc_loss` (another algorithm, float64 there) loss
rtol 2e-4 and gradient atol 2e-4, as `tests/test_ctc.py` holds the JAX loss; the
layout models bitwise (same arithmetic, only the neighbours' source differs); the
summation-order model atol 1e-6 (fp32 sums of occupancies at most 1 in another order).
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
    alphas = ctc.alpha_reference(*args)
    final = ctc.final_log_prob(alphas[-1], args[4])
    grad_out = torch.from_numpy(_weights(3))
    betas = ctc.beta_reference(*args)
    want = ctc.occupancy_gradient(args[0], args[1], extended, args[4], alphas, betas, final,
                                  grad_out)
    before = (ctc_kernels.ctc_alpha.launches, ctc_kernels.ctc_beta_grad.launches)
    got_alphas, got_final = ctc_kernels.ctc_alpha(*args)
    assert torch.equal(got_alphas, alphas) and torch.equal(got_final, final)
    assert torch.equal(ctc_kernels.ctc_beta_grad(*args, alphas, final, grad_out), want)
    got_grad, got_betas = ctc_kernels.ctc_beta_grad(*args, alphas, final, grad_out,
                                                    with_betas=True)
    assert torch.equal(got_grad, want) and torch.equal(got_betas, betas)
    assert (ctc_kernels.ctc_alpha.launches, ctc_kernels.ctc_beta_grad.launches) == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ctc_kernels.ctc_alpha(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ctc_kernels.ctc_beta_grad(*(a.to("meta") for a in (*args, alphas, final, grad_out)))


# ---- plain models of the kernels' orders (csrc/ctc_alpha.cu, csrc/ctc_beta_grad.cu) ----
# The kernels run on the card only; these models repeat, on the CPU, what their layout
# changes: which thread owns which state and where a neighbour's value comes from
# (ctc_common.cuh's published slots), and in which order the gradient's class sums are
# taken. The arithmetic of each state is the plain versions' own.

def _states_per_thread(s_count):
    """The K the C entry points pick: the least power of two with S / K <= 1024."""
    return next(k for k in (1, 2, 4, 8, 16) if s_count <= 1024 * k)


def _alpha_slot(s, k):
    return s if k == 1 else 2 * (s // k) + s % k - (k - 2)


def _beta_slot(s, k):
    return s if k == 1 else 2 * (s // k) + s % k


def _publish(values, k):
    """(B, threads, K) -> (B, 2 * threads): what each thread leaves for its neighbours
    (its last two states for alpha, its first two for beta; its one state for K = 1)."""
    batch, threads, _ = values.shape
    published = torch.full((batch, 2 * threads), ctc.NEG_INF)
    if k == 1:
        published[:, :threads] = values[:, :, 0]
    else:
        published[:, 0::2], published[:, 1::2] = values[:, :, 0], values[:, :, 1]
    return published


def _edge(published, states, slot, s_count, k):
    """(B, threads): the published value of state ``states[i]`` for thread i, NEG_INF
    where the state lies outside [0, S)."""
    inside = [0 <= s < s_count for s in states]
    index = torch.tensor([slot(s, k) if ok else 0 for s, ok in zip(states, inside)])
    return torch.where(torch.tensor(inside), published[:, index], ctc.NEG_INF)


def _alpha_model(log_probs, lengths, extended, skip, s_counts, k):
    """K1's layout: thread i owns states iK .. iK+K-1; s-1 and s-2 across a thread edge
    come from the previous thread's published last two (two threads back for K = 1)."""
    batch, t_max, _ = log_probs.shape
    s_count = extended.shape[1]
    threads = -(-s_count // k)
    pad = threads * k - s_count
    emit = F.pad(ctc.emissions(log_probs, extended), (0, pad)).view(batch, t_max, threads, k)
    s_index = torch.arange(threads * k).view(threads, k)
    live = s_index[None] < s_counts[:, None, None]
    can_skip = F.pad(skip, (0, pad)).view(batch, threads, k)
    value = torch.where(live & (s_index[None] < 2), emit[:, 0], ctc.NEG_INF)
    alphas = [value.reshape(batch, -1)[:, :s_count]]
    firsts = [i * k for i in range(threads)]
    for t in range(1, t_max):
        published = _publish(value[:, :, k - 2:] if k > 1 else value, k)
        edge1 = _edge(published, [f - 1 for f in firsts], _alpha_slot, s_count, k)
        edge2 = _edge(published, [f - 2 for f in firsts], _alpha_slot, s_count, k)
        new = value.clone()
        for j in range(k - 1, -1, -1):
            advance = value[:, :, j - 1] if j >= 1 else edge1
            back2 = value[:, :, j - 2] if j >= 2 else (edge1 if j == 1 else edge2)
            skipped = torch.where(can_skip[:, :, j], back2, ctc.NEG_INF)
            stepped = ctc._logsumexp3(value[:, :, j], advance, skipped) + emit[:, t, :, j]
            new[:, :, j] = torch.where(live[:, :, j], stepped, value[:, :, j])
        value = torch.where((t < lengths)[:, None, None], new, value)
        alphas.append(value.reshape(batch, -1)[:, :s_count])
    return torch.stack(alphas)


def _beta_model(log_probs, lengths, extended, skip, s_counts, k):
    """The fused backward's layout: as K1's, with s+1 and s+2 across a thread edge from
    the next thread's published first two (its published values are scored = β + E)."""
    batch, t_max, _ = log_probs.shape
    s_count = extended.shape[1]
    threads = -(-s_count // k)
    pad = threads * k - s_count
    emit = F.pad(ctc.emissions(log_probs, extended), (0, pad)).view(batch, t_max, threads, k)
    s_index = torch.arange(threads * k).view(threads, k)
    in_range = s_index < s_count
    live = s_index[None] < s_counts[:, None, None]
    skip_from = F.pad(skip, (0, pad + 2))[:, 2:].view(batch, threads, k)
    terminal = F.pad(ctc.beta_terminal(s_counts, s_count), (0, pad),
                     value=ctc.NEG_INF).view(batch, threads, k)
    scored = torch.where(in_range, terminal + emit[:, t_max - 1], ctc.NEG_INF)
    betas = [None] * t_max
    nexts = [(i + 1) * k for i in range(threads)]
    for t in range(t_max - 1, -1, -1):
        published = _publish(scored[:, :, :2], k)
        edge1 = _edge(published, nexts, _beta_slot, s_count, k)
        edge2 = _edge(published, [n + 1 for n in nexts], _beta_slot, s_count, k)
        value = torch.full_like(scored, ctc.NEG_INF)
        for j in range(k):
            advance = scored[:, :, j + 1] if j + 1 < k else edge1
            ahead2 = scored[:, :, j + 2] if j + 2 < k else (edge1 if j + 2 == k else edge2)
            skipped = torch.where(skip_from[:, :, j], ahead2, ctc.NEG_INF)
            stepped = ctc._logsumexp3(scored[:, :, j], advance, skipped)
            stepped = torch.where((t == lengths - 1)[:, None], terminal[:, :, j], stepped)
            value[:, :, j] = torch.where(live[:, :, j], stepped, ctc.NEG_INF)
        scored = torch.where(in_range, value + emit[:, t], ctc.NEG_INF)
        betas[t] = value.reshape(batch, -1)[:, :s_count]
    return torch.stack(betas)


@pytest.mark.parametrize("s_count,k", [(1, 1), (2, 1), (3, 1), (31, 1), (32, 1), (33, 1),
                                       (385, 1), (1201, 2), (385, 4), (385, 16)])
def test_kernel_state_layout_model_equals_the_plain_recursions(s_count, k):
    """α and β of the kernels' thread layout (K states a thread, edges through the
    published slots) equal `alpha_reference` bitwise and `beta_reference` bitwise on
    each row's valid frames, at the S that cross lane and warp edges and the K the
    entry points pick (plus K = 4 and 16 at S = 385)."""
    u_max = s_count // 2  # 2U+1 states, cut to S where S is even
    rng = np.random.default_rng(s_count + k)
    batch, t_max, classes = 3, 12, 6
    labels = np.full((batch, u_max), -1, np.int32)
    label_lengths = np.array([u_max, u_max // 2, max(u_max - 1, 0)], np.int32)
    for row, n in enumerate(label_lengths):
        labels[row, :n] = rng.integers(0, classes - 1, n)
    if u_max >= 2:
        labels[0, 1] = labels[0, 0]  # a repeat: no skip there
    lengths = np.array([t_max, t_max - 3, 1], np.int32)
    log_probs = _log_probs(rng, batch, t_max, classes)
    extended, skip = ctc.extended_labels(torch.from_numpy(labels), classes - 1)
    extended, skip = extended[:, :s_count].contiguous(), skip[:, :s_count].contiguous()
    args = (torch.from_numpy(log_probs), torch.from_numpy(lengths), extended, skip,
            torch.from_numpy(np.minimum(2 * label_lengths + 1, s_count)))
    if k == 1 or s_count > 1024:
        assert k == _states_per_thread(s_count)
    assert torch.equal(_alpha_model(*args, k), ctc.alpha_reference(*args))
    got, want = _beta_model(*args, k), ctc.beta_reference(*args)
    valid = torch.arange(t_max)[:, None] < torch.from_numpy(lengths)[None, :]
    assert torch.equal(got[valid], want[valid])


def _class_sum_model(log_probs, lengths, extended, s_counts, alphas, betas, final,
                     grad_out):
    """The fused backward's summation order: γ = exp((α + β) - logZ) of each row's live
    states, sorted by class (stable), summed in segments of at most L positions of one
    class (the least L >= 16 with L * L >= S), then each class's segments in order;
    -sum * grad_out for t < length, 0 * grad_out after."""
    batch, t_max, class_count = log_probs.shape
    segment = 16
    while segment * segment < extended.shape[1]:
        segment += 1
    grad = torch.zeros_like(log_probs)
    for row in range(batch):
        live = int(s_counts[row])
        gamma = torch.exp((alphas[:, row, :live] + betas[:, row, :live]) - final[row])
        order = torch.sort(extended[row, :live], stable=True).indices.tolist()
        classes = extended[row, :live].tolist()
        for c in range(class_count):
            members = [s for s in order if classes[s] == c]
            total = torch.zeros(t_max)
            for begin in range(0, len(members), segment):
                part = torch.zeros(t_max)
                for s in members[begin:begin + segment]:
                    part = part + gamma[:, s]
                total = total + part
            grad[row, :, c] = -total * grad_out[row]
        grad[row, max(int(lengths[row]), 0):] = 0.0 * grad_out[row]
    return grad


CLASS_SUM_CASES = dict(CASES, wide_s385=lambda: _random_case(8, 2, 400, 192, 29))


@pytest.mark.parametrize("case", sorted(CLASS_SUM_CASES))
def test_class_sum_order_model_equals_occupancy_gradient(case):
    """The fused backward's per-class summation order gives `occupancy_gradient`'s
    gradient within 1e-6 (another order of fp32 sums of occupancies at most 1), also at
    the bench's S = 385, where a segment holds 20 positions."""
    log_probs, lengths, labels, label_lengths = (torch.from_numpy(x)
                                                 for x in CLASS_SUM_CASES[case]())
    extended, skip = ctc.extended_labels(labels, log_probs.shape[2] - 1)
    s_counts = (2 * label_lengths + 1).to(torch.int32)
    args = (log_probs, lengths, extended, skip, s_counts)
    alphas, betas = ctc.alpha_reference(*args), ctc.beta_reference(*args)
    final = ctc.final_log_prob(alphas[-1], s_counts)
    grad_out = torch.from_numpy(_weights(len(lengths)))
    want = ctc.occupancy_gradient(log_probs, lengths, extended, s_counts, alphas, betas,
                                  final, grad_out)
    got = _class_sum_model(log_probs, lengths, extended, s_counts, alphas, betas, final,
                           grad_out)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


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
