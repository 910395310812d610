"""The port's ASG criterion (`speechless_tpu_torch/ops/asg.py`), its training criteria
(`train/trainer.py`: ``"asg"`` and ``"asg_trainable"``) and checkpoints against the JAX
package's on the CPU, on the same numpy inputs (the facade: `test_torch_asg_facade.py`).

JAX's ASG is a pair of `lax.scan`s that compile per shape, so every JAX call here is
jitted once at T <= 40 frames, C <= 8 classes and U <= 6 labels, and the tests reuse
them.

Tolerances, with their reasons:
* losses and each graph's logadd: rtol 1e-5 (fp32 logsumexps in another order);
* gradients for the emissions and both tables: atol 1e-5 plus rtol 1e-5. A table's
  gradient sums B x T frame terms and reaches ~20, where fp32 summation in another
  order alone moves it by ~2e-5 (one element of 64 in `test_gradients_match_jax`);
* log-score tables: rtol 1e-6 (torch's and XLA's fp32 logs);
* default tables, Viterbi paths, decoded texts, averaged checkpoints: exact;
* after Adam steps: parameters and tables atol 1e-2 * lr, Adam moments as in
  `test_torch_train.py` (an element whose gradient is near zero moves by up to lr on
  a rounding difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.ops import asg as jax_asg
from speechless_tpu.train import checkpoint as jax_checkpoint
from speechless_tpu.train import trainer as jax_trainer
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.ops import asg
from speechless_tpu_torch.train import checkpoint, trainer

B, T, C, U = 6, 40, 8, 6
LR = 1e-3
LAYERS = (w2l.ConvSpec("striding_conv", 12, 9, 2),
          w2l.ConvSpec("big_conv_1", 16, 5, 1),
          w2l.ConvSpec("output_conv", C, 1, 1, "linear"))
FEATURES = 8


def _case(seed=0):
    """Rows of 40, 33, 1, 4, 6 and 20 frames: a full row, a ragged one, a length-1 row,
    U > T' (6 labels, 4 frames), U == T' (6 and 6) and an empty label."""
    rng = np.random.default_rng(seed)
    emissions = rng.normal(size=(B, T, C)).astype(np.float32)
    lengths = np.array([40, 33, 1, 4, 6, 20], np.int32)
    label_lengths = np.array([6, 3, 1, 6, 6, 0], np.int32)
    labels = rng.integers(0, C, (B, U)).astype(np.int32)
    labels[np.arange(U)[None] >= label_lengths[:, None]] = -1
    return emissions, lengths, labels, label_lengths


def _tables(seed=0):
    probabilities = (asg.default_asg_transition_probabilities(C, seed),
                     asg.default_asg_initial_probabilities(C, seed))
    return probabilities, asg.log_score_tables(*probabilities)


@jax.jit
def _jax_everything(emissions, lengths, labels, label_lengths, trans, init, trans_p, init_p):
    def total(e, t, i):
        return jnp.sum(jax_asg.asg_loss(e, lengths, labels, label_lengths,
                                        transition_log_scores=t, initial_log_scores=i))

    grads = jax.grad(total, argnums=(0, 1, 2))(emissions, trans, init)
    return {"log_scores": jax_asg.asg_loss(emissions, lengths, labels, label_lengths,
                                           transition_log_scores=trans,
                                           initial_log_scores=init),
            "probabilities": jax_asg.asg_loss(emissions, lengths, labels, label_lengths,
                                              transition_probabilities=trans_p,
                                              initial_probabilities=init_p),
            "defaults": jax_asg.asg_loss(emissions, lengths, labels, label_lengths),
            "free": jax_asg._free_graph_logadd(emissions, lengths, trans, init),
            "constrained": jax_asg._constrained_graph_logadd(emissions, lengths, labels,
                                                            label_lengths, trans, init),
            "grads": grads}


@pytest.fixture(scope="module")
def jax_results():
    """JAX's losses (three table spellings), both graphs and the gradients, for
    `_case()` with the seed-3 tables (the defaults spelling uses seed 0)."""
    case = _case()
    (trans_p, init_p), (trans, init) = _tables(seed=3)
    out = _jax_everything(*map(jnp.asarray, case + (trans, init, trans_p, init_p)))
    return case, (trans_p, init_p, trans, init), jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("size,seed", [(4, 0), (8, 0), (30, 0), (33, 5)])
def test_default_tables_are_bitwise_jax(size, seed):
    for ours, theirs in ((asg.default_asg_transition_probabilities,
                          jax_asg.default_asg_transition_probabilities),
                         (asg.default_asg_initial_probabilities,
                          jax_asg.default_asg_initial_probabilities)):
        got, want = ours(size, seed), theirs(size, seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_log_score_tables_match_jax():
    probabilities = (asg.default_asg_transition_probabilities(C, 1),
                     asg.default_asg_initial_probabilities(C, 1))
    for got, want in zip(asg.log_score_tables(*probabilities),
                         jax_asg.log_score_tables(*probabilities)):
        assert got.dtype == np.float32 and got.shape == want.shape
        finite = want > asg.NEG_INF
        np.testing.assert_array_equal(got[~finite], want[~finite])
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6)


@pytest.mark.parametrize("spelling", ["log_scores", "probabilities", "defaults"])
def test_loss_matches_jax(jax_results, spelling):
    """The loss over variable lengths, given the log-score tables, the reference-layout
    probability tables, or neither (the reference's random tables)."""
    case, (trans_p, init_p, trans, init), want = jax_results
    emissions, lengths, labels, label_lengths = map(torch.from_numpy, case)
    kwargs = {"log_scores": dict(transition_log_scores=torch.from_numpy(trans),
                                 initial_log_scores=torch.from_numpy(init)),
              "probabilities": dict(transition_probabilities=trans_p,
                                    initial_probabilities=init_p),
              "defaults": {}}[spelling]
    got = asg.asg_loss(emissions, lengths, labels, label_lengths, **kwargs).numpy()
    np.testing.assert_allclose(got, want[spelling], rtol=1e-5)


def test_each_graph_matches_jax(jax_results):
    case, (_, _, trans, init), want = jax_results
    emissions, lengths, labels, label_lengths = map(torch.from_numpy, case)
    trans, init = torch.from_numpy(trans), torch.from_numpy(init)
    free = asg._free_graph_logadd(emissions, lengths, trans, init).numpy()
    constrained = asg._constrained_graph_logadd(emissions, lengths, labels, label_lengths,
                                                trans, init).numpy()
    np.testing.assert_allclose(free, want["free"], rtol=1e-5)
    feasible = label_lengths.numpy() <= lengths.numpy()  # the others are ~NEG_INF
    np.testing.assert_allclose(constrained[feasible], want["constrained"][feasible],
                               rtol=1e-5)
    assert (constrained[~feasible] < -1e29).all() and (want["constrained"][~feasible]
                                                       < -1e29).all()


def test_gradients_match_jax(jax_results):
    """Autograd through both frame loops reaches the emissions and both tables; the
    infeasible and empty rows contribute nothing."""
    case, (_, _, trans, init), want = jax_results
    emissions = torch.from_numpy(case[0]).requires_grad_()
    trans, init = (torch.from_numpy(t).requires_grad_() for t in (trans, init))
    loss = asg.asg_loss(emissions, *map(torch.from_numpy, case[1:]),
                        transition_log_scores=trans, initial_log_scores=init)
    loss.sum().backward()
    for got, expected in zip((emissions.grad, trans.grad, init.grad), want["grads"]):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-5)
    infeasible = np.array([3, 5])  # U > T' and the empty label
    assert (loss.detach().numpy()[infeasible] == 0).all()
    assert (emissions.grad.numpy()[infeasible] == 0).all()


@pytest.fixture(scope="module")
def jax_viterbi():
    return jax.jit(jax_asg.asg_viterbi_decode)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_viterbi_paths_match_jax(jax_viterbi, kind):
    """Paths equal, with the length-1 row taking its argmax at t = 0 and padded frames
    repeating the final state. ``ties``: emissions and tables on a coarse grid, so that
    many predecessors tie and the first maximum decides."""
    emissions, lengths, _, _ = _case(seed=1)
    _, (trans, init) = _tables(seed=2)
    if kind == "ties":
        rng = np.random.default_rng(4)
        emissions = rng.integers(-2, 1, emissions.shape).astype(np.float32)
        trans = rng.integers(-1, 1, trans.shape).astype(np.float32)
        init = np.zeros_like(init)
    want = np.asarray(jax_viterbi(*map(jnp.asarray, (emissions, lengths, trans, init))))
    got = asg.asg_viterbi_decode(*map(torch.from_numpy, (emissions, lengths, trans, init)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2, 0] == int(np.argmax(emissions[2, 0] + init)) and (got[2] == got[2, 0]).all()


# ---- the trainer's criteria ---------------------------------------------------------

def _configs():
    config = w2l.Wav2LetterConfig(FEATURES, C, layers=LAYERS)
    jax_config = jax_w2l.Wav2LetterConfig(
        input_size_per_time_step=FEATURES, grapheme_set_size=C,
        layers=tuple(jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride,
                                      s.activation, False) for s in LAYERS))
    return config, jax_config


def _batch(seed=0):
    """80-frame rows (T' = 40, 33, 20, 3) with 6, 3, 2 and 5 labels (the last U > T')."""
    rng = np.random.default_rng(seed)
    inputs = rng.normal(size=(4, 2 * T, FEATURES)).astype(np.float32)
    lengths = np.array([80, 66, 40, 6], np.int32)
    label_lengths = np.array([6, 3, 2, 5], np.int32)
    labels = rng.integers(0, C, (4, U)).astype(np.int32)
    labels[np.arange(U)[None] >= label_lengths[:, None]] = -1
    return inputs, lengths, labels, label_lengths


def _params(seed=1):
    """The narrow model's weights and the seed-3 tables as the pseudo-layer."""
    _, (trans, init) = _tables(seed=3)
    return (w2l.init_params(_configs()[0], seed=seed)
            + [{"asg_transitions": trans, "asg_initials": init}])


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted steps, built once: the eval step per criterion and the
    trainable-table train step."""
    jax_config = _configs()[1]
    (trans_p, init_p), _ = _tables(seed=5)
    return {"eval_asg": jax_trainer.make_eval_step(jax_config, "asg",
                                                   jnp.asarray(trans_p), jnp.asarray(init_p)),
            "eval_asg_trainable": jax_trainer.make_eval_step(jax_config, "asg_trainable"),
            "train": jax_trainer.make_train_step(jax_config, jax_trainer.make_optimizer(LR),
                                                 donate=False, criterion="asg_trainable")}


@pytest.mark.parametrize("criterion", ["asg", "asg_trainable"])
def test_loss_fn_and_eval_step_match_jax(jax_steps, criterion):
    """`loss_fn` (the mean and per-example losses) and `make_eval_step` (log-probs,
    lengths, losses) against JAX's eval step: fixed tables (seed 5) or the model's."""
    config = _configs()[0]
    params = _params()
    if criterion == "asg":
        params = params[:-1]
    (trans_p, init_p), _ = _tables(seed=5)
    tables = dict(asg_transitions=trans_p, asg_initials=init_p) if criterion == "asg" else {}
    batch = _batch()
    want = jax_steps["eval_" + criterion](_jax_params(params),
                                          jax_trainer.Batch(*map(jnp.asarray, batch)))
    model = w2l.build_model(config, params, device="cpu")
    torch_batch = trainer.Batch(*map(torch.from_numpy, batch))
    log_probs, lengths, losses = trainer.make_eval_step(config, criterion,
                                                        **tables)(model, torch_batch)
    np.testing.assert_allclose(log_probs.numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(losses.numpy(), np.asarray(want[2]), rtol=1e-5)
    assert losses[3] == 0  # U > T'
    fixed = (asg.log_tables_on("cpu", config.grapheme_set_size, trans_p, init_p)
             if criterion == "asg" else None)
    mean, per_example = trainer.loss_fn(config, model, torch_batch, criterion, train=False,
                                        asg_tables=fixed)
    np.testing.assert_allclose(per_example.detach().numpy(), np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_allclose(float(mean.detach()), float(np.mean(want[2])), rtol=1e-5)


def _assert_params_close(want_params, got_params, lr=LR):
    assert len(want_params) == len(got_params)
    for want, got in zip(want_params, got_params):
        assert sorted(want) == sorted(got)
        for key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                       atol=1e-2 * lr)


def _assert_leaves_close(jax_opt_state, port_leaves):
    want = jax.tree_util.tree_leaves(jax_opt_state)
    assert len(want) == len(port_leaves)
    for w, g in zip(want, port_leaves):
        w = np.asarray(w)
        assert w.shape == g.shape and w.dtype == g.dtype
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1e-30))


def test_trainable_table_step_matches_jax(jax_steps):
    """One ``asg_trainable`` step from the same weights and tables: the loss, then every
    parameter and the tables' deltas, and the Adam leaves with the tables after the
    convs (``asg_initials`` before ``asg_transitions``, as optax flattens the dict)."""
    config, jax_config = _configs()
    params = _params()
    jax_state = jax_trainer.init_train_state(jax_config, jax_trainer.make_optimizer(LR),
                                             jax.random.PRNGKey(0), params=_jax_params(params))
    jax_state, jax_metrics = jax_steps["train"](jax_state, jax_trainer.Batch(
        *map(jnp.asarray, _batch())))
    state = trainer.init_train_state(config, trainer.make_optimizer(LR), params=params,
                                     device="cpu")
    state, metrics = trainer.make_train_step(config, None, "asg_trainable", device="cpu")(
        state, trainer.Batch(*_batch()))
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-5)
    _assert_params_close(jax_state.params, state.params)
    for key in ("asg_transitions", "asg_initials"):
        want = np.asarray(jax_state.params[-1][key]) - params[-1][key]
        got = state.params[-1][key] - params[-1][key]
        assert np.abs(want).max() > 0.5 * LR  # the tables moved
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * LR)
    leaves = state.opt_state.leaves()
    _assert_leaves_close(jax_state.opt_state, leaves)
    moments = 2 * len(LAYERS) + 2
    assert [leaf.shape for leaf in leaves[1 + moments - 2:1 + moments]] == [(C,), (C, C)]


def test_checkpoints_resume_across_packages_and_average(tmp_path, jax_steps):
    """A trainable-ASG checkpoint written by either package resumes in the other with
    the same parameters, tables and optimizer leaves, and its next step equals the
    writer's own next step; two epochs average to the same arrays in both packages."""
    config, jax_config = _configs()
    params = _params()
    optimizer = trainer.make_optimizer(LR)
    jax_optimizer = jax_trainer.make_optimizer(LR)
    step = trainer.make_train_step(config, None, "asg_trainable", device="cpu")
    batches = [_batch(seed) for seed in range(2)]

    state = trainer.init_train_state(config, optimizer, params=params, device="cpu")
    state, _ = step(state, trainer.Batch(*batches[0]))
    checkpoint.save_checkpoint(tmp_path / "port", 1, state.params,
                               state.opt_state.leaves(), step=state.step)
    jax_state = jax_trainer.init_train_state(jax_config, jax_optimizer, jax.random.PRNGKey(0),
                                             params=_jax_params(params))
    jax_state, _ = jax_steps["train"](jax_state, jax_trainer.Batch(*map(jnp.asarray,
                                                                         batches[0])))
    jax_checkpoint.save_checkpoint(tmp_path / "jax", 1, jax_state.params,
                                   jax_state.opt_state, step=int(jax_state.step))

    # The port's checkpoint in JAX.
    loaded = jax_checkpoint.load_params(tmp_path / "port", 1)
    resumed = jax_trainer.TrainState(
        step=jnp.asarray(jax_checkpoint.load_step(tmp_path / "port", 1), jnp.int32),
        params=loaded, opt_state=jax_checkpoint.load_opt_state(
            tmp_path / "port", 1, jax_optimizer.init(loaded)),
        dropout_rng=jax.random.PRNGKey(0))
    assert resumed.opt_state is not None and sorted(loaded[-1]) == ["asg_initials",
                                                                   "asg_transitions"]
    resumed, _ = jax_steps["train"](resumed, jax_trainer.Batch(*map(jnp.asarray,
                                                                     batches[1])))
    # JAX's checkpoint in the port.
    port_resumed = trainer.init_train_state(
        config, optimizer, params=checkpoint.load_params(tmp_path / "jax", 1), device="cpu")
    assert port_resumed.model.asg is not None
    assert checkpoint.load_opt_state(tmp_path / "jax", 1, port_resumed.opt_state) is not None
    _assert_leaves_close(jax_state.opt_state, port_resumed.opt_state.leaves())
    port_resumed.step = checkpoint.load_step(tmp_path / "jax", 1)
    step(port_resumed, trainer.Batch(*batches[1]))

    jax_straight, _ = jax_steps["train"](jax_state, jax_trainer.Batch(*map(jnp.asarray,
                                                                           batches[1])))
    state, _ = step(state, trainer.Batch(*batches[1]))
    _assert_params_close(jax_straight.params, resumed.params)
    _assert_params_close(state.params, port_resumed.params)
    assert int(resumed.step) == port_resumed.step == state.step == 2

    checkpoint.save_checkpoint(tmp_path / "port", 2, state.params)
    averaged = checkpoint.average_checkpoint_params(tmp_path / "port", [1, 2])
    jax_averaged = jax_checkpoint.average_checkpoint_params(tmp_path / "port", [1, 2])
    assert [sorted(layer) for layer in averaged] == [sorted(layer) for layer in jax_averaged]
    for got, want in zip(averaged, jax_averaged):
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
