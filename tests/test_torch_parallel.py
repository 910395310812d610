"""The port's parallelism (`speechless_tpu_torch.parallel`, the tensor-parallel model,
the data-parallel trainer, the split resident corpus, the sharded batch generator and
`Wav2Letter(mesh=)`) against the JAX package's on its 8-device CPU mesh.

The port's side runs in one gloo world of 4 CPU processes, spawned once for the module
(`torch_parallel_worker.py`): each process imports only torch and the port, and the
JAX references and the single-process runs are computed here. Weights are numpy-seeded
and cross as the JAX layout. Input 16 features, 5 classes, T = 64; the 250/2000-filter
convs are full width, as in JAX's tests.

Tolerances, with their reasons:
* logits: 1e-4 absolute, as `test_torch_model.py` (fp32 convs summed in another order,
  and the row-parallel product summed over the model group);
* gradients: rtol 1e-4 with an atol of 1e-5 of the layer's largest gradient (as
  `test_torch_train.py`);
* the DP x TP step against the port's single-process step on the same four rows: the
  loss rtol 1e-6; the gradients (Adam's first moments, 0.1 g) elementwise within 1e-5
  of the tensor's largest; the updated parameters rtol 1e-4 with an atol of 1e-2 * lr
  (`test_torch_train.py`'s bound for Adam's eps term) on every element outside Adam's
  eps regime. That regime is |g| < 1e-6 (100 eps): Adam's first step moves an element
  by lr * g / (|g| + eps), so there a change of g by 1e-8 moves the update by over 1 %
  of lr, and fp32 rounding of the gradient decides it (a gradient of exactly 0 in both
  steps is held: the parameter stays);
* the DP x TP step against JAX's mesh step: the loss rtol 1e-5 (as
  `test_torch_train.py`); the gradients within 1e-2 relative L2 per tensor, PERF.md
  section 2's limit for one fp32 step of two implementations; the updated parameters
  rtol 1e-4 with an atol of 1e-2 * lr on every element whose gradient lies outside the
  eps regime in both packages with the same sign, or is exactly 0 in both. The gradients cannot be held
  elementwise to JAX's at full width: a ReLU input within rounding of zero takes the
  derivative's other side (at this batch one big_conv_1 input of 4.7e-9 does so in the
  port's fp32 and not in fp64, which moves that layer's bias gradient of a weighted
  log-softmax by 2.2 % of its largest element, where JAX's fp32 stays within 6e-7 of
  fp64), and that moves the gradients upstream by up to ~3e-5, which changes the sign
  of some small elements or puts them into the eps regime. The share of each tensor
  left out is printed under ``-s`` (PERF.md section 6 gives it). On every element the
  parameter moved by at most lr, and every rank's parameters are equal;
* resident batches and the sharded generator's slices: exact; the split corpus's
  losses against the replicated layout's: rtol 1e-5;
* the facade: eval losses, and the epoch loss of `Configuration.train` on a mesh, rtol
  1e-4 (PERF.md section 2's facade limit); a checkpoint
  round trip across topologies: parameters and optimizer leaves exact.
"""
import csv
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeSpectrogram
from speechless_tpu.data.batching import ShardedBatchGenerator as JaxShardedBatchGenerator
from speechless_tpu.data.device_dataset import build_device_dataset as jax_build_dataset
from speechless_tpu.data import LibriSpeechCorpus as JaxLibriSpeechCorpus
from speechless_tpu.data import TrainingTestSplit as JaxTrainingTestSplit
from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.parallel import local_batch_to_global
from speechless_tpu.parallel import mesh as jax_mesh
from speechless_tpu.system import Wav2Letter as JaxWav2Letter
from speechless_tpu.text import CtcGraphemeCodec as JaxCodec
from speechless_tpu.train import Batch as JaxBatch
from speechless_tpu.train import init_train_state as jax_init_train_state
from speechless_tpu.train import make_optimizer as jax_make_optimizer
from speechless_tpu.train import make_train_step as jax_make_train_step
from speechless_tpu_torch.data import (LibriSpeechCorpus, ShardedBatchGenerator,
                                       TrainingTestSplit)
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.parallel import mesh as pmesh
from speechless_tpu_torch.parallel import run_multiprocess_dryrun
from speechless_tpu_torch.system import Wav2Letter
from speechless_tpu_torch.train import trainer

from test_corpus import make_librispeech_tree

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_worker import digests, load, save, spawn  # noqa: E402

FEATURES, CLASSES, FRAMES = 16, 5, 64
LR = 1e-3
CLIP = 1.0  # under the step's global gradient norm, so clipping acts
RESIDENT_LAYERS = (("striding_conv", 8, 5, 2, "relu"), ("inner_conv_1", 8, 3, 1, "relu"),
                   ("big_conv_1", 8, 3, 1, "relu"), ("big_conv_2", 8, 1, 1, "relu"),
                   ("output_conv", 5, 1, 1, "linear"))
RESIDENT_INDICES = np.array([[0, 6, 3, 5], [2, 4, 1, 6], [6, 0, 5, 2]])
PADDED_ROWS = np.array([7, 0, 3, 6])  # row 7: the padding, a copy of row 0
CONFIGURATION_TEXTS = ["ab", "dcba", "bad", "cab", "abc", "dd"]


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _batch(rng, rows):
    return (rng.randn(rows, FRAMES, FEATURES).astype(np.float32),
            np.full(rows, FRAMES, np.int32),
            rng.randint(0, CLASSES - 1, (rows, 8)).astype(np.int32),
            np.full(rows, 8, np.int32))


def _facade_specs():
    rng = np.random.RandomState(0)
    return [(rng.randn(30, 128).astype(np.float32), "ab") for _ in range(8)]


def _train(facade, specs, net_directory, epoch_limit):
    facade.train(iter(lambda: specs, None), preview_labeled_spectrogram_batch=specs[:2],
                 tensor_board_log_directory=net_directory / "logs",
                 net_directory=net_directory, batches_per_epoch=2,
                 epoch_limit=epoch_limit, callback_step=5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's inputs, the JAX facade's epoch 0 and trained run, the port's
    single-process run from it; then one world of 4 runs every case."""
    directory = tmp_path_factory.mktemp("parallel")
    config = w2l.Wav2LetterConfig(FEATURES, CLASSES)
    params = w2l.init_params(config, seed=1)
    rng = np.random.RandomState(2)
    inputs = rng.randn(2, FRAMES, FEATURES).astype(np.float32)
    weights = rng.randn(2, FRAMES // 2, CLASSES).astype(np.float32)
    save(directory, "tp_forward", {"config": (FEATURES, CLASSES), "params": params,
                                   "inputs": inputs, "weights": weights})
    batch = _batch(rng, 4)
    save(directory, "dpxtp_step", {"config": (FEATURES, CLASSES), "params": params,
                                   "batch": batch, "learning_rate": LR, "clip": CLIP})
    resident_config = w2l.Wav2LetterConfig(
        FEATURES, CLASSES, layers=tuple(w2l.ConvSpec(*layer) for layer in RESIDENT_LAYERS))
    examples = [(rng.randn(rng.randint(20, 40), FEATURES).astype(np.float32), text)
                for text in ("ab", "ba", "abc", "c", "dd", "bad", "cab")]
    save(directory, "resident", {
        "config": (FEATURES, CLASSES), "layers": RESIDENT_LAYERS,
        "params": w2l.init_params(resident_config, seed=3), "examples": examples,
        "characters": list("abcd"), "indices": RESIDENT_INDICES, "padded": PADDED_ROWS})
    base = directory / "corpus"
    make_librispeech_tree(base / "shard", ["a b", "c d", "e f", "g h", "i j", "k l"])
    save(directory, "sharded_generator", {"base": str(base)})

    # The facade: JAX's run on its mesh from its epoch 0, the port's single-process run
    # from the same epoch 0 (restored by the world), the world's runs read back here.
    specs = _facade_specs()
    fake = [FakeSpectrogram(spec, label) for spec, label in specs]
    jax_facade = JaxWav2Letter(128, list("abcd"), learning_rate=1e-4,
                               mesh=jax_mesh.make_mesh(model_parallelism=2))
    jax_facade.save(directory / "jax-run", 0)
    _train(jax_facade, fake, directory / "jax-run", 1)
    single = Wav2Letter(128, list("abcd"), device="cpu",
                        load_model_from_directory=directory / "jax-run", load_epoch=0)
    _train(single, fake, directory / "single-run", 1)
    save(directory, "facade", {"base": str(directory), "specs": specs})

    # `Configuration.train` on a 2 x 2 mesh from the same epoch 0, against JAX's facade
    # on its mesh fed each step's global batch (the data ranks' slices put together).
    make_librispeech_tree(base / "mini", CONFIGURATION_TEXTS)
    jax_corpus = JaxLibriSpeechCorpus(base_directory=base, corpus_name="mini",
                                      training_test_split=JaxTrainingTestSplit.training_only)
    global_batches = JaxShardedBatchGenerator(jax_corpus, directory / "jax-cache",
                                              batch_size=4, host_id=0, host_count=1)
    jax_configured = JaxWav2Letter(128, list("abcd"), learning_rate=1e-4,
                                   mesh=jax_mesh.make_mesh(model_parallelism=2),
                                   load_model_from_directory=directory / "jax-run",
                                   load_epoch=0)
    jax_configured.train(global_batches.training_batches(),
                         preview_labeled_spectrogram_batch=global_batches.preview_batch(),
                         tensor_board_log_directory=directory / "jax-configured" / "logs",
                         net_directory=directory / "jax-configured", batches_per_epoch=2,
                         epoch_limit=1)
    with (directory / "jax-configured" / "logs" / "scalars.csv").open() as f:
        jax_epoch = list(csv.reader(f))[1:]
    shutil.rmtree(directory / "jax-configured")  # a full-width checkpoint
    batches = global_batches.training_batches()
    jax_ids = [[s.id for s in next(batches)] for _ in range(2)]
    save(directory, "configuration_train", {"base": str(base),
                                            "jax_run": str(directory / "jax-run")})

    spawn(4, ["tp_forward", "dpxtp_step", "resident", "sharded_generator", "facade",
              "configuration_train"], directory)
    yield {"directory": directory, "config": config, "params": params, "inputs": inputs,
           "weights": weights, "batch": batch, "examples": examples, "base": base,
           "specs": fake, "jax_facade": jax_facade, "single": single,
           "jax_configured": (jax_ids, [row[:3] for row in jax_epoch]),
           "resident_config": resident_config}
    shutil.rmtree(directory)  # full-width checkpoints


def _relative_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _results(world, case):
    return [load(world["directory"], "{}.{}".format(case, rank)) for rank in range(4)]


def test_param_specs_match_jax():
    names = w2l.Wav2LetterConfig(FEATURES, CLASSES).layer_names
    want = jax_mesh.param_specs(names)
    got = pmesh.param_specs(names)
    assert [{k: tuple(v) for k, v in layer.items()} for layer in want] == got
    assert pmesh.shard_params([{"w": np.zeros((1, 4, 6)), "b": np.zeros(6)}],
                              [{"w": (None, None, "model"), "b": ("model",)}],
                              1, 2)[0]["w"].shape == (1, 4, 3)


def test_shard_params_match_jax_shards():
    """Each model rank's shards equal the addressable shards JAX places on the devices
    of that model index."""
    config = w2l.Wav2LetterConfig(FEATURES, CLASSES)
    params = w2l.init_params(config, seed=4)
    mesh = jax_mesh.make_mesh(jax.devices()[:4], model_parallelism=2)
    sharded = jax_mesh.shard_params(_jax_params(params),
                                    jax_mesh.param_shardings(mesh, config.layer_names))
    devices = np.asarray(mesh.devices)
    for model_rank in range(2):
        ours = pmesh.shard_params(params, pmesh.param_specs(config.layer_names),
                                  model_rank, 2)
        device = devices[0, model_rank]
        for mine, theirs in zip(ours, sharded):
            for key in ("w", "b"):
                shard = next(s for s in theirs[key].addressable_shards if s.device == device)
                np.testing.assert_array_equal(mine[key], np.asarray(shard.data))


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_forward_matches_jax(world, tp):
    jax_config = jax_w2l.Wav2LetterConfig(input_size_per_time_step=FEATURES,
                                          grapheme_set_size=CLASSES)
    params = _jax_params(world["params"])
    x = jnp.asarray(world["inputs"])
    want = np.asarray(jax_w2l.apply(jax_config, params, x))
    weights = jnp.asarray(world["weights"])
    want_grads = jax.grad(lambda p: jnp.sum(jax_w2l.apply(jax_config, p, x) * weights))(params)
    first, *others = [result[tp] for result in _results(world, "tp_forward")]
    np.testing.assert_allclose(first["logits"], want, rtol=0, atol=1e-4)
    for layer, want_layer in zip(first["grads"], want_grads):
        for key, axes in (("w", (2, 1, 0)), ("b", None)):
            want_array = np.asarray(want_layer[key])
            got_array = layer[key].transpose(axes) if axes else layer[key]
            np.testing.assert_allclose(got_array, want_array, rtol=1e-4,
                                       atol=1e-5 * np.abs(want_array).max())
    for other in others:  # every rank holds the same logits and gathered gradients
        assert other["logits"] == digests(first["logits"])
        assert other["grads"] == digests(first["grads"])


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_collective_count(world, tp):
    """Exactly one model-group all-reduce in the forward, after big_conv_2's product
    (none between the big convs), and one in the backward, on big_conv_1's input
    gradient: the port's counterpart of `examples/tp_collective_audit.py`."""
    for result in _results(world, "tp_forward"):
        assert result[tp]["forward"] == [("all_reduce", "model", "g: big_conv_2 output")]
        assert result[tp]["backward"] == [("all_reduce", "model",
                                           "f: big_conv_1 input gradient")]


@pytest.fixture(scope="module")
def jax_mesh_step(world):
    """JAX's `make_train_step` on a 2 x 2 mesh of the CPU devices, plain and clipped."""
    jax_config = jax_w2l.Wav2LetterConfig(input_size_per_time_step=FEATURES,
                                          grapheme_set_size=CLASSES)
    mesh = jax_mesh.make_mesh(jax.devices()[:4], model_parallelism=2)
    out = {}
    for name, clip in (("plain", None), ("clipped", CLIP)):
        optimizer = jax_make_optimizer(LR, gradient_clip_norm=clip)
        state = jax_init_train_state(jax_config, optimizer, jax.random.PRNGKey(0),
                                     params=_jax_params(world["params"]))
        params = jax_mesh.shard_params(state.params, jax_mesh.param_shardings(
            mesh, jax_config.layer_names))
        state = state._replace(params=params, opt_state=optimizer.init(params))
        with jax.set_mesh(mesh):
            batch = local_batch_to_global(mesh, JaxBatch(*world["batch"]))
            state, metrics = jax_make_train_step(jax_config, optimizer, donate=False)(
                state, batch)
            out[name] = (float(metrics["loss"]), jax.tree.map(np.asarray, state.params),
                         [np.asarray(leaf) for leaf
                          in jax.tree_util.tree_leaves(state.opt_state)])
    return out


@pytest.fixture(scope="module")
def single_step(world):
    """The port's single-process step on the same four rows, plain and clipped."""
    out = {}
    for name, clip in (("plain", None), ("clipped", CLIP)):
        optimizer = trainer.make_optimizer(LR, gradient_clip_norm=clip)
        state = trainer.init_train_state(world["config"], optimizer,
                                         params=world["params"], device="cpu")
        step = trainer.make_train_step(world["config"], optimizer, device="cpu")
        state, metrics = step(state, trainer.Batch(*world["batch"]))
        out[name] = (float(metrics["loss"]), state.params, state.opt_state.leaves())
    return out


def _parameters_and_moments(params, leaves):
    """The parameters and Adam's first moments in optax leaf order (b before w, layer by
    layer)."""
    flat = [layer[key] for layer in params for key in ("b", "w")]
    return flat, leaves[1:1 + len(flat)]


# Adam's eps regime, as a first moment (0.1 g): |g| < 100 eps = 1e-6.
EPS_REGIME_MOMENT = 0.1 * 1e-6


@pytest.mark.parametrize("name", ["plain", "clipped"])
def test_dp_tp_step_matches_jax_mesh_step(world, jax_mesh_step, single_step, name):
    """One step on a 2 x 2 mesh, each data rank on its two rows: the global mean loss
    on every rank; the gradients and updated parameters (with global-norm clipping over
    split and replicated tensors) against the port's single-process step on the four
    rows, and against JAX's step on a 2 x 2 mesh over them."""
    want_loss, want_params, want_leaves = jax_mesh_step[name]
    if name == "clipped":  # the norm exceeds the limit: every gradient is scaled down
        assert np.abs(want_leaves[1]).max() < 0.5 * np.abs(jax_mesh_step["plain"][2][1]).max()
    first, *others = [result[name] for result in _results(world, "dpxtp_step")]
    assert len(first["leaves"]) == len(want_leaves)
    params, moments = _parameters_and_moments(first["params"], first["leaves"])
    single_loss, *single = single_step[name]
    single_params, single_moments = _parameters_and_moments(*single)
    jax_params, jax_moments = _parameters_and_moments(want_params, want_leaves)
    initial, _ = _parameters_and_moments(world["params"], [])
    np.testing.assert_allclose(first["loss"], single_loss, rtol=1e-6)
    np.testing.assert_allclose(first["loss"], want_loss, rtol=1e-5)
    left_out = []
    for param, moment, start, single_param, single_moment, jax_param, jax_moment in zip(
            params, moments, initial, single_params, single_moments, jax_params,
            jax_moments):
        assert np.abs(param - start).max() <= LR * (1 + 1e-4)
        np.testing.assert_allclose(moment, single_moment, rtol=0,
                                   atol=1e-5 * np.abs(single_moment).max())
        # A gradient of exactly 0 (a unit no row of the batch reaches) leaves the
        # parameter where it was in both steps.
        outside = (np.abs(single_moment) >= EPS_REGIME_MOMENT) \
            | ((single_moment == 0) & (moment == 0))
        np.testing.assert_allclose(param[outside], single_param[outside], rtol=1e-4,
                                   atol=1e-2 * LR)
        assert _relative_l2(moment, jax_moment) <= 1e-2
        held = ((np.sign(moment) == np.sign(jax_moment))
                & (np.abs(moment) >= EPS_REGIME_MOMENT)
                & (np.abs(jax_moment) >= EPS_REGIME_MOMENT)) \
            | ((moment == 0) & (jax_moment == 0))
        np.testing.assert_allclose(param[held], jax_param[held], rtol=1e-4, atol=1e-2 * LR)
        left_out.append((param.shape,
                         float(np.abs(moment - single_moment).max()
                               / np.abs(single_moment).max()),
                         float(1 - outside.mean()), float(1 - held.mean())))
    print("\n{}: loss {!r}, single-process {!r}, JAX {!r}; each tensor's largest gradient "
          "gap to the single-process step (of its largest), and the share of its elements "
          "left out of the elementwise parameter check against that step and against "
          "JAX:".format(name, first["loss"], single_loss, want_loss))
    for entry in left_out:
        print("  {} {:.3g} {:.4f} {:.4f}".format(*entry))
    for got in [first, *others]:
        assert got["loss"] == first["loss"]
        if got is not first:
            assert got["params"] == digests(first["params"])
        data = [event for event in got["events"] if event[1] == "data"]
        assert data == [("all_reduce", "data", "gradients and loss")]
        if name == "clipped":
            assert ("all_reduce", "model", "gradient norm") in got["events"]


def test_dp_tp_step_leaves_gather_whole(world):
    """The optimizer leaves gathered on every rank are one state: equal on all ranks and
    shaped like a single-process state's."""
    results = _results(world, "dpxtp_step")
    optimizer = trainer.make_optimizer(LR)
    single = trainer.init_train_state(world["config"], optimizer, params=world["params"],
                                      device="cpu")
    shapes = [leaf.shape for leaf in single.opt_state.leaves()]
    first, *others = [result["plain"]["leaves"] for result in results]
    assert [leaf.shape for leaf in first] == shapes
    for leaves in others:  # shapes, dtypes and bytes
        assert leaves == digests(first)


def test_resident_split_sampling_matches_replicated_and_jax(world):
    """The corpus split over two data ranks (7 rows padded to 8 by repeating the first,
    as JAX pads) gathers, on every rank, the batches the replicated layout and JAX's
    `jnp.take` give; a device epoch on it steps like the replicated layout."""
    jax_mesh_8 = jax_mesh.make_mesh(jax.devices()[:8], model_parallelism=2)
    examples = [FakeSpectrogram(spec, label) for spec, label in world["examples"]]
    jax_dataset, _ = jax_build_dataset(examples, JaxCodec(list("abcd")), mesh=jax_mesh_8)
    for result in _results(world, "resident"):
        assert result["local_rows"] == 4  # 8 rows over data = 2
        for rows, batch in zip([*RESIDENT_INDICES, PADDED_ROWS], result["batches"]):
            for got, field in zip(batch, jax_dataset):
                np.testing.assert_array_equal(got, np.asarray(field)[rows])
        np.testing.assert_allclose(result["losses"][True], result["losses"][False],
                                   rtol=1e-5)


def test_sharded_batch_generator_matches_jax(world, tmp_path):
    """With ``host_id``/``host_count`` given, the port's slices and hints equal JAX's;
    in a world of 4 they default to its rank and size, also when
    `Configuration.batch_generator_for_corpus` builds one."""
    corpus = LibriSpeechCorpus(base_directory=world["base"], corpus_name="shard",
                               training_test_split=TrainingTestSplit.training_only)
    jax_corpus = JaxLibriSpeechCorpus(base_directory=world["base"], corpus_name="shard",
                                      training_test_split=JaxTrainingTestSplit.training_only)
    for host in range(2):
        for bucketed in (False, True):
            ours = ShardedBatchGenerator(corpus, tmp_path / "port", batch_size=4,
                                         host_id=host, host_count=2,
                                         bucket_training_batches=bucketed).training_batches()
            theirs = JaxShardedBatchGenerator(jax_corpus, tmp_path / "jax", batch_size=4,
                                              host_id=host, host_count=2,
                                              bucket_training_batches=bucketed
                                              ).training_batches()
            for _ in range(3):
                got, want = next(ours), next(theirs)
                assert [s.id for s in got] == [s.id for s in want]
                assert got.bucket_hints == want.bucket_hints
    with pytest.raises(ValueError, match="divide"):
        ShardedBatchGenerator(corpus, tmp_path / "port", batch_size=3, host_id=0,
                              host_count=2)
    for rank, result in enumerate(_results(world, "sharded_generator")):
        assert result["host"] == (rank, 4)
        want = JaxShardedBatchGenerator(jax_corpus, tmp_path / "jax", batch_size=4,
                                        host_id=rank, host_count=4).training_batches()
        assert result["ids"] == [[s.id for s in next(want)] for _ in range(3)]
        assert result["default"] == ("ShardedBatchGenerator", rank, 4)


def test_facade_trains_on_mesh(world):
    """`Wav2Letter(mesh=)` on a 2 x 2 mesh from JAX's epoch 0 (JAX's
    `test_facade_trains_on_mesh`): one epoch on each data rank's half of the batch, a
    checkpoint, eval of a batch that does not divide the data axis; its eval loss
    against the JAX facade trained on its mesh; a resident epoch on the split corpus."""
    want = world["jax_facade"].test_and_predict_batch(world["specs"][:4]).average_loss
    for result in _results(world, "facade"):
        assert result["checkpoint"] and result["step"] == 2
        assert result["eval3"][0] == 3 and np.isfinite(result["eval3"][1])
        np.testing.assert_allclose(result["loss"], want, rtol=1e-4)
        assert result["resident_step"] == 2


def test_configuration_trains_on_mesh(world):
    """`Configuration.train` of a facade on a 2 x 2 mesh: each data rank trains on its
    half of every global batch, and both ranks of a model group on the same half (the
    generator is sliced over the mesh's data axis, not over the world); the epoch's
    step and loss (``scalars.csv``) match JAX's facade on its mesh fed the global
    batches, loss rtol 1e-4."""
    jax_ids, jax_epoch = world["jax_configured"]
    for rank, result in enumerate(_results(world, "configuration_train")):
        data_rank = rank // 2  # the mesh is (data, model): ranks 2d and 2d + 1 share d
        assert result["host"] == (data_rank, 2)
        assert result["ids"] == [ids[2 * data_rank:2 * data_rank + 2] for ids in jax_ids]
        assert result["step"] == 2
        assert [row[:2] for row in result["epoch"]] == [row[:2] for row in jax_epoch]
        np.testing.assert_allclose(float(result["epoch"][0][2]), float(jax_epoch[0][2]),
                                   rtol=1e-4)
    print("\nConfiguration.train on a 2 x 2 mesh, epoch loss: port {}, JAX {}".format(
        result["epoch"][0][2], jax_epoch[0][2]))


def test_cross_topology_checkpoint_restore(world):
    """Mesh -> single process: the gathered parameters and optimizer leaves load
    exactly, the step and the eval loss carry over, training continues. Single process
    -> mesh: the world restored the single run's epoch 1 with its step and eval loss
    and trained on."""
    directory, single = world["directory"], world["single"]
    mesh_run = load(directory, "facade.0")
    restored = Wav2Letter(128, list("abcd"), device="cpu",
                          load_model_from_directory=directory / "mesh-run", load_epoch=1)
    assert restored.mesh is None and restored.state.step == 2
    for got_layer, want_layer in zip(restored.params, mesh_run["params"]):
        for key in want_layer:
            np.testing.assert_array_equal(got_layer[key], want_layer[key])
    for got, want in zip(restored.state.opt_state.leaves(), mesh_run["leaves"]):
        np.testing.assert_array_equal(got, want)
    specs = world["specs"]
    np.testing.assert_allclose(restored.test_and_predict_batch(specs[:4]).average_loss,
                               mesh_run["loss"], rtol=1e-4)
    _train(restored, specs, directory / "restored-run", 2)
    assert restored.state.step == 4

    want = single.test_and_predict_batch(specs[:4]).average_loss
    for rank, result in enumerate(_results(world, "facade")):
        assert result["restored_step"] == 2 and result["continued_step"] == 4
        np.testing.assert_allclose(result["restored_loss"], want, rtol=1e-4)
        if rank:  # every rank gathered the same parameters and optimizer leaves
            assert result["params"] == digests(mesh_run["params"])
            assert result["leaves"] == digests(mesh_run["leaves"])


def test_two_process_bootstrap():
    """Two real processes join a gloo world through `distributed_init` and run one
    DP x TP step each, with equal losses (JAX's `test_two_process_bootstrap`)."""
    run_multiprocess_dryrun(n_processes=2, model_parallelism=2, device="cpu",
                            backend="gloo")


def test_batch_rows_refuse_an_indivisible_batch():
    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (2, 1)[dim]

        def get_local_rank(self, axis):
            return 1

    assert pmesh.batch_rows(Mesh(), 6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.batch_rows(Mesh(), 3)
    assert torch.distributed.is_available() and not torch.distributed.is_initialized()
