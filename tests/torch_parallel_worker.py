"""Worlds of processes for the port's parallel tests (`test_torch_parallel.py`,
`test_torch_sequence_parallel.py`).

A test module's fixture writes each case's inputs into a directory (`save`), `spawn`
starts a gloo world of CPU processes that each run the named cases in turn and write
their results beside them, and the tests read those (`load`). The processes import only
torch, numpy and the port: no pytest worker creates a process group, and the JAX
references are computed in the test process.

    python tests/torch_parallel_worker.py RANK WORLD PORT DIRECTORY CASE...
"""
import hashlib
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def save(directory: Path, name: str, value) -> None:
    with open(Path(directory) / (name + ".pkl"), "wb") as f:
        pickle.dump(value, f)


def load(directory: Path, name: str):
    with open(Path(directory) / (name + ".pkl"), "rb") as f:
        return pickle.load(f)


def digests(value):
    """``value`` with every array replaced by its shape, dtype and SHA-256. The ranks
    after the first save their full-width results so (a few hundred MB a rank less on
    the disk), and the tests hold them to the first rank's bitwise."""
    if isinstance(value, np.ndarray):
        return ("array", value.shape, str(value.dtype),
                hashlib.sha256(np.ascontiguousarray(value).tobytes()).hexdigest())
    if isinstance(value, dict):
        return {key: digests(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(digests(item) for item in value)
    return value


def save_ranked(directory: Path, name: str, rank: int, value) -> None:
    """Rank 0's result whole, the others' as `digests`."""
    save(directory, "{}.{}".format(name, rank), value if rank == 0 else digests(value))


def spawn(world: int, cases, directory: Path, timeout: float = 600.0) -> None:
    """Run ``cases`` in a gloo world of ``world`` processes on the CPU; raises with
    every process's output when one fails."""
    sys.path.insert(0, str(ROOT))
    from speechless_tpu_torch.parallel.distributed import free_port

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    processes = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world), str(port), str(directory),
         *cases], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    outputs, failed = [], False
    for process in processes:
        try:
            out, _ = process.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for other in processes:
                other.kill()
            out, _ = process.communicate()
            failed = True
        outputs.append(out)
        failed = failed or process.returncode != 0
    if failed:
        raise RuntimeError("\n".join("--- rank {} (exit {}) ---\n{}".format(
            rank, process.returncode, out)
            for rank, (process, out) in enumerate(zip(processes, outputs))))


class FakeSpectrogram:
    """A `LabeledSpectrogram` stand-in: fixed features and a transcript."""

    def __init__(self, spec, label):
        self._spec = spec
        self.label = label

    def z_normalized_transposed_spectrogram(self):
        return self._spec


CASES = {}


def case(function):
    CASES[function.__name__] = function
    return function


def _config(inputs, classes, layers=None):
    from speechless_tpu_torch.models import wav2letter as w2l

    if layers is None:
        return w2l.Wav2LetterConfig(inputs, classes)
    return w2l.Wav2LetterConfig(inputs, classes, layers=tuple(
        w2l.ConvSpec(*layer) for layer in layers))


@case
def tp_forward(directory, rank):
    """The split model's logits at tp = 2 and 4, its collectives in the forward and the
    backward, and its gathered gradients of ``sum(logits * weights)``."""
    import torch

    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.parallel import mesh as pmesh

    given = load(directory, "tp_forward")
    config = _config(*given["config"])
    out = {}
    for tp in (2, 4):
        mesh = pmesh.make_mesh(tp, device_type="cpu")
        split = pmesh.model_split(mesh)
        model = w2l.build_model(config, pmesh.shard_params(
            given["params"], pmesh.param_specs(config.layer_names), split.rank, split.size),
            device="cpu", tensor_parallel=split)
        with pmesh.collectives.recording() as forward_events:
            logits = model(torch.from_numpy(given["inputs"]))
        with pmesh.collectives.recording() as backward_events:
            (logits * torch.from_numpy(given["weights"])).sum().backward()
        grads = [{"w": model.full_tensor(conv.weight, conv.weight.grad).numpy(),
                  "b": model.full_tensor(conv.bias, conv.bias.grad).numpy()}
                 for conv in model.layers]
        out[tp] = {"logits": logits.detach().numpy(), "forward": forward_events,
                   "backward": backward_events, "grads": grads}
    save_ranked(directory, "tp_forward", rank, out)


@case
def dpxtp_step(directory, rank):
    """One step on a 2 x 2 mesh on each data rank's rows, plain and with global-norm
    clipping: the loss each rank reports and the gathered parameters after it."""
    from speechless_tpu_torch.parallel import mesh as pmesh
    from speechless_tpu_torch.train import trainer

    given = load(directory, "dpxtp_step")
    config = _config(*given["config"])
    mesh = pmesh.make_mesh(2, device_type="cpu")
    rows = pmesh.batch_rows(mesh, given["batch"][0].shape[0])
    local = trainer.Batch(*(field[rows] for field in given["batch"]))
    out = {}
    for name, clip in (("plain", None), ("clipped", given["clip"])):
        optimizer = trainer.make_optimizer(given["learning_rate"], gradient_clip_norm=clip)
        state = trainer.init_train_state(config, optimizer, params=given["params"],
                                         device="cpu", mesh=mesh)
        step = trainer.make_train_step(config, optimizer, device="cpu")
        with pmesh.collectives.recording() as events:
            state, metrics = step(state, local)
        out[name] = {"loss": float(metrics["loss"]), "params": state.params,
                     "events": events, "leaves": state.opt_state.leaves()}
    save_ranked(directory, "dpxtp_step", rank, out)


@case
def resident(directory, rank):
    """The resident corpus split over the data ranks of a 2 x 2 mesh: the batches it
    gathers, and a device epoch's losses on it and on the replicated layout."""
    import torch

    from speechless_tpu_torch.data.device_dataset import build_device_dataset
    from speechless_tpu_torch.parallel import mesh as pmesh
    from speechless_tpu_torch.text.graphemes import CtcGraphemeCodec
    from speechless_tpu_torch.train import trainer

    given = load(directory, "resident")
    config = _config(*given["config"], layers=given["layers"])
    examples = [FakeSpectrogram(spec, label) for spec, label in given["examples"]]
    codec = CtcGraphemeCodec(given["characters"])
    mesh = pmesh.make_mesh(2, device_type="cpu")
    indices = torch.as_tensor(given["indices"])
    out = {"losses": {}}
    for split_rows in (True, False):
        dataset, megabytes = build_device_dataset(examples, codec, "cpu",
                                                  mesh=mesh if split_rows else None)
        if split_rows:
            out["local_rows"] = dataset.local.example_count
            out["batches"] = [[field.numpy() for field in dataset.gather(rows)]
                              for rows in [*indices, torch.as_tensor(given["padded"])]]
            out["megabytes"] = megabytes
        optimizer = trainer.make_optimizer(1e-3)
        state = trainer.init_train_state(config, optimizer, params=given["params"],
                                         device="cpu", mesh=mesh)
        epoch = trainer.make_device_epoch_step(config, optimizer, batch_size=4,
                                               steps=len(indices), mesh=mesh)
        _, metrics = epoch(state, dataset, indices=indices)
        out["losses"][split_rows] = metrics["step_losses"].numpy()
    save(directory, "resident.{}".format(rank), out)


@case
def sharded_generator(directory, rank):
    """The sharded batch generator's default in a world (the world is the data axis of
    the facade's default mesh), also as `Configuration.batch_generator_for_corpus`
    builds it in a world of more than one process."""
    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.data import (LibriSpeechCorpus, ShardedBatchGenerator,
                                           TrainingTestSplit)

    given = load(directory, "sharded_generator")
    corpus = LibriSpeechCorpus(base_directory=Path(given["base"]), corpus_name="shard",
                               training_test_split=TrainingTestSplit.training_only)
    cache = Path(given["base"]) / "cache-{}".format(rank)
    generator = ShardedBatchGenerator(corpus, cache, batch_size=4)
    batches = generator.training_batches()
    configuration = Configuration("shard", lambda _: corpus,
                                  directories=DataDirectories(Path(given["base"])),
                                  batch_size=4)
    default = configuration.batch_generator_for_corpus(corpus)
    save(directory, "sharded_generator.{}".format(rank), {
        "host": (generator.host_id, generator.host_count),
        "ids": [[s.id for s in next(batches)] for _ in range(3)],
        "default": (type(default).__name__, default.host_id, default.host_count)})


@case
def configuration_train(directory, rank):
    """`Configuration.train` of a facade on a 2 x 2 mesh from JAX's epoch 0: the slice
    its generator gives this rank (from the mesh's data axis), the ids of the first two
    batches, and the epoch's loss as ``scalars.csv`` records it."""
    import csv

    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.data import LibriSpeechCorpus, TrainingTestSplit
    from speechless_tpu_torch.parallel import mesh as pmesh
    from speechless_tpu_torch.system import Wav2Letter

    given = load(directory, "configuration_train")
    base = Path(given["base"])
    corpus = LibriSpeechCorpus(base_directory=base, corpus_name="mini",
                               training_test_split=TrainingTestSplit.training_only)
    mesh = pmesh.make_mesh(2, device_type="cpu")
    configuration = Configuration("mini", lambda _: corpus, allowed_characters=list("abcd"),
                                  directories=DataDirectories(base / "rank-{}".format(rank)),
                                  batch_size=4, training_batches_per_epoch=2)
    facade = Wav2Letter(128, list("abcd"), mesh=mesh, device="cpu",
                        load_model_from_directory=Path(given["jax_run"]), load_epoch=0)
    configuration.train(facade, run_name="mesh", epoch_limit=1)
    generator = configuration.batch_generator_for_corpus(corpus, mesh=mesh)
    batches = generator.training_batches()
    scalars = configuration.directories.tensorboard_log_base_directory / "mesh" / "scalars.csv"
    with scalars.open() as f:
        rows = list(csv.reader(f))[1:]
    if rank == 0:  # the rank that wrote the full-width checkpoint
        shutil.rmtree(configuration.directories.nets_base_directory)
    save(directory, "configuration_train.{}".format(rank), {
        "host": (generator.host_id, generator.host_count),
        "ids": [[s.id for s in next(batches)] for _ in range(2)],
        "epoch": [row[:3] for row in rows], "step": facade.state.step})


def _facade_train(facade, specs, net_directory: Path, epoch_limit: int, resident=False):
    facade.train(iter(lambda: specs, None), preview_labeled_spectrogram_batch=specs[:2],
                 tensor_board_log_directory=net_directory / "logs",
                 net_directory=net_directory, batches_per_epoch=2,
                 epoch_limit=epoch_limit, callback_step=5,
                 device_resident_examples=specs if resident else None,
                 batch_size=len(specs))


@case
def facade(directory, rank):
    """`Wav2Letter(mesh=)` on a 2 x 2 mesh: the run restored from the single-process
    run's epoch 1 (its step, eval loss, one more epoch); a run from JAX's epoch 0 for
    one epoch on each data rank's half of the batch, checkpointed (its eval losses, the
    gathered parameters and optimizer leaves); a resident epoch."""
    import torch.distributed as dist

    from speechless_tpu_torch.parallel import mesh as pmesh
    from speechless_tpu_torch.system import Wav2Letter

    given = load(directory, "facade")
    base = Path(given["base"])
    specs = [FakeSpectrogram(spec, label) for spec, label in given["specs"]]
    mesh = pmesh.make_mesh(2, device_type="cpu")
    rows = pmesh.batch_rows(mesh, len(specs))
    out = {}

    restored = Wav2Letter(128, list("abcd"), mesh=mesh, device="cpu",
                          load_model_from_directory=base / "single-run", load_epoch=1)
    out["restored_step"] = restored.state.step
    out["restored_loss"] = restored.test_and_predict_batch(specs[:4]).average_loss
    _facade_train(restored, specs[rows], base / "mesh-run-2", epoch_limit=2)
    out["continued_step"] = restored.state.step

    facade = Wav2Letter(128, list("abcd"), mesh=mesh, device="cpu",
                        load_model_from_directory=base / "jax-run", load_epoch=0)
    _facade_train(facade, specs[rows], base / "mesh-run", epoch_limit=1)
    out["step"] = facade.state.step
    result = facade.test_and_predict_batch(specs[:3])
    out["eval3"] = (len(result.results), result.average_loss)
    out["loss"] = facade.test_and_predict_batch(specs[:4]).average_loss
    out["params"] = facade.state.params
    out["leaves"] = facade.state.opt_state.leaves()
    out["checkpoint"] = (base / "mesh-run" / "weights-epoch1.npz").exists()

    resident = Wav2Letter(128, list("abcd"), mesh=mesh, device="cpu")
    _facade_train(resident, specs, base / "resident-run", epoch_limit=1, resident=True)
    out["resident_step"] = resident.state.step
    save_ranked(directory, "facade", rank, out)
    dist.barrier()
    if rank == 0:  # full-width checkpoints no test reads
        for run in ("mesh-run-2", "resident-run"):
            shutil.rmtree(base / run)


@case
def sequence(directory, rank):
    """The time-split forward at n = 2 and 4 (the data axis of a 2 x 2 and a 4 x 1
    mesh): logits whole on every rank, and its collectives."""
    import torch

    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.parallel import mesh as pmesh
    from speechless_tpu_torch.parallel.sequence import sequence_parallel_logits

    given = load(directory, "sequence")
    out = {}
    for n in (2, 4):
        mesh = pmesh.make_mesh(4 // n, device_type="cpu")
        for name, (layers, inputs, params) in given.items():
            config = _config(inputs.shape[2], layers[-1][1], layers=layers)
            model = w2l.build_model(config, params, device="cpu")
            with torch.no_grad(), pmesh.collectives.recording() as events:
                logits = sequence_parallel_logits(model, torch.from_numpy(inputs), mesh)
            out[(n, name)] = (logits.numpy(), events)
    save(directory, "sequence.{}".format(rank), out)


@case
def serving(directory, rank):
    """`Transcriber(mesh=)` on a 4 x 1 mesh, greedy and with the word LM: batched
    texts, frame tokens and the indivisible batch's refusal; then
    `transcribe_long_audio(sequence_parallel=True)` over the data axis at n = 2 and 4,
    and on the default mesh (the world)."""
    from speechless_tpu_torch.parallel import mesh as pmesh
    from speechless_tpu_torch.serving import Transcriber

    given = load(directory, "serving")
    config = _config(*given["config"], layers=given["layers"])
    out = {}
    for name, lm in (("greedy", None), ("lm", given["lm"])):
        mesh = pmesh.make_mesh(1, device_type="cpu")
        transcriber = Transcriber(config, given["params"], given["alphabet"], device="cpu",
                                  sample_buckets=(16384,), kenlm_directory=lm, beam_width=8,
                                  mesh=mesh)
        out[name] = {"texts": transcriber.transcribe_batch(given["audios"], batch_size=8)}
        if lm is None:
            out[name]["frames"] = transcriber.frame_tokens_batch(given["audios"][:8],
                                                                 batch_size=8)
            try:
                transcriber.transcribe_batch(given["audios"][:3], batch_size=3)
            except ValueError as error:
                out[name]["refusal"] = str(error)
        transcriber._SP_BUCKET_SAMPLES = given["sp_bucket"]
        for n in (2, 4):
            sp_mesh = pmesh.make_mesh(4 // n, device_type="cpu")
            out[name][("long", n)] = transcriber.transcribe_long_audio(
                given["long"], sequence_parallel=True, mesh=sp_mesh)
        out[name][("long", "default")] = transcriber.transcribe_long_audio(
            given["long"], sequence_parallel=True)
    save(directory, "serving.{}".format(rank), out)


def main() -> None:
    rank, world, port = (int(value) for value in sys.argv[1:4])
    directory, cases = Path(sys.argv[4]), sys.argv[5:]
    import torch
    import torch.distributed as dist

    from speechless_tpu_torch.parallel.distributed import distributed_init

    torch.set_num_threads(1)
    distributed_init("gloo", "tcp://localhost:{}".format(port), world, rank,
                     device_type="cpu")
    for name in cases:
        CASES[name](directory, rank)
        dist.barrier()
    dist.destroy_process_group()
    if "jax" in sys.modules or "speechless_tpu" in sys.modules:
        raise SystemExit("a world process imported jax or the JAX package")


if __name__ == "__main__":
    main()
