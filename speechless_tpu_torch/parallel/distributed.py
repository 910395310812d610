"""Multi-process bootstrap (port of `speechless_tpu/parallel/distributed.py`):
`torch.distributed` initialization and a localhost multi-process dry run that exercises
the real bootstrap.

One process drives one device: `distributed_init` joins the world and selects this
rank's device, and `mesh.make_mesh` builds the ``(data, model)`` mesh over the world.
JAX assembles global arrays from per-process pieces (``put_global``,
``local_batch_to_global``); under the port's data parallelism there is no global
array: each rank keeps its own rows of a batch and its own shards of the parameters,
and the gradient all-reduce joins them (`train/trainer.py`). So none of those names is
kept, nor ``shard_params_global``: `trainer.init_train_state(mesh=)` slices the host
parameters at the rank's place on the model axis (`mesh.shard_params`).

Run on several processes with ``torchrun --nproc-per-node N script.py`` (the script
calls ``distributed_init("nccl")``, which reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), or give ``distributed_init`` the
address (``tcp://localhost:<port>``), world size and rank. The backend is explicit:
``nccl`` for CUDA devices, ``gloo`` for the CPU (or for several processes sharing one
card, which NCCL refuses).
"""
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent


def distributed_init(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device_type: str = "cuda") -> torch.device:
    """Join the process group (idempotent) and return this rank's device. Without
    ``init_method``, ``world_size`` and ``rank`` they come from torchrun's environment
    (``env://``). On ``device_type="cuda"`` rank r takes ``cuda:(local_rank %
    device_count)`` (``LOCAL_RANK``, else the rank), so several processes may share one
    card; ``"cpu"`` is for a gloo world on the CPU."""
    if not dist.is_initialized():
        if init_method is None:
            init_method = "env://"
            world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
            rank = int(os.environ["RANK"]) if rank is None else rank
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
        if device_type == "cuda":
            local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        from ..utils.tools import log
        log("torch.distributed initialized: rank {} of {} ({} on {}).".format(
            dist.get_rank(), dist.get_world_size(), backend, device_type))
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_multiprocess_dryrun(n_processes: int = 2, model_parallelism: int = 2,
                            device: str = "cpu", backend: str = "gloo",
                            timeout_s: float = 600.0) -> None:
    """Validate the multi-process bootstrap end to end on localhost: ``n_processes``
    Python processes (``python -m speechless_tpu_torch.parallel.distributed``) join one
    world over ``backend``, build the ``(data, model)`` mesh, and each runs one DP x TP
    train step on its rows of one global batch, on ``device`` (``"cpu"`` or
    ``"cuda"``: rank r on ``cuda:(r % device_count)``).

    Raises on any process failure, non-finite loss, or a loss that differs across
    processes."""
    port = free_port()
    workers = []
    for rank in range(n_processes):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(n_processes), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), SPEECHLESS_DRYRUN_MP=str(model_parallelism),
                   SPEECHLESS_DRYRUN_DEVICE=device, SPEECHLESS_DRYRUN_BACKEND=backend)
        workers.append(subprocess.Popen(
            [sys.executable, "-m", "speechless_tpu_torch.parallel.distributed"],
            env=env, cwd=str(_REPO_ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs, failed = [], []
    for rank, worker in enumerate(workers):
        try:
            out, _ = worker.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for other in workers:
                other.kill()
            out, _ = worker.communicate()
            failed.append((rank, "timeout", out))
            continue
        outputs.append(out)
        if worker.returncode != 0:
            failed.append((rank, "exit {}".format(worker.returncode), out))
    if failed:
        raise RuntimeError("multi-process dryrun failed:\n" + "\n".join(
            "--- process {} ({}) ---\n{}".format(rank, why, out)
            for rank, why, out in failed))
    for out in outputs:
        if "DRYRUN_OK" not in out:
            raise RuntimeError("worker missing success marker:\n" + out)
    print("run_multiprocess_dryrun OK: {} processes, model_parallelism={}, {} on {}".format(
        n_processes, model_parallelism, backend, device))


def _dryrun_worker() -> None:
    """Entry point of one dry-run process (see `run_multiprocess_dryrun`)."""
    device_type = os.environ["SPEECHLESS_DRYRUN_DEVICE"]
    model_parallelism = int(os.environ["SPEECHLESS_DRYRUN_MP"])
    device = distributed_init(os.environ["SPEECHLESS_DRYRUN_BACKEND"],
                              device_type=device_type)
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))

    from ..models import wav2letter as w2l
    from ..text.charsets import english_frequent_characters
    from ..train.trainer import Batch, init_train_state, make_optimizer, make_train_step
    from . import mesh as pmesh

    mesh = pmesh.make_mesh(model_parallelism, device_type=device_type)
    config = w2l.Wav2LetterConfig(16, len(english_frequent_characters) + 1)
    optimizer = make_optimizer(1e-4)
    # The same seed on every process: the same host params, each rank keeps its shard.
    state = init_train_state(config, optimizer, seed=0, device=device, mesh=mesh)

    # The deterministic global batch, each data rank keeping its rows (the
    # ShardedBatchGenerator pattern).
    global_batch = 2 * pmesh.axis_size(mesh, pmesh.DATA_AXIS)
    rng = np.random.RandomState(0)
    inputs = rng.randn(global_batch, 64, 16).astype(np.float32)
    labels = rng.randint(0, config.grapheme_set_size - 1,
                         size=(global_batch, 8)).astype(np.int32)
    rows = pmesh.batch_rows(mesh, global_batch)
    local = Batch(inputs=inputs[rows], input_lengths=np.full(2, 64, np.int32),
                  labels=labels[rows], label_lengths=np.full(2, 8, np.int32))
    state, metrics = make_train_step(config, optimizer, device=device)(state, local)
    loss = metrics["loss"].reshape(1).to(torch.float64)
    losses = [torch.zeros_like(loss) for _ in range(dist.get_world_size())]
    dist.all_gather(losses, loss)
    losses = torch.cat(losses).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("non-finite loss: {}".format(losses))
    if not np.allclose(losses, losses[0]):
        raise RuntimeError("loss differs across processes: {}".format(losses))
    print("DRYRUN_OK rank {}/{}: loss {:.4f} on a {} mesh".format(
        dist.get_rank(), dist.get_world_size(), float(losses[0]),
        tuple(mesh.mesh.shape)))
    dist.destroy_process_group()


if __name__ == "__main__":
    _dryrun_worker()
