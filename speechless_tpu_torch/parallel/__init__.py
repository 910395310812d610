"""Parallelism of the port: the ``(data, model)`` mesh and the tensor split
(`mesh.py`), the multi-process bootstrap (`distributed.py`) and time-axis sequence
parallelism (`sequence.py`)."""
from .distributed import distributed_init, run_multiprocess_dryrun
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_rows, make_mesh, param_specs,
                   shard_params)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "make_mesh", "batch_rows", "param_specs",
           "shard_params", "distributed_init", "run_multiprocess_dryrun"]
