"""Device meshes and the tensor split of wav2letter's wide tail (port of
`speechless_tpu/parallel/mesh.py`).

One process drives one device. The processes of the initialized world form a
``("data", "model")`` `torch.distributed.device_mesh.DeviceMesh`, ranks in row-major
order (the model axis innermost, as JAX's mesh):

* **data parallelism**: each data rank trains on its rows of the global batch, and the
  gradients are averaged over the data group (`train/trainer.py`), which is JAX's
  gradient of the mean over the global batch when the local batches are equal;
* **tensor parallelism** on the 2000-filter tail (Megatron's column/row pair):
  ``big_conv_1`` is column-parallel (its output channels split over the model axis),
  ``big_conv_2`` row-parallel (its input channels split), so the ``(B, T', 2000/tp)``
  activation between them stays split with no collective, and one all-reduce over the
  model group follows ``big_conv_2``. Everything else is replicated.

JAX places a global array by `NamedSharding`; here a rank holds its own shard, so
`param_specs` names each tensor's split axis in the JAX layout (``(K, Cin, Cout)``
weights) and `shard_params` cuts a full host parameter list into this rank's shards.
JAX's ``replicate`` has no counterpart: every rank builds the same replicated tensors
from the same host values.

Every collective of the port's parallel code goes through `all_reduce` or
`all_gather`, which log it inside a `collectives.recording()` scope, so that a test can
count them, as `examples/tp_collective_audit.py` counts the collectives of JAX's
partitioned program; outside any scope nothing is kept.
Megatron's f and g carry the split's gradients, each a `torch.autograd.Function`:
`copy_to_model_group` (identity forward, all-reduce backward) on ``big_conv_1``'s input
and `reduce_from_model_group` (all-reduce forward, identity backward) after
``big_conv_2``.
"""
import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# A tensor's split in the JAX layout: for each axis the mesh axis it is split over, or
# None (JAX's PartitionSpec as a tuple; () is replicated).
Spec = Tuple[Optional[str], ...]


def make_mesh(model_parallelism: int = 1, device_type: str = "cuda"):
    """The ``(data, model)`` `DeviceMesh` over the whole initialized world:
    ``model_parallelism`` consecutive ranks form each model group (it must divide the
    world size), the rest is data parallelism. ``device_type`` is the devices' type
    (``"cuda"``, or ``"cpu"`` for a gloo world on the CPU); `distributed_init` has set
    each process's device already."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world % model_parallelism != 0:
        raise ValueError("model_parallelism {} must divide device count {}".format(
            model_parallelism, world))
    return init_device_mesh(device_type, (world // model_parallelism, model_parallelism),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def world_mesh(device_type: str) -> Optional[object]:
    """A data-parallel mesh over the world when more than one process runs, else None:
    the default mesh of the facade and of long-form sequence parallelism."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh(device_type=device_type)
    return None


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def batch_rows(mesh, batch_size: int) -> slice:
    """This data rank's rows of a global batch of ``batch_size`` (JAX's ``batch_spec``,
    ``P('data')``): the batch must divide evenly over the data axis."""
    size = axis_size(mesh, DATA_AXIS)
    if batch_size % size:
        raise ValueError("batch size {} does not divide the mesh's data parallelism {}"
                         .format(batch_size, size))
    rows = batch_size // size
    rank = axis_rank(mesh, DATA_AXIS)
    return slice(rank * rows, (rank + 1) * rows)


# ---- parameters -----------------------------------------------------------------------

def param_specs(layer_names: List[str]) -> List[Dict[str, Spec]]:
    """Per-layer splits of the wav2letter parameters, JAX's table: ``big_conv_1``
    column-parallel (``w`` and ``b`` split on the output channels), ``big_conv_2``
    row-parallel (``w`` split on the input channels, ``b`` replicated), everything else
    replicated. Weight layout (K, Cin, Cout)."""
    specs = []
    for name in layer_names:
        if name == "big_conv_1":
            specs.append({"w": (None, None, MODEL_AXIS), "b": (MODEL_AXIS,)})
        elif name == "big_conv_2":
            specs.append({"w": (None, MODEL_AXIS, None), "b": ()})
        else:
            specs.append({"w": (), "b": ()})
    return specs


def split_axis(spec: Spec) -> Optional[int]:
    """The axis a spec splits over the model axis, None when replicated."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard(array: np.ndarray, spec: Spec, model_rank: int, model_size: int) -> np.ndarray:
    """This model rank's part of a full host array split by ``spec``."""
    axis = split_axis(spec)
    if axis is None:
        return array
    if array.shape[axis] % model_size:
        raise ValueError("an axis of {} does not divide over {} model ranks".format(
            array.shape[axis], model_size))
    part = array.shape[axis] // model_size
    index = [slice(None)] * array.ndim
    index[axis] = slice(model_rank * part, (model_rank + 1) * part)
    return np.ascontiguousarray(array[tuple(index)])


def shard_params(params: Sequence[dict], specs: Sequence[dict], model_rank: int,
                 model_size: int) -> List[dict]:
    """Cut a full host parameter list (JAX layout; every rank holds the same one, from
    one seed or one checkpoint) into the shards of this model rank. Layers past
    ``specs`` (the ASG pseudo-layer) are replicated."""
    out = []
    for i, layer in enumerate(params):
        layer_specs = specs[i] if i < len(specs) else {}
        out.append({key: shard(np.asarray(value), layer_specs.get(key, ()), model_rank,
                               model_size) for key, value in layer.items()})
    return out


@dataclass(frozen=True)
class ModelSplit:
    """A model's share of the model axis: its process group, rank and size."""
    group: object
    rank: int
    size: int


def model_split(mesh) -> Optional[ModelSplit]:
    """The model axis of ``mesh`` as a `ModelSplit`, None when it has one rank."""
    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return None
    return ModelSplit(axis_group(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS),
                      axis_size(mesh, MODEL_AXIS))


# ---- collectives ----------------------------------------------------------------------

Event = Tuple[str, str, str]  # (operation, axis, where)


class CollectiveLog:
    """The collectives the parallel code issues inside a `recording` scope, in order.
    Outside every scope none is kept, so a long run holds no growing list."""

    def __init__(self):
        self._events: Optional[List[Event]] = None

    @contextlib.contextmanager
    def recording(self) -> Iterator[List[Event]]:
        """Yield the list that collects the scope's events (an inner scope takes the
        events issued inside it)."""
        outer, self._events = self._events, []
        try:
            yield self._events
        finally:
            self._events = outer

    def log(self, operation: str, axis: str, where: str) -> None:
        if self._events is not None:
            self._events.append((operation, axis, where))


collectives = CollectiveLog()


def all_reduce(tensor: torch.Tensor, group, axis: str, where: str) -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` (the ranks of mesh axis ``axis``)."""
    collectives.log("all_reduce", axis, where)
    dist.all_reduce(tensor, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group, axis: str, where: str,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated along ``dim`` in rank
    order."""
    collectives.log("all_gather", axis, where)
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModelGroup(torch.autograd.Function):
    """Megatron's f: identity forward; the backward sums the input gradient over the
    model group (each rank's part holds only its split channels' contribution)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        all_reduce(grad, ctx.split.group, MODEL_AXIS, "f: big_conv_1 input gradient")
        return grad, None


class _ReduceFromModelGroup(torch.autograd.Function):
    """Megatron's g: the forward sums the row-parallel partial products over the model
    group; identity backward."""

    @staticmethod
    def forward(ctx, x, split):
        x = x.clone(memory_format=torch.contiguous_format)
        return all_reduce(x, split.group, MODEL_AXIS, "g: big_conv_2 output")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, split)


def reduce_from_model_group(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    return _ReduceFromModelGroup.apply(x, split)
