"""Multi-process initialization and the collectives of the port.

Port of sat_tpu/parallel/distributed.py. sat_tpu runs one process per
host, and that process drives all of the host's devices; PyTorch runs one
rank per card. So one node of `torchrun` plays the part of one sat_tpu
process, and its LOCAL_WORLD_SIZE ranks play the part of that process's
devices:

    torchrun --nproc_per_node N -m sat_tpu_torch.train --mesh-data N ...

`initialize` is a no-op in a plain process, so every entry point calls it
unconditionally. It initializes the process group whenever torchrun's
variables are present (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), WORLD_SIZE=1 included, or when the caller passes an
`init_method` (a manual set-up, as sat_tpu's arguments allow: the tests
start their ranks from a `file://` path). The backend is NCCL for a
`cuda` device and gloo for `cpu`, unless `backend=` names one; an NCCL
that fails to initialize raises, and nothing carries on over gloo. A rank
takes the card of its LOCAL_RANK unless its device names one
(`cuda:0`).

The grid (`setup_grid`, sat_tpu's (data, model) mesh): with
`--mesh-model M`, rank r is cell (r // M, r % M) (parallel/mesh.py). Its
data group is the ranks of its model index (they sum gradients and
metrics, and share the feature bank), its model group the M ranks of its
data index (they split the vocabulary: parallel/vocab.py). Every rank
creates every group, in the same order. With M = 1 the data group is the
world and there is no model group, so a data-parallel run makes the calls
it made before the grid.

The collectives below are what the training loop needs besides the
step's SUM all-reduce (parallel/train_step.py), each on every rank of its
group in the same order: the OR of a host flag (preemption), a gather of
equal slices along one axis, built on the all-reduce (gloo carries only
`all_reduce` and `broadcast` for CUDA tensors), a barrier and the
broadcast of a module's parameters (replicated ones from rank 0, vocabulary
shards within their data group).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from sat_tpu_torch.device import resolve_device
from sat_tpu_torch.parallel.mesh import grid_cell

_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# What initialize() learned: the rank's device and its node's layout; and
# setup_grid(): the model axis's size and this rank's two groups.
_state = {"device": None, "local_rank": 0, "local_world_size": 1,
          "n_model": 1, "data_group": None, "model_group": None}


def launched() -> bool:
    """Whether torchrun's variables are all present."""
    return all(os.environ.get(k) for k in _TORCHRUN)


def initialize(device="cuda", backend: str | None = None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None, local_rank: int | None = None,
               local_world_size: int | None = None) -> torch.device:
    """Join the process group when launched by torchrun (or given an
    `init_method`), and return this rank's device: `device`, with the
    card of LOCAL_RANK when it is a bare "cuda". In a plain process it
    returns `device` and initializes nothing."""
    if dist.is_initialized():
        return _state["device"]
    if init_method is None and not launched():
        return resolve_device(device)
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else local_rank)
    local_world_size = (int(env.get("LOCAL_WORLD_SIZE", world_size))
                        if local_world_size is None else local_world_size)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if world_size % local_world_size:
        raise ValueError(
            f"WORLD_SIZE {world_size} is not a multiple of LOCAL_WORLD_SIZE "
            f"{local_world_size}: every node must run as many ranks")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    _state.update(device=dev, local_rank=local_rank,
                  local_world_size=local_world_size)
    return dev


def shutdown() -> None:
    """Leave the process group (after the last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(device=None, local_rank=0, local_world_size=1, n_model=1,
                  data_group=None, model_group=None)


def setup_grid(n_model: int) -> None:
    """Make the data and model groups of an (N, n_model) grid over the
    ranks (module note); n_model must divide WORLD_SIZE and
    LOCAL_WORLD_SIZE (a model group lives on one node). A no-op with
    n_model = 1, or when the grid is already this one."""
    if n_model == _state["n_model"]:
        return
    world = world_size()
    if world % n_model or local_world_size() % n_model:
        raise ValueError(
            f"--mesh-model {n_model} does not divide the {world} ranks "
            f"({local_world_size()} a node) into model groups of "
            f"{n_model} ranks on one node")
    cells = [grid_cell(r, n_model) for r in range(world)]
    data_groups = [dist.new_group([r for r, c in enumerate(cells)
                                   if c[1] == j]) for j in range(n_model)]
    model_groups = [dist.new_group([r for r, c in enumerate(cells)
                                    if c[0] == i])
                    for i in range(world // n_model)]
    i, j = cells[rank()]
    _state.update(n_model=n_model, data_group=data_groups[j],
                  model_group=model_groups[i])


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return _state["local_rank"] if dist.is_initialized() else 0


def local_world_size() -> int:
    return _state["local_world_size"] if dist.is_initialized() else 1


def node_count() -> int:
    """Nodes of the run: sat_tpu's process count."""
    return world_size() // local_world_size()


def node_index() -> int:
    """This rank's node: sat_tpu's process index (torchrun numbers the
    ranks of node h from h * LOCAL_WORLD_SIZE)."""
    return rank() // local_world_size()


def is_primary() -> bool:
    return rank() == 0


def n_model() -> int:
    """Ranks of a model group (--mesh-model); 1 without a grid."""
    return _state["n_model"] if dist.is_initialized() else 1


def n_data() -> int:
    """Ranks of a data group: the data axis."""
    return world_size() // n_model()


def data_index() -> int:
    """This rank's row of the grid: its slice of every global batch."""
    return grid_cell(rank(), n_model())[0]


def model_index() -> int:
    """This rank's column of the grid: its vocabulary shard."""
    return grid_cell(rank(), n_model())[1]


def data_group():
    """The ranks that share this rank's model index; None (the world)
    without a model axis."""
    return _state["data_group"]


def model_group():
    """The ranks that share this rank's data index; None without a model
    axis."""
    return _state["model_group"]


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def capturable() -> bool:
    """Whether a CUDA graph may hold this group's collectives: NCCL's can
    be captured, gloo's cannot."""
    return backend() == "nccl"


def _flag_device() -> torch.device:
    """Where a host value goes for a collective: the card under NCCL,
    which carries only CUDA tensors, else the host."""
    return _state["device"] if capturable() else torch.device("cpu")


def any_flag(flag: bool, group=None) -> bool:
    """The OR of a host flag over the ranks of `group` (None: all)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def barrier(group=None) -> None:
    """Return once every rank of `group` (None: all) has called it."""
    if dist.is_initialized():
        any_flag(False, group)


def gather(x, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's `x` in `group` (None: all; a tensor, or a numpy array
    taken to the rank's device), each of the same shape, concatenated
    along `dim` in group-rank order: a zero buffer with this rank's slice
    in place, summed over the group. The sum turns a -0.0 into +0.0."""
    x = torch.as_tensor(x)
    if capturable():
        x = x.to(_state["device"])
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * dist.get_world_size(group)
    out = x.new_zeros(shape)
    out.narrow(dim, dist.get_rank(group) * n, n).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def broadcast_module(module: torch.nn.Module, sharded=()) -> None:
    """Rank 0's parameters and buffers into every rank's `module`; the
    tensors named in `sharded` (vocabulary shards) from the first rank of
    this rank's data group, which holds the same shard."""
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        if name in sharded and n_model() > 1:
            dist.broadcast(t.data, src=model_index(), group=data_group())
        else:
            dist.broadcast(t.data, src=0)
