"""Data parallelism over processes (counterpart of the JAX
``parallel/mesh.py``).

The JAX package runs one SPMD step over a ``data`` mesh: the global batch
is sharded over the devices, and every reduction in the step (BatchNorm
statistics, the loss normalizers, the gradients and the clip's norm) is
over the global batch because XLA's partitioner makes it so. The port
runs one process per device (``python -m torch.distributed.run``), each
holding ``batch_size`` rows of the global batch, and makes the same
reductions explicit with the collectives here:

- :func:`global_moments`, the per-channel batch moments of a train-mode
  BatchNorm over the global batch (differentiable, so the gradient
  through the global mean and variance reaches every rank);
- :func:`all_sum` for the loss normalizers and the logged metrics,
  :func:`all_reduce_grads` for the gradients, :func:`process_sum_scalars`
  for host scalars (the val losses);
- :func:`zero1_owners` and :func:`gather_owned`, ZeRO-1: each rank
  updates the AdamW moments of its share of the parameters, and the
  updated parameters are gathered on every rank;
- :func:`make_mesh`, the JAX ``(data, model)`` mesh as process groups: a
  rank's width group (its row) and data group (its column), for
  width-sharded training over several requests at once
  (``parallel/spatial.py``).

Without a process group every function is the identity, so a process
that was not launched as a rank runs the single-device step unchanged.
The JAX ``shard_batch`` and ``fetch_local`` have no counterpart beyond
the loader's per-rank slice (``data/dataset.py::DataLoader``'s
``process_index``/``process_count``): each rank's tensors are already its
local rows of the global batch.

The backend follows the device the caller names: ``nccl`` for CUDA
(``cuda:LOCAL_RANK``), ``gloo`` for the CPU. Neither falls back to the
other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_WORLD = "world"
# The group the batch reductions run over: the world, a data group
# (inside ``replicated_batch(data_group)``), or None (a data axis of one).
_BATCH: list = [_WORLD]


def active() -> bool:
    """Whether this process is a rank of an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def initialize_distributed(
    device: str | torch.device,
    *,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
) -> torch.device:
    """Join the process group and return this rank's device.

    ``init_method`` (with ``rank`` and ``world_size``) names the group
    explicitly; without it the environment that ``python -m
    torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) does, and a process without
    ``WORLD_SIZE`` in its environment joins nothing (the JAX
    ``initialize_distributed`` without ``JAX_COORDINATOR_ADDRESS``). On a
    CUDA ``device`` the rank takes ``cuda:LOCAL_RANK``. A group that is
    already initialized is kept if its backend is the device's, else this
    raises.
    """
    device = torch.device(device)
    backend = _BACKENDS.get(device.type)
    if backend is None:
        raise ValueError(f"initialize_distributed: no backend for device {device}")
    if not active():
        if init_method is None:
            if "WORLD_SIZE" not in os.environ:
                return device
            init_method = "env://"
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        explicit = {} if rank is None else {"rank": rank, "world_size": world_size}
        dist.init_process_group(backend, init_method=init_method, **explicit)
    elif dist.get_backend() != backend:
        raise RuntimeError(
            f"the process group's backend is {dist.get_backend()}; device "
            f"{device} needs {backend}"
        )
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


@contextlib.contextmanager
def replicated_batch(data_group=None) -> Iterator[None]:
    """Inside, the ranks of a width group hold the same rows (width
    sharding, ``parallel/spatial.py``): the batch reductions
    (:func:`all_sum`, :func:`global_moments` without a group) run over
    ``data_group``, the ranks that hold the other rows of the global batch
    (:class:`Mesh`'s ``data``), and are the identity without one (a data
    axis of size 1), so a loss on gathered outputs counts each image
    once."""
    old = _BATCH[0]
    _BATCH[0] = data_group
    try:
        yield
    finally:
        _BATCH[0] = old


def replicated() -> bool:
    """Whether the batch reductions are the identity: a
    :func:`replicated_batch` block without a data group is running."""
    return _BATCH[0] is None


def _batch_group():
    return dist.group.WORLD if _BATCH[0] is _WORLD else _BATCH[0]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, model)`` layout of the ranks.

    ``width``: the ranks of its row (the same data index), over which one
    request's width is split; ``data``: the ranks of its column (the same
    model index), which hold the other rows of the global batch;
    ``group``: every rank of the mesh, over which train-mode BatchNorm
    reduces its moments (the JAX ``bn_axes = ("data", "model")``). A rank
    outside the mesh has indices -1. Without a process group every group
    is None (a mesh of one).
    """

    num_data: int
    num_model: int
    data_index: int
    model_index: int
    width: Any = None
    data: Any = None
    group: Any = None


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """The JAX ``make_mesh(num_data, num_model)`` over the ranks: they are
    laid out as ``reshape(num_data, num_model)``, so rank = d *
    num_model + m, and the first ``num_data * num_model`` ranks make the
    mesh. Every rank must call this (it creates every row's and every
    column's group, in the same order on each rank). Without a process
    group only (1, 1) is possible, and every group is None."""
    n = world()
    if num_data is None:
        num_data = max(1, n // num_model)
    needed = num_data * num_model
    if needed > n or num_data < 1 or num_model < 1:
        raise ValueError(f"mesh ({num_data} data x {num_model} model) needs {needed} "
                         f"ranks; have {n}")
    if not active():
        return Mesh(1, 1, 0, 0)
    rows = [dist.new_group(list(range(d * num_model, (d + 1) * num_model)))
            for d in range(num_data)]
    cols = [dist.new_group(list(range(m, needed, num_model))) for m in range(num_model)]
    whole = dist.group.WORLD if needed == n else dist.new_group(list(range(needed)))
    r = rank()
    if r >= needed:
        return Mesh(num_data, num_model, -1, -1)
    d, m = divmod(r, num_model)
    return Mesh(num_data, num_model, d, m, width=rows[d], data=cols[m], group=whole)


def barrier() -> None:
    if active():
        dist.barrier()


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (no gradient), as a new tensor."""
    if not active() or replicated():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=_batch_group())
    return out


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank (a host synchronisation)."""
    if not active():
        return flag
    return bool(all_sum(torch.tensor([float(flag)], device=device)).item() > 0)


def global_moments(
    mean: torch.Tensor, sq_mean: torch.Tensor, group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global batch's per-channel ``E[y]`` and ``E[y^2]`` from each
    rank's over its local rows.

    Every rank holds the same number of elements a channel (the same
    batch shape: the loader pads the shards to equal batch counts), so the
    global ``sum(y) / count`` is the mean of the ranks' means; both
    moments go through one fp32 all-reduce, differentiable (its backward
    sums the gradients over the ranks). The division is by the world
    size, exact at 1 and 2, so a group of one rank gives the single
    device's statistics bit for bit.

    ``group`` (a width group or a mesh's, ``parallel/spatial.py::
    bn_mean``) reduces over its ranks instead; without it the reduction is
    over the data axis: the world, or :func:`replicated_batch`'s data
    group (the identity without one).
    """
    if not active() or (group is None and replicated()):
        return mean, sq_mean
    if group is None:
        group = _batch_group()
    from torch.distributed.nn.functional import all_reduce

    C = mean.shape[0]
    # A profiler range, so that a trace can tell these all-reduces from the
    # gradients' (their backward is autograd's ``_AllReduceBackward``).
    with torch.profiler.record_function("mesh.global_moments"):
        both = all_reduce(torch.cat([mean.float(), sq_mean.float()]), group=group)
        both = both / dist.get_world_size(group)
    return both[:C], both[C:]


def all_reduce_grads(grads: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Gradients summed over the ranks (of ``group``: a :class:`Mesh`'s
    ``group`` for width-sharded training on a mesh), in one all-reduce of
    a flat buffer."""
    if not active():
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
    return out


def process_sum_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """Host scalars summed over the ranks (the ``sync_dist=True`` analog,
    reference ``detector.py:385-389``); the identity without a group."""
    if not active():
        return {k: float(v) for k, v in values.items()}
    keys = sorted(values)
    device = (
        torch.device("cuda", torch.cuda.current_device())
        if dist.get_backend() == "nccl"
        else torch.device("cpu")
    )
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return {k: float(v) for k, v in zip(keys, t.tolist())}


def zero1_owners(sizes: Sequence[int], n_ranks: int) -> List[int]:
    """The rank that keeps each parameter's AdamW moments under ZeRO-1:
    the largest parameters first, each to the rank holding the fewest
    elements so far (the lowest such rank on a tie). Every rank computes
    the same assignment."""
    if n_ranks > len(sizes):
        raise ValueError(
            f"ZeRO-1 over {n_ranks} ranks needs at least as many parameters; "
            f"got {len(sizes)}"
        )
    load = [0] * n_ranks
    owners = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(n_ranks), key=lambda q: (load[q], q))
        owners[i] = r
        load[r] += sizes[i]
    return owners


@torch.no_grad()
def gather_owned(tensors: Sequence[torch.Tensor], owners: Sequence[int]) -> None:
    """Overwrite every tensor with its owner's copy, in place: each rank
    packs the tensors it owns into one flat buffer, the buffers are
    all-gathered, and each rank unpacks the others'. The tensors share a
    dtype and a device."""
    if not active():
        return
    W, me = world(), rank()
    sizes = [0] * W
    for t, o in zip(tensors, owners):
        sizes[o] += t.numel()
    ref = tensors[0]
    buf = ref.new_zeros(max(sizes))
    offset = 0
    for t, o in zip(tensors, owners):
        if o == me:
            buf[offset : offset + t.numel()] = t.reshape(-1)
            offset += t.numel()
    parts = [torch.empty_like(buf) for _ in range(W)]
    dist.all_gather(parts, buf)
    offsets = [0] * W
    for t, o in zip(tensors, owners):
        if o != me:
            t.copy_(parts[o][offsets[o] : offsets[o] + t.numel()].view_as(t))
        offsets[o] += t.numel()
