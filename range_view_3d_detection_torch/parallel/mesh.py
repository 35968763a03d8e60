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
  updated parameters are gathered on every rank.

Without a process group every function is the identity, so a process
that was not launched as a rank runs the single-device step unchanged.
The JAX ``make_mesh``, ``shard_batch`` and ``fetch_local`` have no
counterpart beyond the loader's per-rank slice
(``data/dataset.py::DataLoader``'s ``process_index``/``process_count``):
each rank's tensors are already its local rows of the global batch.

The backend follows the device the caller names: ``nccl`` for CUDA
(``cuda:LOCAL_RANK``), ``gloo`` for the CPU. Neither falls back to the
other.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_REPLICATED = [False]


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
def replicated_batch() -> Iterator[None]:
    """Inside, every rank holds the whole batch (width sharding at a data
    axis of size 1, ``parallel/spatial.py``): the batch reductions
    (:func:`all_sum`, :func:`global_moments` without a group) are the
    identity, so a loss on gathered outputs counts each image once."""
    old = _REPLICATED[0]
    _REPLICATED[0] = True
    try:
        yield
    finally:
        _REPLICATED[0] = old


def replicated() -> bool:
    """Whether a :func:`replicated_batch` block is running."""
    return _REPLICATED[0]


def barrier() -> None:
    if active():
        dist.barrier()


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (no gradient), as a new tensor."""
    if not active() or _REPLICATED[0]:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
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

    ``group`` (a width group, ``parallel/spatial.py::bn_mean``) reduces
    over its ranks instead; without it the reduction is over the data
    axis, the identity under :func:`replicated_batch`.
    """
    if not active() or (group is None and _REPLICATED[0]):
        return mean, sq_mean
    from torch.distributed.nn.functional import all_reduce

    C = mean.shape[0]
    # A profiler range, so that a trace can tell these all-reduces from the
    # gradients' (their backward is autograd's ``_AllReduceBackward``).
    with torch.profiler.record_function("mesh.global_moments"):
        both = all_reduce(
            torch.cat([mean.float(), sq_mean.float()]),
            group=dist.group.WORLD if group is None else group,
        ) / dist.get_world_size(group)
    return both[:C], both[C:]


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Gradients summed over the ranks, in one all-reduce of a flat buffer."""
    if not active():
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
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
