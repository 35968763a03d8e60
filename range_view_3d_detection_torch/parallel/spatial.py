"""Width (azimuth) sharding, exact: the counterpart of the JAX
``parallel/spatial.py``.

One request's range image is split along its width over the ranks of a
process group (one process a card, as ``mesh.py`` runs data parallelism;
at serving the data axis has size 1 and the width group is the world; in
training, ``mesh.make_mesh(num_data, num_model)`` lays the ranks out as
JAX's ``(data, model)`` mesh, each row a width group).
Every width-affecting op exchanges exactly the halo it needs, at its own
resolution, so the sharded network computes the global one:

- a k-wide conv (``models/blocks.py::ConvNormAct``) fetches ``(k-1)//2``
  columns from its ring neighbours and runs VALID over width, so its
  output is exactly the shard's width again (the stride-2 convs too);
- a transposed conv fetches the columns its kernel footprint reads and
  slices the exact local output region (the phase decomposition consumes
  a (1, 1) halo with VALID width and needs no slice);
- the MetaKernel stem's neighbour shifts take the halo columns instead of
  zero padding (``models/stems.py``).

Every op's output is exactly shard-wide, so a BatchNorm never sees halo
columns; in train mode its moments are reduced over the width group
(:func:`bn_mean`, through ``mesh.global_moments``), which
makes the sharded forward and backward the global model's up to the
order of floating-point sums.

The ops consult a module-level context (:func:`width_sharding`), so the
model code stays layout-agnostic. The collectives are neighbour
point-to-point messages (``dist.batch_isend_irecv``); ``circular=True``
wraps the azimuth seam (exact for 360-degree sweeps), ``circular=False``
zeroes the outermost halos, as the zero-padded global convs do. A group of
one rank (or no process group) exchanges nothing: the circular halo is
the shard's own far columns, the other one zeros.

Every shard's width must be a multiple of the model's width stride (16
for ``RangeNet``: four stride-2 stages), so that each strided stage and
each ``strided_views`` slice starts on the global grid
(:func:`check_width`).
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from range_view_3d_detection_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class WidthShardingContext:
    """State consulted by width-affecting ops while a sharded forward runs.

    ``group``: the width group (None: the default group, or no group at
    all in a process that joined none). ``bn_reduce``: train-mode
    BatchNorm moments are reduced over ``bn_group`` (the JAX ``bn_axes``:
    a mesh's group of data x width ranks), or over the width group when
    it is None (a data axis of size 1); False is eval-only use.
    """

    group: Any = None
    circular: bool = False
    bn_reduce: bool = False
    bn_group: Any = None


_CTX: Optional[WidthShardingContext] = None


def context() -> Optional[WidthShardingContext]:
    return _CTX


@contextmanager
def width_sharding(group=None, *, circular: bool = False, bn_reduce: bool = False,
                   bn_group=None):
    """Activate width-sharded op behaviour for the code run inside."""
    global _CTX
    old = _CTX
    _CTX = WidthShardingContext(group, circular, bn_reduce, bn_group)
    try:
        yield _CTX
    finally:
        _CTX = old


def group_size(group=None) -> int:
    return dist.get_world_size(group) if mesh.active() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if mesh.active() else 0


def _group(group):
    """The process group a collective takes: ``group``, or the world."""
    return dist.group.WORLD if group is None else group


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _exchange(sends, recv_like, group) -> list:
    """One ``batch_isend_irecv`` of ``sends`` [(tensor, peer rank in group,
    tag)] and receives [(like, peer, tag)]; returns the received tensors.
    Every rank lists its ops in the same order, so NCCL (which ignores the
    tags) pairs them as gloo (which matches the tags) does."""
    ops, outs = [], []
    for kind, items in (("send", sends), ("recv", recv_like)):
        for t, peer, tag in items:
            if t is None:
                continue
            if kind == "send":
                ops.append(dist.P2POp(dist.isend, t, _peer(group, peer), group, tag))
            else:
                buf = torch.empty_like(t, memory_format=torch.contiguous_format)
                outs.append(buf)
                ops.append(dist.P2POp(dist.irecv, buf, _peer(group, peer), group, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


def _cat(parts, w_axis: int, like: torch.Tensor) -> torch.Tensor:
    """``torch.cat`` along the width, in ``like``'s channels_last memory
    when it has it (the conv blocks' layout)."""
    out = torch.cat(parts, dim=w_axis)
    if like.dim() == 4 and not like.is_contiguous() and like.is_contiguous(
        memory_format=torch.channels_last
    ):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


class _HaloExchange(torch.autograd.Function):
    """Neighbour halo exchange of ``n > 1`` ranks, differentiable: the
    backward sends each halo's gradient back to the rank it came from and
    adds it to that rank's edge columns."""

    @staticmethod
    def forward(ctx, x, lo, hi, w_axis, circular, group):
        n, i = group_size(group), group_rank(group)
        ctx.meta = (lo, hi, w_axis, circular, group, x.shape[w_axis])
        W = x.shape[w_axis]
        nxt, prv = (i + 1) % n, (i - 1) % n
        left_in = lo and (circular or i > 0)  # rank i receives from i-1
        right_in = hi and (circular or i < n - 1)  # rank i receives from i+1
        left_out = lo and (circular or i < n - 1)  # i's last cols go to i+1
        right_out = hi and (circular or i > 0)  # i's first cols go to i-1
        last = x.narrow(w_axis, W - lo, lo).contiguous() if lo else None
        first = x.narrow(w_axis, 0, hi).contiguous() if hi else None
        recv = _exchange(
            [(last if left_out else None, nxt, 0), (first if right_out else None, prv, 1)],
            [(last if left_in else None, prv, 0), (first if right_in else None, nxt, 1)],
            group,
        )
        parts = []
        if lo:
            parts.append(recv.pop(0) if left_in else torch.zeros_like(last))
        parts.append(x)
        if hi:
            parts.append(recv.pop(0) if right_in else torch.zeros_like(first))
        return _cat(parts, w_axis, x)

    @staticmethod
    def backward(ctx, grad):
        lo, hi, w_axis, circular, group, W = ctx.meta
        n, i = group_size(group), group_rank(group)
        nxt, prv = (i + 1) % n, (i - 1) % n
        g_left = grad.narrow(w_axis, 0, lo).contiguous() if lo else None
        g_right = grad.narrow(w_axis, lo + W, hi).contiguous() if hi else None
        gx = grad.narrow(w_axis, lo, W).clone()
        # The forward's messages reversed: a received halo's gradient goes
        # back to its sender.
        left_in = lo and (circular or i > 0)
        right_in = hi and (circular or i < n - 1)
        left_out = lo and (circular or i < n - 1)
        right_out = hi and (circular or i > 0)
        recv = _exchange(
            [(g_left if left_in else None, prv, 2), (g_right if right_in else None, nxt, 3)],
            [(g_left if left_out else None, nxt, 2), (g_right if right_out else None, prv, 3)],
            group,
        )
        if lo and left_out:
            gx.narrow(w_axis, W - lo, lo).add_(recv.pop(0))
        if hi and right_out:
            gx.narrow(w_axis, 0, hi).add_(recv.pop(0))
        return gx, None, None, None, None, None


def exchange_halo_lr(
    x: torch.Tensor,
    lo: int,
    hi: int,
    group=None,
    *,
    w_axis: int = 2,
    circular: bool = False,
) -> torch.Tensor:
    """Widen a width shard with ``lo`` columns of the left neighbour and
    ``hi`` of the right one (the JAX ``exchange_halo_lr``).

    Shard i sends its last ``lo`` columns to shard i+1 and its first
    ``hi`` to shard i-1 in one ``batch_isend_irecv``. ``circular=False``
    zeroes the first shard's left halo and the last shard's right halo;
    ``circular=True`` wraps the seam. A group of one takes its own far
    columns (circular) or zeros, without a message. A halo wider than
    the local width raises (one hop only). Differentiable.
    ``exchange_halo_lr.calls`` counts the exchanges.
    """
    if lo == 0 and hi == 0:
        return x
    W = x.shape[w_axis]
    if max(lo, hi) > W:
        raise ValueError(
            f"halo ({lo},{hi}) exceeds local width {W}; use fewer width "
            "shards (single-hop neighbour exchange only)"
        )
    exchange_halo_lr.calls += 1
    if group_size(group) > 1:
        with torch.profiler.record_function("spatial.exchange_halo"):
            return _HaloExchange.apply(x, lo, hi, w_axis, circular, group)
    parts = []
    if lo:
        left = x.narrow(w_axis, W - lo, lo)
        parts.append(left if circular else torch.zeros_like(left))
    parts.append(x)
    if hi:
        right = x.narrow(w_axis, 0, hi)
        parts.append(right if circular else torch.zeros_like(right))
    return _cat(parts, w_axis, x)


exchange_halo_lr.calls = 0


def exchange_halo(x: torch.Tensor, halo: int, group=None, *, w_axis: int = 2) -> torch.Tensor:
    """Symmetric circular halo exchange (the ring wraps both ways)."""
    return exchange_halo_lr(x, halo, halo, group, w_axis=w_axis, circular=True)


def bn_mean(
    mean: torch.Tensor, sq_mean: torch.Tensor, ctx: Optional[WidthShardingContext]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm moments ``E[y]`` and ``E[y^2]`` over the
    context's BatchNorm group (its mesh's data x width ranks, or its width
    group) when it reduces them; else over the data axis
    (``mesh.global_moments``, the identity without a process group)."""
    if ctx is not None and ctx.bn_reduce:
        group = ctx.bn_group if ctx.bn_group is not None else ctx.group
        return mesh.global_moments(mean, sq_mean, group=_group(group))
    return mesh.global_moments(mean, sq_mean)


# -- placing a request, gathering its outputs -----------------------------------


def check_width(W: int, n: int, stride: int) -> None:
    """Refuse a width whose shards are not a multiple of ``stride``: each
    strided stage and each strided view of a shard must start on the
    global grid. The error names the nearest widths that work."""
    unit = n * stride
    if W % unit:
        below, above = W // unit * unit, (W // unit + 1) * unit
        raise ValueError(
            f"width {W} does not split into {n} shards of a multiple of {stride} "
            f"columns (the model's width stride); widths that work near it: "
            f"{below}, {above} (multiples of {unit})"
        )


def shard_width(x: torch.Tensor, group=None, *, w_axis: int = 2) -> torch.Tensor:
    """This rank's slice of a full request along the width axis."""
    n, r = group_size(group), group_rank(group)
    W = x.shape[w_axis]
    if W % n:
        raise ValueError(f"width {W} does not split into {n} shards")
    return x.narrow(w_axis, r * (W // n), W // n).contiguous()


class _GatherWidth(torch.autograd.Function):
    """All-gather along the width axis. Its backward takes this rank's
    slice of the incoming gradient: every rank computes the same function
    of the gathered tensor (the replicated loss of a width-sharded step),
    so that slice is the exact gradient of its shard."""

    @staticmethod
    def forward(ctx, x, w_axis, group):
        n = group_size(group)
        ctx.meta = (w_axis, group_rank(group), x.shape[w_axis])
        send = x.contiguous()
        if send.dtype == torch.bool:
            send = send.to(torch.uint8)
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send, group=group)
        return torch.cat(parts, dim=w_axis).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        w_axis, r, W = ctx.meta
        return grad.narrow(w_axis, r * W, W), None, None


def gather_width(out: Any, group=None, *, w_axis: int = 2) -> Any:
    """Every tensor of a nested output (the detector's ``head`` and
    ``strided`` dicts) put back together along the width axis, in shard
    order. The identity in a group of one."""
    if group_size(group) == 1:
        return out
    if isinstance(out, dict):
        return {k: gather_width(v, group, w_axis=w_axis) for k, v in out.items()}
    return _GatherWidth.apply(out, w_axis, group)


def width_sharded_forward(
    apply_fn: Callable[..., Dict[str, Any]],
    group,
    features: torch.Tensor,
    cart: torch.Tensor,
    mask: torch.Tensor,
    *,
    circular: bool = False,
    bn_reduce: bool = False,
    bn_group=None,
) -> Dict[str, Any]:
    """One width-sharded forward: ``apply_fn(features, cart, mask)`` on
    this rank's shards (:func:`shard_width`) under the width context.
    Returns this rank's shard of the outputs (:func:`gather_width` puts
    them together)."""
    with width_sharding(group, circular=circular, bn_reduce=bn_reduce, bn_group=bn_group):
        return apply_fn(features, cart, mask)


def width_stride(model: nn.Module) -> int:
    """The largest width stride of a detector's backbone (16 for the
    five-stage ``RangeBackbone``)."""
    for m in model.modules():
        if hasattr(m, "width_stride"):
            return int(m.width_stride)
    return 1


def width_sharded_apply(
    model: nn.Module,
    group=None,
    *,
    circular: bool = False,
    train: bool = False,
) -> Callable[..., Dict[str, Any]]:
    """A closure ``sharded(features, cart, mask)`` that runs ``model``
    width-sharded over ``group`` on this rank's shards and returns this
    rank's shard of its outputs.

    ``group`` is a width group (or None: the world), or a
    ``mesh.Mesh``: then the request is split over its ``width`` group,
    each data index holding its own rows of the global batch (the JAX
    ``(data, model)`` mesh).

    Train mode (``model.train()``) reduces every BatchNorm's moments over
    the width group, or over the mesh's ``group`` of data x width ranks
    (the JAX ``bn_axes = ("data", "model")``), so each rank's running
    statistics move identically (the JAX package's replicated
    ``batch_stats``). Compute the loss on :func:`gather_width`'s outputs,
    the same on every rank of a width group, under
    ``mesh.replicated_batch(mesh.data)`` (``replicated_batch()`` at a data
    axis of one): its normalizers count the global batch once. Then sum
    the parameter gradients over the mesh (``mesh.all_reduce_grads(grads,
    mesh.group)``, or over the width group): each rank's backward holds
    its shard's share of its rows' loss. The up-front check refuses a
    shard width that is not a multiple of the model's width stride.
    """
    bn_group = None
    if isinstance(group, mesh.Mesh):
        group, bn_group = group.width, group.group
    stride = width_stride(model)
    n = group_size(group)

    def sharded(features, cart, mask):
        check_width(features.shape[2] * n, n, stride)
        model.train(train)
        return width_sharded_forward(
            model, group, features, cart, mask, circular=circular, bn_reduce=train,
            bn_group=bn_group,
        )

    return sharded
