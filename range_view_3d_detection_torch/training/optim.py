"""Optimizer and learning-rate schedule (counterpart of the JAX
``training/optim.py``): AdamW, a OneCycle schedule stepped per applied
update, clipping by the global gradient norm, and gradient accumulation.

The JAX package builds ``optax.chain(clip_by_global_norm, adamw)``, wrapped
in ``optax.MultiSteps`` to accumulate. Here:

- the schedule is optax's ``cosine_onecycle_schedule`` as a function of
  the applied-update count, computed in fp32 in optax's order (torch's
  ``OneCycleLR`` puts its phase boundaries a step apart from optax's and
  cycles the momentum, so it is not used);
- the clip is optax's: every gradient scaled by ``max / norm`` unless
  ``norm < max``, with the fp32 norm over every gradient (torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead);
- the update is ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8 outside
  the square root, decay on every parameter, BatchNorm scales included),
  which equals optax's ``adamw`` up to the order of rounding;
- accumulation keeps the running mean of the micro-batch gradients, as
  ``MultiSteps`` does, and clips and updates on the k-th; the schedule
  counts applied updates only;
- ZeRO-1 (``zero1``, the JAX ``zero1_state_sharding``): under a process
  group each rank keeps the AdamW moments of its share of the parameters
  (``parallel/mesh.py::zero1_owners``) and updates only those, and the
  updated parameters are gathered on every rank. AdamW is elementwise,
  so the parameters equal the replicated optimizer's; ``state_dict``
  gathers the moments into the replicated layout, so a checkpoint does
  not depend on the world size or on ``zero1``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Sequence

import numpy as np
import torch

from range_view_3d_detection_torch.parallel import mesh

Schedule = Callable[[int], float]


def onecycle_schedule(
    max_lr: float,
    total_steps: int,
    *,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """optax's ``cosine_onecycle_schedule(max(total_steps, 1), max_lr, ...)``:
    cosine from ``max_lr / div_factor`` up to ``max_lr`` over the first
    ``int(pct_start * T)`` updates, then down to ``max_lr / div_factor /
    final_div_factor`` at update ``T``, constant after."""
    T = max(total_steps, 1)
    bounds = (0, int(pct_start * T), T)
    values = np.cumprod([max_lr / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])
    f32 = np.float32

    def schedule(count: int) -> float:
        if count >= bounds[2]:
            return float(f32(values[2]))
        i = 0 if count < bounds[1] else 1
        pct = f32(count - bounds[i]) / f32(bounds[i + 1] - bounds[i])
        start, end = values[i], values[i + 1]
        cos = np.cos(f32(math.pi) * pct, dtype=f32)
        return float(f32(end) + f32((start - end) / 2.0) * (cos + f32(1.0)))

    return schedule


def scaled_max_lr(max_lr: float, num_devices: int, batch_size: int, *, enable: bool) -> float:
    """The sqrt linear learning-rate scaling rule."""
    if enable:
        return max_lr * math.sqrt(num_devices * batch_size)
    return max_lr


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """fp32 ``sqrt(sum of squares)`` over every gradient (optax's order)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: each gradient as it is when ``norm <
    max_norm``, else ``g / norm * max_norm``; no host synchronisation."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class Optimizer:
    """AdamW over ``params`` with the schedule, the clip and accumulation.

    ``apply(grads)`` takes one micro-batch's gradients (the global
    batch's, the same on every rank) and returns whether an update was
    applied. ``updates`` counts applied updates (the schedule's count);
    ``mini_step`` and ``acc`` are the accumulator's position and running
    mean (``MultiSteps``' ``mini_step`` and ``acc_grads``). With
    ``zero1`` under a process group, ``owners[i]`` is the rank that
    updates ``params[i]`` and ``adamw`` holds only this rank's.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: Schedule,
        *,
        weight_decay: float,
        grad_clip_norm: float,
        accumulate_steps: int,
        zero1: bool = False,
    ):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.accumulate_steps = max(accumulate_steps, 1)
        self.owners: List[int] | None = None
        owned = self.params
        if zero1 and mesh.active():
            self.owners = mesh.zero1_owners([p.numel() for p in self.params], mesh.world())
            owned = [p for p, o in zip(self.params, self.owners) if o == mesh.rank()]
        self.adamw = torch.optim.AdamW(
            owned, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.updates = 0
        self.mini_step = 0
        self.acc: List[torch.Tensor] | None = None
        if self.accumulate_steps > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor]) -> bool:
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accumulate_steps
            if self.mini_step:
                return False
            grads = self.acc
        for p, g in zip(self.params, clip_by_global_norm(grads, self.grad_clip_norm)):
            p.grad = g
        lr = self.schedule(self.updates)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.updates += 1
        for p in self.params:
            p.grad = None
        if self.owners is not None:
            mesh.gather_owned(self.params, self.owners)
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True

    def _adamw_state_dict(self) -> dict:
        """AdamW's state over every parameter (the replicated layout); under
        ZeRO-1 the moments are gathered from their owners, a collective
        every rank enters."""
        local = self.adamw.state_dict()
        if self.owners is None:
            return local
        group = {**local["param_groups"][0], "params": list(range(len(self.params)))}
        if not local["state"]:
            return {"state": {}, "param_groups": [group]}
        step = next(iter(local["state"].values()))["step"]
        moments = {key: [] for key in ("exp_avg", "exp_avg_sq")}
        j = 0  # this rank's index of an owned parameter in ``adamw``
        for p, o in zip(self.params, self.owners):
            entry = None
            if o == mesh.rank():
                entry, j = local["state"][j], j + 1
            for key, out in moments.items():
                out.append(entry[key].clone() if entry else torch.zeros_like(p))
        for tensors in moments.values():
            mesh.gather_owned(tensors, self.owners)
        state = {
            i: {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
            for i, (m, v) in enumerate(zip(moments["exp_avg"], moments["exp_avg_sq"]))
        }
        return {"state": state, "param_groups": [group]}

    def state_dict(self) -> dict:
        return {
            "adamw": self._adamw_state_dict(),
            "updates": self.updates,
            "mini_step": self.mini_step,
            "acc": self.acc,
        }

    def load_state_dict(self, state: dict) -> None:
        adamw = state["adamw"]
        if self.owners is not None:
            mine = [i for i, o in enumerate(self.owners) if o == mesh.rank()]
            saved = adamw["state"]
            adamw = {
                "state": {j: saved[i] for j, i in enumerate(mine) if i in saved},
                "param_groups": [
                    {**adamw["param_groups"][0], "params": list(range(len(mine)))}
                ],
            }
        self.adamw.load_state_dict(adamw)
        self.updates = int(state["updates"])
        self.mini_step = int(state["mini_step"])
        if self.acc is not None:
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` returns in place of an optax transformation:
    ``spec.init(params)`` builds the :class:`Optimizer` over ``params``."""

    schedule: Schedule
    weight_decay: float
    grad_clip_norm: float
    accumulate_steps: int
    zero1: bool = False

    def init(self, params: Iterable[torch.nn.Parameter]) -> Optimizer:
        return Optimizer(
            params, self.schedule, weight_decay=self.weight_decay,
            grad_clip_norm=self.grad_clip_norm, accumulate_steps=self.accumulate_steps,
            zero1=self.zero1,
        )


def make_optimizer(
    max_lr: float,
    total_steps: int,
    *,
    weight_decay: float = 0.01,
    grad_clip_norm: float = 35.0,
    num_devices: int = 1,
    batch_size: int = 1,
    use_linear_lr_scaling: bool = False,
    debug: bool = False,
    accumulate_steps: int = 1,
    zero1: bool = False,
) -> tuple[OptimizerSpec, Schedule]:
    """AdamW + OneCycle + clip-by-global-norm, as the JAX ``make_optimizer``.

    In debug mode the learning rate is constant. ``total_steps`` counts
    applied updates (micro-batches / ``accumulate_steps``), and the sqrt
    rule scales by the effective batch ``batch_size * accumulate_steps``
    on each of ``num_devices``. ``zero1`` shards the moments (see
    :class:`Optimizer`).
    """
    lr = scaled_max_lr(
        max_lr, num_devices, batch_size * max(accumulate_steps, 1),
        enable=use_linear_lr_scaling,
    )
    if debug:
        schedule: Schedule = lambda count: lr  # noqa: E731
    else:
        schedule = onecycle_schedule(lr, total_steps)
    spec = OptimizerSpec(schedule, weight_decay, grad_clip_norm, accumulate_steps, zero1)
    return spec, schedule
