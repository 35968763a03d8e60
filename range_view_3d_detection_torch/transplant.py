"""Flax variables <-> the port's ``state_dict``.

The port's modules carry the flax module names, so a flax variable path
``A/B/Conv_0/kernel`` is the ``state_dict`` key ``A.B.Conv_0.weight``.
Conversions:

- conv kernels HWIO -> OIHW;
- transposed-conv kernels (cross-correlation over the dilated input)
  flipped in space -> ``ConvTranspose2d``'s (I, O, kh, kw); a transposed
  conv's ``bias`` (``use_bias=True``), like a conv's, keeps name and
  layout;
- BatchNorm ``scale``/``bias`` and ``mean``/``var`` -> ``weight``/``bias``
  and ``running_mean``/``running_var`` (+ ``num_batches_tracked``);
- the MetaKernel's explicit tensors (``pos_{i}_conv_kernel`` (I, O),
  ``pos_{i}_bn_*``, ``fusion1_kernel`` (n*n, C, C)) keep name and layout.

Inputs are nested mappings of array-likes (numpy), as
``jax.device_get(variables)`` gives them; nothing here imports JAX.

The optimizer's state carries over too (:func:`load_optax_state`,
:func:`optax_state_of`): optax ``adamw``'s ``mu``/``nu`` (params-shaped
trees, converted as the params are) and ``count``, and ``MultiSteps``'
``acc_grads``, ``mini_step`` and ``gradient_step``, into the port's
``training.optim.Optimizer`` and back. Gradients compare in the flax
layout through :func:`state_dict_to_flax` of ``{name: grad}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def flax_to_state_dict(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from flax ``params`` and ``batch_stats``."""
    out: Dict[str, torch.Tensor] = {}
    for path, x in _leaves(params):
        *mods, leaf = path
        if leaf == "kernel":
            if mods[-1].startswith("TorchConvTranspose"):
                x = x[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                x = x.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(x))
    for path, x in _leaves(batch_stats):
        *mods, leaf = path
        if leaf in _BN_STATS:
            out[".".join(mods + ["num_batches_tracked"])] = torch.zeros((), dtype=torch.long)
            leaf = _BN_STATS[leaf]
        out[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(x))
    return out


def state_dict_to_flax(
    state_dict: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of :func:`flax_to_state_dict`: (params, batch_stats) trees."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, mods, leaf, x):
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = x

    inverse_stats = {v: k for k, v in _BN_STATS.items()}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        x = t.detach().cpu().float().numpy().copy()  # not a view of the tensor
        if leaf in inverse_stats:
            put(stats, mods, inverse_stats[leaf], x)
        elif leaf.endswith(("_bn_mean", "_bn_var")):
            put(stats, mods, leaf, x)
        elif leaf == "weight" and x.ndim == 4:
            if mods[-1].startswith("TorchConvTranspose"):
                x = x.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                x = x.transpose(2, 3, 1, 0)
            put(params, mods, "kernel", np.ascontiguousarray(x))
        elif leaf == "weight":
            put(params, mods, "scale", x)
        else:
            put(params, mods, leaf, x)
    return params, stats


def load_flax_variables(
    module: nn.Module, params: Mapping[str, Any], batch_stats: Mapping[str, Any]
) -> nn.Module:
    """Load flax variables into ``module`` (strict: every key must match)."""
    module.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    return module


def _params_tree_to_tensors(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return flax_to_state_dict(tree, {})


def load_optax_state(
    model: nn.Module,
    opt: Any,
    *,
    mu: Mapping[str, Any],
    nu: Mapping[str, Any],
    count: int,
    acc_grads: Mapping[str, Any] | None = None,
    mini_step: int = 0,
    gradient_step: int | None = None,
) -> None:
    """Set ``opt`` (the port's ``Optimizer`` over ``model``'s parameters)
    to an optax state: AdamW's moments and count, and with accumulation
    the running mean of the micro-gradients and its position.
    ``gradient_step`` (applied updates, the schedule's count) defaults to
    ``count``."""
    names = {id(p): n for n, p in model.named_parameters()}
    mu_t, nu_t = _params_tree_to_tensors(mu), _params_tree_to_tensors(nu)
    for p in opt.params:
        name = names[id(p)]
        opt.adamw.state[p] = {
            "step": torch.tensor(float(count)),
            # Copies: the tensors would otherwise share the callers' arrays.
            "exp_avg": mu_t[name].to(p.device, copy=True),
            "exp_avg_sq": nu_t[name].to(p.device, copy=True),
        }
    opt.updates = int(count if gradient_step is None else gradient_step)
    opt.mini_step = int(mini_step)
    if acc_grads is not None:
        acc_t = _params_tree_to_tensors(acc_grads)
        for a, p in zip(opt.acc, opt.params):
            a.copy_(acc_t[names[id(p)]])


def optax_state_of(model: nn.Module, opt: Any) -> Dict[str, Any]:
    """The inverse of :func:`load_optax_state`: ``mu``, ``nu`` (flax
    params-shaped numpy trees), ``count``, ``gradient_step``,
    ``mini_step`` and ``acc_grads`` (None without accumulation)."""
    names = {id(p): n for n, p in model.named_parameters()}

    def tree(tensors):
        return state_dict_to_flax(
            {names[id(p)]: t for p, t in zip(opt.params, tensors)}
        )[0]

    states = [opt.adamw.state.get(p, {}) for p in opt.params]
    zeros = [torch.zeros_like(p) for p in opt.params]
    count = int(states[0]["step"]) if states[0] else 0
    return {
        "mu": tree([s.get("exp_avg", z) for s, z in zip(states, zeros)]),
        "nu": tree([s.get("exp_avg_sq", z) for s, z in zip(states, zeros)]),
        "count": count,
        "gradient_step": opt.updates,
        "mini_step": opt.mini_step,
        "acc_grads": None if opt.acc is None else tree(opt.acc),
    }
