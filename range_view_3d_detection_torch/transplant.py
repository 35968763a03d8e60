"""Flax variables <-> the port's ``state_dict``.

The port's modules carry the flax module names, so a flax variable path
``A/B/Conv_0/kernel`` is the ``state_dict`` key ``A.B.Conv_0.weight``.
Conversions:

- conv kernels HWIO -> OIHW;
- transposed-conv kernels (cross-correlation over the dilated input)
  flipped in space -> ``ConvTranspose2d``'s (I, O, kh, kw);
- BatchNorm ``scale``/``bias`` and ``mean``/``var`` -> ``weight``/``bias``
  and ``running_mean``/``running_var`` (+ ``num_batches_tracked``);
- the MetaKernel's explicit tensors (``pos_{i}_conv_kernel`` (I, O),
  ``pos_{i}_bn_*``, ``fusion1_kernel`` (n*n, C, C)) keep name and layout.

Inputs are nested mappings of array-likes (numpy), as
``jax.device_get(variables)`` gives them; nothing here imports JAX.
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
        x = t.detach().cpu().float().numpy()
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
