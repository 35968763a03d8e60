"""Small fixed-size sorts (counterpart of the JAX ``ops/sorting.py``).

The JAX package sorts the rotated-IoU polygon's candidate points with a
bitonic compare-exchange network. A bitonic network is not stable: on
equal keys the order it leaves differs from a stable sort's, so the port
runs the same network on the keys and their positions, and moves the
payload with one gather of the resulting permutation.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def _bitonic_stages(n: int) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """(partner permutation, take_min mask) per stage for size n (a power
    of two)."""
    if n & (n - 1):
        raise ValueError(f"bitonic size must be a power of two, not {n}")
    idx = np.arange(n)
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            take_min = ((idx & k) == 0) == (idx < partner)
            stages.append((partner, take_min))
            j //= 2
        k *= 2
    return tuple(stages)


def sort_with_payload(
    keys: torch.Tensor, payload: torch.Tensor, n_pad: int | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending sort of ``keys (..., n)`` carrying ``payload (..., n, P)``.

    Pads to ``n_pad`` (default: the next power of two) with ``+inf`` keys
    and zero payload rows. Returns (sorted_keys, sorted_payload) of the
    padded size, in the order of the JAX package's bitonic network, ties
    included.
    """
    n = keys.shape[-1]
    size = n_pad or (1 << (n - 1).bit_length())
    if size != n:
        keys = torch.cat(
            [keys, keys.new_full(keys.shape[:-1] + (size - n,), float("inf"))], dim=-1
        )
        payload = torch.cat(
            [payload, payload.new_zeros(payload.shape[:-2] + (size - n, payload.shape[-1]))],
            dim=-2,
        )
    perm = torch.arange(size, device=keys.device).expand(keys.shape).contiguous()
    for partner_np, take_min_np in _bitonic_stages(size):
        partner = torch.as_tensor(partner_np, device=keys.device)
        take_min = torch.as_tensor(take_min_np, device=keys.device)
        b_keys = keys[..., partner]
        # Equal keys keep each side's own element (as in JAX: with `<=`
        # both partners would pick the same one).
        choose_a = (keys == b_keys) | ((keys < b_keys) == take_min)
        keys = torch.where(choose_a, keys, b_keys)
        perm = torch.where(choose_a, perm, perm[..., partner])
    index = perm[..., None].expand(perm.shape + (payload.shape[-1],))
    return keys, torch.gather(payload.expand(keys.shape + payload.shape[-1:]), -2, index)
