"""Index manipulation utilities (counterpart of the JAX ``ops/index.py``):
ravel/unravel multi-indices, dense scatter, grids, unique-index
selection, on tensors."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def ravel_multi_index(indices: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(N, D) multi-indices -> (N,) flat indices (row-major)."""
    shape = tuple(int(s) for s in shape)
    strides = np.cumprod((1,) + shape[::-1][:-1])[::-1].copy()
    strides = torch.as_tensor(strides, dtype=indices.dtype, device=indices.device)
    return (indices * strides).sum(dim=-1)


def unravel_index(flat: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(N,) flat indices -> (N, D) multi-indices (row-major)."""
    return torch.stack(torch.unravel_index(flat, tuple(int(s) for s in shape)), dim=-1)


def scatter_nd(
    indices: torch.Tensor, updates: torch.Tensor, shape: Sequence[int]
) -> torch.Tensor:
    """Dense scatter of ``updates`` at multi-``indices`` (N, D) into
    zeros(shape)."""
    out = torch.zeros(tuple(shape), dtype=updates.dtype, device=updates.device)
    out[tuple(indices.T)] = updates
    return out


def mgrid(sizes: Sequence[int], device: str | torch.device = "cpu") -> torch.Tensor:
    """Dense integer grid: (prod(sizes), len(sizes))."""
    axes = [torch.arange(int(s), device=device) for s in sizes]
    grid = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grid], dim=-1)


def ogrid_sparse_neighborhoods(
    centers: torch.Tensor, sizes: Sequence[int]
) -> torch.Tensor:
    """Neighborhood offsets around each center: (N * prod(sizes), D)."""
    offsets = mgrid(sizes, device=centers.device) - torch.as_tensor(
        [int(s) // 2 for s in sizes], device=centers.device
    )
    return (centers[:, None, :] + offsets[None]).reshape(-1, centers.shape[-1])


def unique_indices(indices: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Indices of the first occurrence of each unique row, in stable order."""
    _, first = np.unique(indices.cpu().numpy(), axis=dim, return_index=True)
    return torch.as_tensor(np.sort(first), device=indices.device)
