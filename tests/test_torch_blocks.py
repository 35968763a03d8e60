"""Port parity: the torch blocks against the flax blocks, fp32 on the CPU.

Both sides get the same weights: flax initialises them, the BatchNorm
affines and running statistics are randomised in the numpy tree (so a
statistics-mapping mistake shows), and ``transplant.py`` loads the tree
into the torch module. Tolerance: atol = rtol = 1e-4 (fp32 convolutions
summed in different orders).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.models import blocks as tb
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.models import blocks as jb

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), dict(tree))


def randomize_bn(params, batch_stats, seed: int):
    """Random BN scale/bias (in params) and mean/var (var in [0.5, 2])."""
    rng = np.random.default_rng(seed)
    params, batch_stats = numpy_tree(params), numpy_tree(batch_stats)

    def walk(tree, fn):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, fn)
            else:
                tree[k] = fn(k, v)

    def stat(name, v):
        if name.endswith("mean"):
            return rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        if name.endswith("var"):
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return v

    def affine(name, v):
        if name == "scale" or name.endswith("bn_scale"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if v.ndim == 1 and (name == "bias" or name.endswith("bn_bias")):
            return rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        return v

    walk(params, affine)
    walk(batch_stats, stat)
    return params, batch_stats


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def _run_pair(jx_module, tx_module, inputs, seed=0):
    v = jx_module.init(jax.random.PRNGKey(seed), *inputs)
    params, stats = randomize_bn(v["params"], v.get("batch_stats", {}), seed + 1)
    want = np.asarray(
        jx_module.apply({"params": params, "batch_stats": stats}, *inputs)
    )
    load_flax_variables(tx_module.eval(), params, stats)
    with torch.no_grad():
        got = nhwc(tx_module(*(nchw(x) for x in inputs)))
    return got, want


CASES = {
    "conv_norm_act_s12": lambda: (
        jb.ConvNormAct(8, strides=(1, 2)),
        tb.ConvNormAct(5, 8, (3, 3), (1, 2)),
        [(2, 6, 16, 5)],
    ),
    "basic_block": lambda: (
        jb.BasicBlock(6),
        tb.BasicBlock(6, 6),
        [(2, 6, 16, 6)],
    ),
    "basic_block_project_s12": lambda: (
        jb.BasicBlock(8, strides=(1, 2), project=True),
        tb.BasicBlock(5, 8, strides=(1, 2), project=True),
        [(2, 6, 16, 5)],
    ),
    "residual_block_s12": lambda: (
        jb.ResidualBlock(8, num_blocks=2, strides=(1, 2)),
        tb.ResidualBlock(6, 8, num_blocks=2, strides=(1, 2)),
        [(2, 6, 16, 6)],
    ),
    "aggregation_k38_s14_p12": lambda: (
        jb.AggregationBlock(8, (3, 8), (1, 4), (1, 2), num_blocks=2),
        tb.AggregationBlock(6, 8, (3, 8), (1, 4), (1, 2), num_blocks=2),
        [(2, 5, 16, 8), (2, 5, 4, 6)],
    ),
    "aggregation_k34_s12_p11": lambda: (
        jb.AggregationBlock(8, (3, 4), (1, 2), (1, 1), num_blocks=1),
        tb.AggregationBlock(6, 8, (3, 4), (1, 2), (1, 1), num_blocks=1),
        [(2, 5, 16, 8), (2, 5, 8, 6)],
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_flax(case):
    jx_module, tx_module, shapes = CASES[case]()
    rng = np.random.default_rng(7)
    inputs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    got, want = _run_pair(jx_module, tx_module, inputs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
