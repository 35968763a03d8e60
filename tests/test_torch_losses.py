"""Port parity for the losses and the affinity assignment, on the CPU.

Losses: ``sigmoid_bce``, ``varifocal_loss``, ``focal_loss`` (with and
without the class weight), ``penalty_reduced_focal_loss`` and ``l1_loss``
on seeded logits in [-8, 8] and soft targets with exact zeros and ones,
against the JAX functions: fp32 within 1e-6 relative, and the output
dtype is the JAX one's (fp32 and bf16 inputs).

Assignment: ``compute_classification_targets`` on the targets of a seeded
(2, 8, 64) scene (``test_torch_targets.scene``, K = 8) with regressands
near the targets, some pixels set exactly to their targets so that
affinities tie at 1, for the GAUSSIAN and BEV affinities, ``k`` infinite
and 2 (ties broken by flat index), and ``normalize_affinities`` on and
off. Masks equal. GAUSSIAN affinities within 1e-6 relative. BEV
affinities within 3e-5 absolute: an fp32 rotated IoU is good to about
1e-5 (its shoelace sum cancels; JAX's eager and jitted IoUs of one pair
differ by 5e-6, ``test_torch_targets.test_aligned_bev_iou_matches_jax``),
so 1e-6 relative would hold the port to digits neither package computes.
The BEV cases take no engineered ties: the self-IoU of a box is 1 only to
within that noise, so which of several "tied" pixels the top-k keeps is
decided by noise, in JAX's eager and jitted runs alike.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.ops import assignment as tassign
from range_view_3d_detection_torch.ops import losses as tlosses
from range_view_3d_detection_tpu.ops import assignment as jassign
from range_view_3d_detection_tpu.ops import losses as jlosses
from range_view_3d_detection_tpu.ops import targets as jtargets
from test_torch_targets import TASKS, scene

torch.set_num_threads(2)

LOSSES = {
    "bce": (lambda m, x, t: m.sigmoid_bce(x, t)),
    "varifocal": (lambda m, x, t: m.varifocal_loss(x, t, alpha=0.75, gamma=2.0)),
    "focal": (lambda m, x, t: m.focal_loss(x, t)),
    "focal-no-alpha": (lambda m, x, t: m.focal_loss(x, t, alpha=-1.0, gamma=1.5)),
    "penalty-reduced": (lambda m, x, t: m.penalty_reduced_focal_loss(x, t, alpha=2.0, gamma=4.0)),
    "l1": (lambda m, x, t: m.l1_loss(x, t)),
}


def _loss_inputs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    logits = rng.uniform(-8, 8, n).astype(np.float32)
    targets = rng.uniform(0, 1, n).astype(np.float32)
    targets[rng.uniform(size=n) < 0.4] = 0.0
    targets[rng.uniform(size=n) < 0.1] = 1.0
    return logits, targets


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    fn = LOSSES[name]
    x, t = _loss_inputs()
    want = np.asarray(fn(jlosses, jnp.asarray(x), jnp.asarray(t)))
    got = fn(tlosses, torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # bf16 in, bf16 out, as in JAX.
    want16 = fn(jlosses, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16))
    got16 = fn(tlosses, torch.from_numpy(x).bfloat16(), torch.from_numpy(t).bfloat16())
    assert str(want16.dtype) == "bfloat16" and got16.dtype == torch.bfloat16


def _assignment_inputs(seed, ties=True):
    cart, valid, boxes, box_valid, box_task, box_offset = scene(seed=seed)
    box_task[:] = 0
    tg = jtargets.compute_targets(
        *(jnp.asarray(a) for a in (cart, valid, boxes, box_valid, box_task, box_offset)),
        tasks=TASKS, fpn_strides=(1,),
    )[1][0]
    reg_t = np.array(tg.regression_targets)
    rng = np.random.default_rng(seed + 100)
    regressands = reg_t + rng.normal(0, 0.2, reg_t.shape).astype(np.float32)
    regressands[..., 3:6] = reg_t[..., 3:6] + rng.normal(0, 0.05, reg_t[..., 3:6].shape)
    if ties:
        exact = rng.uniform(size=reg_t.shape[:-1]) < 0.3
        regressands[exact] = reg_t[exact]  # affinity exactly 1 here: ties
    regressands = regressands.astype(np.float32)
    return (regressands, reg_t, np.array(tg.labels), np.array(tg.winner_index), cart, valid)


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("k", [float("inf"), 2.0], ids=["k-inf", "k2"])
@pytest.mark.parametrize("affinity_fn", ["GAUSSIAN", "BEV"])
def test_classification_targets_match_jax(affinity_fn, k, normalize):
    args = _assignment_inputs(seed=11, ties=affinity_fn == "GAUSSIAN")
    kw = dict(num_categories=2, affinity_fn=affinity_fn, sigma=0.75, k=k,
              normalize_affinities=normalize, max_boxes=8)
    want = jassign.compute_classification_targets(*(jnp.asarray(a) for a in args), **kw)
    targs = [torch.from_numpy(a) for a in args]
    targs[0].requires_grad_()
    got = tassign.compute_classification_targets(*targs, **kw)
    assert not got.affinities.requires_grad

    g_aff, w_aff = got.affinities.numpy(), np.asarray(want.affinities)
    fg = w_aff.max(-1) > 0
    assert fg.sum() > (20 if k == float("inf") else 8), fg.sum()
    if affinity_fn == "GAUSSIAN":
        np.testing.assert_allclose(g_aff, w_aff, rtol=1e-6, atol=0)
        assert (w_aff == 1.0).any()  # the tied pixels
        for name in ("foreground_mask", "background_mask", "regression_weights"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
            )
        return
    np.testing.assert_allclose(g_aff, w_aff, atol=3e-5, rtol=0)
    np.testing.assert_array_equal(got.regression_weights.numpy(),
                                  np.asarray(want.regression_weights))
    # The masks follow aff > 0, which the IoU noise cannot flip unless an
    # affinity sits within it of 0.
    clear = (w_aff.max(-1) == 0) | (w_aff.max(-1) > 3e-5)
    for name in ("foreground_mask", "background_mask"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy()[clear], np.asarray(getattr(want, name))[clear],
            err_msg=name,
        )


def test_top_k_ranks_ties_by_flat_index():
    """Three pixels of one instance tie at affinity 1 and k = 2: the first
    two in flat order keep it, in both packages; the other instance's
    pixels are ranked by affinity."""
    aff = np.zeros((1, 2, 4), np.float32)
    win = np.full((1, 2, 4), -1, np.int32)
    aff[0, 0, [1, 2]] = 1.0
    aff[0, 1, 3] = 1.0
    win[0, 0, [1, 2]] = 3
    win[0, 1, 3] = 3
    aff[0, 1, [0, 1, 2]] = [0.2, 0.7, 0.5]
    win[0, 1, [0, 1, 2]] = 0
    kw = dict(k=2.0, normalize=False, max_boxes=8)
    want = np.asarray(jassign._per_instance_postprocess(jnp.asarray(aff), jnp.asarray(win), **kw))
    got = tassign._per_instance_postprocess(torch.from_numpy(aff), torch.from_numpy(win), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0, 1] == want[0, 0, 2] == 1.0 and want[0, 1, 3] == 0.0
    assert want[0, 1, 0] == 0.0 and want[0, 1, 1] == np.float32(0.7)
