"""Port parity for the dense training targets, fp32 on the CPU.

The JAX ``ops/targets.py::compute_targets`` and the port's on the same
batch: (B, H, W) = (2, 8, 64), K = 8 padded boxes (6 valid, centred on
returns, one of them a copy of another so two boxes tie on their interior
counts), two tasks. Covered: strides 1 and 2 (one config with both), FPN
assignment None, RANGE and POINTS, azimuth-invariant coding on and off.

Held: ``labels``, ``winner_index``, ``points_per_obj`` and ``num_objects``
equal; ``regression_targets`` within 1e-5 absolute. The geometry the
targets rest on (``points_in_boxes``, ``wrap_angle``,
``boxes_to_vertices``), ``encode_boxes`` (against JAX, and round trip
through the port's ``decode_boxes``) and the aligned BEV IoU are held
against the JAX functions too.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.ops import coding as tcoding
from range_view_3d_detection_torch.ops import geometry as tgeom
from range_view_3d_detection_torch.ops import iou as tiou
from range_view_3d_detection_torch.ops import targets as ttargets
from range_view_3d_detection_tpu.ops import coding as jcoding
from range_view_3d_detection_tpu.ops import geometry as jgeom
from range_view_3d_detection_tpu.ops import iou as jiou
from range_view_3d_detection_tpu.ops import targets as jtargets

torch.set_num_threads(2)
TASKS = {0: ("A", "B"), 1: ("C",)}


def scene(seed=0, B=2, H=8, W=64, K=8, n_real=6):
    """A batch of range images with boxes centred on valid returns; box 2
    is a copy of box 1 (equal interior counts, annotation order decides)."""
    rng = np.random.default_rng(seed)
    az = np.linspace(-np.pi, np.pi, W, endpoint=False)
    incl = np.linspace(-0.3, 0.1, H)
    r = rng.uniform(5, 30, size=(B, H, W))
    cart = np.stack(
        [
            r * np.cos(incl[None, :, None]) * np.cos(az[None, None, :]),
            r * np.cos(incl[None, :, None]) * np.sin(az[None, None, :]),
            r * np.sin(incl[None, :, None]),
        ],
        axis=-1,
    ).astype(np.float32)
    valid = rng.uniform(size=(B, H, W)) > 0.1
    boxes = np.zeros((B, K, 7), np.float32)
    for b in range(B):
        ys, xs = np.nonzero(valid[b])
        pick = rng.choice(len(ys), n_real, replace=False)
        boxes[b, :n_real, :3] = cart[b, ys[pick], xs[pick]] + rng.normal(0, 0.3, (n_real, 3))
        boxes[b, :n_real, 3:6] = rng.uniform(2, 12, (n_real, 3))
        boxes[b, :n_real, 6] = rng.uniform(-np.pi, np.pi, n_real)
        boxes[b, 2] = boxes[b, 1]
    box_valid = np.zeros((B, K), bool)
    box_valid[:, :n_real] = True
    box_task = rng.integers(0, 2, (B, K)).astype(np.int32)
    box_task[:, 2] = box_task[:, 1]
    box_offset = rng.integers(0, 2, (B, K)).astype(np.int32)
    return cart, valid, boxes, box_valid, box_task, box_offset


def _both(args, **kw):
    want = jtargets.compute_targets(*(jnp.asarray(a) for a in args), **kw)
    got = ttargets.compute_targets(*(torch.from_numpy(a) for a in args), **kw)
    return want, got


def _check(want, got):
    assert set(want) == set(got)
    for stride in want:
        assert set(want[stride]) == set(got[stride])
        for task in want[stride]:
            w, g = want[stride][task], got[stride][task]
            for name in ("labels", "winner_index", "points_per_obj", "num_objects"):
                gv, wv = getattr(g, name).numpy(), np.asarray(getattr(w, name))
                assert gv.dtype == np.int32, name
                np.testing.assert_array_equal(gv, wv, err_msg=f"{name} s{stride} t{task}")
            np.testing.assert_allclose(
                g.regression_targets.numpy(), np.asarray(w.regression_targets),
                atol=1e-5, rtol=0,
            )


ASSIGNMENTS = {
    "none": dict(fpn_assignment_method=None),
    "range": dict(
        fpn_assignment_method="RANGE", range_partitions={1: (0.0, 18.0), 2: (18.0, float("inf"))}
    ),
    "points": dict(
        fpn_assignment_method="POINTS", point_intervals={1: (0.0, 6.0), 2: (6.0, float("inf"))}
    ),
}


@pytest.mark.parametrize("azimuth_invariant", [True, False], ids=["az", "no-az"])
@pytest.mark.parametrize("assignment", sorted(ASSIGNMENTS))
@pytest.mark.parametrize("strides", [(1,), (2,), (1, 2)], ids=["s1", "s2", "s1s2"])
def test_targets_match_jax(strides, assignment, azimuth_invariant):
    args = scene(seed=len(strides) + 3 * azimuth_invariant)
    want, got = _both(
        args, tasks=TASKS, fpn_strides=strides, azimuth_invariant=azimuth_invariant,
        **ASSIGNMENTS[assignment],
    )
    _check(want, got)
    # The scene has real work: winners at every stride, and both tasks.
    for stride in strides:
        wins = sum(int((got[stride][t].winner_index >= 0).sum()) for t in TASKS)
        assert wins > 0


def test_equal_counts_go_to_the_first_box():
    """Boxes 1 and 2 are the same box: every pixel inside them goes to box
    1 (lower annotation index), in both packages."""
    args = scene(seed=7)
    cart, valid, boxes, box_valid, box_task, box_offset = args
    box_task[:] = 0
    want, got = _both(args, tasks=TASKS, fpn_strides=(1,))
    _check(want, got)
    win = got[1][0].winner_index.numpy()
    inside = ttargets.interior_mask(
        torch.from_numpy(cart), torch.from_numpy(boxes), torch.from_numpy(box_valid)
    ).numpy() & valid[:, None]
    both = inside[:, 1] & inside[:, 2]
    assert both.any()
    # Where box 1 (= box 2) wins, box 2 never does.
    assert (win == 2).sum() == 0 and (win[both] == 1).sum() > 0


def test_geometry_matches_jax():
    rng = np.random.default_rng(3)
    boxes = np.concatenate(
        [rng.normal(0, 5, (6, 3)), rng.uniform(1, 6, (6, 3)), rng.uniform(-4, 4, (6, 1))],
        axis=-1,
    ).astype(np.float32)
    pts = rng.normal(0, 5, (500, 3)).astype(np.float32)
    for inclusive in (True, False):
        want = np.asarray(jgeom.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes),
                                                inclusive=inclusive))
        got = tgeom.points_in_boxes(torch.from_numpy(pts), torch.from_numpy(boxes),
                                    inclusive=inclusive).numpy()
        assert want.any() and (got == want).all()
    theta = rng.uniform(-20, 20, 1000).astype(np.float32)
    np.testing.assert_allclose(
        tgeom.wrap_angle(torch.from_numpy(theta)).numpy(),
        np.asarray(jgeom.wrap_angle(jnp.asarray(theta))), atol=1e-6, rtol=0,
    )
    np.testing.assert_allclose(
        tgeom.boxes_to_vertices(torch.from_numpy(boxes)).numpy(),
        np.asarray(jgeom.boxes_to_vertices(jnp.asarray(boxes))), atol=1e-5, rtol=0,
    )


@pytest.mark.parametrize("azimuth_invariant", [True, False], ids=["az", "no-az"])
def test_encode_boxes_matches_jax_and_round_trips(azimuth_invariant):
    rng = np.random.default_rng(4)
    cart = rng.uniform(-40, 40, (64, 3)).astype(np.float32)
    boxes = np.concatenate(
        [cart + rng.normal(0, 2, (64, 3)), rng.uniform(0.5, 6, (64, 3)),
         rng.uniform(-np.pi, np.pi, (64, 1))], axis=-1,
    ).astype(np.float32)
    kw = dict(azimuth_invariant=azimuth_invariant)
    got = tcoding.encode_boxes(torch.from_numpy(boxes), torch.from_numpy(cart), **kw)
    want = np.asarray(jcoding.encode_boxes(jnp.asarray(boxes), jnp.asarray(cart), **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    back = tcoding.decode_boxes(got, torch.from_numpy(cart), **kw).numpy()
    np.testing.assert_allclose(back[:, :6], boxes[:, :6], atol=1e-4, rtol=1e-5)
    dyaw = tgeom.wrap_angle(torch.from_numpy(back[:, 6] - boxes[:, 6])).numpy()
    np.testing.assert_allclose(dyaw, 0.0, atol=1e-5)


def test_aligned_bev_iou_matches_jax():
    """Within 3e-5 absolute: the shoelace sum cancels, so an fp32 IoU is
    good to about 1e-5 (pair 13 here: fp64 0.8387707, the port 0.8387740,
    JAX eager 0.8387594, JAX jitted 0.8387644)."""
    rng = np.random.default_rng(5)
    a = np.concatenate(
        [rng.normal(0, 2, (256, 3)), rng.uniform(0.5, 6, (256, 3)),
         rng.uniform(-np.pi, np.pi, (256, 1))], axis=-1,
    ).astype(np.float32)
    b = a + rng.normal(0, 0.5, a.shape).astype(np.float32)
    b[:, 3:6] = np.abs(b[:, 3:6])
    want = np.asarray(jiou.iou_rotated_bev_aligned(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.iou_rotated_bev_aligned(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
