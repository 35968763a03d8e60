"""Range-view augmentations on numpy image tensors (the port's copy of
the JAX ``data/augmentations.py``: the same draws from the same
``np.random.Generator``).

Capability parity with ``prototype/loader.py`` (flip_azimuth 941-990,
random_rotation 825-880, random_global_scale 883-911,
random_global_translation 914-938, _point_dropout 506-512) — re-designed to
operate directly on the decoded ``(H, W, C)`` image dict instead of polars
frames (cheaper: no frame round-trips in the worker hot path).

A "sweep" is a dict with keys:
    features (H, W, F) — feature channels in config order
    cart     (H, W, 3)
    range    (H, W)
    mask     (H, W) bool
and boxes are ``(N, 7)`` cuboids + auxiliary columns handled by the caller.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

Sweep = Dict[str, np.ndarray]


def _rot_z(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _apply_cart(sweep: Sweep, fn, feature_cart_slices) -> None:
    """Apply a pointwise xyz transform to cart and any xyz feature channels."""
    sweep["cart"] = fn(sweep["cart"])
    for sl in feature_cart_slices:
        sweep["features"][..., sl] = fn(sweep["features"][..., sl])


def flip_azimuth(
    sweep: Sweep,
    boxes: np.ndarray,
    rng: np.random.Generator,
    *,
    p: float = 0.5,
    feature_cart_slices=(),
) -> Tuple[Sweep, np.ndarray]:
    """Horizontal flip: reverse image columns, mirror y, negate yaw
    (``loader.py:941-990``)."""
    if rng.uniform() > p:
        return sweep, boxes
    for k in ("features", "cart", "range", "mask"):
        sweep[k] = np.ascontiguousarray(np.flip(sweep[k], axis=1))

    def mirror(xyz):
        out = xyz.copy()
        out[..., 1] = -out[..., 1]
        return out

    _apply_cart(sweep, mirror, feature_cart_slices)
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
    return sweep, boxes


def random_rotation(
    sweep: Sweep,
    boxes: np.ndarray,
    rng: np.random.Generator,
    *,
    low: float,
    high: float,
    p: float = 1.0,
    feature_cart_slices=(),
) -> Tuple[Sweep, np.ndarray]:
    """Azimuth roll of columns + SO(2) rotation of geometry
    (``loader.py:825-880``)."""
    if rng.uniform() > p:
        return sweep, boxes
    theta = float(rng.uniform(low, high))
    width = sweep["features"].shape[1]
    shift = math.floor(theta / math.tau * width)
    for k in ("features", "cart", "range", "mask"):
        sweep[k] = np.roll(sweep[k], shift=shift, axis=1)

    rot = _rot_z(theta)

    def rotate(xyz):
        return xyz @ rot  # row-vectors: equals R(-theta) @ x per reference

    _apply_cart(sweep, rotate, feature_cart_slices)
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, :3] = boxes[:, :3] @ rot
        boxes[:, 6] = boxes[:, 6] - theta
    return sweep, boxes


def random_global_scale(
    sweep: Sweep,
    boxes: np.ndarray,
    rng: np.random.Generator,
    *,
    low: float,
    high: float,
    range_feature_index: Optional[int] = None,
    feature_cart_slices=(),
) -> Tuple[Sweep, np.ndarray]:
    """Uniform scale of geometry + ranges (``loader.py:883-911``)."""
    scale = float(rng.uniform(low, high))

    def scale_fn(xyz):
        return xyz * scale

    _apply_cart(sweep, scale_fn, feature_cart_slices)
    sweep["range"] = sweep["range"] * scale
    if range_feature_index is not None:
        sweep["features"][..., range_feature_index] *= scale
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, :6] *= scale
    return sweep, boxes


def random_global_translation(
    sweep: Sweep,
    boxes: np.ndarray,
    rng: np.random.Generator,
    *,
    std_x: float,
    std_y: float,
    std_z: float,
    feature_cart_slices=(),
) -> Tuple[Sweep, np.ndarray]:
    """Global translation of geometry (``loader.py:914-938``; note the
    reference does not refresh the range channel here — preserved)."""
    t = np.array(
        [
            rng.normal(0, std_x),
            rng.normal(0, std_y),
            rng.normal(0, std_z),
        ],
        np.float32,
    )

    def translate(xyz):
        return xyz + t

    _apply_cart(sweep, translate, feature_cart_slices)
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, :3] += t
    return sweep, boxes


def point_dropout(
    sweep: Sweep, rng: np.random.Generator, *, p: float
) -> Sweep:
    """Random pixel dropout (``loader.py:506-512``)."""
    keep = rng.uniform(size=sweep["mask"].shape) <= p
    sweep["mask"] = sweep["mask"] & keep
    sweep["features"] = sweep["features"] * keep[..., None]
    sweep["cart"] = sweep["cart"] * keep[..., None]
    sweep["range"] = sweep["range"] * keep
    return sweep


def apply_augmentations(
    sweep: Sweep,
    boxes: np.ndarray,
    config: Dict[str, Dict[str, float]],
    rng: np.random.Generator,
    *,
    feature_cart_slices=(),
    range_feature_index: Optional[int] = None,
) -> Tuple[Sweep, np.ndarray]:
    """Dispatch in config order (``loader.py::apply_augmentations``)."""
    for name, kwargs in (config or {}).items():
        kwargs = dict(kwargs)
        if name == "flip_azimuth":
            sweep, boxes = flip_azimuth(
                sweep, boxes, rng, feature_cart_slices=feature_cart_slices,
                **kwargs,
            )
        elif name == "random_rotation":
            sweep, boxes = random_rotation(
                sweep, boxes, rng, feature_cart_slices=feature_cart_slices,
                **kwargs,
            )
        elif name == "random_global_scale":
            sweep, boxes = random_global_scale(
                sweep,
                boxes,
                rng,
                feature_cart_slices=feature_cart_slices,
                range_feature_index=range_feature_index,
                **kwargs,
            )
        elif name == "random_global_translation":
            sweep, boxes = random_global_translation(
                sweep, boxes, rng, feature_cart_slices=feature_cart_slices,
                **kwargs,
            )
        elif name == "point_dropout":
            sweep = point_dropout(sweep, rng, **kwargs)
        else:
            raise NotImplementedError(f"augmentation {name}")
    return sweep, boxes
