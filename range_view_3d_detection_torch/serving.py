"""Serving entry point: the flagship configuration, sample inputs, a
training batch, and a ``Predictor`` that answers requests with forward
-> decode -> NMS, in the compute dtype or, after ``Predictor.quantize``,
on the int8 PTQ path.

``_flagship_config``, ``_sample_inputs`` and ``_dryrun_batch`` are the
port's own copies of the JAX package's ``__graft_entry__.py`` helpers
(numpy only).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from range_view_3d_detection_torch.models.decoder import DecoderConfig, Proposals, decode
from range_view_3d_detection_torch.models.detector import Detector, DetectorConfig
from range_view_3d_detection_torch.models.quantized import (
    calibrate_scales,
    filter_scope,
    fold_batch_norms,
    quantize_model,
)
from range_view_3d_detection_torch.ops.nms import NMSResult


def _flagship_config(tiny: bool = False) -> DetectorConfig:
    """rv-av2 flagship (``conf/experiment/rv-av2.yaml``), or a tiny twin."""
    if tiny:
        return DetectorConfig(
            tasks=((0, ("PEDESTRIAN", "REGULAR_VEHICLE")),),
            in_channels=5,
            layers=(8, 8, 8, 8, 8),
            stem_type="META",
            fpn=((1, 16),),
            fpn_kernel_sizes=((1, (3, 3)),),
            classification_head_channels=8,
            regression_head_channels=8,
            num_classification_blocks=1,
            num_regression_blocks=1,
            max_boxes=8,
            dtype="float32",
        )
    cats = tuple(f"C{i}" for i in range(26))
    return DetectorConfig(
        tasks=((0, cats),),
        in_channels=5,
        layers=(256, 128, 128, 128, 128),
        stem_type="META",
        fpn=((1, 512),),
        fpn_kernel_sizes=((1, (3, 3)),),
        classification_head_channels=512,
        regression_head_channels=512,
        max_boxes=256,
        dtype="bfloat16",
        stem_pallas=True,  # the fused eval stem (K1)
    )


def _sample_inputs(
    B: int, H: int, W: int, C: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A synthetic range image: (features (B,H,W,C), cart (B,H,W,3), mask)."""
    rng = np.random.default_rng(seed)
    az = np.linspace(-np.pi, np.pi, W, endpoint=False, dtype=np.float32)
    incl = np.linspace(-0.3, 0.1, H, dtype=np.float32)
    r = rng.uniform(5, 60, size=(B, H, W)).astype(np.float32)
    cart = np.stack(
        [
            r * np.cos(incl[None, :, None]) * np.cos(az[None, None, :]),
            r * np.cos(incl[None, :, None]) * np.sin(az[None, None, :]),
            r * np.sin(incl[None, :, None]),
        ],
        axis=-1,
    )
    feats = np.concatenate(
        [rng.uniform(0, 1, (B, H, W, C - 3)).astype(np.float32), cart], axis=-1
    )
    mask = r > 6.0
    return feats, cart, mask


def _dryrun_batch(
    cfg: DetectorConfig, B: int, H: int, W: int, C: int, seed: int = 1
) -> Dict[str, np.ndarray]:
    """A training batch: ``_sample_inputs`` plus two 4 m boxes an image at
    the return of pixel (H/2, W/8), in ``cfg.max_boxes`` padded slots."""
    rng = np.random.default_rng(seed)
    feats, cart, mask = _sample_inputs(B, H, W, C, seed=seed)
    K = cfg.max_boxes
    boxes = np.zeros((B, K, 7), np.float32)
    boxes[:, :2, :3] = cart[:, H // 2, W // 8][:, None, :]
    boxes[:, :2, 3:6] = 4.0
    return {
        "features": feats,
        "cart": cart,
        "mask": mask,
        "boxes": boxes,
        "box_valid": np.asarray([[True, True] + [False] * (K - 2)] * B),
        "box_task": np.zeros((B, K), np.int32),
        "box_offset": rng.integers(0, 2, (B, K)).astype(np.int32),
    }


class Predictor:
    """Serves detections: ``predictor(feats, cart, mask) -> NMSResult``
    (the decoder's ``Proposals`` before NMS when ``use_nms`` is False).

    Runs on ``device`` (``"cuda"`` unless the caller asks for the CPU; a
    host without a CUDA device raises). Weights come from ``generator``
    or are loaded afterwards into ``predictor.model``; ``bn_folded`` says
    that their BatchNorm statistics are already folded into the affines
    (a loaded artifact's are), so :meth:`quantize` does not fold again.
    """

    def __init__(
        self,
        cfg: DetectorConfig,
        decoder_cfg: DecoderConfig = DecoderConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor: no CUDA device on this host; pass device='cpu' "
                "to run the plain kernels on the CPU"
            )
        self.cfg = cfg
        self.decoder_cfg = decoder_cfg
        self.model = Detector(cfg, device=self.device, generator=generator)
        self.quant_tree: Mapping[str, Any] | None = None
        self.bn_folded = False
        self.use_nms = True

    def quantize(
        self,
        batches: Iterable[Tuple[Any, Any, Any]] | None = None,
        *,
        scope: str = "full",
        stem_int8: bool = False,
        quant_tree: Mapping[str, Any] | None = None,
    ) -> "Predictor":
        """Turn this predictor into the int8 PTQ predictor, in place.

        The pipeline of the JAX package's serving point: fold the
        BatchNorm statistics into their affines (once), calibrate the activation
        scales on ``batches`` of ``(feats, cart, mask)`` (or take
        ``quant_tree``, e.g. a JAX ``quant`` collection as numpy), keep
        ``scope`` ("full" or "heads"), and quantize; the stem runs the
        int8 kernel only with ``stem_int8``. Returns ``self``.
        """
        if (batches is None) == (quant_tree is None):
            raise ValueError("Predictor.quantize: pass batches or quant_tree")
        if not self.bn_folded:
            fold_batch_norms(self.model)
            self.bn_folded = True
        with torch.inference_mode():
            if quant_tree is None:
                quant_tree = calibrate_scales(self.model, batches)
        self.quant_tree = filter_scope(quant_tree, scope)
        quantize_model(self.model, self.quant_tree, stem_int8=stem_int8)
        return self

    def __call__(self, feats, cart, mask) -> NMSResult | Proposals:
        with torch.inference_mode():
            feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
            cart = torch.as_tensor(cart, dtype=torch.float32, device=self.device)
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
            out = self.model(feats, cart, mask)
            return decode(out, self.decoder_cfg, self.cfg.tasks_dict, use_nms=self.use_nms)
