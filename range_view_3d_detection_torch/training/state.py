"""Train state and the train, eval and val steps (counterpart of the JAX
``training/state.py``).

The JAX steps are pure jitted functions over an immutable ``TrainState``;
here the state holds the model (parameters and BatchNorm statistics) and
its optimizer, and a step updates them in place and returns the state.
Steps take a batch of numpy arrays or tensors in the layout of
``models/detector.py`` and move it to the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode
from range_view_3d_detection_torch.models.blocks import checkpoint
from range_view_3d_detection_torch.models.detector import (
    Detector,
    DetectorConfig,
    compute_batch_targets,
    detection_loss,
    global_metrics,
)
from range_view_3d_detection_torch.models.quantized import qat
from range_view_3d_detection_torch.parallel import mesh
from range_view_3d_detection_torch.training.optim import (
    Optimizer,
    OptimizerSpec,
    global_norm,
)

_BATCH_DTYPES = {
    "features": torch.float32,
    "cart": torch.float32,
    "mask": torch.bool,
    "boxes": torch.float32,
    "box_valid": torch.bool,
    "box_task": torch.int32,
    "box_offset": torch.int32,
}


@dataclasses.dataclass
class TrainState:
    step: int
    model: Detector
    opt: Optimizer


def create_state(
    config: DetectorConfig,
    tx: OptimizerSpec,
    *,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
) -> TrainState:
    """A fresh state on ``device`` (``"cuda"`` unless the caller asks for
    the CPU), weights drawn from ``generator``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "create_state: no CUDA device on this host; pass device='cpu' "
            "to train on the CPU"
        )
    model = Detector(config, device=device, generator=generator)
    return TrainState(step=0, model=model, opt=tx.init(model.parameters()))


def make_forward(config: DetectorConfig, *, device: str | torch.device = "cuda"):
    """The plain eval forward (the JAX ``make_forward``):
    ``forward(variables, features, cart, mask)`` with flax-layout
    ``variables`` (``{"params", "batch_stats"}``, numpy) or the port's
    ``state_dict``, on ``device``; returns the detector's outputs."""
    from range_view_3d_detection_torch.transplant import flax_to_state_dict

    model = Detector(config, device=device)
    dev = next(model.parameters()).device

    def forward(variables, features, cart, mask):
        if "params" in variables:
            variables = flax_to_state_dict(variables["params"], variables.get("batch_stats", {}))
        model.load_state_dict(variables, strict=True)
        with torch.inference_mode():
            return model(
                *(torch.as_tensor(a, dtype=dt, device=dev)
                  for a, dt in ((features, torch.float32), (cart, torch.float32),
                                (mask, torch.bool)))
            )

    return forward


def batch_to_device(
    batch: Mapping[str, Any], device: torch.device
) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors of the layout's dtypes on ``device``."""
    return {
        k: torch.as_tensor(v, dtype=_BATCH_DTYPES[k], device=device)
        for k, v in batch.items()
        if k in _BATCH_DTYPES
    }


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def make_train_step(config: DetectorConfig, *, quant_tree: Any = None):
    """The train step: ``train_step(state, batch) -> (state, metrics)``.

    Targets are computed without gradients before the forward; the loss
    is differentiated by autograd, and ``state.opt`` applies the update
    (or accumulates). ``metrics`` holds every key of ``detection_loss``
    and ``grad_norm``, the micro-batch gradients' global norm, as 0-d
    tensors on the device. ``mark``, when given, is called with
    "targets", "forward", "loss", "backward" and "optimizer" as each part
    ends (``chip_smoke.py`` records a CUDA event there); ``grads_out``, a
    list, receives the micro-batch gradients in ``state.opt.params`` order.

    With ``config.remat`` and "loss" in its scope the loss is checkpointed
    from the head outputs, the targets staying outside (the JAX
    ``jax.checkpoint(loss_from_outputs)``). With ``quant_tree`` (a
    calibrated quant tree, JAX layout) the forward runs under QAT
    (``models/quantized.py::qat``): frozen activation scales, only the
    parameters train.

    Under a process group (``parallel/mesh.py``) each rank passes its rows
    of the global batch: the statistics and loss normalizers are global,
    the gradients are summed over the ranks before the clip, and the
    metrics are the global batch's, so every rank takes the JAX step on
    the global batch. The optimizer lives in the state, so the step takes
    no ``tx``; ZeRO-1 is the optimizer's (``training/optim.py``).
    """
    loss_fn = detection_loss
    if config.remat and "loss" in config.remat_scope:
        def loss_fn(outputs, b, cfg, tgts):
            return checkpoint(lambda o: detection_loss(o, b, cfg, tgts=tgts), outputs)

    def train_step(
        state: TrainState,
        batch: Mapping[str, Any],
        mark: Callable[[str], None] | None = None,
        grads_out: List[torch.Tensor] | None = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        mark = mark or (lambda name: None)
        model = state.model.train()
        b = batch_to_device(batch, _device(state))
        with torch.no_grad():
            tgts = compute_batch_targets(b, config)
        mark("targets")
        with qat(model, quant_tree):
            outputs = model(b["features"], b["cart"], b["mask"])
            mark("forward")
            loss, metrics = loss_fn(outputs, b, config, tgts=tgts)
            mark("loss")
            grads = torch.autograd.grad(loss, state.opt.params)
        grads = mesh.all_reduce_grads(grads)
        mark("backward")
        metrics = global_metrics(metrics)
        metrics["grad_norm"] = global_norm(grads)
        if grads_out is not None:
            grads_out.extend(grads)
        state.opt.apply(grads)
        mark("optimizer")
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(
    config: DetectorConfig, decoder_config: DecoderConfig, *, use_nms: bool = True
):
    """Eval forward (running BatchNorm statistics) + decode (+ NMS)."""

    def eval_step(state: TrainState, batch: Mapping[str, Any]):
        model = state.model.eval()
        with torch.inference_mode():
            b = batch_to_device(batch, _device(state))
            outputs = model(b["features"], b["cart"], b["mask"])
            return decode(outputs, decoder_config, config.tasks_dict, use_nms=use_nms)

    return eval_step


def make_val_step(
    config: DetectorConfig, decoder_config: DecoderConfig, *, use_nms: bool = True
):
    """Eval forward, its loss metrics (``val/`` keys; the global batch's
    under a process group, so every rank runs it) and the decode."""

    def val_step(state: TrainState, batch: Mapping[str, Any]):
        model = state.model.eval()
        with torch.inference_mode():
            b = batch_to_device(batch, _device(state))
            outputs = model(b["features"], b["cart"], b["mask"])
            _, metrics = detection_loss(outputs, b, config)
            metrics = global_metrics(metrics)
            result = decode(outputs, decoder_config, config.tasks_dict, use_nms=use_nms)
        return result, {f"val/{k}": v for k, v in metrics.items()}

    return val_step


def make_scoremap_step(config: DetectorConfig):
    """Per-stride range-image panels for training visualisation: the
    max-class score map of each task and the strided validity mask, of
    image 0 only, as fp32 (H, W/stride) tensors (the JAX
    ``make_scoremap_step``)."""

    def scoremap_step(state: TrainState, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        with torch.inference_mode():
            b = batch_to_device(batch, _device(state))
            outputs = model(b["features"], b["cart"], b["mask"])
            maps: Dict[str, torch.Tensor] = {}
            for stride in sorted(outputs["head"]):
                for tid in sorted(outputs["head"][stride]):
                    logits = outputs["head"][stride][tid]["logits"]
                    maps[f"stride{stride}/task{tid}/score"] = (
                        torch.sigmoid(logits[0].float()).amax(dim=-1)
                    )
                maps[f"stride{stride}/mask"] = outputs["strided"][stride]["mask"][0].float()
        return maps

    return scoremap_step
