"""Training loop: data -> train step -> validation -> prediction shards
(counterpart of the JAX ``training/loop.py``), on one device.

Capability parity with the orchestration half of the reference
(``scripts/train.py:34-113`` + ``Detector.training_step/validation_step/
on_validation_end``, detector.py:238-544): a plain Python loop around the
port's train step; prediction shards are written as Feather per
(log_id, timestamp), as the reference and the JAX package write them,
then evaluated on the host.

The JAX Trainer's mesh, batch sharding and cross-process reductions have
no counterpart here: the port trains on one device (``cuda`` unless the
caller or ``trainer.device`` asks for the CPU), and ``trainer.devices``
other than 1 (or ``auto`` on a host with several cards) and
``trainer.zero1=true`` raise (multi-GPU is ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import json
import logging
import signal
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from range_view_3d_detection_torch.data.dataset import DataLoader, RangeViewDataset
from range_view_3d_detection_torch.models.decoder import DecoderConfig
from range_view_3d_detection_torch.models.detector import DetectorConfig
from range_view_3d_detection_torch.training import optim
from range_view_3d_detection_torch.training.builders import (
    build_dataset_config,
    build_decoder_config,
    build_detector_config,
)
from range_view_3d_detection_torch.training.checkpoints import CheckpointManager
from range_view_3d_detection_torch.training.state import (
    _BATCH_DTYPES,
    TrainState,
    create_state,
    make_eval_step,
    make_scoremap_step,
    make_train_step,
    make_val_step,
)
from range_view_3d_detection_torch.utils.config import flatten
from range_view_3d_detection_torch.utils.feather import write_feather
from range_view_3d_detection_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)

_CUBOID_COLUMNS = ("tx_m", "ty_m", "tz_m", "length_m", "width_m", "height_m")


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def flatten_detections(result, uuids, categories) -> Dict[str, np.ndarray]:
    """NMSResult (B, cap, ...) -> flat prediction columns with uuid joins.

    Mirrors ``build_dataframe`` (coding.py:31-76): cuboid params + quat +
    score + category name + log_id/timestamp, as the JAX
    ``flatten_detections`` builds them.
    """
    keep = result.keep.cpu().numpy()
    cuboids = result.cuboids.cpu().numpy()
    scores = result.scores.cpu().numpy()
    cats = result.categories.cpu().numpy()
    names = (*_CUBOID_COLUMNS, "qw", "qx", "qy", "qz", "score", "category",
             "log_id", "timestamp_ns")
    cols: Dict[str, list] = {k: [] for k in names}
    for b, (log_id, ts) in enumerate(uuids):
        sel = keep[b]
        cub = cuboids[b][sel]
        half = cub[:, 6] * 0.5
        zeros = np.zeros_like(half)
        quat = np.stack([np.cos(half), zeros, zeros, np.sin(half)], axis=-1)
        for i, name in enumerate(_CUBOID_COLUMNS):
            cols[name].append(cub[:, i])
        for i, name in enumerate(("qw", "qx", "qy", "qz")):
            cols[name].append(quat[:, i])
        cols["score"].append(scores[b][sel])
        cols["category"].append(np.asarray([categories[c] for c in cats[b][sel]], dtype=object))
        n = int(sel.sum())
        cols["log_id"].append(np.asarray([log_id] * n, dtype=object))
        cols["timestamp_ns"].append(np.full(n, ts, np.int64))
    return {k: np.concatenate(v) if v else np.asarray([]) for k, v in cols.items()}


def write_prediction_shards(result, uuids, categories, dst: Path) -> None:
    """One Feather shard of ``result``'s kept detections per (log_id,
    timestamp) of the batch, ``dst/<log_id>_<timestamp>.feather``
    (``detector.py:366-380``)."""
    cols = flatten_detections(result, uuids, categories)
    for log_id, ts in uuids:
        m = (cols["log_id"] == log_id) & (cols["timestamp_ns"] == ts)
        shard = {k: (v[m] if len(v) else v) for k, v in cols.items()}
        shard["category"] = shard["category"].astype(str)
        shard["log_id"] = shard["log_id"].astype(str)
        write_feather(dst / f"{log_id}_{ts}.feather", shard)


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` on a host without a card
    raises (there is no quiet CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device on this host; pass device='cpu' (or "
            "++trainer.device=cpu) to run on the CPU"
        )
    return device


class Trainer:
    """End-to-end trainer over a composed config dict, on ``device``
    (``trainer.device`` in the config, else ``cuda``)."""

    def __init__(self, cfg: Dict[str, Any], *, device: str | torch.device | None = None):
        self.cfg = cfg
        tcfg = cfg["trainer"]
        self.device = resolve_device(device or tcfg.get("device", "cuda"))
        devices = tcfg.get("devices", "auto")
        n_cards = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if (devices == "auto" and n_cards > 1) or (devices != "auto" and int(devices) != 1):
            raise NotImplementedError(
                f"trainer.devices={devices}: the port trains on one device; "
                "multi-GPU is ROADMAP.md Queue 1 item 6"
            )
        if bool(tcfg.get("zero1", False)):
            raise NotImplementedError(
                "trainer.zero1=true: optimizer sharding is multi-GPU, ROADMAP.md "
                "Queue 1 item 6"
            )
        self.det_cfg: DetectorConfig = build_detector_config(cfg)
        self.dec_cfg: DecoderConfig = build_decoder_config(cfg)

        run_dir = Path(cfg.get("run_dir") or Path(tempfile.gettempdir()) / "rangebox-torch")
        run_dir.mkdir(parents=True, exist_ok=True)
        self.run_dir = run_dir
        self.logger = MetricsLogger(
            run_dir, backend=tcfg.get("logger", {}).get("backend", "jsonl")
        )

        self.batch_size = int(cfg["model"]["batch_size"])
        self.train_ds = RangeViewDataset(build_dataset_config(cfg, "train"))
        self.val_ds = RangeViewDataset(build_dataset_config(cfg, "val"))
        self.train_loader = DataLoader(self.train_ds, self.batch_size, shuffle=True)
        self.val_loader = DataLoader(
            self.val_ds, self.batch_size, shuffle=False, drop_last=False
        )

        self.max_epochs = int(tcfg.get("max_epochs", 20))
        steps_per_epoch = max(len(self.train_loader), 1)
        # PTL accumulate_grad_batches analog: the scheduler counts
        # OPTIMIZER steps, of which there are micro-steps / k.
        self.accum_steps = max(int(tcfg.get("accumulate_grad_batches", 1)), 1)
        total_steps = max(steps_per_epoch * self.max_epochs // self.accum_steps, 1)

        m = cfg["model"]
        debug = bool(m.get("debug", False))
        self.tx, self.schedule = optim.make_optimizer(
            float(m["_scheduler"]["max_lr"]),
            total_steps,
            weight_decay=float(m["_optimizer"].get("weight_decay", 0.01)),
            grad_clip_norm=float(tcfg.get("gradient_clip_val", 35.0)),
            num_devices=1,
            batch_size=self.batch_size,
            use_linear_lr_scaling=bool(m.get("use_linear_lr_scaling", False)),
            debug=debug,
            accumulate_steps=self.accum_steps,
        )
        self.train_step = make_train_step(self.det_cfg)
        self.eval_step = make_eval_step(self.det_cfg, self.dec_cfg)
        self._scoremap_step = None

        ckpt_cfg = tcfg.get("checkpoint", {})
        self.ckpt: Optional[CheckpointManager] = None
        if ckpt_cfg.get("enable", True) and not debug:
            self.ckpt = CheckpointManager(
                ckpt_cfg.get("dir", run_dir / "checkpoints"),
                keep=int(ckpt_cfg.get("keep", 2)),
            )
        # Mid-epoch checkpoint cadence (0 = per-epoch only) and
        # signal-triggered preemption saves (reference analog: the SLURM
        # SIGUSR2 requeue hook, scripts/train.py:46-57).
        self.ckpt_every_n_steps = int(ckpt_cfg.get("every_n_steps", 0))
        self.ckpt_on_preempt = bool(ckpt_cfg.get("on_preempt", True))
        self._preempt_requested = False

        # Flat category list in (task, offset) order for decoding indices.
        self.categories = []
        for _, cats in sorted(self.det_cfg.tasks, key=lambda kv: kv[0]):
            self.categories.extend(sorted(cats))

        self.train_log_freq = int(m.get("train_log_freq", 100))
        # Mid-run validation cadence (``check_val_every_n_epoch``; the
        # default, max_epochs, validates only at the end).
        self.val_every_n_epoch = int(
            tcfg.get("check_val_every_n_epoch", self.max_epochs) or self.max_epochs
        )
        self.state: Optional[TrainState] = None
        self._val_step = None

        # Persist hyperparameters (save_hyperparameters parity,
        # detector.py:143-158): flattened config at step 0 + full JSON.
        (run_dir / "config.json").write_text(json.dumps(cfg, default=str))
        self.logger.log({k: v for k, v in flatten(cfg).items() if _is_number(v)}, 0)

    def _init_state(self) -> TrainState:
        """A fresh state from seed 0, or the latest checkpoint's."""
        state = create_state(
            self.det_cfg, self.tx, device=self.device,
            generator=torch.Generator().manual_seed(0),
        )
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, _ = self.ckpt.restore(state)
            logger.info("resumed from step %d", int(state.step))
        return state

    def _to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device: through pinned host memory with
        ``non_blocking`` copies on a card, so the copy does not hold the
        host."""
        out = {}
        for k, dtype in _BATCH_DTYPES.items():
            t = torch.from_numpy(np.ascontiguousarray(batch[k])).to(dtype)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _device_prefetch(self, loader) -> Iterator[Tuple[Dict[str, torch.Tensor], dict]]:
        """Yield (device_batch, host_batch) with the NEXT batch's copy
        already enqueued, one batch ahead (the JAX Trainer's
        ``_device_prefetch``; the reference's pin_memory + non_blocking)."""
        q: deque = deque()
        for batch in loader:
            q.append((self._to_device(batch), batch))
            if len(q) >= 2:
                yield q.popleft()
        while q:
            yield q.popleft()

    def _install_preempt_handlers(self):
        """SIGTERM/SIGUSR2 -> request a checkpoint-and-exit at the next
        step boundary (the reference requeues SLURM jobs off SIGUSR2,
        scripts/train.py:46-57). Returns the previous handlers for
        restoration; no-op off the main thread or when disabled."""
        if not self.ckpt_on_preempt or self.ckpt is None:
            return []

        def _handler(signum, frame):
            logger.warning(
                "signal %s received: will checkpoint and exit at the next step boundary",
                signum,
            )
            self._preempt_requested = True

        previous = []
        for sig in (signal.SIGTERM, signal.SIGUSR2):
            try:
                previous.append((sig, signal.signal(sig, _handler)))
            except (ValueError, OSError):  # non-main thread / platform
                pass
        return previous

    def fit(self) -> TrainState:
        """Train ``trainer.max_epochs`` epochs from ``self.state`` when a
        caller set it, else from a fresh (or the latest checkpointed) state."""
        t0 = time.time()
        step = int(self.state.step) if self.state is not None else 0
        last_saved = -1
        prev_handlers = self._install_preempt_handlers()

        def _save(step: int) -> None:
            nonlocal last_saved
            if self.ckpt is not None and step != last_saved:
                self.ckpt.save(step, self.state, self.cfg)
                last_saved = step

        try:
            for epoch in range(self.max_epochs):
                for device_batch, batch in self._device_prefetch(self.train_loader):
                    if self.state is None:
                        self.state = self._init_state()
                        step = int(self.state.step)
                    self.state, metrics = self.train_step(self.state, device_batch)
                    step += 1
                    if step % 10 == 0 or step == 1:
                        m: Dict[str, Any] = {k: float(v) for k, v in metrics.items()}
                        m["epoch"] = epoch
                        # The schedule's count increments AFTER each applied
                        # update, so the most recent update used
                        # schedule(applied - 1).
                        m["lr"] = self.schedule(max(step // self.accum_steps - 1, 0))
                        m["wall_time"] = time.time() - t0
                        self.logger.log(m, step)
                    if self.train_log_freq and step % self.train_log_freq == 0:
                        self._log_images(device_batch, batch, step)
                    if self.ckpt_every_n_steps and step % self.ckpt_every_n_steps == 0:
                        _save(step)
                    if self._preempt_requested:
                        _save(step)
                        logger.warning(
                            "preempted: checkpoint saved at step %d; resume by "
                            "relaunching with the same run_dir", step,
                        )
                        return self.state
                _save(step)
                if (epoch + 1) % self.val_every_n_epoch == 0 and epoch + 1 < self.max_epochs:
                    # Mid-run cadence: val losses only; the end-of-fit
                    # validate() writes the shards.
                    self.validate(write_shards=False)
            return self.state
        finally:
            for sig, old in prev_handlers:
                try:
                    signal.signal(sig, old)
                except (ValueError, OSError):
                    pass

    def _log_images(self, device_batch, batch, step: int) -> None:
        """Decode image 0 of the batch and render GT-vs-pred BEV plus the
        per-stride range-image score/mask panels every ``train_log_freq``
        steps (``Detector.on_train_batch_end``, detector.py:249-314, and
        the per-stride panels of ``rendering/tensorboard.py:354-387``)."""
        try:
            from range_view_3d_detection_torch.utils.rendering import (
                draw_bev,
                draw_range_maps,
            )

            result = self.eval_step(self.state, device_batch)
            if self._scoremap_step is None:
                self._scoremap_step = make_scoremap_step(self.det_cfg)
            maps = self._scoremap_step(self.state, device_batch)
            keep = result.keep[0].cpu().numpy()
            preds = result.cuboids[0].cpu().numpy()[keep]
            n = int(np.asarray(batch["box_valid"][0]).sum())
            gts = np.asarray(batch["boxes"][0][:n])
            cart = np.asarray(batch["cart"][0]).reshape(-1, 3)
            mask = np.asarray(batch["mask"][0]).reshape(-1)
            img_dir = self.run_dir / "images"
            img_dir.mkdir(exist_ok=True)
            draw_bev(cart[mask][:, :2], gts, preds, out_path=img_dir / f"bev_{step:07d}.png")
            draw_range_maps(
                {k: v.cpu().numpy() for k, v in maps.items()},
                out_path=img_dir / f"range_{step:07d}.png",
            )
        except Exception as exc:  # visualization must never kill training
            logger.warning("image logging failed: %s", exc)

    def validate(
        self,
        dst_dir: Optional[Path] = None,
        *,
        compute_losses: bool = True,
        write_shards: bool = True,
    ) -> Path:
        """Decode the val split and write prediction Feather shards;
        optionally log averaged validation losses (``validation_step`` +
        shard write, detector.py:316-390). ``write_shards=False`` is the
        mid-run cadence mode: losses are computed and logged, no Feather
        IO."""
        assert self.state is not None, "call fit() or restore first"
        dst = Path(dst_dir or (self.run_dir / "predictions"))
        if write_shards:
            dst.mkdir(parents=True, exist_ok=True)
        if compute_losses and self._val_step is None:
            self._val_step = make_val_step(self.det_cfg, self.dec_cfg)
        val_step = self._val_step if compute_losses else None
        val_metric_sums: Dict[str, float] = {}
        num_val_batches = 0
        for device_batch, batch in self._device_prefetch(self.val_loader):
            if val_step is not None:
                result, vm = val_step(self.state, device_batch)
                num_val_batches += 1
                for k, v in vm.items():
                    val_metric_sums[k] = val_metric_sums.get(k, 0.0) + float(v)
            else:
                result = self.eval_step(self.state, device_batch)
            if write_shards:
                write_prediction_shards(result, batch["uuids"], self.categories, dst)
        if num_val_batches:
            self.logger.log(
                {k: v / num_val_batches for k, v in val_metric_sums.items()},
                int(self.state.step),
            )
        return dst
