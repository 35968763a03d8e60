"""Training loop: data -> train step -> validation -> prediction shards
(counterpart of the JAX ``training/loop.py``).

Capability parity with the orchestration half of the reference
(``scripts/train.py:34-113`` + ``Detector.training_step/validation_step/
on_validation_end``, detector.py:238-544): a plain Python loop around the
port's train step; prediction shards are written as Feather per
(log_id, timestamp), as the reference and the JAX package write them,
then evaluated on the host.

Data parallelism (the JAX Trainer's ``data`` mesh): launched under
``python -m torch.distributed.run --nproc_per_node=N``, each process is
one rank on ``cuda:LOCAL_RANK`` (NCCL), or on the CPU (gloo) when
``trainer.device`` asks for it. ``trainer.devices: auto`` is the launched
world size, and an integer must equal it. Each rank loads its shard of
the data (``batch_size`` rows a step, so the global batch is
``batch_size x world``), and the step reduces over the global batch
(``parallel/mesh.py``); ``trainer.zero1`` shards the AdamW moments.
Logging, image logging, the checkpoint file and evaluation are rank 0's;
every rank validates and writes the shards of the sweeps it holds, the
val losses are summed over the ranks, and a preemption signal on any
rank stops every rank at the same step. Without a launcher the Trainer
runs on one device (``cuda`` unless the caller or ``trainer.device`` asks
for the CPU).
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
from range_view_3d_detection_torch.parallel import mesh
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


def write_prediction_shards(result, uuids, categories, dst: Path, only=None) -> None:
    """One Feather shard of ``result``'s kept detections per (log_id,
    timestamp) of the batch (of those in ``only`` when given),
    ``dst/<log_id>_<timestamp>.feather`` (``detector.py:366-380``)."""
    cols = flatten_detections(result, uuids, categories)
    for log_id, ts in uuids if only is None else only:
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
    (``trainer.device`` in the config, else ``cuda``), as one rank of the
    process group when launched as one."""

    def __init__(self, cfg: Dict[str, Any], *, device: str | torch.device | None = None):
        self.cfg = cfg
        tcfg = cfg["trainer"]
        self.device = mesh.initialize_distributed(
            resolve_device(device or tcfg.get("device", "cuda"))
        )
        self.world, self.rank = mesh.world(), mesh.rank()
        devices = tcfg.get("devices", "auto")
        if devices != "auto" and int(devices) != self.world:
            raise ValueError(
                f"trainer.devices={devices}, but {self.world} process(es) were "
                "launched: run under `python -m torch.distributed.run "
                f"--nproc_per_node={devices}` or set trainer.devices=auto"
            )
        self.zero1 = bool(tcfg.get("zero1", False))
        # Rank gating (the reference gates artifacts and evaluation on
        # global rank 0, detector.py:426); collectives run on every rank.
        self.is_main = self.rank == 0
        self.det_cfg: DetectorConfig = build_detector_config(cfg)
        self.dec_cfg: DecoderConfig = build_decoder_config(cfg)

        run_dir = Path(cfg.get("run_dir") or Path(tempfile.gettempdir()) / "rangebox-torch")
        run_dir.mkdir(parents=True, exist_ok=True)
        self.run_dir = run_dir
        self.logger = MetricsLogger(
            run_dir, backend=tcfg.get("logger", {}).get("backend", "jsonl"),
            enabled=self.is_main,
        )

        self.batch_size = int(cfg["model"]["batch_size"])  # per rank
        self.global_batch = self.batch_size * self.world
        self.train_ds = RangeViewDataset(build_dataset_config(cfg, "train"))
        self.val_ds = RangeViewDataset(build_dataset_config(cfg, "val"))
        shard = dict(process_index=self.rank, process_count=self.world)
        self.train_loader = DataLoader(self.train_ds, self.batch_size, shuffle=True, **shard)
        self.val_loader = DataLoader(
            self.val_ds, self.batch_size, shuffle=False, drop_last=False, **shard
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
            num_devices=self.world,
            batch_size=self.batch_size,
            use_linear_lr_scaling=bool(m.get("use_linear_lr_scaling", False)),
            debug=debug,
            accumulate_steps=self.accum_steps,
            zero1=self.zero1,
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
        # Names of the prediction shards this rank wrote in its last validate.
        self.last_shards: list = []

        # Persist hyperparameters (save_hyperparameters parity,
        # detector.py:143-158): flattened config at step 0 + full JSON.
        if self.is_main:
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
                    if self.is_main and self.train_log_freq and step % self.train_log_freq == 0:
                        self._log_images(device_batch, batch, step)
                    if self.ckpt_every_n_steps and step % self.ckpt_every_n_steps == 0:
                        _save(step)
                    if mesh.active():
                        # Every rank stops at the step where any rank saw
                        # the signal.
                        self._preempt_requested = mesh.any_rank(
                            self._preempt_requested, self.device
                        )
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
        IO. Every rank runs it on its shard of the split and writes the
        shards of the sweeps it holds (``DataLoader.owned_indices``: one
        writer a sweep, none for the wrap padding); the val losses are the
        global batches' (``make_val_step``), averaged as the JAX Trainer
        averages them; it returns when every rank is done."""
        assert self.state is not None, "call fit() or restore first"
        dst = Path(dst_dir or (self.run_dir / "predictions"))
        if write_shards:
            dst.mkdir(parents=True, exist_ok=True)
        if compute_losses and self._val_step is None:
            self._val_step = make_val_step(self.det_cfg, self.dec_cfg)
        val_step = self._val_step if compute_losses else None
        val_metric_sums: Dict[str, float] = {}
        num_val_batches = 0
        owned = {self.val_ds.index[int(i)] for i in self.val_loader.owned_indices()}
        self.last_shards = []
        for device_batch, batch in self._device_prefetch(self.val_loader):
            if val_step is not None:
                result, vm = val_step(self.state, device_batch)
                num_val_batches += 1
                for k, v in vm.items():
                    val_metric_sums[k] = val_metric_sums.get(k, 0.0) + float(v)
            else:
                result = self.eval_step(self.state, device_batch)
            if write_shards:
                mine = [u for u in batch["uuids"] if tuple(u) in owned]
                write_prediction_shards(result, batch["uuids"], self.categories, dst, mine)
                self.last_shards.extend(f"{log_id}_{ts}.feather" for log_id, ts in mine)
        if num_val_batches:
            # sync_dist=True parity (detector.py:385-389): each batch's
            # metrics are the global batch's; sums and counts over ranks.
            totals = mesh.process_sum_scalars(
                {**val_metric_sums, "_num_batches": float(num_val_batches)}
            )
            nb = totals.pop("_num_batches")
            self.logger.log({k: v / nb for k, v in totals.items()}, int(self.state.step))
        mesh.barrier()
        return dst
