"""Dataset index + per-sweep loading + fixed-shape batching (the port's
copy of the JAX ``data/dataset.py``: the same items, bit for bit, and the
same batches in the same order, on one device).

Capability parity with ``src/torchbox3d/prototype/loader.py`` (DataModule
138-233, DataLoader 254-822, ``subsample_range_view`` 792-815,
``_collate_fn`` 236-251) — re-designed:

- the port's own Feather reader (``utils/feather.py``) instead of
  polars; sweeps decode straight into ``(H, W, C)`` numpy (the reference's ``_npy_to_tch`` transpose hot path).
- Annotations become a padded ``(K, 7)`` box tensor + valid/task/offset
  vectors (static device shapes) while the relational form (uuids,
  categories) stays host-side for evaluation.
- Collation stacks numpy; device placement happens in the train loop.

On-disk layout is byte-compatible with the reference converters:
``root/split/log_id/sensors/range_view/<timestamp>.feather`` +
``root/split/log_id/annotations.feather``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from range_view_3d_detection_torch.data import augmentations as augs
from range_view_3d_detection_torch.utils.feather import read_feather

logger = logging.getLogger(__name__)

AV2_FEATURES = ("intensity", "range", "x", "y", "z")
WAYMO_FEATURES = ("elongation", "intensity", "range", "x", "y", "z")

CUBOID_COLUMNS = (
    "tx_m",
    "ty_m",
    "tz_m",
    "length_m",
    "width_m",
    "height_m",
)


def quat_to_yaw_np(qw, qx, qy, qz):
    return np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))


@dataclasses.dataclass
class RangeViewConfig:
    height: int = 64
    width: int = 1800
    feature_column_names: Tuple[str, ...] = AV2_FEATURES
    filter_roi: bool = False


@dataclasses.dataclass
class DatasetConfig:
    root_dir: str
    dataset_name: str = "av2"  # av2 | waymo | nuscenes
    split_name: str = "train"
    range_view: RangeViewConfig = dataclasses.field(default_factory=RangeViewConfig)
    tasks: Dict[int, Sequence[str]] = dataclasses.field(
        default_factory=lambda: {0: ("REGULAR_VEHICLE",)}
    )
    max_boxes: int = 256
    subsampling_rate: int = 1
    x_stride: int = 1
    padding_mode: str = "constant"  # constant | circular
    augmentations: Optional[Dict[str, Dict[str, float]]] = None
    use_median_filter: bool = False  # 3x3 median over the range channel
    use_repeat_factor_sampling: bool = False
    min_points_filter: int = 0  # Waymo <50k-point sweep filter analog
    enable_database: bool = False  # GT-paste augmentation (loader.py:672-686)
    db_dir: Optional[str] = None  # defaults to <root>/../db
    db_config: Optional[Dict[str, int]] = None  # {category: num_samples}
    seed: int = 0


def width_padding(width: int, x_stride: int) -> int:
    """Per-side column padding so padded W / x_stride is divisible by 16
    (``subsample_range_view``, loader.py:792-815).

    Computed, not table-driven: the smallest symmetric pad with
    ``(W + 2*pad) % (16 * x_stride) == 0`` (av2 1800 -> 4 / 28,
    waymo 2650 -> 3 / 19 for x_stride 1 / 4, matching the reference's
    constants).
    """
    unit = 16 * x_stride
    deficit = (-width) % unit
    if deficit % 2:
        # unit is even, so an odd deficit (odd width) can never be fixed
        # by a symmetric integer pad.
        raise ValueError(
            f"width={width} x_stride={x_stride}: no symmetric pad exists"
        )
    return deficit // 2


class RangeViewDataset:
    """Index of (log_id, timestamp) sweeps + per-sweep loading."""

    def __init__(self, cfg: DatasetConfig):
        self.cfg = cfg
        self.split_dir = Path(cfg.root_dir) / cfg.split_name
        self._category_map = self._build_category_map()
        self._ann_cache: "OrderedDict[str, dict]" = OrderedDict()
        self._ann_cache_size = 64
        # DataLoader worker threads hit the cache concurrently; guard the
        # read-move/insert-evict sequences (concurrent eviction otherwise
        # double-pops the same oldest key -> KeyError mid-epoch).
        self._ann_cache_lock = threading.Lock()
        self.index = self._build_index()
        self._filter_train_index()
        self.epoch = 0  # set by the loader; varies augmentation draws
        self._db = None
        if cfg.enable_database and cfg.split_name == "train":
            from range_view_3d_detection_torch.data.database import (
                DatabaseSampler,
            )

            db_dir = cfg.db_dir or str(Path(cfg.root_dir).parent / "db")
            self._db = DatabaseSampler(db_dir)
        if cfg.use_repeat_factor_sampling and cfg.split_name == "train":
            self.index = self._repeat_factor_sample(self.index)
        self.index = self.index[:: max(cfg.subsampling_rate, 1)]

    # -- index ------------------------------------------------------------

    def _build_category_map(self) -> Dict[str, Tuple[int, int]]:
        """category -> (task_id, offset); offsets over sorted task categories
        (``loader.py:558-566``)."""
        out: Dict[str, Tuple[int, int]] = {}
        for task_id, cats in self.cfg.tasks.items():
            for offset, cat in enumerate(sorted(cats)):
                out[cat] = (int(task_id), offset)
        return out

    def _build_index(self) -> List[Tuple[str, int]]:
        index: List[Tuple[str, int]] = []
        for log_path in sorted(self.split_dir.glob("*")):
            sweep_dir = log_path / "sensors" / "range_view"
            if not sweep_dir.is_dir():
                continue
            for sweep_path in sorted(sweep_dir.glob("*.feather")):
                index.append((log_path.stem, int(sweep_path.stem)))
        return index

    def _filter_train_index(self) -> None:
        """Drop train sweeps without objects of interest
        (``loader.py:331-344``) and low-point sweeps (``:350-358``)."""
        if self.cfg.split_name != "train":
            return
        min_pts = self._sweep_point_counts() if self.cfg.min_points_filter else {}
        keep: List[Tuple[str, int]] = []
        for log_id, ts in self.index:
            if (
                min_pts
                and min_pts.get((log_id, ts), np.inf) < self.cfg.min_points_filter
            ):
                continue
            ann = self._load_annotations(log_id, ts)
            if len(ann["category"]) > 0:
                keep.append((log_id, ts))
        self.index = keep

    def _sweep_point_counts(self) -> Dict[Tuple[str, int], int]:
        """Per-sweep point counts from converter metadata (the Waymo <50k
        filter, loader.py:350-358; my converter writes per-log
        metadata.feather)."""
        counts: Dict[Tuple[str, int], int] = {}
        for log_path in sorted(self.split_dir.glob("*")):
            meta_path = log_path / "metadata.feather"
            if not meta_path.is_file():
                continue
            meta = read_feather(meta_path)
            for lid, ts, n in zip(
                meta["log_id"], meta["timestamp_ns"], meta["num_pts"]
            ):
                counts[(str(lid), int(ts))] = int(n)
        return counts

    def _repeat_factor_sample(
        self, index: List[Tuple[str, int]]
    ) -> List[Tuple[str, int]]:
        """Repeat-factor sampling (``loader.py:369-457``): oversample sweeps
        containing rare categories with factor max(1, sqrt(t / f_c))."""
        t = 0.01
        cat_presence: Dict[str, int] = {}
        per_sweep_cats: List[set] = []
        for log_id, ts in index:
            ann = self._load_annotations(log_id, ts)
            cats = set(np.unique(ann["category"]).tolist())
            per_sweep_cats.append(cats)
            for c in cats:
                cat_presence[c] = cat_presence.get(c, 0) + 1
        total = sum(cat_presence.values())
        r_c = {
            c: max(1.0, np.sqrt(t / (n / total))) for c, n in cat_presence.items()
        }
        rng = np.random.default_rng(0)
        out: List[Tuple[str, int]] = []
        for (log_id, ts), cats in zip(index, per_sweep_cats):
            r = max((r_c[c] for c in cats), default=1.0)
            reps = int(r) + int(rng.uniform() < (r - int(r)))
            out.extend([(log_id, ts)] * max(reps, 1))
        return out

    # -- per-sweep loading -------------------------------------------------

    def __len__(self) -> int:
        return len(self.index)

    def annotations_path(self, log_id: str) -> Path:
        return self.split_dir / log_id / "annotations.feather"

    def sweep_path(self, log_id: str, timestamp_ns: int) -> Path:
        return (
            self.split_dir
            / log_id
            / "sensors"
            / "range_view"
            / f"{timestamp_ns}.feather"
        )

    def _log_annotations(self, log_id: str):
        """Per-log annotation table, LRU-cached.

        Index build (`_filter_train_index` / `_repeat_factor_sample`)
        visits every sweep of a log consecutively; without the cache each
        visit re-read the log's whole annotations.feather — O(sweeps)
        full-file reads, minutes-to-hours at AV2 scale (~150k sweeps).
        With it, index build is one read per log and the train-time
        random access pattern stays bounded by the cache size.
        """
        with self._ann_cache_lock:
            cached = self._ann_cache.get(log_id)
            if cached is not None:
                self._ann_cache.move_to_end(log_id)
                return cached
        # Read outside the lock (IO dominates); worst case two threads
        # read the same log once and the second insert wins.
        ann = read_feather(self.annotations_path(log_id))
        ann["timestamp_ns"] = ann["timestamp_ns"].astype(np.int64)
        ann["_keep"] = (ann["num_interior_pts"] > 0) & np.isin(
            ann["category"], list(self._category_map)
        )
        with self._ann_cache_lock:
            self._ann_cache[log_id] = ann
            while len(self._ann_cache) > self._ann_cache_size:
                self._ann_cache.popitem(last=False)
        return ann

    def _load_annotations(self, log_id: str, timestamp_ns: int):
        ann = self._log_annotations(log_id)
        m = ann["_keep"] & (ann["timestamp_ns"] == timestamp_ns)
        return {k: v[m] for k, v in ann.items() if k != "_keep"}

    def load_sweep(self, log_id: str, timestamp_ns: int) -> augs.Sweep:
        cols = read_feather(self.sweep_path(log_id, timestamp_ns))
        h, w = self.cfg.range_view.height, self.cfg.range_view.width

        def img(name):
            return cols[name].astype(np.float32).reshape(h, w)

        if self.cfg.range_view.filter_roi and "is_within_roi" in cols:
            roi = cols["is_within_roi"].astype(np.float32).reshape(h, w)
        else:
            roi = None

        feature_names = self.cfg.range_view.feature_column_names

        def feature_img(name):
            if name == "view":
                # Laser -> sensor-view channel (loader.py:605-621): 2 for the
                # upper 32-beam LiDAR, 1 for the lower, 0 for empty pixels.
                ln = cols["laser_number"].astype(np.float32).reshape(h, w)
                rv = img("range") > 0
                return np.where(rv, np.where(ln <= 32, 2.0, 1.0), 0.0).astype(
                    np.float32
                )
            return img(name)

        feats = np.stack([feature_img(n) for n in feature_names], axis=-1)
        cart = np.stack([img("x"), img("y"), img("z")], axis=-1)
        rng_img = img("range")
        if roi is not None:
            feats *= roi[..., None]
            cart *= roi[..., None]
            rng_img *= roi

        if self.cfg.dataset_name == "waymo" and "intensity" in feature_names:
            i = feature_names.index("intensity")
            feats[..., i] = np.tanh(feats[..., i])
        if "timedelta_ns" in feature_names:
            i = feature_names.index("timedelta_ns")
            feats[..., i] = feats[..., i] * 1e-9

        if self.cfg.use_median_filter:
            # Despeckle the range channel (the reference's
            # use_median_filter config flag; off by default).
            from scipy.ndimage import median_filter

            filtered = median_filter(rng_img, size=3, mode="wrap")
            # Only replace isolated outliers; keep empty pixels empty.
            outlier = (rng_img > 0) & (
                np.abs(rng_img - filtered) > 0.5 * np.maximum(filtered, 1.0)
            )
            rng_img = np.where(outlier, filtered, rng_img)
            if "range" in feature_names:
                feats[..., feature_names.index("range")] = rng_img

        return {
            "features": feats,
            "cart": cart,
            "range": rng_img,
            "mask": rng_img > 0.0,
        }

    def _boxes_from_annotations(self, ann) -> Tuple[np.ndarray, np.ndarray]:
        n = len(ann["category"])
        boxes = np.zeros((n, 7), np.float32)
        for i, c in enumerate(CUBOID_COLUMNS):
            boxes[:, i] = ann[c].astype(np.float32)
        boxes[:, 6] = quat_to_yaw_np(
            ann["qw"].astype(np.float64),
            ann["qx"].astype(np.float64),
            ann["qy"].astype(np.float64),
            ann["qz"].astype(np.float64),
        ).astype(np.float32)
        return boxes, np.asarray(ann["category"]).astype(str)

    def _tasks_offsets(
        self, categories: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(task, offset) per box + the (task, offset) sort permutation
        (parity with loader.py:699-704)."""
        n = len(categories)
        tasks = np.zeros(n, np.int32)
        offsets = np.zeros(n, np.int32)
        for i, cat in enumerate(categories):
            t, o = self._category_map[str(cat)]
            tasks[i] = t
            offsets[i] = o
        order = np.lexsort((offsets, tasks))
        return tasks, offsets, order

    def _feature_cart_slices(self):
        names = list(self.cfg.range_view.feature_column_names)
        slices = []
        if all(n in names for n in ("x", "y", "z")):
            i = names.index("x")
            if names[i : i + 3] == ["x", "y", "z"]:
                slices.append(slice(i, i + 3))
        return tuple(slices)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        log_id, ts = self.index[idx]
        sweep = self.load_sweep(log_id, ts)
        ann = self._load_annotations(log_id, ts)
        boxes, box_cats = self._boxes_from_annotations(ann)

        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, self.epoch, idx])
        )
        if self.cfg.split_name == "train" and self.cfg.augmentations:
            names = list(self.cfg.range_view.feature_column_names)
            sweep, boxes = augs.apply_augmentations(
                sweep,
                boxes,
                self.cfg.augmentations,
                rng,
                feature_cart_slices=self._feature_cart_slices(),
                range_feature_index=(
                    names.index("range") if "range" in names else None
                ),
            )

        if self._db is not None and self.cfg.db_config:

            def _normalize_crop(cols: Dict[str, np.ndarray]):
                # Match load_sweep's per-dataset feature normalization.
                out = dict(cols)
                if self.cfg.dataset_name == "waymo" and "intensity" in out:
                    out["intensity"] = np.tanh(out["intensity"])
                if "timedelta_ns" in out:
                    out["timedelta_ns"] = out["timedelta_ns"] * 1e-9
                return out

            sweep, boxes, box_cats = self._db.sample(
                sweep,
                boxes,
                box_cats,
                self.cfg.db_config,
                rng,
                feature_columns=self.cfg.range_view.feature_column_names,
                feature_transform=_normalize_crop,
            )

        box_task, box_offset, order = self._tasks_offsets(box_cats)
        boxes, box_task, box_offset = (
            boxes[order],
            box_task[order],
            box_offset[order],
        )

        features, cart, mask = self._pad_and_stride(sweep)

        K = self.cfg.max_boxes
        n = min(len(boxes), K)
        pad_boxes = np.zeros((K, 7), np.float32)
        pad_valid = np.zeros((K,), bool)
        pad_task = np.zeros((K,), np.int32)
        pad_offset = np.zeros((K,), np.int32)
        pad_boxes[:n] = boxes[:n]
        pad_valid[:n] = True
        pad_task[:n] = box_task[:n]
        pad_offset[:n] = box_offset[:n]

        return {
            "features": features,
            "cart": cart,
            "mask": mask,
            "boxes": pad_boxes,
            "box_valid": pad_valid,
            "box_task": pad_task,
            "box_offset": pad_offset,
            "log_id": log_id,
            "timestamp_ns": ts,
            "num_boxes": n,
        }

    def _pad_and_stride(self, sweep: augs.Sweep):
        """Width pad + column decimation (``subsample_range_view``)."""
        pad = width_padding(self.cfg.range_view.width, self.cfg.x_stride)
        mode = "wrap" if self.cfg.padding_mode == "circular" else "constant"
        feats = sweep["features"] * sweep["mask"][..., None]
        spec = ((0, 0), (pad, pad), (0, 0))

        feats = np.pad(feats, spec, mode=mode)[:, :: self.cfg.x_stride]
        cart = np.pad(sweep["cart"], spec, mode=mode)[:, :: self.cfg.x_stride]
        mask = np.pad(sweep["mask"], spec[:2], mode=mode)[:, :: self.cfg.x_stride]
        return feats.astype(np.float32), cart.astype(np.float32), mask


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack numpy samples into a fixed-shape batch (``_collate_fn``)."""
    batch: Dict[str, np.ndarray] = {}
    tensor_keys = (
        "features",
        "cart",
        "mask",
        "boxes",
        "box_valid",
        "box_task",
        "box_offset",
    )
    for k in tensor_keys:
        batch[k] = np.stack([s[k] for s in samples])
    batch["uuids"] = [(s["log_id"], s["timestamp_ns"]) for s in samples]
    return batch


class DataLoader:
    """Epoch iterator with shuffling, fixed batch size, and background
    thread prefetch.

    The reference hides IO behind 6 torch DataLoader workers per rank
    (``conf/model/baseline.yaml:24``); here, as in the JAX package, a
    thread pool decodes sweeps (numpy's copies and reshapes release the
    GIL) and a small prefetch queue keeps batches ahead of the device
    step. Under data parallelism each process (rank ``process_index`` of
    ``process_count``) loads its shard of every epoch: ``batch_size`` is
    the per-process batch.
    """

    def __init__(
        self,
        dataset: RangeViewDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 2,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size  # per-process batch size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        n_total = len(self.dataset)
        if n_total == 0:
            return 0
        # Per-process shard size after the wrap padding in _batch_indices.
        n = -(-n_total // self.process_count)
        if self.drop_last:
            # Never 0 batches for a non-empty dataset: datasets smaller
            # than one batch wrap-pad to a single full batch (see
            # _batch_indices) — the static-shape analog of the reference
            # loader emitting one partial batch (drop_last=False there),
            # which is exactly the debug-overfit regime
            # (scripts/debug-overfit.sh: ~1 sweep, batch 2).
            return max(n // self.batch_size, 1)
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        self.dataset.epoch = self.epoch  # fresh augmentation draws per epoch
        self.epoch += 1
        order = self._process_shard(order)
        if self.drop_last and 0 < len(order) < self.batch_size:
            # Fewer sweeps than one static-shape batch: wrap-pad to ONE
            # full batch instead of yielding zero batches (see __len__).
            order = np.resize(order, self.batch_size)
        batches = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    break
                # np.resize wraps as many times as needed (a dataset much
                # smaller than the batch needs more than one pass).
                pad = np.resize(order, self.batch_size - len(idx))
                idx = np.concatenate([idx, pad])
            batches.append(idx)
        return batches

    def _process_shard(self, order: np.ndarray) -> np.ndarray:
        """This process's strided shard of the (identically shuffled)
        global order, the DistributedSampler rule: the order wrap-padded
        to a multiple of ``process_count`` first, so every process yields
        the same number of batches (each train step is a collective, and a
        process short of a batch would leave the others waiting in it)."""
        if self.process_count > 1:
            rem = len(order) % self.process_count
            if rem:
                order = np.concatenate([order, order[: self.process_count - rem]])
            order = order[self.process_index :: self.process_count]
        return order

    def owned_indices(self) -> np.ndarray:
        """The dataset indices this process holds in an unshuffled epoch
        without the wrap padding: every index belongs to exactly one
        process (the single writer of its prediction shard)."""
        n, W = len(self.dataset), self.process_count
        positions = np.arange(-(-n // W) * W)[self.process_index :: W]
        return positions[positions < n]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batch_indices()
        if self.num_workers <= 0 or len(batches) <= 1:
            for idx in batches:
                yield collate([self.dataset[int(i)] for i in idx])
            return

        from concurrent.futures import ThreadPoolExecutor

        def load(idx):
            return collate([self.dataset[int(i)] for i in idx])

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = max(self.prefetch, 1)
            futures = [pool.submit(load, idx) for idx in batches[:window]]
            next_submit = window
            for i in range(len(batches)):
                batch = futures[i].result()
                if next_submit < len(batches):
                    futures.append(pool.submit(load, batches[next_submit]))
                    next_submit += 1
                yield batch
