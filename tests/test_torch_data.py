"""The port's data layer against the JAX package's, on the CPU.

- ``generate_dataset`` writes the same arrays as the JAX one for the same
  seed, in the AV2 and in the Waymo layout.
- ``RangeViewDataset`` items are equal bit for bit, on train (with
  ``conf/model/baseline.yaml``'s augmentations) and val, over two epochs,
  and with the median filter, repeat-factor sampling, the min-points
  filter, circular padding and x_stride 2.
- ``DataLoader`` batches come in the same order: shuffled, with
  drop-last, without it (wrap-padded last batch), and for a dataset
  smaller than one batch.
- ``enable_database`` without a built database raises, as in JAX (the
  sampler itself: ``tests/test_torch_database.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from range_view_3d_detection_torch.data import dataset as td
from range_view_3d_detection_torch.data import synthetic as ts
from range_view_3d_detection_torch.utils.feather import read_feather, write_feather
from range_view_3d_detection_tpu.data import dataset as jd
from range_view_3d_detection_tpu.data import synthetic as js
from range_view_3d_detection_tpu.utils.config import compose

AUGS = compose("conf", "rv-av2")["model"]["augmentations_config"]
TASKS = {0: ("PEDESTRIAN", "REGULAR_VEHICLE")}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    kw = dict(splits={"train": 2, "val": 1}, sweeps_per_log=3, height=8, width=56, seed=3,
              num_bg_points=1500)
    out = {"port": ts.generate_dataset(base / "port", **kw),
           "jax": js.generate_dataset(base / "jax", **kw), "counts": []}
    # Per-log point counts for the min-points filter (the converters' metadata).
    for log in sorted((out["port"] / "train").iterdir()):
        ts_ = sorted(int(p.stem) for p in (log / "sensors" / "range_view").glob("*.feather"))
        counts = [int((read_feather(log / "sensors" / "range_view" / f"{t}.feather")["range"]
                       > 0).sum()) for t in ts_]
        out["counts"] += counts
        write_feather(log / "metadata.feather", {
            "log_id": np.asarray([log.name] * len(ts_)), "timestamp_ns": np.asarray(ts_),
            "num_pts": np.asarray(counts)})
    return out


@pytest.mark.parametrize("layout", ["av2", "waymo"])
def test_generate_dataset_equals_jax(tmp_path, layout):
    kw = dict(splits={"train": 1, "val": 1}, sweeps_per_log=2, height=8, width=58, seed=9,
              dataset_name=layout)
    a = ts.generate_dataset(tmp_path / "port", **kw)
    b = js.generate_dataset(tmp_path / "jax", **kw)
    files = sorted(p.relative_to(a) for p in a.rglob("*.feather"))
    assert files == sorted(p.relative_to(b) for p in b.rglob("*.feather")) and len(files) == 6
    from range_view_3d_detection_tpu.utils.feather import read_feather as jread

    for f in files:
        x, y = jread(a / f), jread(b / f)
        assert list(x) == list(y)
        for k in y:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (f, k)


def configs(root, split, **kw):
    base = dict(root_dir=str(root), split_name=split, tasks=TASKS, max_boxes=8,
                augmentations=AUGS if split == "train" else None)
    base.update(kw)
    return (td.DatasetConfig(range_view=td.RangeViewConfig(height=8, width=56), **base),
            jd.DatasetConfig(range_view=jd.RangeViewConfig(height=8, width=56), **base))


def assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


VARIANTS = {
    "train": ("train", {}),
    "val": ("val", {}),
    "median-filter": ("train", {"use_median_filter": True}),
    "repeat-factor": ("train", {"use_repeat_factor_sampling": True}),
    "min-points": ("train", {"min_points_filter": None}),  # the median count
    "circular-stride2": ("train", {"padding_mode": "circular", "x_stride": 2}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_items_equal_jax_over_two_epochs(roots, variant):
    split, kw = VARIANTS[variant]
    if "min_points_filter" in kw:
        kw = {"min_points_filter": int(np.median(roots["counts"])) + 1}
    tcfg, jcfg = configs(roots["port"], split, **kw)
    tds, jds = td.RangeViewDataset(tcfg), jd.RangeViewDataset(jcfg)
    assert tds.index == jds.index and len(tds) > 0
    if variant == "min-points":
        assert 0 < len(tds) < 6  # the filter dropped some sweeps
    for epoch in range(2):
        tds.epoch = jds.epoch = epoch
        for i in range(len(tds)):
            assert_items_equal(tds[i], jds[i])


@pytest.mark.parametrize("case", ["shuffle", "drop-last", "wrap-pad", "smaller-than-batch"])
def test_loader_batch_order_equals_jax(roots, case):
    tcfg, jcfg = configs(roots["port"], "train")
    batch, kw = 4, {}
    if case == "shuffle":
        kw = dict(shuffle=True, seed=5)
    elif case == "wrap-pad":
        kw = dict(drop_last=False, shuffle=True)
    elif case == "smaller-than-batch":
        tcfg, jcfg = (dataclasses.replace(c, subsampling_rate=4) for c in (tcfg, jcfg))
        batch = 3
    tl = td.DataLoader(td.RangeViewDataset(tcfg), batch, **kw)
    jl = jd.DataLoader(jd.RangeViewDataset(jcfg), batch, **kw)
    assert len(tl) == len(jl) >= 1
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == len(jl)
        for a, b in zip(tb, jb):
            assert a["uuids"] == b["uuids"] and len(a["uuids"]) == batch
            assert_items_equal({k: v for k, v in a.items() if k != "uuids"},
                               {k: v for k, v in b.items() if k != "uuids"})


def test_database_raises(roots):
    """``enable_database`` without a built database (``<root>/../db``)
    raises in both packages; with one, ``tests/test_torch_database.py``
    holds the pasted items."""
    tcfg, jcfg = configs(roots["port"], "train", enable_database=True)
    with pytest.raises(FileNotFoundError, match="db.feather"):
        td.RangeViewDataset(tcfg)
    with pytest.raises(OSError):
        jd.RangeViewDataset(jcfg)
