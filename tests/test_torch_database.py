"""The port's GT-paste database (``data/database.py``) against the JAX
package's, on the CPU, on the corpus ``tests/test_waymo_eval_db.py``
builds (one train log of two 8x56 sweeps, four boxes each).

- ``build_database`` writes the same catalog and the same crops, file by
  file and column by column;
- ``DatabaseSampler.sample`` pastes the same pixels and appends the same
  boxes for the same ``np.random.Generator``;
- a train item and a loader batch with ``enable_database`` (the default
  ``<root>/../db``, rv-av2's augmentations) equal JAX's bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

from range_view_3d_detection_torch.data import database as tdb
from range_view_3d_detection_torch.data import dataset as td
from range_view_3d_detection_torch.data.synthetic import generate_dataset
from range_view_3d_detection_torch.utils.feather import read_feather
from range_view_3d_detection_tpu.data import database as jdb
from range_view_3d_detection_tpu.data import dataset as jd
from range_view_3d_detection_tpu.utils.config import compose

H, W = 8, 56
FEATURES = ("intensity", "range", "x", "y", "z")
TASKS = {0: ("PEDESTRIAN", "REGULAR_VEHICLE")}
DB_CONFIG = {"REGULAR_VEHICLE": 2, "PEDESTRIAN": 2}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("db")
    root = generate_dataset(base / "sensor", splits={"train": 1}, sweeps_per_log=2,
                            height=H, width=W, num_boxes=4, num_bg_points=800, seed=3)
    kw = dict(height=H, width=W, feature_columns=FEATURES, min_interior_pts=1)
    tdb.build_database(root, base / "db", **kw)  # the datasets' default db_dir
    jdb.build_database(root, base / "db_jax", **kw)
    return root, base / "db", base / "db_jax"


def _assert_columns_equal(a, b, where):
    assert list(a) == list(b), where
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (where, k)


def test_build_database_equals_jax(corpus):
    _, db, db_jax = corpus
    files = sorted(p.relative_to(db) for p in db.rglob("*.feather"))
    assert files == sorted(p.relative_to(db_jax) for p in db_jax.rglob("*.feather"))
    assert len(files) > 2
    for f in files:
        _assert_columns_equal(read_feather(db / f), read_feather(db_jax / f), f)


def _empty_sweep():
    return {
        "features": np.zeros((H, W, 5), np.float32),
        "cart": np.zeros((H, W, 3), np.float32),
        "range": np.zeros((H, W), np.float32),
        "mask": np.zeros((H, W), bool),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_equals_jax(corpus, seed):
    _, db, db_jax = corpus
    out = []
    for sampler in (tdb.DatabaseSampler(db), jdb.DatabaseSampler(db_jax)):
        out.append(sampler.sample(
            _empty_sweep(), np.zeros((0, 7), np.float32), np.zeros(0, dtype="<U32"),
            DB_CONFIG, np.random.default_rng(seed), feature_columns=FEATURES,
        ))
    (sweep, boxes, cats), (jsweep, jboxes, jcats) = out
    assert len(boxes) > 0 and sweep["mask"].sum() > 0
    for k in jsweep:
        assert sweep[k].dtype == jsweep[k].dtype and np.array_equal(sweep[k], jsweep[k]), k
    assert boxes.dtype == jboxes.dtype and np.array_equal(boxes, jboxes)
    assert list(cats) == list(jcats)


def test_train_items_and_batch_with_database_equal_jax(corpus):
    root, _, _ = corpus
    augs = compose("conf", "rv-av2")["model"]["augmentations_config"]
    base = dict(root_dir=str(root), split_name="train", tasks=TASKS, max_boxes=16,
                augmentations=augs, enable_database=True, db_config=DB_CONFIG)
    tds = td.RangeViewDataset(td.DatasetConfig(range_view=td.RangeViewConfig(H, W), **base))
    jds = jd.RangeViewDataset(jd.DatasetConfig(range_view=jd.RangeViewConfig(H, W), **base))
    assert tds.index == jds.index and len(tds) == 2
    pasted = 0
    for epoch in range(2):
        tds.epoch = jds.epoch = epoch
        for i in range(len(tds)):
            a, b = tds[i], jds[i]
            assert sorted(a) == sorted(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
                else:
                    assert a[k] == b[k], k
            pasted += int(b["box_valid"].sum()) > 4
    assert pasted > 0  # some item carries more boxes than its scene's four
    tb = next(iter(td.DataLoader(tds, 2, shuffle=True, seed=1)))
    jb = next(iter(jd.DataLoader(jds, 2, shuffle=True, seed=1)))
    assert tb["uuids"] == jb["uuids"]
    for k in jb:
        if isinstance(jb[k], np.ndarray):
            assert np.array_equal(tb[k], jb[k]), k
