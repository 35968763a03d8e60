"""The port's converters (``range_view_3d_detection_torch/converters/``)
against the repository's (``converters/``, on the JAX package and
pyarrow), on the same seeded raw logs.

Every output file of the two is equal, tolerance 0: Feather files read by
pyarrow with the same schema and every column equal bit for bit, other
files byte for byte.

- AV2: raw logs in AV2's schema (``chip_smoke.write_raw_av2_log`` at a
  few thousand points: x/y/z ``float16``, ``offset_ns`` over the spin,
  poses at 10 Hz, a map with drivable polygons, annotations without
  ``num_interior_pts``), uncompressed and as pyarrow writes them by
  default (LZ4 bodies, the category dictionary-encoded as a pandas
  ``category`` is), with and without the map and ``num_interior_pts``, at
  64 and 32 rows, in a log whose laser numbers are corrected. The LZ4 and
  the uncompressed input convert to the same corpus.
- The ROI raster of the port (``evaluation/roi.py``) equals the JAX
  converter's matplotlib fill on the AV2 converter test's polygons and on
  random ones, cells on an edge included.
- nuScenes: the mini layout of ``tests/test_nuscenes_converter.py``.
- Waymo: the fixture frames of ``tests/test_waymo_converter.py``, with
  the camera sidecars (JPEGs through TensorFlow or PIL, as the JAX test
  needs one of them).
- The Waymo metadata tool (``converters/waymo/metadata.py``) against
  ``tools/build_waymo_metadata.py``.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

import chip_smoke
from range_view_3d_detection_torch.converters.av2 import export as port_av2
from range_view_3d_detection_torch.converters.nuscenes import export as port_nusc
from range_view_3d_detection_torch.converters.waymo import export as port_waymo
from range_view_3d_detection_torch.converters.waymo import metadata as port_metadata
from range_view_3d_detection_torch.evaluation.roi import RoiMap as PortRoiMap
from test_nuscenes_converter import _write_mini_nuscenes
from test_waymo_converter import _camera_fixture, _fake_frame

CATEGORIES = ("REGULAR_VEHICLE", "PEDESTRIAN", "BICYCLIST", "MOTORCYCLIST",
              "WHEELED_RIDER", "BOLLARD", "CONSTRUCTION_CONE", "SIGN")


def read_pa(path: Path) -> pa.Table:
    # Read into memory, not a memory map: some tests rewrite the file.
    return paipc.open_file(pa.BufferReader(path.read_bytes())).read_all()


def assert_same_tree(want: Path, got: Path) -> int:
    """Every file of ``want`` and ``got`` equal; returns the file count."""
    files_w = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    files_g = sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    assert files_w == files_g
    for rel in files_w:
        if rel.suffix != ".feather":
            assert (want / rel).read_bytes() == (got / rel).read_bytes(), rel
            continue
        tw, tg = read_pa(want / rel), read_pa(got / rel)
        assert tw.schema.equals(tg.schema, check_metadata=True), (rel, tw.schema, tg.schema)
        for name in tw.column_names:
            cw = tw.column(name).to_numpy(zero_copy_only=False)
            cg = tg.column(name).to_numpy(zero_copy_only=False)
            assert cw.dtype == cg.dtype, (rel, name)
            if cw.dtype == object:
                assert list(cw) == list(cg), (rel, name)
            else:
                assert np.array_equal(cw.view(np.uint8), cg.view(np.uint8)), (rel, name)
    return len(files_w)


def raw_av2(root: Path, *, log_id: str, seed: int, points: int = 3000) -> Path:
    log = root / "train" / log_id
    chip_smoke.write_raw_av2_log(log, sweeps=2, seed=seed, categories=CATEGORIES,
                                 points=points)
    return log


def as_pyarrow_writes_it(src: Path, dst: Path) -> None:
    """Copy a raw log tree, its Feather files rewritten as pyarrow writes
    them by default: LZ4 bodies, and ``category`` dictionary-encoded."""
    shutil.copytree(src, dst)
    for path in dst.rglob("*.feather"):
        t = read_pa(path)
        if "category" in t.column_names:
            i = t.column_names.index("category")
            t = t.set_column(i, "category", t.column(i).dictionary_encode())
        opts = paipc.IpcWriteOptions(compression="lz4")
        with paipc.new_file(str(path), t.schema, options=opts) as w:
            w.write_table(t)


def convert_both(src: Path, tmp: Path, **kw) -> tuple:
    from converters.av2.export import export_dataset as jax_export

    jax_export(str(src), str(tmp / "jax"), splits=("train",), **kw)
    port_av2.export_dataset(str(src), str(tmp / "port"), splits=("train",), **kw)
    return tmp / "jax", tmp / "port"


@pytest.mark.parametrize("variant", ["plain", "lz4", "no_map", "with_pts", "rows32",
                                     "corrected_log"])
def test_av2_converter_equals_jax(tmp_path, variant):
    log_id = {"corrected_log": chip_smoke.RAW_AV2_LOGS["val"][0]}.get(variant, "log-a")
    log = raw_av2(tmp_path / "raw", log_id=log_id, seed=7)
    src = tmp_path / "raw"
    if variant == "lz4":
        as_pyarrow_writes_it(tmp_path / "raw", tmp_path / "raw_lz4")
        src = tmp_path / "raw_lz4"
        assert read_pa(src / "train" / log_id / "annotations.feather").schema.field(
            "category").type == pa.dictionary(pa.int32(), pa.string())
    if variant == "no_map":
        shutil.rmtree(log / "map")
    if variant == "with_pts":
        t = read_pa(log / "annotations.feather")
        t = t.append_column("num_interior_pts", pa.array(np.arange(len(t)) % 7))
        with paipc.new_file(str(log / "annotations.feather"), t.schema) as w:
            w.write_table(t)
    kw = dict(height=32, width=64) if variant == "rows32" else dict(height=64, width=128)
    jax_dir, port_dir = convert_both(src, tmp_path / variant, **kw)
    assert assert_same_tree(jax_dir, port_dir) == 5 - (variant == "no_map")
    ann = read_pa(port_dir / "train" / log_id / "annotations.feather").to_pydict()
    sweep = read_pa(next(port_dir.rglob("range_view/*.feather"))).to_pydict()
    if variant == "with_pts":
        assert ann["num_interior_pts"] == [i % 7 for i in range(len(ann["tx_m"]))]
    else:
        assert min(ann["num_interior_pts"]) > 0
    if variant != "no_map":  # the flags are computed, and not all alike
        assert 0 < sum(ann["is_within_roi"]) < len(ann["is_within_roi"])
        valid = np.asarray(sweep["range"]) > 0
        roi = np.asarray(sweep["is_within_roi"])[valid]
        assert 0 < roi.mean() < 1
    if variant == "lz4":  # the same corpus as from the uncompressed input
        port_av2.export_dataset(str(tmp_path / "raw"), str(tmp_path / "port_plain"),
                                splits=("train",), **kw)
        assert_same_tree(tmp_path / "port_plain", port_dir)


POLYGONS = {
    # tests/test_converter_roi.py's drivable area and ROI square: cell
    # centres fall on their edges.
    "converter_test_area": [[0.0, -15.0], [40.0, -15.0], [40.0, 15.0], [0.0, 15.0]],
    "roi_square": [[0.0, 0.0], [20.0, 0.0], [20.0, 20.0], [0.0, 20.0]],
    "chip_road": [[2420.0, 1180.0], [2600.0, 1180.0], [2600.0, 1225.0], [2420.0, 1225.0]],
    "concave": [[0.0, 0.0], [9.0, 0.0], [9.0, 3.0], [3.0, 3.0], [3.0, 9.0], [0.0, 9.0]],
}


@pytest.mark.parametrize("name", [*POLYGONS, "random"])
def test_roi_raster_equals_jax(name):
    from converters.av2.roi import RoiMap as JaxRoiMap

    if name == "random":
        rng = np.random.default_rng(3)
        polys = [np.round(rng.uniform(-20, 20, (k, 2)) / 0.3) * 0.3 for k in (3, 5, 8)]
    else:
        polys = [np.asarray(POLYGONS[name])]
    want, got = JaxRoiMap(polys), PortRoiMap(polys)
    assert np.array_equal(want.origin, got.origin)
    assert want.raster.shape == got.raster.shape
    assert int((want.raster != got.raster).sum()) == 0


def test_nuscenes_converter_equals_jax(tmp_path):
    from converters.nuscenes.export import export_dataset as jax_export

    src = tmp_path / "nusc"
    version = _write_mini_nuscenes(src)
    for name, export in (("jax", jax_export), ("port", port_nusc.export_dataset)):
        export(str(src), str(tmp_path / name), version=version, height=32, width=360)
    assert assert_same_tree(tmp_path / "jax", tmp_path / "port") == 4


def _frames(cameras: bool):
    frames = []
    for i, ts in enumerate((1_000_000, 1_100_000)):
        frame, ri, pose_ri = _fake_frame(ts, seed=3 + i)
        if cameras:
            calib, cam_image, _ = _camera_fixture()
            frame.context.camera_calibrations = [calib]
            frame.images = [cam_image]
        frames.append((frame, ri, pose_ri))
    return frames


def _has_jpeg_codec() -> bool:
    for name in ("tensorflow", "PIL"):
        try:
            __import__(name)
            return True
        except ImportError:
            pass
    return False


@pytest.mark.parametrize("cameras", [False, True])
def test_waymo_converter_equals_jax(tmp_path, cameras):
    if cameras and not _has_jpeg_codec():
        pytest.skip("the camera sidecars need TensorFlow or PIL, as the JAX test does")
    from converters.waymo.export import export_log as jax_export_log

    n = {}
    for name, export in (("jax", jax_export_log), ("port", port_waymo.export_log)):
        n[name] = export(None, tmp_path / name / "train" / "log_w", frames=iter(_frames(cameras)),
                         export_cameras=cameras)
    assert n["jax"] == n["port"] == 2
    files = assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert files == (8 if cameras else 5)


def test_waymo_require_raises_as_jax_does():
    from converters.waymo.export import _require_waymo as jax_require

    try:
        jax_require()
    except RuntimeError as exc:
        with pytest.raises(RuntimeError) as port_exc:
            port_waymo._require_waymo()
        assert str(port_exc.value) == str(exc)
    else:
        port_waymo._require_waymo()


def test_waymo_metadata_tool_equals_jax(tmp_path, monkeypatch, capsys):
    import tools.build_waymo_metadata as jax_tool

    root = tmp_path / "sensor"
    for k, seed in enumerate((1, 2)):
        frames = [_fake_frame(ts, seed=seed + 10 * i)
                  for i, ts in enumerate((1_000_000 * (k + 1), 1_000_000 * (k + 1) + 100_000))]
        port_waymo.export_log(None, root / "train" / f"log_{k}", frames=iter(frames),
                              export_cameras=False)
    for name, main in (("jax", jax_tool.main), ("port", port_metadata.main)):
        monkeypatch.setattr(sys, "argv", ["metadata", "--root-dir", str(root), "--out",
                                          str(tmp_path / name / "waymo.feather")])
        main()
    assert capsys.readouterr().out.count("wrote 4 rows") == 2
    assert assert_same_tree(tmp_path / "jax", tmp_path / "port") == 1
    monkeypatch.setattr(sys, "argv", ["metadata", "--root-dir", str(root), "--split", "val"])
    with pytest.raises(SystemExit, match="no per-log metadata"):
        port_metadata.main()

