"""Parts of ``chip_smoke.py`` that run without a card.

- The zero-spill gate reads ptxas's report of every K1 instance. K1 is a
  template (a 128- and a 256-wide instance), so the gate must see each
  instance's spill line, and fail when the kernel is not in the report at
  all (a build whose log was lost would otherwise pass unchecked).
- The edge-case IoU matrices on which it holds K2 against its twin have
  the property each is named for, and the kernel's decomposition
  (``nms_scan_bitmask_plain``) agrees with the plain scan on them, at
  cap 100 and at caps that are not a multiple of 4; its misaligned copies
  start 4 bytes past a 16-byte boundary.
- The K4 edge case (``k4_edge_case``) binds what it is named for: ``hq``
  saturates at 127, ``pq`` clamps at +127 and -127, and both ``rint``
  steps meet .5 ties that round down and up; on it K4's plain twin equals
  the JAX Pallas kernel in interpret mode bit for bit, so the card's check
  of K4 against the twin rests on a case known to be right.
- The BN epilogue's fused multiply-add reference (``check_addcmul_fma``)
  accepts a fused ``addcmul`` and refuses a multiply and an add rounded
  apart.
- The training phases' batch (``flagship_train_batch``) has what it is
  named for, and the card-against-CPU step check (``train_card_vs_cpu``)
  passes when both sides are the CPU (tiny config).
- Phase 29's LZ4 encoder (``lz4_frame_compress``) writes frames that
  pyarrow decodes to the input bytes, with linked blocks whose matches
  reach into the previous block, overlapping matches and raw blocks; its
  raw-log writer (``write_raw_av2_log``) writes AV2's schema (x/y/z
  ``float16``, intensity and laser_number ``uint8`` over 64 lasers,
  ``offset_ns`` ``uint32`` within the 100 ms spin, poses at 10 Hz around
  the sweeps, annotations without ``num_interior_pts``, a map archive);
  its LZ4 Feather writer (``write_feather_lz4``) writes files pyarrow reads
  equal to the columns, with compressed and raw (``-1``) buffers; and its
  conversion process (``chip_smoke.py convert``) runs here on small raw
  logs, imports none of JAX, pyarrow, the JAX package, ``converters/`` and
  ``tools/``, and finds the AV2 corpus equal to the one on
  ``z_buffer_numpy`` and to the one from the LZ4 copy of the logs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from range_view_3d_detection_torch.kernels.stem import meta_kernel_fused_i8_plain
from range_view_3d_detection_tpu.kernels.stem_pallas import meta_kernel_fused_i8
from range_view_3d_detection_torch.kernels.nms import (
    nms_scan_bitmask_plain,
    nms_scan_plain,
)

LOG = """\
ptxas info    : Compiling entry function '_Z7k3_convv' for 'sm_90a'
ptxas info    : Function properties for _Z7k3_convv
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Function properties for _ZN4_GN_23meta_kernel_fused_wgmmaILi256EEEvii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
ptxas info    : Function properties for _ZN4_GN_23meta_kernel_fused_wgmmaILi128EEEvii
    32 bytes stack frame, 32 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
"""


def test_ptxas_spills_reads_every_instance():
    got = chip_smoke.ptxas_spills(LOG, "meta_kernel_fused_wgmma")
    assert got == {
        "_ZN4_GN_23meta_kernel_fused_wgmmaILi256EEEvii": 0,
        "_ZN4_GN_23meta_kernel_fused_wgmmaILi128EEEvii": 80,
    }


def test_ptxas_spills_fails_without_the_kernel():
    with pytest.raises(RuntimeError, match="not in the ptxas log"):
        chip_smoke.ptxas_spills("", "meta_kernel_fused_wgmma")


@pytest.mark.parametrize("case", chip_smoke.NMS_EDGE_CASES)
def test_nms_edge_cases(case):
    gen = torch.Generator().manual_seed(1)
    iou, scores, valid, payload = chip_smoke.nms_edge_case(case, 2, 100, gen, "cpu")
    diag = iou.diagonal(dim1=1, dim2=2)
    if case == "zero_diagonal":
        assert (diag == 0).sum() >= 2 * 25 and (iou.sum(-1) == 0).sum() >= 2 * 12
    elif case == "asymmetric":
        assert not torch.equal(iou, iou.transpose(1, 2))
    elif case == "invalid_middle":
        assert not valid[:, 25:50].any()
    elif case == "all_suppressed":
        assert (iou == 1).all()
    elif case == "duplicated":
        assert (scores[:, 1:] == scores[:, :-1]).sum() >= 2 * 40
    _decomposition_matches_plain(iou, scores, valid, payload)


def _decomposition_matches_plain(*inputs):
    for merge in (0.5, 1.01):
        kw = dict(iou_threshold=0.3, merge_threshold=merge)
        keep, merged, _ = nms_scan_bitmask_plain(*inputs, **kw)
        keep_p, merged_p = nms_scan_plain(*inputs, **kw)
        assert torch.equal(keep, keep_p)
        torch.testing.assert_close(merged, merged_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", chip_smoke.NMS_EDGE_CASES)
def test_nms_edge_cases_cap_37(case):
    """The edge cases at a cap that is not a multiple of 4, which phase 4
    holds on the card's scalar kernel instances."""
    gen = torch.Generator().manual_seed(2)
    _decomposition_matches_plain(*chip_smoke.nms_edge_case(case, 2, 37, gen, "cpu"))


@pytest.mark.parametrize("cap", [1, 37])
def test_nms_case_ragged_caps(cap):
    gen = torch.Generator().manual_seed(3)
    _decomposition_matches_plain(*chip_smoke.nms_case(3, cap, gen, "cpu"))


def test_misaligned_copy():
    t = torch.arange(24.0).view(2, 3, 4)
    got = chip_smoke.misaligned(t)
    assert torch.equal(got, t) and got.is_contiguous()
    assert got.data_ptr() % 16 == 4


def _k4_before_rounding(x):
    """Per neighbour, what the twin rounds: ``h = x0 a0 + b0`` (hq's rint
    and clamp) and ``p * fs`` (pq's)."""
    g, feats = x["g"], x["feats"]
    H, W = g.shape[1:3]
    gp = torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1))
    fp = torch.nn.functional.pad(feats, (0, 0, 1, 1, 1, 1))
    hs, pfs = [], []
    for dy in range(3):
        for dx in range(3):
            x0 = (gp[:, dy : dy + H, dx : dx + W] - g).float()
            h = x0 * x["a0"] + x["b0"]
            hq = torch.clamp(torch.round(torch.relu(h)), max=127.0)
            z = (hq.double() @ x["w1_i8"].double()).float()
            p = torch.relu(z * x["a1"] + x["b1"])
            hs.append(h)
            pfs.append(p * fp[:, dy : dy + H, dx : dx + W].float())
    return torch.stack(hs), torch.stack(pfs)


@pytest.mark.parametrize("shape", [(1, 4, 37, 32), (2, 3, 20, 64)])
def test_k4_edge_case_twin_equals_pallas_interpret(shape):
    gen = torch.Generator().manual_seed(4)
    x = chip_smoke.k4_edge_case(*shape, gen, "cpu")
    h, pf = _k4_before_rounding(x)
    half = lambda v: v - v.floor() == 0.5  # noqa: E731
    assert (h > 127).any()  # hq saturates
    tie_h = half(h) & (h > 0) & (h < 127)
    assert (tie_h & (h.floor() % 2 == 0)).any() and (tie_h & (h.floor() % 2 == 1)).any()
    assert (pf > 127).any() and (pf < -127).any()  # pq clamps both ways
    tie_p = half(pf) & (pf.abs() < 127)
    assert (tie_p & (pf.floor() % 2 == 0)).any() and (tie_p & (pf.floor() % 2 == 1)).any()
    jx = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) if v.dtype == torch.bfloat16
          else jnp.asarray(v.numpy()) for k, v in x.items()}
    want = np.asarray(meta_kernel_fused_i8(**jx, interpret=True))
    got = meta_kernel_fused_i8_plain(**x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_addcmul_fma_reference(monkeypatch):
    gen = torch.Generator().manual_seed(5)
    chip_smoke.check_addcmul_fma("cpu", gen, n=1 << 16)  # CPU addcmul is fused too
    monkeypatch.setattr(torch, "addcmul", lambda b, d, m: d * m + b)
    with pytest.raises(RuntimeError, match="not one fused multiply-add"):
        chip_smoke.check_addcmul_fma("cpu", gen, n=1 << 16)


def test_flagship_train_batch():
    from range_view_3d_detection_torch import serving

    cfg = serving._flagship_config()
    b = chip_smoke.flagship_train_batch(cfg, 2, 8, 256, seed=3, n_boxes=64)
    assert b["boxes"].shape == (2, 256, 7) and b["box_valid"].sum(-1).tolist() == [64, 64]
    valid = b["boxes"][b["box_valid"]]
    assert (valid[:, 3:6] >= 0.5).all() and (valid[:, 3:6] <= 6.0).all()
    assert (np.abs(valid[:, 6]) <= np.pi).all()
    assert b["box_offset"].min() >= 0 and b["box_offset"].max() < 26
    for i in range(2):  # each centre is the return of a valid pixel
        ctr = b["boxes"][i, :64, None, :3]
        hit = (b["cart"][i][b["mask"][i]][None] == ctr).all(-1).any(-1)
        assert hit.all()


def test_train_card_vs_cpu_on_the_cpu(capsys):
    from range_view_3d_detection_torch import serving

    chip_smoke.train_card_vs_cpu(serving._flagship_config(tiny=True), "cpu")
    assert "train card vs CPU" in capsys.readouterr().out


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_gate_explains_moved_columns(stride):
    """Phase 19's gate: a pixel may differ between two rasterizations only
    where a point changed column. One winning point turned by one column
    changes pixels that the moved set explains, and nothing else does;
    a tanh plane may differ by a few ulps, and only a plane so named."""
    from range_view_3d_detection_torch.data.dataset import AV2_FEATURES, width_padding
    from range_view_3d_detection_torch.export import _sample_points
    from range_view_3d_detection_torch.ops.projection import (
        range_view_coordinates_t,
        rasterize_points,
    )

    H, W = 8, 56
    xyz, laser, inten = _sample_points(1, 600, H, W, seed=5)
    kw = dict(height=H, width=W, feature_names=AV2_FEATURES, x_stride=stride,
              pad=width_padding(W, stride), padding_mode="circular")
    args = [torch.from_numpy(laser), {"intensity": torch.from_numpy(inten)}]
    want = rasterize_points(torch.from_numpy(xyz), *args, **kw)
    row, col, _ = range_view_coordinates_t(torch.from_numpy(xyz[0]),
                                           torch.from_numpy(laser[0]), height=H, width=W)
    gate = dict(feature_names=AV2_FEATURES, pad=kw["pad"], x_stride=stride, width=W)
    a = stride * 2 * np.pi / W  # turned by `stride` columns: still in a kept one
    for i in range(20):  # the first point whose move shows in the image
        moved_xyz = xyz.copy()
        x, y = xyz[0, i, 0], xyz[0, i, 1]
        moved_xyz[0, i, :2] = [x * np.cos(a) - y * np.sin(a), x * np.sin(a) + y * np.cos(a)]
        got = rasterize_points(torch.from_numpy(moved_xyz), *args, **kw)
        _, col2, _ = range_view_coordinates_t(torch.from_numpy(moved_xyz[0]),
                                              torch.from_numpy(laser[0]), height=H,
                                              width=W)
        assert int(col2[i]) != int(col[i])
        moved = {(0, int(row[i]), int(col[i])), (0, int(row[i]), int(col2[i]))}
        n_diff, n_bad = chip_smoke.unexplained_pixels(got, want, moved, ulp_names=(),
                                                      **gate)
        if n_diff:
            break
    assert n_diff > 0 and n_bad == 0
    assert chip_smoke.unexplained_pixels(got, want, set(), ulp_names=(), **gate)[1] > 0
    # A few ulps in the intensity plane pass only where it is named.
    i = AV2_FEATURES.index("intensity")
    nudged = want[0].clone()
    bits = nudged[..., i].contiguous().view(torch.int32)
    nudged[..., i] = torch.where(want[2], bits + chip_smoke.TANH_ULPS, bits).view(
        torch.float32)
    near = (nudged, want[1], want[2])
    assert chip_smoke.unexplained_pixels(near, want, set(), ulp_names=("intensity",),
                                         **gate) == (0, 0)
    assert chip_smoke.unexplained_pixels(near, want, set(), ulp_names=(), **gate)[1] > 0


@pytest.mark.parametrize("options", [{}, dict(linked=False, block_checksum=True),
                                     dict(block_size=1 << 18, content_checksum=True,
                                          content_size=True)])
def test_lz4_encoder_frames_decode_in_pyarrow(options):
    import pyarrow as pa

    rng = np.random.default_rng(5)
    sweep = (rng.normal(size=60_000) * 20).astype(np.float16).tobytes()
    data = chip_smoke.lz4_test_data(sweep, seed=6)
    stats = {}
    frame = chip_smoke.lz4_frame_compress(data, stats=stats, **options)
    assert pa.decompress(frame, decompressed_size=len(data), codec="lz4",
                         asbytes=True) == data
    assert stats["overlapping"] > 0 and stats["raw_blocks"] > 0
    assert (stats["into_earlier_block"] > 0) == options.get("linked", True)


def test_raw_av2_log_has_the_av2_schema(tmp_path):
    from range_view_3d_detection_torch.utils.feather import read_feather

    log = tmp_path / "log"
    chip_smoke.write_raw_av2_log(log, sweeps=3, seed=1, categories=("REGULAR_VEHICLE", "BUS"),
                                 points=5000)
    sweeps = sorted((log / "sensors" / "lidar").glob("*.feather"))
    stamps = [int(p.stem) for p in sweeps]
    assert len(sweeps) == 3 and np.all(np.diff(stamps) == chip_smoke.SWEEP_NS)
    for p in sweeps:
        cols = read_feather(p)
        assert {k: str(v.dtype) for k, v in cols.items()} == {
            "x": "float16", "y": "float16", "z": "float16", "intensity": "uint8",
            "laser_number": "uint8", "offset_ns": "uint32"}
        assert len(cols["x"]) == 5000 and set(np.unique(cols["laser_number"])) == set(range(64))
        assert cols["offset_ns"].max() < chip_smoke.SWEEP_NS
        assert np.isfinite(cols["x"]).all() and np.abs(cols["x"]).max() <= 80
    poses = read_feather(log / "city_SE3_egovehicle.feather")
    assert np.all(np.diff(poses["timestamp_ns"]) == chip_smoke.SWEEP_NS)
    assert poses["timestamp_ns"][0] < stamps[0] and poses["timestamp_ns"][-1] > stamps[-1]
    ann = read_feather(log / "annotations.feather")
    assert "num_interior_pts" not in ann and set(ann["timestamp_ns"]) == set(stamps)
    assert set(ann["category"]) <= {"REGULAR_VEHICLE", "BUS"}
    assert len(list((log / "map").glob("log_map_archive_*.json"))) == 1


def test_convert_rank_on_the_cpu(tmp_path):
    import json
    import subprocess
    import sys

    from range_view_3d_detection_torch.utils.config import compose

    categories = compose(chip_smoke.REPO / "conf", "rv-av2")["model"]["tasks"][0]
    for k, (split, (log_id, sweeps)) in enumerate(chip_smoke.RAW_AV2_LOGS.items()):
        chip_smoke.write_raw_av2_log(tmp_path / "raw_av2" / split / log_id, sweeps=sweeps,
                                     seed=k, categories=categories, points=4000)
    chip_smoke.write_raw_nuscenes(tmp_path / "raw_nuscenes", seed=2, points=3000)
    counts = chip_smoke.lz4_copy(tmp_path / "raw_av2", tmp_path / "raw_av2_lz4")
    assert counts["lz4"] > 0 and counts["raw"] > 0
    proc = subprocess.run([sys.executable, str(chip_smoke.REPO / "chip_smoke.py"), "convert",
                           str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [x for x in proc.stdout.splitlines() if x.startswith("chip_smoke_convert ")]
    out = json.loads(line[0].split(" ", 1)[1])
    assert out["banned_imported"] == [] and out["av2_differ"] == [] and out["finite"]
    assert out["av2_lz4_differ"] == []
    assert out["av2_sweeps"] == 6 and out["av2_points"] == 6 * 4000
    assert out["av2_boxes_with_points"] == out["av2_boxes"] > 0
    assert out["nuscenes_shapes"] == [32 * 1800] and out["waymo_shapes"] == [64 * 2650]
    assert out["waymo_num_pts"] == out["waymo_valid_pixels"]


def test_write_feather_lz4_reads_in_pyarrow(tmp_path):
    import pyarrow.ipc as paipc

    rng = np.random.default_rng(7)
    cols = {"noise": rng.normal(size=30_000),  # does not compress: stored raw
            "zeros": np.zeros(30_000, np.float32), "h": rng.normal(size=30_000).astype(
                np.float16), "flag": rng.uniform(size=30_000) < 0.5,
            "cat": np.asarray([f"c{i % 3}" for i in range(30_000)])}
    counts = chip_smoke.write_feather_lz4(tmp_path / "c.feather", cols)
    assert counts["lz4"] > 0 and counts["raw"] > 0
    table = paipc.open_file(str(tmp_path / "c.feather")).read_all()
    for k, v in cols.items():
        got = table.column(k).to_numpy(zero_copy_only=False)
        assert got.dtype == (object if v.dtype.kind == "U" else v.dtype)
        assert got.tolist() == v.tolist()


# -- phases 30-38: the bench and the measurement tools --------------------------


def _bench_line(**kw):
    line = {"metric": "e2e_frames_per_sec_per_chip", "value": 29.1, "unit": "frames/s",
            "path": "int8", "inputs": "range images", "mode": "int8 eager",
            "p50_ms": 69.9, "p90_ms": 71.6, "batch": 2,
            "device": "NVIDIA H100 80GB HBM3, 700.00 W"}
    line.update(kw)
    return line


def test_bench_json_is_the_last_metric_line():
    import json

    first = json.dumps({"latency_ms_p50": 1.0})
    out = "\n".join(["log", first, json.dumps(_bench_line()), "{not json"])
    assert chip_smoke.bench_json(out) == _bench_line()
    with pytest.raises(RuntimeError, match="no bench JSON line"):
        chip_smoke.bench_json(first)


def test_check_bench_line_gates():
    kind, smi = "NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3, 700.00 W"
    chip_smoke.check_bench_line("int8", _bench_line(), kind, smi)
    for bad in (dict(value=0.0), dict(p50_ms=80.0), dict(device="cpu"),
                dict(metric="frames"), dict(mode="int8 torch.compile(x=1)"), dict(batch=1)):
        with pytest.raises(RuntimeError):
            chip_smoke.check_bench_line("int8", _bench_line(**bad), kind, smi)


def test_bench_modes_and_their_kernels():
    """Every bench mode says which kernels must and must not launch, and
    the two sets name the four wrappers' counters."""
    from range_view_3d_detection_torch import bench

    names = {"meta_kernel_fused", "nms_scan", "conv3x3_i8_fused", "meta_kernel_fused_i8"}
    assert [m[0] for m in chip_smoke.BENCH_MODES] == list(chip_smoke.BENCH_EXPECT)
    for tag, args, stem in chip_smoke.BENCH_MODES:
        need, never = chip_smoke.BENCH_EXPECT[tag]
        assert need | never <= names and not need & never and "nms_scan" in need
        assert ("meta_kernel_fused_i8" in need) == stem
        parsed = bench.main(args + ["--dry-parse"])
        assert parsed == 0.0


def test_compile_config_takes_k1():
    """Phase 37's model is one K1 takes: bf16, C a multiple of 32, the
    fused stem on."""
    cfg = chip_smoke.compile_config()
    assert cfg.dtype == "bfloat16" and cfg.stem_pallas and cfg.layers[0] % 32 == 0
