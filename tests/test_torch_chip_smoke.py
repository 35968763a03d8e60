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
- Phase 45's helpers: the rv-waymo config and decoder it builds have the
  published widths, classes, cap and layout; its requests are B=2 x 64 x
  2650 padded with constant padding to 2656; its raw points go through
  ``make_points_predict`` with Waymo's projection and constant padding;
  ``chip_smoke.py waymo`` and the other subcommands are parsed.
- Phase 46's: the same builders give base-av2 (the BASIC stem, 1808
  served) and rv-av2-fast (pad 28, 464 served, constant, x_stride 4) as
  ``conf/`` publishes them; rv-av2-fast's request is the dataset's sweep
  padded and strided, and its points go through the front end at x_stride
  4; each mode's expected launches name the four wrappers' counters, with
  neither stem kernel for the BASIC stem; ``chip_smoke.py configs`` runs
  phase 46's entry point.
- Phase 47's: rv-nuscenes (32 rows, 1800 padded by 4 to 1808, its val
  split constant and its train split circular) and base-waymo (the BASIC
  stem on Waymo's six features, 2650 padded by 3 to 2656) as ``conf/``
  publishes them; nuScenes' points (the intensity channel, raw 0-255
  intensity, 32 lasers) through the front end; the train batch padded as
  the train split pads; ``chip_smoke.py configs 47`` runs phase 47's
  entry point and an unknown phase is refused; phase 29's nuScenes
  Trainer block (``nuscenes_trainer_run``) fits, validates and scores a
  converted ``write_raw_nuscenes`` corpus at small widths.
- Phase 48's: its Trainer block (``waymo_trainer_run``) composes rv-waymo
  on a converted Waymo corpus (val pinned to train), fits one B=2 step,
  validates to one shard a sweep and finds every WOD average finite under
  ``detection_cfg_factory("waymo")``, at small widths on the CPU; its
  requests are B=2 pairs of the corpus's padded sweeps and its clouds the
  corpus's own returns, zero-padded; ``bit_equal`` tells NaNs alike and
  signed zeros apart; the oracle's epoch count, its gates and the cut list
  are what the phase prints; ``chip_smoke.py waymo-user`` runs phase
  48's entry point, which fails without a card.
- Phase 49's: K2's check holds non-finite merged values to the twin's
  (the same infinity, or NaN in both) and fails on any other; the cut
  list; ``PUBLISHED_USERS``' request shapes are the configs' own layouts
  (rv-av2-fast's x_stride 4); its corpora converted again when the phase
  runs alone (``convert_user_corpora``); B=2 requests of rv-av2-fast's
  val sweeps, padded and strided; the train, predict and export blocks
  (``user_train``, ``user_predict``, ``user_export``) on the CPU at small
  widths; the min_confidence-0 predictor leaves the artifact's
  ``meta.json`` as written; ``chip_smoke.py users`` runs phase 49's entry
  point, which fails without a card.
"""

from __future__ import annotations

import dataclasses

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
    elif case == "nonfinite_payload":
        assert (payload == float("inf")).any() and payload.isnan().any()
        assert (payload == -float("inf")).any()
    _decomposition_matches_plain(iou, scores, valid, payload)


def _decomposition_matches_plain(*inputs):
    for merge in (0.5, 1.01):
        kw = dict(iou_threshold=0.3, merge_threshold=merge)
        keep, merged, _ = nms_scan_bitmask_plain(*inputs, **kw)
        keep_p, merged_p = nms_scan_plain(*inputs, **kw)
        assert torch.equal(keep, keep_p)
        # Non-finite values (the nonfinite_payload case) must match exactly:
        # the same infinity, or NaN in both.
        torch.testing.assert_close(merged, merged_p, atol=1e-5, rtol=0, equal_nan=True)


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
    """Phase 37's models are ones K1 takes with the fused stem on: the tiny
    config as it is (widths 8, fp32, K1's 3xTF32 kernel) and the tiny
    config at 32 channels in bf16, the served dtype (K1's wgmma kernel)."""
    import dataclasses

    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.kernels.stem import k1_plan

    cfgs = chip_smoke.compile_configs()
    tiny = dataclasses.replace(serving._flagship_config(tiny=True), stem_pallas=True)
    assert cfgs["tiny fp32"] == tiny and tiny.dtype == "float32"
    bf16 = cfgs["tiny at 32 channels bf16"]
    assert bf16 == dataclasses.replace(tiny, layers=(32,) * 5, dtype="bfloat16")
    assert k1_plan(tiny.layers[0], torch.float32) == ("tf32x3", 8)
    assert k1_plan(bf16.layers[0], torch.bfloat16) == ("wgmma", 0)


def test_waymo_phase_config_and_request():
    """Phase 45 builds rv-waymo as ``conf/`` publishes it (128-channel stem
    and stages, FPN 256, 256-channel towers, 3 classes, 6 channels, bf16
    with the fused stem, its own decoder at nms_cap 1024) and serves it
    B=2 x 64 x 2650 padded by 3 a side, constant, to 2656; its stem takes
    K1's and K4's 128-wide wgmma instances."""
    from range_view_3d_detection_torch.data.dataset import WAYMO_FEATURES
    from range_view_3d_detection_torch.kernels.stem import k1_plan, k4_plan
    from range_view_3d_detection_torch.training import builders
    from range_view_3d_detection_torch.utils.config import compose

    assert chip_smoke.PUBLISHED_CONFIGS["rv-waymo"] == (45, 1, 250, 45, 2)
    cfg, dec, layout = chip_smoke.experiment_configs("rv-waymo", 1)
    raw = compose("conf", "rv-waymo")
    assert cfg == builders.build_detector_config(raw)
    assert dec == builders.build_decoder_config(raw)
    assert cfg.layers == (128,) * 5 and cfg.stage_blocks == (2, 3, 3, 5, 5)
    assert cfg.fpn == ((1, 256),)
    assert cfg.classification_head_channels == cfg.regression_head_channels == 256
    assert cfg.num_classification_blocks == cfg.num_regression_blocks == 4
    assert len(cfg.tasks_dict[0]) == 3 and cfg.in_channels == 6
    assert cfg.dtype == "bfloat16" and cfg.stem_type == "META" and cfg.stem_pallas
    assert dec.nms_cap == 1024
    assert layout == dict(height=64, sensor_width=2650, pad=3, width=2656,
                          feature_names=WAYMO_FEATURES, dataset_name="waymo", x_stride=1,
                          padding_mode="constant")
    feats, cart, mask = chip_smoke.padded_request(2, 64, 2650, cfg.in_channels, seed=0)
    assert feats.shape == (2, 64, 2656, 6) and cart.shape == (2, 64, 2656, 3)
    assert mask.shape == (2, 64, 2656) and mask.dtype == bool
    for a in (feats, cart, mask):
        assert not a[:, :, :3].any() and not a[:, :, -3:].any()
    assert mask[:, :, 3:-3].mean() > 0.9
    small = chip_smoke.padded_request(1, 8, 250, 6, seed=45)
    assert small[0].shape == (1, 8, 256, 6)
    assert k1_plan(128, torch.bfloat16) == ("wgmma", 0)
    assert k4_plan(128, torch.bfloat16) == ("wgmma", 0)


def test_waymo_points_front_end():
    """Phase 45's raw points go through ``export.make_points_predict`` with
    Waymo's layout: constant padding, the waymo projection, its two
    extra channels in their order, into a 64 x 2656 x 6 range image."""
    import dataclasses

    from range_view_3d_detection_torch import serving

    cfg, dec, layout = chip_smoke.experiment_configs("rv-waymo", 1)
    tiny = dataclasses.replace(serving._flagship_config(tiny=True), in_channels=6)
    predictor = serving.Predictor(tiny, dec, device="cpu")
    points_predict, extra = chip_smoke.points_front_end(predictor, layout)
    assert extra == ["elongation", "intensity"]
    kw = points_predict.kw
    assert kw["padding_mode"] == "constant" and kw["pad"] == 3 and kw["width"] == 2650
    assert kw["dataset_name"] == "waymo" and kw["x_stride"] == 1 and kw["height"] == 64
    clouds = chip_smoke.sensor_points(2, 4096, layout, extra, seed=0)
    xyz, laser, elongation, intensity = clouds
    assert xyz.shape == (2, 4096, 3) and laser.shape == elongation.shape == (2, 4096)
    assert 0 <= elongation.min() and elongation.max() < 2 and intensity.max() > 1
    feats, cart, mask = points_predict.rasterize(*clouds)
    assert tuple(feats.shape) == (2, 64, 2656, 6) and mask.any()
    assert not mask[:, :, :3].any() and not mask[:, :, -3:].any()


def test_subcommands_are_parsed(monkeypatch):
    """``chip_smoke.py waymo`` and ``chip_smoke.py configs`` run phases
    45's and 46's entry points; a subcommand's own arguments reach it; no
    argument runs the whole script."""
    called = []
    monkeypatch.setattr(chip_smoke, "configs_main", lambda phase: called.append(phase) or phase)
    monkeypatch.setattr(chip_smoke, "convert_rank", lambda args: called.append(args) or 29)
    monkeypatch.setitem(chip_smoke.SUBCOMMANDS, "convert", chip_smoke.convert_rank)
    monkeypatch.setattr(chip_smoke, "main", lambda: called.append("main") or 0)
    assert chip_smoke.run(["waymo"]) == 45
    assert chip_smoke.run(["configs"]) == 46
    assert chip_smoke.run(["convert", "WORK"]) == 29
    assert chip_smoke.run([]) == 0
    assert called == [45, 46, ["WORK"], "main"]
    assert set(chip_smoke.SUBCOMMANDS) == {
        "waymo", "configs", "kernel-shapes", "tools", "conv-shapes", "compile-decode",
        "train-rank", "width-rank", "convert", "shipped-times", "shipped-round", "waymo-user",
        "users"}


def test_published_configs_and_requests():
    """Phase 46 builds base-av2 and rv-av2-fast as ``conf/`` publishes
    them: base-av2 with the BASIC stem (stages 64, 64, 128 x 3, FPN 128,
    128-channel towers, no fused stem) at 1800 columns padded by 4 to
    1808, rv-av2-fast the flagship at x_stride 4, 1800 padded by 28 to
    1856 and strided to 464; both AV2's five features with constant
    padding, 26 classes, nms_cap 1024, their own decoders. A request is
    the dataset's sweep padded and strided; the card-against-CPU request
    is 256 columns served."""
    from range_view_3d_detection_torch.data.dataset import AV2_FEATURES
    from range_view_3d_detection_torch.training import builders
    from range_view_3d_detection_torch.utils.config import compose

    want = {"base-av2": (4, 1808, "BASIC", (64, 64, 128, 128, 128), ((1, 128),), 128, False),
            "rv-av2-fast": (28, 464, "META", (256,) + (128,) * 4, ((1, 512),), 512, True)}
    phase46 = {k: v for k, v in chip_smoke.PUBLISHED_CONFIGS.items() if v[0] == 46}
    assert set(phase46) == set(want)
    for name, (_, x_stride, small_sensor, _, train_batch) in phase46.items():
        pad, served, stem, layers, fpn, towers, pallas = want[name]
        assert train_batch == 4
        cfg, dec, layout = chip_smoke.experiment_configs(name, x_stride)
        raw = compose("conf", name)
        assert cfg == builders.build_detector_config(raw)
        assert dec == builders.build_decoder_config(raw) and dec.nms_cap == 1024
        assert (cfg.stem_type, cfg.layers, cfg.fpn, cfg.stem_pallas) == (stem, layers, fpn, pallas)
        assert cfg.classification_head_channels == cfg.regression_head_channels == towers
        assert len(cfg.tasks_dict[0]) == 26 and cfg.dtype == "bfloat16"
        assert layout == dict(height=64, sensor_width=1800, pad=pad, width=served,
                              feature_names=AV2_FEATURES, dataset_name="av2",
                              x_stride=x_stride, padding_mode="constant")
        small = chip_smoke.padded_request(1, 8, small_sensor, 5, seed=45, x_stride=x_stride)
        assert small[0].shape == (1, 8, 256, 5)
    with pytest.raises(RuntimeError, match="x_stride 4"):
        chip_smoke.experiment_configs("rv-av2-fast", 1)


def test_strided_request_is_the_dataset_sweep():
    """rv-av2-fast's request: ``_sample_inputs`` at 1800 columns, padded
    by 28 a side with zeros, then every 4th column, as
    ``data/dataset.py`` pads and strides a sweep; stride 1 gives phase
    45's padded request unchanged."""
    from range_view_3d_detection_torch import serving

    feats, cart, mask = chip_smoke.padded_request(2, 4, 1800, 5, seed=3, x_stride=4)
    f0, c0, m0 = serving._sample_inputs(2, 4, 1800, 5, seed=3)
    assert feats.shape == (2, 4, 464, 5) and cart.shape == (2, 4, 464, 3)
    assert mask.shape == (2, 4, 464) and feats.flags.c_contiguous
    # padded column 4 j is sensor column 4 j - 28: columns 0-6 are padding.
    np.testing.assert_array_equal(feats[:, :, 7:-7], f0[:, :, 0:1800:4][:, :, :450])
    np.testing.assert_array_equal(mask[:, :, 7:-7], m0[:, :, 0:1800:4][:, :, :450])
    assert not feats[:, :, :7].any() and not mask[:, :, -7:].any()
    one = chip_smoke.padded_request(2, 4, 1800, 5, seed=3)
    padded = np.pad(f0, ((0, 0), (0, 0), (4, 4), (0, 0)))
    np.testing.assert_array_equal(one[0], padded)


def test_fast_points_front_end():
    """rv-av2-fast's raw points go through ``make_points_predict`` at
    x_stride 4 with AV2's projection and constant padding, into a 64 x 464
    x 5 range image; AV2's intensity is the bench's, unscaled."""
    from range_view_3d_detection_torch import serving

    cfg, dec, layout = chip_smoke.experiment_configs("rv-av2-fast", 4)
    tiny = serving._flagship_config(tiny=True)
    predictor = serving.Predictor(tiny, dec, device="cpu")
    points_predict, extra = chip_smoke.points_front_end(predictor, layout)
    assert extra == chip_smoke.POINTS_EXTRA["av2"] == ["intensity"]
    kw = points_predict.kw
    assert kw["x_stride"] == 4 and kw["pad"] == 28 and kw["padding_mode"] == "constant"
    xyz, laser, intensity = chip_smoke.sensor_points(2, 4096, layout, extra, seed=0)
    assert 0 <= intensity.min() and intensity.max() < 1
    feats, cart, mask = points_predict.rasterize(xyz, laser, intensity)
    assert tuple(feats.shape) == (2, 64, 464, 5) and mask.any()
    assert not mask[:, :, :7].any() and not mask[:, :, -7:].any()


@pytest.mark.parametrize("stem", ["META", "BASIC"])
def test_config_phase_expected_launches(stem):
    """Phases 45 and 46 expect of each served and bench mode the kernels
    the stem takes: the META stem the bench's table (its served points
    bf16), the BASIC stem neither stem kernel, K2 in every mode and K3 in
    the int8 ones; only the META stem has an int8 stem mode."""
    names = {"meta_kernel_fused", "nms_scan", "conv3x3_i8_fused", "meta_kernel_fused_i8"}
    served, bench = chip_smoke.CONFIG_EXPECT[stem], chip_smoke.CONFIG_BENCH_EXPECT[stem]
    assert served["points"] == bench["bf16"] and set(served) == set(bench)
    assert ("int8 K4 stem" in served) == (stem == "META")
    for tag, (need, never) in {**served, **{f"bench {k}": v for k, v in bench.items()}}.items():
        assert need | never == names and not need & never and "nms_scan" in need, tag
        assert ("conv3x3_i8_fused" in need) == ("int8" in tag or tag == "bench points"), tag
        if stem == "BASIC":
            assert {"meta_kernel_fused", "meta_kernel_fused_i8"} <= never, tag
    if stem == "META":
        assert bench == chip_smoke.BENCH_EXPECT



def test_last_configs_and_requests():
    """Phase 47 builds rv-nuscenes (the META stem at 128, stages of 128,
    FPN 256, 256-channel towers, 10 classes, AV2's five features; 32 x
    1800 padded by 4 to 1808) and base-waymo (the BASIC stem, stages 64,
    64, 128 x 3, FPN 128, 128-channel towers, 3 classes, Waymo's six
    features; 64 x 2650 padded by 3 to 2656) as ``conf/`` publishes them,
    each val split with constant padding (``experiment_configs``' check)
    and rv-nuscenes' train split circular; the card-against-CPU request is
    256 columns served."""
    from range_view_3d_detection_torch.data.dataset import AV2_FEATURES, WAYMO_FEATURES
    from range_view_3d_detection_torch.training import builders
    from range_view_3d_detection_torch.utils.config import compose

    want = {
        "rv-nuscenes": ("META", (128,) * 5, ((1, 256),), 256, True, 10, AV2_FEATURES,
                        "nuscenes", 32, 1800, 4, 1808, "circular"),
        "base-waymo": ("BASIC", (64, 64, 128, 128, 128), ((1, 128),), 128, False, 3,
                       WAYMO_FEATURES, "waymo", 64, 2650, 3, 2656, "constant"),
    }
    phase47 = {k: v for k, v in chip_smoke.PUBLISHED_CONFIGS.items() if v[0] == 47}
    assert set(phase47) == set(want)
    for name, (_, x_stride, small_sensor, _, train_batch) in phase47.items():
        (stem, layers, fpn, towers, pallas, classes, features, dataset, height, sensor, pad,
         served, train_mode) = want[name]
        assert x_stride == 1 and train_batch == 4
        cfg, dec, layout = chip_smoke.experiment_configs(name, x_stride)
        raw = compose("conf", name)
        assert cfg == builders.build_detector_config(raw)
        assert dec == builders.build_decoder_config(raw) and dec.nms_cap == 1024
        assert (cfg.stem_type, cfg.layers, cfg.fpn, cfg.stem_pallas) == (stem, layers, fpn, pallas)
        assert cfg.classification_head_channels == cfg.regression_head_channels == towers
        assert len(cfg.tasks_dict[0]) == classes and cfg.dtype == "bfloat16"
        assert cfg.in_channels == len(features)
        assert layout == dict(height=height, sensor_width=sensor, pad=pad, width=served,
                              feature_names=features, dataset_name=dataset, x_stride=1,
                              padding_mode="constant")
        assert chip_smoke.train_padding(name) == train_mode
        small = chip_smoke.padded_request(1, 8, small_sensor, cfg.in_channels, seed=45)
        assert small[0].shape == (1, 8, 256, cfg.in_channels)
        request = chip_smoke.padded_request(2, height, sensor, cfg.in_channels, seed=0)
        assert request[0].shape == (2, height, served, cfg.in_channels)
    with pytest.raises(RuntimeError, match="rv-nuscenes.s layout: x_stride 1, constant"):
        chip_smoke.experiment_configs("rv-nuscenes", 1, padding_mode="circular")


def test_nuscenes_points_front_end():
    """rv-nuscenes' raw points: ``POINTS_EXTRA["nuscenes"]`` is the
    intensity channel, ``sensor_points`` draws nuScenes' raw 0-255
    intensity on the 32 lasers of the sensor, and the front end (the
    nuScenes projection, constant padding) rasterizes them into a 32 x
    1808 x 5 range image with the raw intensity kept."""
    from range_view_3d_detection_torch import serving

    cfg, dec, layout = chip_smoke.experiment_configs("rv-nuscenes", 1)
    predictor = serving.Predictor(serving._flagship_config(tiny=True), dec, device="cpu")
    points_predict, extra = chip_smoke.points_front_end(predictor, layout)
    assert extra == chip_smoke.POINTS_EXTRA["nuscenes"] == ["intensity"]
    kw = points_predict.kw
    assert kw["dataset_name"] == "nuscenes" and kw["height"] == 32 and kw["pad"] == 4
    assert kw["padding_mode"] == "constant"
    xyz, laser, intensity = chip_smoke.sensor_points(2, 4096, layout, extra, seed=0)
    assert laser.min() == 0 and laser.max() == 31
    assert 0 <= intensity.min() and 200 < intensity.max() < 255
    feats, cart, mask = points_predict.rasterize(xyz, laser, intensity)
    assert tuple(feats.shape) == (2, 32, 1808, 5) and mask.any()
    assert not mask[:, :, :4].any() and not mask[:, :, -4:].any()
    assert float(feats[..., 0].max()) > 200


def test_train_batch_pads_as_the_train_split():
    """Phase 47's train batch for rv-nuscenes: the sweep padded
    circularly (its train split's mode), the boxes centred on its valid
    returns."""
    cfg, _, layout = chip_smoke.experiment_configs("rv-nuscenes", 1)
    mode = chip_smoke.train_padding("rv-nuscenes")
    inputs = chip_smoke.padded_request(2, 4, 1800, 5, seed=3, padding_mode=mode)
    b = chip_smoke.flagship_train_batch(cfg, 2, 4, 1808, seed=3, inputs=inputs)
    feats, mask = b["features"], b["mask"]
    assert feats.shape == (2, 4, 1808, 5) and b["boxes"].shape == (2, cfg.max_boxes, 7)
    np.testing.assert_array_equal(feats[:, :, :4], feats[:, :, 1800:1804])
    np.testing.assert_array_equal(mask[:, :, -4:], mask[:, :, 4:8])
    for i in range(2):
        ctr = b["boxes"][i, :64, None, :3]
        assert (b["cart"][i][mask[i]][None] == ctr).all(-1).any(-1).all()
    with pytest.raises(RuntimeError, match="train batch of"):
        chip_smoke.flagship_train_batch(cfg, 2, 4, 1800, seed=3, inputs=inputs)


def test_configs_subcommand_takes_the_phase(monkeypatch):
    """``chip_smoke.py configs 47`` runs phase 47's entry point and
    ``configs`` alone phase 46's; ``configs_main`` refuses a phase that
    no published configuration has, before it looks for a card."""
    called = []
    monkeypatch.setattr(chip_smoke, "configs_main", lambda phase: called.append(phase) or phase)
    assert chip_smoke.run(["configs", "47"]) == 47
    assert chip_smoke.run(["configs"]) == 46
    assert chip_smoke.run(["configs", "45"]) == 45
    assert called == [47, 46, 45]
    monkeypatch.undo()
    monkeypatch.setattr(chip_smoke, "card_start", lambda: pytest.fail("looked for a card"))
    with pytest.raises(RuntimeError, match="no phase 44"):
        chip_smoke.configs_main(44)


def test_nuscenes_trainer_run_on_the_cpu(tmp_path):
    """Phase 29's nuScenes block on the CPU at small widths: the corpus
    converted from ``write_raw_nuscenes`` (its train split, 32 x 360 here,
    1800 on the card),
    the rv-nuscenes Trainer at one step of B=2, two shards, finite
    averages under the nuScenes settings (55 m, every instance)."""
    from range_view_3d_detection_torch.converters.nuscenes import export as nusc_export

    version = chip_smoke.write_raw_nuscenes(tmp_path / "raw", seed=chip_smoke.SEED + 292)
    nusc_export.export_dataset(str(tmp_path / "raw"), str(tmp_path / "nuscenes"),
                               version=version, height=32, width=360)
    small = ["++dataset._train_dataset.range_view_config.width=360","++model._backbone.layers=[8,8,8,8,8]", "++model._backbone.stem_pallas=false",
             "++model._head.fpn={1: 16}", "++model._head.classification_head_channels=8",
             "++model._head.regression_head_channels=8",
             "++model._head.num_classification_blocks=1",
             "++model._head.num_regression_blocks=1", "++model.max_boxes=16",
             "++model.post_processing_config.nms_cap=128", "++model.precision=float32"]
    out = chip_smoke.nuscenes_trainer_run(tmp_path / "nuscenes", tmp_path / "run", "cpu",
                                          overrides=small)
    assert out["shards"] == 2 and out["shape"] == (32, 368, 5)
    assert out["layers"] == (8,) * 5 and np.isfinite(out["loss"])
    assert (out["max_range_m"], out["eval_only_roi_instances"]) == (55.0, False)
    assert "AP" in out["average"]


# -- phase 48 -----------------------------------------------------------------


@pytest.fixture(scope="module")
def waymo_corpus(tmp_path_factory):
    """Phase 48's corpus at an 8 x 58 sensor: one log of two frames, as
    phase 29 converts it (every label on a return, so the train split
    keeps both sweeps)."""
    from range_view_3d_detection_torch.converters.waymo import export as waymo_export
    from test_torch_waymo_user import waymo_frames_on_points

    root = tmp_path_factory.mktemp("waymo_user") / "sensor"
    waymo_export.export_log(None, root / "train" / "segment-0",
                            frames=waymo_frames_on_points(2, seed=chip_smoke.SEED + 29),
                            export_cameras=False)
    return root


WAYMO_SMALL = ["++dataset._train_dataset.range_view_config.height=8",
               "++dataset._train_dataset.range_view_config.width=58",
               "++dataset._train_dataset.min_points_filter=0",
               "++model._backbone.layers=[8,8,8,8,8]", "++model._backbone.stem_pallas=false",
               "++model._head.fpn={1: 16}", "++model._head.classification_head_channels=8",
               "++model._head.regression_head_channels=8",
               "++model._head.num_classification_blocks=1",
               "++model._head.num_regression_blocks=1", "++model.max_boxes=16",
               "++model.post_processing_config.nms_cap=128", "++model.precision=float32"]


def test_waymo_trainer_run_on_the_cpu(waymo_corpus, tmp_path):
    """Phase 48's Trainer block on the CPU at small widths: rv-waymo
    composed on the corpus, val pinned to train, one step of B=2, two
    shards, the WOD averages (mAP and mAPH at levels 1 and 2, with the
    penalty and without) finite."""
    out = chip_smoke.waymo_trainer_run(waymo_corpus, tmp_path / "run", "cpu",
                                       overrides=WAYMO_SMALL)
    trainer = out["trainer"]
    assert trainer.device.type == "cpu" and trainer.cfg["name"] == "rv-waymo"
    assert trainer.cfg["dataset"]["_val_dataset"]["split_name"] == "train"
    assert trainer.cfg["model"]["batch_size"] == 2 and trainer.max_epochs == 1
    assert out["shards"] == 2 and out["shape"] == (8, 64, 6)
    assert out["layers"] == (8,) * 5 and np.isfinite(out["loss"])
    assert len(out["average"]) == 8 and all(np.isfinite(v) for v in out["average"].values())


def test_waymo_requests_and_clouds(waymo_corpus):
    """Phase 48's requests are ``WAYMO_USER_PAIRS`` of the padded sweeps;
    its clouds the corpus's returns with their row as the laser and the
    raw channels, zero-padded to the pair's larger count."""
    from range_view_3d_detection_torch.data.dataset import RangeViewDataset
    from range_view_3d_detection_torch.training.builders import build_dataset_config
    from range_view_3d_detection_torch.utils.config import compose
    from range_view_3d_detection_torch.utils.feather import read_feather

    cfg = compose(chip_smoke.REPO / "conf", "rv-waymo",
                  [f"++dataset.root_dir={waymo_corpus}",
                   "++dataset._val_dataset.split_name=train", *WAYMO_SMALL])
    ds = RangeViewDataset(build_dataset_config(cfg, "val"))
    requests = chip_smoke.corpus_requests(ds)
    assert len(requests) == 4 and [r[0].shape for r in requests] == [(2, 8, 64, 6)] * 4
    assert np.array_equal(requests[1][0][0], requests[0][0][1])
    assert np.array_equal(requests[3][2][1], ds[1]["mask"])
    sweeps = [read_feather(p) for p in
              sorted(waymo_corpus.rglob("sensors/range_view/*.feather"))]
    clouds = chip_smoke.corpus_clouds(waymo_corpus, ["elongation", "intensity"], height=8)
    xyz, laser, elong, inten = clouds[0]
    n = [int((c["range"] > 0).sum()) for c in sweeps]
    assert xyz.shape == (2, max(n), 3) and laser.shape == elong.shape == inten.shape == (2, max(n))
    valid = sweeps[1]["range"] > 0
    np.testing.assert_array_equal(xyz[1, :n[1], 0], sweeps[1]["x"][valid])
    np.testing.assert_array_equal(laser[1, :n[1]], (np.arange(8 * 58) // 58)[valid])
    np.testing.assert_array_equal(inten[1, :n[1]], sweeps[1]["intensity"][valid])
    short = int(np.argmin(n))
    assert not xyz[short, n[short]:].any() and laser.max() == 7


def test_bit_equal():
    a = torch.tensor([1.0, float("nan"), 0.0])
    assert chip_smoke.bit_equal(a, a.clone())
    assert not chip_smoke.bit_equal(a, torch.tensor([1.0, float("nan"), -0.0]))
    assert not chip_smoke.bit_equal(a, a.double())
    assert chip_smoke.bit_equal(a.bfloat16(), a.bfloat16())
    assert chip_smoke.bit_equal(torch.tensor([True, False]), torch.tensor([True, False]))


def test_waymo_oracle_gates_and_cuts():
    """The oracle runs ``WAYMO_ORACLE_EPOCHS`` (40) of the manual run's 250
    epochs and gates below the JAX package's own reading there (mAP_L2
    0.4111 without the penalty, the last-10 loss 0.655 of the first); the
    cut list names the epochs, the corpus and the requests."""
    assert chip_smoke.WAYMO_ORACLE_EPOCHS == 40
    assert 0.0 < chip_smoke.WAYMO_ORACLE_BAR < 0.4111
    assert 0.655 < chip_smoke.WAYMO_ORACLE_LOSS_SHARE < 1.0
    cuts = chip_smoke.waymo_user_cuts()
    assert "oracle: 40 epochs (320 steps) of the manual run's 250 (2000)" in cuts
    assert chip_smoke.waymo_user_cuts(20)[2].startswith("oracle: 20 epochs (160 steps)")
    assert any(c.startswith("corpus: phase 29's") for c in cuts)
    assert any("4 B=2 pairs" in c for c in cuts)


def test_convert_waymo_corpus_is_phase_29s(tmp_path):
    """Run alone, phase 48 converts phase 29's frames itself: one log of
    two sweeps, each of the sensor's size."""
    from range_view_3d_detection_torch.utils.feather import read_feather

    root = chip_smoke.convert_waymo_corpus(tmp_path / "sensor", height=8, width=58)
    sweeps = sorted((root / "train" / "segment-0" / "sensors" / "range_view").glob("*.feather"))
    assert len(sweeps) == 2 and len(read_feather(sweeps[0])["range"]) == 8 * 58


def test_waymo_user_subcommand(monkeypatch):
    """``chip_smoke.py waymo-user`` runs phase 48's entry point, which
    exits non-zero without a card."""
    called = []
    monkeypatch.setattr(chip_smoke, "waymo_user_main", lambda: called.append(48) or 48)
    assert chip_smoke.run(["waymo-user"]) == 48 and called == [48]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        assert chip_smoke.run(["waymo-user"]) == 1


# -- phase 49 -----------------------------------------------------------------


def test_check_k2_holds_nonfinite_values(monkeypatch):
    """K2's check takes the twin's infinities and NaNs where the kernel
    gives the same, and fails where a non-finite value differs (on the CPU
    the wrapper is the twin; the perturbed call stands for a kernel)."""
    from range_view_3d_detection_torch.kernels import nms as knms

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    case = chip_smoke.nms_edge_case("nonfinite_payload", 2, 100, torch.Generator().manual_seed(4),
                                    "cpu")
    assert chip_smoke.check_k2("nonfinite", case) < 1e-4
    plain = knms.nms_scan

    def inf_for_nan(*args, **kw):
        keep, merged = plain(*args, **kw)
        return keep, torch.where(merged.isnan(), float("inf"), merged)

    monkeypatch.setattr(knms, "nms_scan", inf_for_nan)
    with pytest.raises(RuntimeError, match="non-finite merged values differ"):
        chip_smoke.check_k2("nonfinite", case)


def test_published_user_cuts():
    """Phase 49's cut list names the corpora, the batches, the requests,
    AOT at B=2 and the min_confidence-0 request."""
    cuts = chip_smoke.published_user_cuts()
    assert cuts[0].startswith("corpora: phase 29's converted fixtures")
    assert any("B=4 for base-av2 and rv-av2-fast" in c and "B=2 for rv-nuscenes" in c
               for c in cuts)
    assert any(c.startswith(f"requests: {len(chip_smoke.USER_PAIRS)} B=2 pairs") for c in cuts)
    assert any(c.startswith("AOT: B=2 only, for base-av2 and rv-av2-fast") for c in cuts)
    assert chip_smoke.USER_AOT == ("base-av2", "rv-av2-fast")
    assert all(name in chip_smoke.PUBLISHED_USERS for name in chip_smoke.USER_AOT)
    assert any("min_confidence lowered to 0" in c for c in cuts)


@pytest.mark.parametrize("name", list(chip_smoke.PUBLISHED_USERS))
def test_published_users_shapes_are_the_configs(name):
    """Each config's requests in ``PUBLISHED_USERS`` are B=2 at its own
    served layout (``experiment_configs``), its corpus one of phase 29's,
    its train batch the published batch_size where the corpus holds it."""
    from range_view_3d_detection_torch.utils.config import compose

    corpus, split, shape, batch = chip_smoke.PUBLISHED_USERS[name]
    stride = 4 if name == "rv-av2-fast" else 1
    cfg, _, layout = chip_smoke.experiment_configs(name, stride)
    assert shape == (2, layout["height"], layout["width"], cfg.in_channels)
    assert corpus in chip_smoke.USER_CORPORA and split == ("val" if corpus == "av2" else "train")
    published = compose(chip_smoke.REPO / "conf", name)["model"]["batch_size"]
    assert batch == (published if corpus == "av2" else 2) and published == 4
    assert (cfg.stem_type == "META") == name.startswith("rv-")


@pytest.fixture(scope="module")
def user_corpora(tmp_path_factory):
    """Phase 49's corpora converted as ``chip_smoke.py users`` converts
    them, at small sensors."""
    return chip_smoke.convert_user_corpora(
        tmp_path_factory.mktemp("user_corpora"), av2_width=1000, nuscenes_width=248,
        waymo_size=(8, 58), points=4000)


def test_convert_user_corpora(user_corpora):
    """The AV2 corpus holds 4 train and 2 val sweeps, nuScenes and Waymo
    2 train sweeps each, at the sensors asked for; the raw logs are gone."""
    from range_view_3d_detection_torch.utils.feather import read_feather

    assert sorted(p.name for p in user_corpora.iterdir()) == sorted(chip_smoke.USER_CORPORA)
    for name, split, n, pixels in (("av2", "train", 4, 64 * 1000), ("av2", "val", 2, 64 * 1000),
                                   ("nuscenes", "train", 2, 32 * 248),
                                   ("waymo", "train", 2, 8 * 58)):
        sweeps = sorted((user_corpora / name / split).rglob("sensors/range_view/*.feather"))
        assert len(sweeps) == n and len(read_feather(sweeps[0])["range"]) == pixels, name


def test_fast_corpus_requests_at_x_stride_4(user_corpora):
    """Phase 49's rv-av2-fast requests: B=2 pairs of the val sweeps as the
    val split pads and strides them (1000 columns padded by 12 a side, every
    4th kept: 256), the second pair the first swapped."""
    from range_view_3d_detection_torch.data.dataset import RangeViewDataset, width_padding
    from range_view_3d_detection_torch.training.builders import build_dataset_config
    from range_view_3d_detection_torch.utils.config import compose

    cfg = compose(chip_smoke.REPO / "conf", "rv-av2-fast",
                  [f"++dataset.root_dir={user_corpora / 'av2'}",
                   "++dataset._train_dataset.range_view_config.width=1000"])
    val = build_dataset_config(cfg, "val")
    ds = RangeViewDataset(val)
    assert val.x_stride == 4 and width_padding(1000, 4) == 12
    requests = chip_smoke.corpus_requests(ds, chip_smoke.USER_PAIRS)
    assert len(requests) == 2 and [r[0].shape for r in requests] == [(2, 64, 256, 5)] * 2
    assert np.array_equal(requests[1][0][0], requests[0][0][1])
    assert np.array_equal(requests[0][1][0], ds[0]["cart"]) and requests[0][2].any()


def test_user_blocks_on_the_cpu(user_corpora, tmp_path):
    """Phase 49's train, predict and export blocks on the CPU at small
    widths: rv-av2-fast on the AV2 corpus, one step at B=4 with its
    checkpoint, finite AV2 averages; ``predict.main``'s shards byte-equal
    to the Trainer's; both artifacts with the val split's x_stride and
    padding, the published min_confidence."""
    small = ["++dataset._train_dataset.range_view_config.width=1000",
             "++model._backbone.layers=[8,8,8,8,8]", "++model._head.fpn={1: 16}",
             "++model._head.classification_head_channels=8",
             "++model._head.regression_head_channels=8",
             "++model._head.num_classification_blocks=1",
             "++model._head.num_regression_blocks=1", "++model.max_boxes=16",
             "++model.post_processing_config.nms_cap=128", "++model.precision=float32"]
    run = tmp_path / "run"
    out = chip_smoke.user_train("rv-av2-fast", user_corpora / "av2", run, batch=4,
                                pin_val=False, device="cpu", overrides=small)
    assert out["trainer"].device.type == "cpu" and out["shape"] == (64, 256, 5)
    assert out["shards"] == 2 and out["dataset"] == "av2" and np.isfinite(out["loss"])
    assert set(out["average"]) == {"AP", "ATE", "ASE", "AOE", "CDS"}
    pred = chip_smoke.user_predict(run, tmp_path / "pred", device="cpu")
    assert pred["shards"] == 2 and len(pred["rows"]) == 2
    ex = chip_smoke.user_export(run, tmp_path / "art", device="cpu")
    assert (ex["meta"]["x_stride"], ex["meta"]["padding_mode"]) == (4, "constant")
    assert ex["eval_shape"] == (64, 256)


def test_lowered_confidence_predictor_keeps_meta(tmp_path):
    """The min_confidence-0 predictor lowers the decoder in memory only:
    the artifact's ``meta.json`` is byte for byte as written, with the
    published 0.1."""
    import json

    from range_view_3d_detection_torch import export as texport
    from range_view_3d_detection_torch import serving
    from range_view_3d_detection_torch.models.decoder import DecoderConfig

    cfg = serving._flagship_config(tiny=True)
    model = serving.Predictor(cfg, DecoderConfig(), device="cpu").model
    texport.export_artifact(model, cfg, DecoderConfig(), tmp_path / "bf16")
    written = (tmp_path / "bf16" / "meta.json").read_bytes()
    predictor, published = chip_smoke.lowered_confidence_predictor(tmp_path / "bf16", "cpu")
    assert predictor.decoder_cfg.min_confidence == 0.0 and published.min_confidence == 0.1
    assert predictor.decoder_cfg == dataclasses.replace(published, min_confidence=0.0)
    assert (tmp_path / "bf16" / "meta.json").read_bytes() == written
    assert json.loads(written)["decoder_config"]["min_confidence"] == 0.1


def test_users_subcommand(monkeypatch):
    """``chip_smoke.py users`` runs phase 49's entry point, which exits
    non-zero without a card."""
    called = []
    monkeypatch.setattr(chip_smoke, "users_main", lambda: called.append(49) or 49)
    assert chip_smoke.run(["users"]) == 49 and called == [49]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        assert chip_smoke.run(["users"]) == 1


def test_config_bench_iters_take_the_bench_loop(monkeypatch):
    """Phases 45-47 run the bench's loop (``bench.measure``) on half its
    requests (``CONFIG_BENCH_ITERS`` inside ``bench_cut``): the warm-up, 12
    timed requests for frames/s, then ``latency_bench``'s two warm-ups and
    25; the bench's own counts are back after the block, and 12 is a
    multiple of its chunk."""
    from range_view_3d_detection_torch import bench, export

    calls = []

    def pipeline(*args):
        calls.append(args)
        return (torch.zeros(2),)

    pipeline.device = "cpu"

    def make_batch(seed):
        return (np.full((2, 1), seed, np.float32),)

    monkeypatch.setattr(export, "_device_name", lambda predict: "cpu")
    args = tuple(torch.as_tensor(a) for a in make_batch(0))
    saved = bench.ITERS, bench.LATENCY_ITERS
    with chip_smoke.bench_cut():
        fps, lat = bench.measure(pipeline, args, make_batch, 2)
    assert chip_smoke.CONFIG_BENCH_ITERS == dict(ITERS=12, LATENCY_ITERS=25)
    assert len(calls) == bench.WARMUP + 12 + 2 + 25 and fps > 0 and lat["iters"] == 25
    assert (bench.ITERS, bench.LATENCY_ITERS) == saved and 12 % bench.CHUNK == 0
