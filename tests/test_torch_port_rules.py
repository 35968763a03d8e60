"""Rules of the PyTorch port, checked on the CPU.

- Every port module, ``chip_smoke.py``, ``chip_probe_k1.py``,
  ``chip_probe_k4.py`` and ``chip_scaling.py`` import with JAX, flax, optax, orbax, the JAX
  package, ``tools/``, ``converters/``, pyarrow, PyYAML, matplotlib, polars, tensorboard,
  msgpack and ml_dtypes made unimportable (none of the last seven is on
  the machine with the card), and the training, data, evaluation,
  utility, projection, export and predict modules, the native library's
  binding, the LZ4 twin and the converters are among them; in
  that process ``rv-av2`` composes, a Feather file and a msgpack tree
  round-trip, a PNG is drawn and decoded, and the ``tensorboard`` logger
  backend raises. Width sharding (``parallel.spatial``), the result
  types (``results``), the bench, the dry run, the compiler-options and
  W&B utilities and every measurement tool (``tools.*``) are among the
  modules.
- Importing the port registers the four kernels as ``torch.library``
  custom ops (``rv3d::meta_kernel_fused``, ``rv3d::nms_scan``,
  ``rv3d::conv3x3_i8``, ``rv3d::meta_kernel_fused_i8``) and builds
  nothing: the kernels' library is not loaded, and each op runs its plain
  twin on CPU tensors.
- The training options that raised until the port had them, QAT
  (``make_train_step(quant_tree=...)``) and ``remat=True``, build and
  step (``test_unported_training_options_raise`` keeps its name; the
  options are held against JAX in ``test_torch_qat.py`` and
  ``test_torch_remat.py``); the ``parallel`` package is among the
  modules that import without JAX.
- Entry points default to the card: on a host without a CUDA device,
  ``Predictor`` and ``Trainer`` with their default device, ``python
  chip_smoke.py``, ``python chip_scaling.py`` and ``python -m
  range_view_3d_detection_torch.bench`` fail loudly (the bench naming
  the missing device) instead of running on the CPU.
- The flax -> torch transplant round-trips every leaf of the tiny
  config's variables, and loads strictly into the port's Detector; a JAX
  quant tree round-trips through the scales of the quantized port model.
"""

from __future__ import annotations

import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import range_view_3d_detection_torch
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.transplant import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from range_view_3d_detection_tpu.models.detector import Detector
from test_torch_blocks import numpy_tree, randomize_bn

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    pkg = range_view_3d_detection_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    modules = _port_modules()
    assert "range_view_3d_detection_torch.kernels.stem" in modules
    assert "range_view_3d_detection_torch.kernels.conv" in modules
    assert "range_view_3d_detection_torch.models.quantized" in modules
    assert "range_view_3d_detection_torch.parallel.mesh" in modules
    assert "range_view_3d_detection_torch.parallel.spatial" in modules
    assert "range_view_3d_detection_torch.results" in modules
    for name in ("geometry", "targets", "assignment", "losses"):
        assert f"range_view_3d_detection_torch.ops.{name}" in modules
    for name in ("optim", "state", "checkpoints", "builders", "loop"):
        assert f"range_view_3d_detection_torch.training.{name}" in modules
    for name in ("data.dataset", "data.augmentations", "data.synthetic",
                 "evaluation.av2_eval", "evaluation.waymo_eval", "evaluation.iou_np",
                 "evaluation.roi", "utils.config", "utils.yaml_subset", "utils.feather",
                 "utils.logging", "utils.rendering", "train", "evaluate", "overfit",
                 "ops.projection", "ops.index", "ops.sorting", "utils.msgpack",
                 "data.database", "export", "predict", "data.native_io", "utils.lz4",
                 "converters.av2.row_mappings", "converters.av2.log_corrections",
                 "converters.av2.export", "converters.nuscenes.export",
                 "converters.waymo.range_image", "converters.waymo.camera",
                 "converters.waymo.export", "converters.waymo.metadata", "bench", "dryrun",
                 "utils.compile_opts", "utils.wandb", "tools", "tools.benchmark",
                 "tools.profile_trace", "tools.profile_forward", "tools.profile_train",
                 "tools.remat_grid", "tools.flops", "tools.quant_accuracy",
                 "tools.quant_cert_scale", "tools.scale_drill"):
        assert f"range_view_3d_detection_torch.{name}" in modules
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "range_view_3d_detection_tpu",
              "pyarrow", "yaml", "matplotlib", "polars", "tensorboard", "msgpack",
              "ml_dtypes", "tools", "converters")
    code = "\n".join(
        [
            "import importlib, sys, tempfile",
            "from pathlib import Path",
            f"for banned in {banned!r}:",
            "    sys.modules[banned] = None",
            f"sys.path.insert(0, {str(REPO)!r})",
            f"for name in {modules!r}:",
            "    importlib.import_module(name)",
            "import chip_smoke, chip_probe_k1, chip_probe_k4, chip_scaling",
            "import torch",
            "from range_view_3d_detection_torch.kernels import _build",
            "for op in ('meta_kernel_fused', 'nms_scan', 'conv3x3_i8', "
            "'meta_kernel_fused_i8'):",
            "    assert hasattr(torch.ops.rv3d, op), op",
            "assert _build.library.cache_info().currsize == 0",
            "import numpy as np",
            "from range_view_3d_detection_torch.utils import config, feather, rendering",
            f"cfg = config.compose({str(REPO / 'conf')!r}, 'rv-av2')",
            "assert cfg['model']['_backbone']['stem_pallas'] is True",
            "d = Path(tempfile.mkdtemp())",
            "cols = {'x': np.arange(3.0), 'c': np.asarray(['a', 'b', 'c'])}",
            "feather.write_feather(d / 'a.feather', cols)",
            "back = feather.read_feather(d / 'a.feather')",
            "assert list(back['c']) == ['a', 'b', 'c'] and back['x'].tolist() == [0, 1, 2]",
            "img = rendering.draw_bev(np.zeros((4, 2)), np.ones((1, 7)), np.ones((1, 7)),",
            "                         out_path=d / 'bev.png')",
            "assert (rendering.read_png(d / 'bev.png') == img).all()",
            "from range_view_3d_detection_torch.utils import msgpack",
            "tree = {'b': np.arange(3, dtype=np.int8), 'a': {'s': np.float32(2.5)}}",
            "back = msgpack.msgpack_restore(msgpack.msgpack_serialize(tree))",
            "assert back['b'].tolist() == [0, 1, 2] and back['a']['s'] == 2.5",
            "from range_view_3d_detection_torch.utils.logging import MetricsLogger",
            "try:",
            "    MetricsLogger(d, backend='tensorboard')",
            "    raise AssertionError('tensorboard backend without tensorboard')",
            "except RuntimeError as exc:",
            "    assert 'tensorboard' in str(exc)",
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{banned!r} and sys.modules[m] is not None]",
            "assert not bad, bad",
            "print('ok')",
        ]
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=REPO,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_entry_points_refuse_a_host_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Predictor(serving._flagship_config(tiny=True))
    from range_view_3d_detection_torch.training.loop import Trainer
    from range_view_3d_detection_torch.utils.config import compose

    cfg = compose(REPO / "conf", "rv-synthetic", [f"++run_dir={tmp_path / 'run'}",
                                                  f"++dataset.root_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    smoke = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert smoke.returncode != 0
    assert '"ok": true' not in smoke.stdout
    # Alone in a directory, without the port, it fails too.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    alone = subprocess.run(
        [sys.executable, str(lone)], capture_output=True, text=True, timeout=120,
        cwd=tmp_path,
    )
    assert alone.returncode != 0 and '"ok": true' not in alone.stdout
    scaling = subprocess.run(
        [sys.executable, str(REPO / "chip_scaling.py")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert scaling.returncode != 0 and "two or more CUDA devices" in scaling.stderr
    bench = subprocess.run(
        [sys.executable, "-m", "range_view_3d_detection_torch.bench"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert bench.returncode != 0 and "no CUDA device" in bench.stderr
    assert '"metric"' not in bench.stdout


def test_transplant_round_trips_tiny_tree():
    cfg = graft._flagship_config(tiny=True)
    feats, cart, mask = serving._sample_inputs(1, 4, 32, cfg.in_channels)
    v = Detector(cfg).init(jax.random.PRNGKey(0), feats, cart, mask, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=1)

    model = serving.Predictor(
        serving._flagship_config(tiny=True), device="cpu"
    ).model
    model.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    back_params, back_stats = state_dict_to_flax(model.state_dict())

    for want, got in ((params, back_params), (stats, back_stats)):
        want_leaves = jax.tree_util.tree_leaves_with_path(numpy_tree(want))
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(want_leaves) == len(got_leaves)
        for path, leaf in want_leaves:
            np.testing.assert_array_equal(got_leaves[path], leaf, err_msg=str(path))


def test_jax_quant_tree_round_trips_through_the_port():
    from range_view_3d_detection_torch.models.quantized import (
        fold_batch_norms,
        quant_tree_of,
        quantize_model,
    )
    from range_view_3d_detection_tpu.models.quantized import calibrate_scales
    from tools.export import fold_batch_norms as jax_fold

    cfg = graft._flagship_config(tiny=True)
    batch = serving._sample_inputs(1, 4, 32, cfg.in_channels)
    jx = Detector(cfg)
    v = jx.init(jax.random.PRNGKey(0), *batch, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=1)
    folded = jax_fold({"params": params, "batch_stats": stats})
    qtree = calibrate_scales(jx, folded, [batch])

    model = serving.Predictor(serving._flagship_config(tiny=True), device="cpu").model
    model.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    fold_batch_norms(model)
    keys = set(model.state_dict())
    quantize_model(model, qtree)
    assert set(model.state_dict()) == keys  # int8 operands are not state
    want = dict(jax.tree_util.tree_leaves_with_path(numpy_tree(qtree)))
    got = dict(jax.tree_util.tree_leaves_with_path(quant_tree_of(model)))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_unported_training_options_raise():
    """Once refused, now ported: a QAT step and a remat step build and
    step to finite losses."""
    import dataclasses

    from range_view_3d_detection_torch.training import optim as toptim
    from range_view_3d_detection_torch.training import state as tstate

    cfg = serving._flagship_config(tiny=True)
    batch = serving._dryrun_batch(cfg, 2, 8, 64, 5, seed=1)
    qtree = {"RangeNet_0": {"RangeBackbone_0": {"ResidualBlock_0": {"BasicBlock_0": {
        "ConvNormAct_0": {"in_scale": np.float32(0.05)}}}}}}
    for c, tree in ((cfg, qtree), (dataclasses.replace(cfg, remat=True), None)):
        st = tstate.create_state(c, toptim.make_optimizer(1e-3, 20)[0], device="cpu")
        st, m = tstate.make_train_step(c, quant_tree=tree)(st, batch)
        assert st.step == 1 and bool(torch.isfinite(m["loss"]))


def test_custom_ops_run_their_twins_on_the_cpu():
    """Each ``rv3d::`` op on CPU tensors is its plain twin, without a build."""
    from range_view_3d_detection_torch.kernels import _build, conv, nms, stem

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    g, f = t(1, 3, 5, 32), t(1, 3, 5, 32)
    w1, k, a = t(32, 32), t(9, 32, 32), t(32)
    assert torch.equal(torch.ops.rv3d.meta_kernel_fused(g, f, w1, k, a, a, a, a),
                       stem.meta_kernel_fused_plain(g, f, w1, k, a, a, a, a))
    w1q, kq = w1.clamp(-1, 1).mul(100).to(torch.int8), k.clamp(-1, 1).mul(100).to(torch.int8)
    kdq = t(9, 32).abs()
    assert torch.equal(
        torch.ops.rv3d.meta_kernel_fused_i8(g, f, w1q, kq, a, a, a, a, kdq),
        stem.meta_kernel_fused_i8_plain(g, f, w1q, kq, a, a, a, a, kdq))
    x = t(1, 3, 6, 32)
    scale = torch.tensor(0.02)
    got = torch.ops.rv3d.conv3x3_i8(x, kq, kdq[0], scale, 2, torch.bfloat16)
    want = conv.conv3x3_i8_fused_plain(x, kq, kdq[0], stride_w=2, in_scale=scale)
    assert torch.equal(got, want) and got.shape == (1, 3, 3, 32)
    iou = t(2, 37, 37).abs().clamp_max(1)
    scores, valid, payload = t(2, 37).sort(descending=True)[0], torch.ones(2, 37, dtype=torch.bool), t(2, 37, 9)
    keep, merged = torch.ops.rv3d.nms_scan(iou, scores, valid, payload, 0.3, 0.5)
    want = nms.nms_scan_plain(iou, scores, valid, payload, iou_threshold=0.3,
                              merge_threshold=0.5)
    assert torch.equal(keep, want[0]) and torch.equal(merged, want[1])
    assert _build.library.cache_info().currsize == 0
