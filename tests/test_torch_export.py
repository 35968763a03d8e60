"""The port's serving export (``range_view_3d_detection_torch/export.py``)
against ``tools/export.py``, on the CPU, on the tiny config (fp32) with
randomised BatchNorm statistics and each head's final conv scaled so that
NMS has real work (as ``tests/test_torch_quantized.py`` sets it up).

- ``fold_batch_norms`` equals ``tools/export.py``'s bit for bit, on the
  tree and through the port's model.
- An artifact written by either package loads in the other: the configs
  come back equal, and its detections equal the writer's own within the
  served-path tolerance of ``tests/test_torch_detector.py`` (``keep`` and
  categories equal, kept cuboids within 1e-3 m plus 1e-4 relative, scores
  within 1e-5); ``meta.json`` is the same JSON from both writers.
- The int8 artifact both ways: the reader's quant tree equals the
  written ``quant.msgpack`` bit for bit, the two packages' calibrations
  agree within ``tests/test_torch_quantized.py``'s rtol 2e-2, and the
  detections agree within its int8 tolerance (``keep`` equal, cuboids
  within 1e-3 m plus 1e-3 relative, scores within 1e-3).
- The dataset meta round-trips; ``make_points_predict`` equals rasterize
  then predict exactly, and JAX's points predict within the served-path
  tolerance; the benches print their JSON keys (the stream bench's chunk
  loop too); ``main`` takes every flag of ``tools/export.py`` plus
  ``--device``, exports and loads, ``--aot`` writes a program that serves
  and ``--bench --chunk 2`` prints its line; ``load_artifact_width_sharded``
  without a process group (one shard) serves as ``load_artifact``'s fp
  path does.
- The deployment modes (as ``tests/test_export.py:161``, ``:199`` and
  ``:364-405`` hold JAX's): width-sharded serving at 4 gloo ranks
  (``tests/test_torch_spatial.py``'s harness) keeps exactly the boxes
  plain serving keeps, the same on every rank; the chunked predict equals
  the per-call predict bit for bit; the AOT program (``export_aot``, then
  ``load_aot``) equals ``load_artifact``'s predict bit for bit, fp32
  and int8 alike, and loads in a process that imports only the
  kernels package.
- The bf16 artifact (ROADMAP Queue 3): a bf16 copy of the tiny config,
  one artifact served by both packages' ``load_artifact`` beside each
  package's unfolded forward. The port's folded detections match JAX's
  unfolded ones within ``test_served_path_tiny_bf16``'s kept-box match
  (JAX's own folded detections do not: at seeds 0 and 3 one kept box of
  an image lies 0.127 and 3.72 m from every unfolded one), and the port's
  folded-against-unfolded agreement (``chip_smoke.py``'s ``kept_match``,
  the card's metric) is no lower than JAX's own, nor is its agreement
  with JAX's folded detections. Seen (seeds 0-3): JAX 1.0, 1.0, 1.0,
  0.9942; the port 1.0 at each. At the
  flagship's widths on an 8x64 image (``python tests/test_torch_export.py
  fold-study flagship 0 1``, about 45 s a seed) JAX's own agreement
  drops as the port's does: JAX 0.9611 and 0.9817, the port 0.9494 and
  0.9862. The bf16 fold rounds differently from the unfolded BatchNorm in
  both packages; the card's 0.8006 at 64x1808 is that, not a port fault.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import export as texport
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.models.decoder import DecoderConfig as TDecoderConfig
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.data.dataset import AV2_FEATURES, width_padding
from range_view_3d_detection_tpu.models.decoder import DecoderConfig
from range_view_3d_detection_tpu.models.detector import Detector
from range_view_3d_detection_tpu.ops.projection import rasterize_points_jax
from test_torch_blocks import numpy_tree, randomize_bn
from tools import export as jexport

torch.set_num_threads(2)
B, H, W = 2, 8, 64
DEC = dict(nms_cap=128, num_post_nms=64)


@pytest.fixture(scope="module")
def tiny():
    cfg = graft._flagship_config(tiny=True)
    feats, cart, _ = serving._sample_inputs(B, H, W, cfg.in_channels, seed=0)
    mask = np.random.default_rng(1).uniform(size=(B, H, W)) < 0.3
    model = Detector(cfg)
    v = model.init(jax.random.PRNGKey(0), feats, cart, mask, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=2)
    first = model.apply({"params": params, "batch_stats": stats}, feats, cart, mask,
                        train=False)["head"][1][0]
    for name, sub in params["DetectionHead_0"].items():
        final = sub[f"ConvNormAct_{len(sub) - 1}"]["Conv_0"]
        key = "logits" if name.startswith("cls_") else "regressands"
        final["kernel"] *= (2.0 if key == "logits" else 0.3) / float(
            np.std(np.asarray(first[key])))
        final["bias"][:] = 0.0
        if key == "logits":
            final["bias"][0] = 2.0
        else:
            final["bias"][3:6] = np.log(8.0)
    return dict(cfg=cfg, batch=(feats, cart, mask),
                variables=numpy_tree({"params": params, "batch_stats": stats}))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _port_model(t):
    p = serving.Predictor(serving._flagship_config(tiny=True), device="cpu")
    v = t["variables"]
    load_flax_variables(p.model, v["params"], v["batch_stats"])
    return p.model


def test_fold_equals_tools_export(tiny, tmp_path):
    want = numpy_tree(jexport.fold_batch_norms(tiny["variables"]))
    _assert_trees_equal(texport.fold_batch_norms(tiny["variables"]), want)
    # Through the port's model: the artifact's variables, read by flax.
    import flax.serialization

    texport.export_artifact(_port_model(tiny), serving._flagship_config(tiny=True),
                            TDecoderConfig(**DEC), tmp_path / "art")
    got = flax.serialization.msgpack_restore(
        (tmp_path / "art" / "variables.msgpack").read_bytes())
    _assert_trees_equal(got, want)


def _check_served(got, want, int8=False):
    keep = np.asarray(want.keep)
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.categories.numpy(), np.asarray(want.categories))
    rtol, s_atol = (1e-3, 1e-3) if int8 else (1e-4, 1e-5)
    np.testing.assert_allclose(got.cuboids.numpy()[keep], np.asarray(want.cuboids)[keep],
                               atol=1e-3, rtol=rtol)
    np.testing.assert_allclose(got.scores.numpy()[keep], np.asarray(want.scores)[keep],
                               atol=s_atol)


def _write(writer, tiny, art, **kw):
    if writer == "jax":
        jexport.export_artifact(tiny["variables"], tiny["cfg"], DecoderConfig(**DEC), art,
                                **kw)
    else:
        texport.export_artifact(_port_model(tiny), serving._flagship_config(tiny=True),
                                TDecoderConfig(**DEC), art, **kw)


@pytest.fixture(scope="module")
def fp_artifacts(tiny, tmp_path_factory):
    """The fp artifact written by each package, and JAX's predict loaded
    from the port's (one JAX compile serves the tests below)."""
    base = tmp_path_factory.mktemp("fp")
    for writer in ("jax", "port"):
        _write(writer, tiny, base / writer)
    jpredict, jdet, jdec = jexport.load_artifact(base / "port", cache=False)
    assert jdet == tiny["cfg"] and jdec == DecoderConfig(**DEC)
    return dict(dirs={w: base / w for w in ("jax", "port")}, jpredict=jpredict)


def test_artifact_serves_in_both_packages(tiny, fp_artifacts):
    """Both writers give the same bytes, so JAX serving the port's artifact
    and the port serving JAX's are held against each other."""
    dirs = fp_artifacts["dirs"]
    for name in ("variables.msgpack", "meta.json"):
        assert (dirs["jax"] / name).read_bytes() == (dirs["port"] / name).read_bytes()
    tpredict, tdet, tdec = texport.load_artifact(dirs["jax"], device="cpu")
    assert tpredict.bn_folded and tpredict.quant_tree is None
    assert tdet == serving._flagship_config(tiny=True) and tdec == TDecoderConfig(**DEC)
    _check_served(tpredict(*tiny["batch"]), fp_artifacts["jpredict"](*tiny["batch"]))
    # use_nms=False gives the decoder's proposals.
    props, _, _ = texport.load_artifact(dirs["jax"], device="cpu", use_nms=False)
    proposals = props(*tiny["batch"])
    assert not hasattr(proposals, "keep") and proposals.scores.shape[0] == B


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_int8_artifact_serves_in_both_packages(tiny, tmp_path, writer, monkeypatch):
    import flax.serialization

    art = tmp_path / "art"
    _write(writer, tiny, art, quantize_batches=[tiny["batch"]],
           **({"device": "cpu"} if writer == "port" else {}))
    written = flax.serialization.msgpack_restore((art / "quant.msgpack").read_bytes())

    def fold_again(model):
        raise AssertionError("the artifact's BatchNorm was folded a second time")

    # The loaded weights are folded already: quantizing must not fold them.
    monkeypatch.setattr(serving, "fold_batch_norms", fold_again)
    tpredict, _, _ = texport.load_artifact(art, device="cpu")
    monkeypatch.undo()
    _assert_trees_equal(tpredict.quant_tree, written)
    assert tpredict.bn_folded
    # The stem kernel follows RV3D_STEM_INT8, as in the JAX package.
    assert tpredict.model.RangeNet_0.MetaKernel_0.i8_w1 is None
    monkeypatch.setenv("RV3D_STEM_INT8", "1")
    k4, _, _ = texport.load_artifact(art, device="cpu")
    assert k4.model.RangeNet_0.MetaKernel_0.i8_w1 is not None
    monkeypatch.delenv("RV3D_STEM_INT8")
    jpredict, _, _ = jexport.load_artifact(art, cache=False)
    _check_served(tpredict(*tiny["batch"]), jpredict(*tiny["batch"]), int8=True)
    # The other package's calibration of the same weights.
    other = tmp_path / "other"
    _write("port" if writer == "jax" else "jax", tiny, other,
           quantize_batches=[tiny["batch"]],
           **({"device": "cpu"} if writer == "jax" else {}))
    theirs = _flat(flax.serialization.msgpack_restore((other / "quant.msgpack").read_bytes()))
    ours = _flat(written)
    assert sorted(theirs) == sorted(ours)
    for k, v in ours.items():
        np.testing.assert_allclose(theirs[k], v, rtol=2e-2, err_msg=k)


def test_dataset_meta_round_trip(tiny, tmp_path):
    run_cfg = {"dataset": {
        "_train_dataset": {"range_view_config": {}},
        "_val_dataset": {
            "dataset_name": "av2", "x_stride": 2, "padding_mode": "constant",
            "range_view_config": {"height": 16, "width": 60,
                                  "feature_column_names": list(AV2_FEATURES)},
        },
    }}
    meta = texport._dataset_meta_from_cfg(run_cfg)
    assert meta == jexport._dataset_meta_from_cfg(run_cfg)
    assert texport._eval_shape(run_cfg) == jexport._eval_shape(run_cfg) == (16, 32)
    texport.export_artifact(_port_model(tiny), serving._flagship_config(tiny=True),
                            TDecoderConfig(**DEC), tmp_path / "art", dataset_meta=meta)
    on_disk = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert on_disk["dataset"] == meta


def test_points_predict(tiny, fp_artifacts):
    """The points path equals rasterize-then-predict exactly, and JAX's
    (``rasterize_points_jax`` vmapped, then its predict: what
    ``tools/export.py::make_points_predict`` composes) within the
    served-path tolerance."""
    W_sensor = 60
    pad = width_padding(W_sensor, 1)
    assert W_sensor + 2 * pad == W
    tpredict, _, _ = texport.load_artifact(fp_artifacts["dirs"]["port"], device="cpu")
    points_predict, extra = texport.make_points_predict(
        tpredict, sensor_width=W_sensor, height=H, feature_names=AV2_FEATURES)
    assert extra == ["intensity"]
    xyz, laser, inten = texport._sample_points(B, 1024, H, W_sensor, seed=3)
    for a, b in zip((xyz, laser, inten),
                    jexport._sample_points(B, 1024, H, W_sensor, seed=3)):
        np.testing.assert_array_equal(a, b)
    got = points_predict(xyz, laser, inten)
    inputs = points_predict.rasterize(xyz, laser, inten)
    for a, b in zip(got, tpredict(*inputs)):
        assert torch.equal(a, b)
    want = jax.vmap(lambda p, ln, i: rasterize_points_jax(
        p, ln, {"intensity": i}, height=H, width=W_sensor, feature_names=AV2_FEATURES,
        pad=pad))(xyz, laser, inten)
    for a, b in zip(inputs, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _check_served(got, fp_artifacts["jpredict"](*want))


def test_benches_print_their_keys(tiny, tmp_path, capsys):
    art = tmp_path / "art"
    _write("port", tiny, art)
    tpredict, _, _ = texport.load_artifact(art, device="cpu")
    kw = dict(batch=1, iters=3, H=H, W=W, C=5)
    stats = texport.latency_bench(tpredict, **kw)
    fps = texport.stream_bench(tpredict, **kw)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x[:1] == "{"]
    assert lines[0] == stats and lines[0]["device"] == "cpu"
    assert {"latency_ms_p50", "latency_ms_p90", "latency_ms_p99", "latency_ms_min",
            "batch", "iters"} <= set(stats)
    assert stats["latency_ms_min"] <= stats["latency_ms_p50"] <= stats["latency_ms_p99"]
    assert {"stream_frames_per_sec", "batch", "iters", "ms_per_batch"} <= set(lines[1])
    assert lines[1]["stream_frames_per_sec"] == round(fps, 2)
    fps = texport.stream_bench(tpredict, chunk=2, **kw)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert {"stream_frames_per_sec", "batch", "chunk", "iters", "ms_per_microbatch",
            "device"} <= set(line)
    assert line["chunk"] == 2 and line["stream_frames_per_sec"] == round(fps, 2)


# tools/export.py's flags (its main()).
JAX_FLAGS = {
    "run_dir", "out", "load", "synthetic", "bench", "aot", "batch", "chunk", "latency",
    "iters", "height", "width", "points", "num_points", "sensor_width", "padding_mode",
    "x_stride", "nms_cap", "quantize", "fp",
}


def test_main_takes_every_flag(tmp_path, capsys):
    assert {a.dest for a in texport._parser()._actions} - {"help"} == JAX_FLAGS | {"device"}

    art = tmp_path / "art"
    texport.main(["--synthetic", "--out", str(art), "--device", "cpu", "--height", "8",
                  "--width", "64", "--nms-cap", "64", "--quantize", "heads"])
    meta = json.loads((art / "meta.json").read_text())
    assert "dataset" not in meta and meta["decoder_config"]["nms_cap"] == 64
    capsys.readouterr()
    common = ["--load", str(art), "--device", "cpu", "--height", "8", "--width", "64",
              "--iters", "2", "--batch", "1"]
    stats = texport.main(common + ["--latency", "--fp"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == stats
    texport.main(common + ["--bench", "--points", "--num-points", "512",
                           "--sensor-width", "56", "--padding-mode", "constant",
                           "--x-stride", "1"])
    assert "stream_frames_per_sec" in json.loads(capsys.readouterr().out.splitlines()[-1])
    (aot,) = texport.main(common + ["--aot"])
    assert aot == art / "predict_b1.pt2" and callable(texport.load_aot(aot))
    capsys.readouterr()
    texport.main(common + ["--bench", "--chunk", "2"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["chunk"] == 2 and "ms_per_microbatch" in line
    # No process group: one width shard, fp (the artifact's int8 scales are
    # ignored). The flagship's stem takes the accumulate path there (K1 is
    # device-local) and K1 in plain serving, so the bf16 sums differ; the
    # tiny config is held to plain serving below.
    predict, place, det_cfg, dec_cfg = texport.load_artifact_width_sharded(
        art, None, circular=False, device="cpu")
    assert det_cfg == serving._flagship_config() and dec_cfg.nms_cap == 64
    batch = serving._sample_inputs(1, 8, 64, 5, seed=4)
    got = predict(*place(*batch))
    want = texport.load_artifact(art, quantized=False, device="cpu")[0](*batch)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(got, want))
    assert bool(torch.isfinite(got.cuboids).all())


# -- width sharding, the chunk loop, AOT -------------------------------------------


def test_width_sharded_serving_matches_plain(tiny, fp_artifacts, tmp_path):
    """Four gloo ranks each serve a quarter of the request's width; every
    rank returns plain serving's detections (``keep`` and categories
    equal, kept boxes within the served-path tolerance)."""
    from test_torch_spatial import launch

    art = fp_artifacts["dirs"]["port"]
    torch.save({"art": art, "request": tiny["batch"]}, tmp_path / "inputs.pt")
    ranks = launch("serve", tmp_path, 4)
    want, _, _ = texport.load_artifact(art, device="cpu")
    want = want(*tiny["batch"])
    assert 0 < want.keep.sum() < want.keep.numel()
    for rank in ranks:
        got = type(want)(*rank["result"])
        assert torch.equal(got.keep, want.keep) and torch.equal(got.categories,
                                                                 want.categories)
        keep = want.keep
        torch.testing.assert_close(got.cuboids[keep], want.cuboids[keep], rtol=1e-4,
                                   atol=1e-3)
        torch.testing.assert_close(got.scores[keep], want.scores[keep], rtol=0, atol=1e-5)
        for a, b in zip(rank["result"], ranks[0]["result"]):
            assert torch.equal(a, b)
        assert rank["exchanges"] > 0


def test_chunked_predict_matches_per_call(tiny, fp_artifacts):
    predict, _, _ = texport.load_artifact(fp_artifacts["dirs"]["port"], device="cpu")
    parts = [serving._sample_inputs(B, H, W, 5, seed=s) for s in range(3)]
    parts[0] = tiny["batch"]
    stacked = [np.stack([p[j] for p in parts]) for j in range(3)]
    got = texport.make_chunked_predict(predict, 3)(*stacked)
    assert got.keep.shape[0] == 3 and got.keep[0].sum() > 0
    for i, p in enumerate(parts):
        for a, b in zip(got, predict(*p)):
            assert torch.equal(a[i], b)
    with pytest.raises(ValueError, match="chunk"):
        texport.make_chunked_predict(predict, 2)(*stacked)


@pytest.mark.parametrize("int8", [False, True])
def test_aot_round_trip(tiny, tmp_path, int8):
    """``export_aot`` then ``load_aot`` equals ``load_artifact``'s predict
    bit for bit (the same kernels' plain twins, in the same order), and the
    program loads and serves in a process that imports only the kernels
    package."""
    import subprocess
    import sys

    art = tmp_path / "art"
    _write("port", tiny, art, **(dict(quantize_batches=[tiny["batch"]], device="cpu")
                                 if int8 else {}))
    path = texport.export_aot(art, batch=B, height=H, width=W, device="cpu")
    assert path == art / f"predict_b{B}.pt2"
    want = texport.load_artifact(art, device="cpu")[0](*tiny["batch"])
    assert want.keep.sum() > 0
    got = texport.load_aot(path, device="cpu" if int8 else None)(*tiny["batch"])
    assert type(got).__name__ == "NMSResult"
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if int8:
        return
    np.savez(tmp_path / "req.npz", *tiny["batch"])
    code = "\n".join([
        "import sys, numpy as np, torch",
        f"sys.path.insert(0, {str(texport.__file__.rsplit('/', 2)[0])!r})",
        "import range_view_3d_detection_torch.kernels",
        f"r = np.load({str(tmp_path / 'req.npz')!r})",
        "a = [torch.from_numpy(r[f'arr_{i}']) for i in range(3)]",
        "with torch.inference_mode():",
        f"    out = torch.export.load({str(path)!r}).module()(*a)",
        f"torch.save(tuple(out), {str(tmp_path / 'out.pt')!r})",
        "bad = [m for m in sys.modules if m.startswith(",
        "       ('range_view_3d_detection_torch.models', 'range_view_3d_detection_torch.export',",
        "        'range_view_3d_detection_torch.serving', 'jax'))]",
        "assert not bad, bad",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for a, b in zip(torch.load(tmp_path / "out.pt"), want):
        assert torch.equal(a, b)


# -- the bf16 artifact against the unfolded forward (ROADMAP Queue 3) --------


def bf16_fold_study(flagship: bool, seed: int, work):
    """One artifact of a bf16 config (the tiny one, or the flagship's
    widths on a B=2 8x64 image), its weights randomised as the served-path
    test sets them; each package's unfolded forward and its
    ``load_artifact`` of that artifact. Returns the four results and the
    kept-box agreements."""
    import dataclasses

    import jax.numpy as jnp

    import chip_smoke
    from range_view_3d_detection_tpu.models.decoder import decode
    from test_torch_detector import _served_pair

    bf = dict(dtype="bfloat16", stem_pallas=False)
    jcfg = dataclasses.replace(graft._flagship_config(tiny=not flagship), **bf)
    tcfg = dataclasses.replace(serving._flagship_config(tiny=not flagship), **bf)
    out, _, j_unf, t_unf, (params, stats), batch = _served_pair(
        jcfg, tcfg, B, H, W, seed, return_inputs=True)
    jexport.export_artifact(numpy_tree({"params": params, "batch_stats": stats}), jcfg,
                            DecoderConfig(), work)
    j_fold = jexport.load_artifact(work, cache=False)[0](*(jnp.asarray(a) for a in batch))
    t_fold = texport.load_artifact(work, device="cpu")[0](*batch)

    def host(r):
        return type("R", (), {k: torch.as_tensor(np.asarray(getattr(r, k)))
                              for k in ("keep", "cuboids", "categories")})

    km = chip_smoke.kept_match
    return dict(j_unf=j_unf, j_fold=j_fold, t_unf=t_unf, t_fold=t_fold,
                jax=km([host(j_fold)], [host(j_unf)]), port=km([t_fold], [t_unf]),
                cross=km([t_fold], [host(j_fold)]))


@pytest.mark.parametrize("seed", [0, 3])
def test_bf16_artifact_agrees_as_jax_does(seed, tmp_path):
    from test_torch_detector import _check_kept_boxes

    r = bf16_fold_study(False, seed, tmp_path / "art")
    _check_kept_boxes(r["j_unf"], r["t_fold"])
    assert r["port"] >= r["jax"], (r["port"], r["jax"])
    assert r["cross"] >= r["jax"], (r["cross"], r["jax"])


if __name__ == "__main__":
    import sys
    import tempfile
    from pathlib import Path

    if len(sys.argv) < 3 or sys.argv[1] != "fold-study":
        raise SystemExit("usage: python tests/test_torch_export.py fold-study tiny|flagship SEED...")
    jax.config.update("jax_platforms", "cpu")
    for seed in map(int, sys.argv[3:]):
        with tempfile.TemporaryDirectory() as d:
            r = bf16_fold_study(sys.argv[2] == "flagship", seed, Path(d) / "art")
        print(f"seed {seed}: kept-box agreement folded/unfolded JAX {r['jax']:.4f}, "
              f"port {r['port']:.4f}; port folded/JAX folded {r['cross']:.4f}", flush=True)
