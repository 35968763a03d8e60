"""The four kernels at every dtype and shape their Pallas counterparts take,
on the CPU (the wrappers' plain twins; the card's kernels are held to the
same twins by ``chip_smoke.py``).

- K1's twin against the JAX Pallas kernel in interpret mode, in fp32 and
  bf16 at C = 8, 36, 48 and 288 (on and off the wgmma kernel's multiple
  of 8, and past 256): fp32 within atol = rtol = 1e-4 (fp32 sums
  in another order, as ``test_torch_stem.py``); bf16 within 2e-2 x
  max|ref|, the bound the card's kernel is held to (the two round the
  intermediate ``p`` to bf16 at the same point, and an fp32 difference of
  one ulp before that rounding flips a bf16 ulp).
- K4's twin against the Pallas kernel in interpret mode, with fp32 and
  bf16 ``g`` at C = 40 and 288: within 1e-4 x max|ref| (the int8 products
  are exact; an fp32 ulp of the dequantized neighbour sums). In bf16 the
  kernel's source rounds ``x0 = gs - g`` to bf16 (its dtype), as the twin
  and the card's kernel do, but XLA on the CPU keeps the fp32 difference
  there (its excess-precision rewrite of a bf16 subtract followed by an
  fp32 cast), which moves ``hq`` by a step wherever the rounding does; so
  the bf16 case draws ``g`` on the grid of 1/16 in [-4, 4], whose
  differences (at most 129 steps) bf16 holds exactly and on which the two
  conventions agree.
- K3's twin against the Pallas kernel in interpret mode at (Cin, Cout) =
  (8, 8), (24, 40) and (48, 24), strides 1 and 2, int8 input: bit for bit;
  and the wrapper's zero padding of Cin (what the card's launch adds)
  leaves the twin's result unchanged, bit for bit.
- K2's plain scan against the Pallas scan in interpret mode at payload
  widths P = 5 and 12: ``keep`` equal, ``merged`` within 1e-5.
- The served tiny config (widths 8) end to end against the JAX package:
  fp32 with ``stem_pallas`` (K1's twin against the Pallas kernel), heads
  within atol = rtol = 1e-4 and the NMS equal (``test_torch_detector.py::
  _check_nms``); bf16 with ``stem_pallas``, heads within 2^-5 x max|ref|
  and a relative RMS of 2^-6 (``test_served_path_tiny_bf16``'s bounds and
  reasons); int8 quantized from fp32 with the int8 stem (K4's twin against
  JAX's ``RV3D_STEM_INT8=1`` Pallas stem) and K3 at Cin = 8, on the JAX
  quant tree: heads within a relative RMS of 1e-3
  (``test_torch_quantized.py``'s bound).
- Each wrapper's launch plan (``k1_plan``, ``k4_plan``, ``k3_plan``,
  ``k2_plan``), a pure function of shape and dtype that the launch
  consumes (K1's other routes: ``test_torch_stem_tf32.py``): the shipped
  shapes keep their old instances (K1/K4 at C = 32,
  128 and 256 in bf16 on the wgmma kernel with no copy, every K3 shape of
  the flagship with no padding, K2's box payload on its own merge), and no
  shape or dtype the JAX kernels take is refused; and the stem wrappers'
  zero channels (``padded_operands``) leave the twins' outputs as they
  were.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.kernels import conv as tconv
from range_view_3d_detection_torch.kernels import nms as tnms
from range_view_3d_detection_torch.kernels import stem as tstem
from range_view_3d_detection_torch.models.detector import Detector as TDetector
from range_view_3d_detection_torch.transplant import load_flax_variables
from range_view_3d_detection_tpu.kernels.conv_pallas import conv3x3_i8_fused
from range_view_3d_detection_tpu.kernels.nms_pallas import nms_scan_pallas
from range_view_3d_detection_tpu.kernels.stem_pallas import (
    meta_kernel_fused,
    meta_kernel_fused_i8,
)
from range_view_3d_detection_tpu.models import quantized as jq
from range_view_3d_detection_tpu.models import stems as jstems
from range_view_3d_detection_tpu.models.detector import Detector
from test_torch_blocks import numpy_tree, randomize_bn
from test_torch_detector import _check_nms, _served_pair
from tools.export import fold_batch_norms as jax_fold

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _k1_inputs(C, seed):
    rng = np.random.default_rng(seed)
    return dict(
        g=rng.normal(size=(1, 3, 10, C)).astype(np.float32),
        feats=rng.normal(size=(1, 3, 10, C)).astype(np.float32),
        w1=(rng.normal(size=(C, C)) * C**-0.5).astype(np.float32),
        k=(rng.normal(size=(9, C, C)) * C**-0.5).astype(np.float32),
        a0=rng.uniform(0.5, 1.5, C).astype(np.float32),
        b0=rng.normal(size=C).astype(np.float32),
        a1=rng.uniform(0.5, 1.5, C).astype(np.float32),
        b1=rng.normal(size=C).astype(np.float32),
    )


@pytest.mark.parametrize("C", [8, 36, 48, 288])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k1_twin_matches_pallas_at_any_c(C, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _k1_inputs(C, seed=C)
    cast = ("g", "feats", "w1", "k")
    want = np.asarray(meta_kernel_fused(
        **{k: jnp.asarray(v, jdt) if k in cast else jnp.asarray(v) for k, v in x.items()},
        interpret=True,
    ))
    launches = tstem.meta_kernel_fused.launches
    got = tstem.meta_kernel_fused(**{
        k: torch.from_numpy(v).to(tdt) if k in cast else torch.from_numpy(v)
        for k, v in x.items()
    })
    assert tstem.meta_kernel_fused.launches == launches  # CPU: the twin
    assert got.dtype == torch.float32 and got.shape == want.shape
    if tdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-2 * np.abs(want).max(), rtol=0)


def _k4_inputs(C, seed, integral_g=False):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(1, 3, 10, C))
    if integral_g:
        g = rng.integers(-64, 65, size=g.shape) / 16.0
    return dict(
        g=g.astype(np.float32),
        feats=rng.normal(size=(1, 3, 10, C)).astype(np.float32),
        w1_i8=rng.integers(-127, 128, size=(C, C)).astype(np.int8),
        k_i8=rng.integers(-127, 128, size=(9, C, C)).astype(np.int8),
        a0=rng.uniform(15, 45, C).astype(np.float32),
        b0=(rng.normal(size=C) * 30).astype(np.float32),
        a1=(rng.uniform(0.5, 1.5, C) * 1e-3).astype(np.float32),
        b1=rng.normal(size=C).astype(np.float32),
        kdq=(rng.uniform(0.5, 1.5, (9, C)) * 1e-3).astype(np.float32),
    )


@pytest.mark.parametrize("C", [40, 288])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k4_twin_matches_pallas_at_any_c(C, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _k4_inputs(C, seed=C + 1, integral_g=tdt == torch.bfloat16)
    cast = ("g", "feats")
    want = np.asarray(meta_kernel_fused_i8(
        **{k: jnp.asarray(v, jdt) if k in cast else jnp.asarray(v) for k, v in x.items()},
        interpret=True,
    ))
    launches = tstem.meta_kernel_fused_i8.launches
    got = tstem.meta_kernel_fused_i8(**{
        k: torch.from_numpy(v).to(tdt) if k in cast else torch.from_numpy(v)
        for k, v in x.items()
    })
    assert tstem.meta_kernel_fused_i8.launches == launches  # CPU: the twin
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("stride_w", [1, 2])
@pytest.mark.parametrize("cin,cout", [(8, 8), (24, 40), (48, 24)])
def test_k3_twin_matches_pallas_at_any_channels(cin, cout, stride_w):
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.integers(-127, 128, size=(1, 3, 10, cin), dtype=np.int8)
    w = rng.integers(-127, 128, size=(9, cin, cout), dtype=np.int8)
    dq = rng.uniform(1e-3, 2e-2, size=(cout,)).astype(np.float32)
    want = np.asarray(conv3x3_i8_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(dq), stride_w=stride_w,
        out_dtype=jnp.float32, interpret=True,
    ))
    xt, wt, dqt = (torch.from_numpy(a) for a in (x, w, dq))
    launches = tconv.conv3x3_i8_fused.launches
    got = tconv.conv3x3_i8_fused(xt, wt, dqt, stride_w=stride_w, out_dtype=torch.float32)
    assert tconv.conv3x3_i8_fused.launches == launches  # CPU: the twin
    np.testing.assert_array_equal(got.numpy(), want)
    # The card's launch pads Cin with zero channels of x and of the taps.
    pad = tconv.k3_plan(cin, cout, stride_w, torch.int8, False).cin_pad
    assert (cin + pad) % 32 == 0
    padded = tconv.conv3x3_i8_fused_plain(
        torch.nn.functional.pad(xt, (0, pad)),
        torch.nn.functional.pad(wt.transpose(1, 2), (0, pad)).transpose(1, 2),
        dqt, stride_w=stride_w, out_dtype=torch.float32,
    )
    assert torch.equal(padded, got)


@pytest.mark.parametrize("P", [5, 12])
def test_k2_plain_scan_matches_pallas_at_any_payload(P):
    rng = np.random.default_rng(P)
    cap = 64
    xy = rng.uniform(-6, 6, (cap, 2))
    bev = np.concatenate(
        [xy, rng.uniform(2, 5, (cap, 1)), rng.uniform(1, 2.5, (cap, 1)),
         rng.uniform(-np.pi, np.pi, (cap, 1))], axis=-1).astype(np.float32)
    from range_view_3d_detection_tpu.ops import iou as jiou

    iou = np.array(jiou.iou_rotated_bev(jnp.asarray(bev), jnp.asarray(bev)))
    scores = np.sort(rng.uniform(0, 1, cap).astype(np.float32))[::-1].copy()
    valid = scores >= 0.1
    payload = rng.uniform(-40, 40, (cap, P)).astype(np.float32)
    for merge_threshold in (0.5, 1.01):
        kw = dict(iou_threshold=0.3, merge_threshold=merge_threshold)
        want_keep, want_merged = nms_scan_pallas(
            iou, scores, valid, payload, interpret=True, **kw)
        keep, merged = tnms.nms_scan(
            *(torch.from_numpy(a[None]) for a in (iou, scores, valid, payload)), **kw)
        assert merged.shape == (1, cap, P)
        assert 0 < int(keep.sum()) < int(valid.sum())
        np.testing.assert_array_equal(keep[0].numpy(), np.asarray(want_keep))
        np.testing.assert_allclose(merged[0].numpy(), np.asarray(want_merged), atol=1e-5)


def test_served_tiny_fp32_with_the_fused_stem():
    fused = dict(stem_pallas=True)
    out, tout, ref, got = _served_pair(
        dataclasses.replace(graft._flagship_config(tiny=True), **fused),
        dataclasses.replace(serving._flagship_config(tiny=True), **fused),
        2, 8, 64, seed=0,
    )
    assert jstems.LAST_STEM_PATH == "pallas_fp"
    for key in ("logits", "regressands"):
        want = np.asarray(out["head"][1][0][key])
        np.testing.assert_allclose(tout["head"][1][0][key].numpy(), want,
                                   atol=1e-4, rtol=1e-4)
    _check_nms(ref, got)


def test_served_tiny_bf16_with_the_fused_stem():
    bf16 = dict(dtype="bfloat16", stem_pallas=True)
    out, tout, _, got = _served_pair(
        dataclasses.replace(graft._flagship_config(tiny=True), **bf16),
        dataclasses.replace(serving._flagship_config(tiny=True), **bf16),
        2, 8, 64, seed=1,
    )
    assert jstems.LAST_STEM_PATH == "pallas_fp"
    for key in ("logits", "regressands"):
        want = np.asarray(out["head"][1][0][key], np.float32)
        have = tout["head"][1][0][key].float().numpy()
        np.testing.assert_allclose(have, want, atol=2.0**-5 * float(np.abs(want).max()),
                                   rtol=0)
        assert np.sqrt(np.mean((have - want) ** 2) / np.mean(want**2)) <= 2.0**-6
    assert int(got.keep.sum()) > 0


def test_served_tiny_int8_with_the_int8_stem(monkeypatch):
    """fp32 weights quantized with the int8 stem: K4's twin with fp32 ``g``
    at C = 8, and every 3x3 conv on K3's route at Cin = 8."""
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True), stem_pallas=True)
    tcfg = dataclasses.replace(serving._flagship_config(tiny=True), stem_pallas=True)
    B, H, W = 2, 8, 64
    feats, cart, _ = serving._sample_inputs(B, H, W, jcfg.in_channels, seed=3)
    mask = np.random.default_rng(4).uniform(size=(B, H, W)) < 0.3
    batch = (feats, cart, mask)
    model = Detector(jcfg)
    v = model.init(jax.random.PRNGKey(3), *batch, train=False)
    params, stats = randomize_bn(v["params"], v["batch_stats"], seed=5)
    folded = numpy_tree(jax_fold({"params": params, "batch_stats": stats}))
    qtree = jq.calibrate_scales(model, folded, [batch])
    monkeypatch.setenv("RV3D_STEM_INT8", "1")
    with jq.quantization("int8"):
        want = model.apply({**folded, "quant": qtree}, *batch, train=False)["head"][1][0]
    assert jstems.LAST_STEM_PATH == "pallas_int8"

    p = serving.Predictor(tcfg, device="cpu")
    load_flax_variables(p.model, params, stats)
    p.quantize(quant_tree=qtree, stem_int8=True)
    routes = {m.route for m in p.model.modules() if hasattr(m, "route")}
    assert "k3" in routes
    calls = []
    real_k3 = tconv.conv3x3_i8_fused

    def counting(x, *a, **kw):
        calls.append(x.shape[-1])
        return real_k3(x, *a, **kw)

    from range_view_3d_detection_torch.models import blocks, quantized, stems

    monkeypatch.setattr(blocks, "conv3x3_i8_fused", counting)
    monkeypatch.setattr(quantized, "conv3x3_i8_fused", counting)
    k4 = []
    monkeypatch.setattr(stems, "meta_kernel_fused_i8",
                        lambda g, *a: k4.append(g.dtype) or tstem.meta_kernel_fused_i8(g, *a))
    with torch.inference_mode():
        got = p.model(*(torch.from_numpy(a) for a in batch))["head"][1][0]
    assert k4 == [torch.float32] and 8 in calls
    for key in ("logits", "regressands"):
        w = np.asarray(want[key])
        rel_rms = np.sqrt(np.mean((got[key].numpy() - w) ** 2) / np.mean(w**2))
        assert rel_rms < 1e-3, (key, rel_rms)


SHIPPED_STEMS = (32, 128, 256)


@pytest.mark.parametrize("plan", [tstem.k1_plan, tstem.k4_plan], ids=["K1", "K4"])
def test_stem_plans_keep_the_shipped_instances_and_refuse_nothing(plan):
    multiple = 8 if plan is tstem.k1_plan else 16
    for C in SHIPPED_STEMS:
        assert plan(C, torch.bfloat16) == ("wgmma", 0)
    for C in range(1, 600):
        for dt in (torch.bfloat16, torch.float32):
            got = plan(C, dt)
            if dt == torch.bfloat16 and C <= 256:
                assert got.kernel == "wgmma"
                assert (C + got.pad) % multiple == 0 and 0 <= got.pad < multiple
                assert C + got.pad <= 256
            elif plan is tstem.k4_plan:  # fp32 to 256, and past 256: the output-tiled kernel
                assert got == ("wgmma_fp32" if C <= 256 else "wgmma_tiled", -C % 16)
            elif dt == torch.float32:  # K1: 3xTF32 on the register-A kernel
                assert got == ("tf32x3", -C % 16)
            else:  # K1: bf16 past 256 on the register-A kernel's output tiles
                assert got == ("wgmma_tiled", -C % 32)
    with pytest.raises(TypeError):
        plan(32, torch.float16)
    with pytest.raises(ValueError):
        plan(0, torch.float32)


@pytest.mark.parametrize("C", [12, 36, 100])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_stem_wrapper_padding_is_exact(kernel, C):
    """The zero channels the CUDA wrappers add (``padded_operands`` with
    the plan's pad) leave the twin's first C channels as they were: bit
    for bit for K4 (exact integer sums), within 1e-6 x max|ref| for K1 (its
    fp32 products over a longer K may sum in another order)."""
    rng = np.random.default_rng(C)
    B, H, W = 1, 3, 11
    plan = (tstem.k1_plan if kernel == "K1" else tstem.k4_plan)(C, torch.bfloat16)
    assert plan.kernel == "wgmma" and plan.pad > 0
    g = torch.from_numpy(rng.standard_normal((B, H, W, C), np.float32)).bfloat16()
    feats = torch.from_numpy(rng.standard_normal((B, H, W, C), np.float32)).bfloat16()
    vec = [torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)) for _ in range(4)]
    if kernel == "K1":
        w1 = torch.from_numpy(rng.standard_normal((C, C), np.float32) / C**0.5).bfloat16()
        k = torch.from_numpy(rng.standard_normal((9, C, C), np.float32) / C**0.5).bfloat16()
        args = (g, feats, w1, k, *vec)
        fn = tstem.meta_kernel_fused_plain
    else:
        w1 = torch.from_numpy(rng.integers(-127, 128, (C, C), np.int8))
        k = torch.from_numpy(rng.integers(-127, 128, (9, C, C), np.int8))
        kdq = torch.from_numpy(rng.uniform(1e-4, 1e-3, (9, C)).astype(np.float32))
        vec = [v * 4 for v in vec[:2]] + [v * 1e-3 for v in vec[2:]]
        args = (g, feats, w1, k, *vec, kdq)
        fn = tstem.meta_kernel_fused_i8_plain
    want = fn(*args)
    got = fn(*tstem.padded_operands(plan.pad, *args))
    assert got.shape[-1] == C + plan.pad and not got[..., C:].any()
    if kernel == "K4":
        assert torch.equal(got[..., :C], want)
    else:
        err = (got[..., :C] - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), err


def test_k3_plan_keeps_the_flagship_shapes_and_refuses_nothing():
    model = TDetector(serving._flagship_config(), device="cpu")
    shapes = {
        (m.in_channels, m.out_channels, m.stride[1])
        for m in model.modules()
        if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3) and m.stride[0] == 1
    }
    assert len(shapes) >= 4
    for cin, cout, stride in shapes:
        for dt, kind in ((torch.bfloat16, 1), (torch.float32, 2)):
            assert tconv.k3_plan(cin, cout, stride, dt, True) == (kind, 0)
        assert tconv.k3_plan(cin, cout, stride, torch.int8, False) == (0, 0)
    for cin in range(1, 70):
        for cout in (1, 5, 8, 24, 40, 129):
            for stride in (1, 2):
                plan = tconv.k3_plan(cin, cout, stride, torch.bfloat16, True)
                assert (cin + plan.cin_pad) % 32 == 0 and plan.cin_pad < 32
    with pytest.raises(ValueError):
        tconv.k3_plan(32, 32, 3, torch.int8, False)
    with pytest.raises(TypeError):
        tconv.k3_plan(32, 32, 1, torch.int8, True)


def test_k2_plan_keeps_the_box_payload_and_refuses_nothing():
    assert tnms.k2_plan(1024, tnms.PAYLOAD) == ("register", "p9")
    assert tnms.k2_plan(9216, tnms.PAYLOAD) == ("ahead", "p9")
    for P in range(1, 40):
        for cap in (1, 37, 4096, 4097):
            plan = tnms.k2_plan(cap, P)
            assert plan.merge == ("p9" if P == 9 else "passes")
    with pytest.raises(ValueError):
        tnms.k2_plan(1024, 0)
