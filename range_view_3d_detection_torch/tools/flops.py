"""FLOPs and bytes per pipeline stage, and speed-of-light times
(counterpart of the repo-root ``tools/flops.py``, which reads XLA's
``cost_analysis``):

    python -m range_view_3d_detection_torch.tools.flops [--height 64] [--width 1808] \\
        [--batch 1] [--train [--remat 1]] [--tiny] [--device cpu] \\
        [--peak-tflops 989] [--hbm-gbps 3350]

Each stage runs once on the device under two dispatch modes:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the convolutions
  and matrix products; elementwise ops count 0, where XLA counts them),
  with a formula registered for each of the four ``rv3d::`` kernels: K1
  and K4 two C x C GEMMs per neighbour and pixel, K3 a 3x3 conv, K2 0 (a
  scan). ``chip_smoke.py``'s ``k1_cost``, ``k4_cost`` and
  ``k3_shape_cost`` give the same counts.
- Bytes: :class:`ByteCounter` sums every op's operand and result bytes
  (views excepted), XLA's "bytes accessed" per HLO op: an unfused
  elementwise pass counts its full traffic.

Stages: stem, backbone, heads, forward, decode (no NMS), NMS (decode with
NMS less decode without), full (forward, decode and NMS); ``--train`` adds
one train step (forward, loss, backward, AdamW). The speed-of-light
defaults are the H100 SXM data sheet's dense bf16 989 TFLOP/s and HBM3
3.35 TB/s, labelled as such in the report.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.models.decoder import DecoderConfig, decode
from range_view_3d_detection_torch.tools import device_line
from range_view_3d_detection_torch.training.loop import resolve_device

DATASHEET = "H100 SXM data sheet (dense, not measured): bf16 989 TFLOP/s, HBM3 3.35 TB/s"
# Ops that allocate without reading or writing data.
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}


def k1_flops(B: int, H: int, W: int, C: int) -> int:
    """K1 and K4: two C x C GEMMs per neighbour (9) and pixel."""
    return 2 * B * H * W * 9 * 2 * C * C


def k3_flops(B: int, H: int, W_out: int, cin: int, cout: int) -> int:
    """K3: a 3x3 conv, ``W_out`` output columns."""
    return 2 * B * H * W_out * 9 * cin * cout


def register_kernel_formulas() -> None:
    """Register the ``rv3d::`` ops' FLOP formulas with the flop counter
    (once per process)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    import range_view_3d_detection_torch.kernels  # noqa: F401 (registers the ops)

    ops = torch.ops.rv3d
    if ops.meta_kernel_fused in flop_registry:
        return

    @register_flop_formula([ops.meta_kernel_fused, ops.meta_kernel_fused_i8])
    def _stem(g_shape, *args, out_shape=None, **kwargs):
        return k1_flops(*g_shape)

    @register_flop_formula(ops.conv3x3_i8)
    def _conv(x_shape, w_shape, *args, out_shape=None, **kwargs):
        B, H, _, cin = x_shape
        return k3_flops(B, H, out_shape[2], cin, w_shape[2])

    @register_flop_formula(ops.nms_scan)
    def _scan(*args, out_shape=None, **kwargs):
        return 0


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor operands and results:
    each input read once and each output written once, per op. Views and
    bare allocations move nothing and count 0."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.by_op: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if not _is_view(func) and name not in _ALLOCATIONS:
            n = sum(t.numel() * t.element_size()
                    for t in pytree.tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
            self.bytes += n
            self.by_op[str(func._overloadpacket)] += n
        return out


def stage_cost(fn, *args):
    """``(flops, bytes, result, flops by op)`` of one call of ``fn``."""
    register_kernel_formulas()
    flop_mode = FlopCounterMode(display=False)
    with flop_mode, ByteCounter() as counter:
        result = fn(*args)
    by_op = {str(k): int(v) for k, v in flop_mode.get_flop_counts().get("Global", {}).items()}
    return flop_mode.get_total_flops(), counter.bytes, result, by_op


def costs(cfg, B: int, H: int, W: int, device, *, dec_cfg=None, train=False,
          remat=False, seed=0) -> dict:
    """``{stage: (flops, bytes)}`` and the FLOPs of each ``rv3d::`` op a
    full request launches (``"kernels"``)."""
    from range_view_3d_detection_torch.models.detector import Detector

    dec_cfg = dec_cfg or DecoderConfig()
    model = Detector(cfg, device=device, generator=torch.Generator().manual_seed(seed)).eval()
    feats, cart, mask = (torch.as_tensor(a, device=device)
                         for a in serving._sample_inputs(B, H, W, cfg.in_channels))
    rows = {}
    rangenet = model.RangeNet_0
    with torch.inference_mode():
        nchw = feats.permute(0, 3, 1, 2).to(rangenet.dtype)
        stem = getattr(rangenet, "MetaKernel_0", None) or rangenet.BasicBlock_0
        stem_args = (nchw, cart) if stem is getattr(rangenet, "MetaKernel_0", None) else (nchw,)
        *rows["stem"], x, _ = stage_cost(stem, *stem_args)
        *rows["backbone"], ms, _ = stage_cost(rangenet.RangeBackbone_0, x)
        *rows["heads"], _, _ = stage_cost(model.DetectionHead_0, ms)
        *rows["forward"], out, _ = stage_cost(model, feats, cart, mask)
        tasks = cfg.tasks_dict
        *rows["decode"], _, _ = stage_cost(lambda o: decode(o, dec_cfg, tasks, use_nms=False), out)
        f_dn, b_dn, _, _ = stage_cost(lambda o: decode(o, dec_cfg, tasks, use_nms=True), out)
        rows["nms"] = [f_dn - rows["decode"][0], b_dn - rows["decode"][1]]
        f, b, _, by_op = stage_cost(
            lambda: decode(model(feats, cart, mask), dec_cfg, tasks, use_nms=True))
        rows["full"] = [f, b]
    kernels = {k.split(".")[-1]: v for k, v in by_op.items() if k.startswith("rv3d")}
    if train:
        from range_view_3d_detection_torch.training import optim
        from range_view_3d_detection_torch.training import state as state_lib

        train_cfg = dataclasses.replace(cfg, remat=bool(remat))
        batch = state_lib.batch_to_device(serving._dryrun_batch(train_cfg, B, H, W, 5), device)
        st = state_lib.create_state(train_cfg, optim.make_optimizer(1e-3, 100, debug=True)[0],
                                    device=device, generator=torch.Generator().manual_seed(seed))
        step = state_lib.make_train_step(train_cfg)
        f, b, _, _ = stage_cost(step, st, batch)
        rows["train_step"] = [f, b]
    return {"rows": {k: tuple(v) for k, v in rows.items()}, "kernels": kernels}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=1808)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--peak-tflops", type=float, default=989.0,
                    help="speed-of-light rate (default: the H100 SXM data sheet's dense bf16)")
    ap.add_argument("--hbm-gbps", type=float, default=3350.0,
                    help="speed-of-light memory rate (default: the H100 SXM data sheet's)")
    ap.add_argument("--tiny", action="store_true", help="the tiny config")
    ap.add_argument("--train", action="store_true", help="add one train step")
    ap.add_argument("--remat", type=int, default=0, help="train-step remat (1: every group)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = serving._flagship_config(tiny=args.tiny)
    dec_cfg = DecoderConfig(nms_cap=256) if args.tiny else DecoderConfig()
    B, H, W = args.batch, args.height, args.width
    out = costs(cfg, B, H, W, device, dec_cfg=dec_cfg, train=args.train, remat=args.remat)
    peak = args.peak_tflops * 1e3  # GFLOP/s
    bw = args.hbm_gbps  # GB/s
    default_rates = (args.peak_tflops, args.hbm_gbps) == (989.0, 3350.0)
    report = {
        "shape": [B, H, W, cfg.in_channels],
        "device": device_line(device),
        "speed_of_light": DATASHEET if default_rates
        else f"given: {args.peak_tflops} TFLOP/s, {args.hbm_gbps} GB/s",
        "kernel_gflop": {k: v / 1e9 for k, v in out["kernels"].items()},
    }
    for name, (f, b) in out["rows"].items():
        gf, gb = f / 1e9, b / 1e9
        report[name] = {
            "gflop": round(gf, 4),
            "gbytes": round(gb, 4),
            "sol_compute_ms": round(gf / peak * 1e3, 4),
            "sol_memory_ms": round(gb / bw * 1e3, 4),
            "arithmetic_intensity": round(gf / max(gb, 1e-9), 2),
        }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
