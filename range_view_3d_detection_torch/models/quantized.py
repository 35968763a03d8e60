"""Post-training int8 quantization of the serving forward (PTQ).

Counterpart of the JAX ``models/quantized.py`` (``Int8Conv``,
``calibrate_scales``, ``filter_scope``) and of ``tools/export.py::
fold_batch_norms``. The pipeline, as the JAX package's serving point runs
it: fold the BatchNorm statistics, calibrate one activation scale per
quantizable block on a few batches, then quantize:

- every BN-bearing ``ConvNormAct`` and every ``TorchConvTranspose`` whose
  scope carries an ``in_scale`` quantizes its input per tensor and its
  weight per output channel to symmetric int8, accumulates in int32 and
  dequantizes into the unchanged BatchNorm epilogue;
- the MetaKernel stem takes the int8 kernel (K4) when asked
  (``stem_int8=True``) and its two scales exist; else it stays on K1.

Scales live in a nested dict with the layout of the JAX ``quant``
collection (``RangeNet_0/.../ConvNormAct_0/in_scale``,
``.../MetaKernel_0/stem_hh_scale``), so a JAX quant tree (numpy) loads
unchanged. Weights are quantized once, in :func:`quantize_model`, into
non-persistent buffers: the ``state_dict`` keeps its fp layout.

QAT (the JAX ``fake_quant``/``QATConv`` and the "qat" context):
:func:`qat` sets each scale-bearing block's ``qat_scale`` from a quant
tree for the length of a train step, and the block then runs
:func:`qat_conv`, an fp32 conv of STE fake-quantized operands whose
forward is the int8 serving value up to fp32 rounding. The MetaKernel
stem has no QAT branch, as in JAX.

Routing is by shape only (:class:`Int8Conv`): a 3x3 'same' conv with
height stride 1, width stride 1 or 2 and no bias runs the int8 conv
kernel (K3, ``kernels/conv.py``), which takes the activation and
``in_scale`` and quantizes while it stages the input
(``quantize_to_int8``, the JAX package's formula); an unpadded 1x1 conv
quantizes in torch ops and is a plain int8 matrix product
(``torch._int_mm`` on the card, an exact fp64 product on the CPU); every
other shape (any kernel, stride, padding, bias, and the zero-inserted
input of a transposed conv) is that product over an int8 im2col
(:func:`int8_conv_nhwc`). The JAX package leaves all but K3's shapes to
XLA's ``conv_general_dilated``; integer sums are exact, so each route
equals it bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from range_view_3d_detection_torch.kernels.conv import (
    INT8_MAX,
    conv3x3_i8_fused,
    quantize_to_int8,
)

BN_EPS = 1e-5  # flax BatchNorm epsilon, used across the model


def weight_scale_per_channel(w: torch.Tensor, out_dim: int = 0) -> torch.Tensor:
    """Symmetric int8 scale per output channel: ``max(max|w| / 127, 1e-12)``
    over every dimension but ``out_dim`` (fp32)."""
    w = w.float()
    dims = tuple(d for d in range(w.dim()) if d != out_dim)
    return torch.clamp(w.abs().amax(dim=dims) / INT8_MAX, min=1e-12)


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator: the forward
    value is ``clip(round(x / scale), ±127) * scale`` (``torch.round`` is
    half to even, as ``jnp.round``), the gradient passes unchanged."""
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX) * scale
    return x + (q - x).detach()


def qat_conv(
    conv: Callable, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
    in_scale: torch.Tensor, out_dim: int, **kw,
) -> torch.Tensor:
    """``conv`` (``F.conv2d`` or ``F.conv_transpose2d``) in fp32 on the
    fake-quantized input (the frozen per-tensor ``in_scale``) and weight
    (per output channel ``out_dim`` from the live weight, gradient
    stopped), plus the fp32 bias: the JAX ``QATConv``. The result is fp32.

    TF32 is off for this conv's forward only: ``round(x / s) * s`` carries
    a full fp32 mantissa, which TF32's 10-bit operands would round, so
    the forward would no longer be the int8 serving value.
    """
    w = weight.float()
    w_scale = weight_scale_per_channel(w.detach(), out_dim)
    shape = [1] * w.dim()
    shape[out_dim] = -1
    w_fq = fake_quant(w, w_scale.reshape(shape))
    x_fq = fake_quant(x.float(), in_scale)
    b = None if bias is None else bias.float()
    if x.device.type != "cuda":
        return conv(x_fq, w_fq, b, **kw)
    cudnn = torch.backends.cudnn
    allow_tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        return conv(x_fq, w_fq, b, **kw)
    finally:
        cudnn.allow_tf32 = allow_tf32


@contextlib.contextmanager
def qat(model: nn.Module, quant_tree: Mapping[str, Any] | None) -> Iterator[None]:
    """Run ``model`` under QAT for the length of the block: every block
    whose scope in ``quant_tree`` (JAX layout) carries an ``in_scale``
    takes it as its frozen activation scale; the stem's scales are not
    used (the JAX stem has no QAT branch). ``None`` is a no-op."""
    if quant_tree is None:
        yield
        return
    device = next(model.parameters()).device
    blocks = []
    for mods, leaf, value in _scale_leaves(quant_tree):
        if leaf == "in_scale":
            module = model.get_submodule(".".join(mods))
            module.set_qat(torch.tensor(value, dtype=torch.float32, device=device))
            blocks.append(module)
    try:
        yield
    finally:
        for module in blocks:
            module.set_qat(None)


def int8_matmul(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ w_nk.T`` of int8 operands as fp32 (int32 then f32).

    ``a`` is (M, K) int8 and ``w_nk`` (N, K) int8 with K and N multiples
    of 8 (the caller zero-pads). The card runs ``torch._int_mm`` (int32
    accumulate); the CPU an fp64 product, exact below 2**53. Either sum is
    converted to fp32 once, rounding to nearest.
    """
    if a.device.type == "cuda":
        m = a.shape[0]
        if m <= 16:  # _int_mm takes M > 16
            a = F.pad(a, (0, 0, 0, 17 - m))
        return torch._int_mm(a, w_nk.t())[:m].float()
    return (a.double() @ w_nk.double().t()).float()


# Bytes of int8 im2col a block of output rows may take (the rest of a
# request's activations fit beside it on the card).
IM2COL_BYTES = 1 << 29


def weight_rows_i8(w_hwio: torch.Tensor) -> torch.Tensor:
    """(kh, kw, ci, co) int8 -> the (co, kh*kw*ci) rows of
    :func:`int8_conv_nhwc`, ci zero-padded to a multiple of 8 and co to a
    multiple of 8 (``_int_mm``'s K and N)."""
    kh, kw, ci, co = w_hwio.shape
    w = F.pad(w_hwio, (0, -co % 8, 0, -ci % 8))  # (kh, kw, ci8, co8)
    return w.permute(3, 0, 1, 2).reshape(w.shape[3], -1).contiguous()


def _dilate_pad(xq: torch.Tensor, dilation, padding, cpad: int) -> torch.Tensor:
    """NHWC ``xq`` with ``dilation - 1`` zeros between pixels (the
    transposed conv's input dilation), ``padding`` ((top, bottom), (left,
    right)) zeros around (a negative one crops) and ``cpad`` zero
    channels: XLA's ``lhs_dilation`` and ``padding`` on int8 operands."""
    (dh, dw), ((pt, pb), (pl, pr)) = dilation, padding
    if (dh, dw) == (1, 1) and min(pt, pb, pl, pr) >= 0:
        return F.pad(xq, (0, cpad, pl, pr, pt, pb)) if cpad or pt or pb or pl or pr else xq
    B, H, W, C = xq.shape
    Hd, Wd = (H - 1) * dh + 1, (W - 1) * dw + 1
    top, left = max(pt, 0), max(pl, 0)
    xp = xq.new_zeros((B, top + Hd + max(pb, 0), left + Wd + max(pr, 0), C + cpad))
    xp[:, top : top + Hd : dh, left : left + Wd : dw, :C] = xq
    return xp[:, max(-pt, 0) : xp.shape[1] - max(-pb, 0),
              max(-pl, 0) : xp.shape[2] - max(-pr, 0)]


def int8_conv_nhwc(
    xq: torch.Tensor, w_rows: torch.Tensor, cout: int, kernel, stride, padding,
    dq: torch.Tensor, bias: torch.Tensor | None, out_dtype: torch.dtype,
    dilation=(1, 1),
) -> torch.Tensor:
    """int8 conv of any shape as int8 matrix products: XLA's
    ``conv_general_dilated(xq, w, stride, padding, lhs_dilation=dilation,
    preferred_element_type=int32)``, dequantized with ``acc.float() * dq``,
    plus the fp32 ``bias``, cast to ``out_dtype`` (the JAX ``Int8Conv``'s
    order).

    ``xq`` (B, H, W, C) int8; ``w_rows`` from :func:`weight_rows_i8`. The
    im2col of the dilated, padded input has columns in (dy, dx, c) order,
    the weight rows'; it is copied from one strided view a block of output
    rows (at most :data:`IM2COL_BYTES` of it at a time), 8 channels to an
    int64 word (C is padded to a multiple of 8), and multiplied by
    :func:`int8_matmul`. Returns (B, Ho, Wo, cout).
    """
    (kh, kw), (sh, sw) = kernel, stride
    xp = _dilate_pad(xq, dilation, padding, w_rows.shape[1] // (kh * kw) - xq.shape[3])
    B, Hp, Wp, C = xp.shape
    Ho, Wo = (Hp - kh) // sh + 1, (Wp - kw) // sw + 1
    words = xp.contiguous().view(torch.int64)  # (B, Hp, Wp, C // 8)
    s = words.stride()
    rows = max(1, min(Ho, IM2COL_BYTES // (B * Wo * kh * kw * C)))
    out = None
    for r0 in range(0, Ho, rows):
        n = min(rows, Ho - r0)
        cols = words[:, r0 * sh :].as_strided(
            (B, n, Wo, kh, kw, C // 8), (s[0], sh * s[1], sw * s[2], s[1], s[2], s[3])
        )
        a = cols.reshape(B * n * Wo, kh * kw * C // 8).contiguous()
        if a.stride(1) != 1:  # one word a row: its stride may be any
            a = a.as_strided(a.shape, (a.shape[1], 1))
        a = a.view(torch.int8)
        y = int8_matmul(a, w_rows)[:, :cout] * dq
        if bias is not None:
            y = y + bias
        y = y.to(out_dtype).reshape(B, n, Wo, cout)
        if n == Ho:
            return y
        if out is None:
            out = y.new_empty((B, Ho, Wo, cout))
        out[:, r0 : r0 + n] = y
    return out


class Int8Conv(nn.Module):
    """Int8 twin of a ``ConvNormAct``'s ``Conv_0``, built from its weights.

    Per output channel ``w_scale = max(max|w| / 127, 1e-12)`` over
    (I, kh, kw) and ``w_i8 = clip(round(w / w_scale), ±127)``; the input is
    quantized per tensor with ``in_scale``; the int32 sum is dequantized
    with ``acc.float() * (in_scale * w_scale)``, the bias (if any) added in
    fp32, and the result cast to ``dtype``. All tensors are non-persistent
    buffers.

    ``padding`` ((top, bottom), (left, right)) defaults to the conv's own
    symmetric padding; the block passes its asymmetric one for an even
    kernel. ``route`` names what the conv runs: ``"k3"`` (K3: a 3x3 conv
    padded 1 a side, height stride 1, width stride 1 or 2, no bias),
    ``"matmul"`` (an unpadded 1x1 conv, one product of the strided view)
    or ``"general"`` (any other shape, :func:`int8_conv_nhwc`). A call
    with another padding (a width-sharded shard's, padded 0 in width)
    takes the general route.
    """

    def __init__(self, conv: nn.Conv2d, in_scale, dtype: torch.dtype, padding=None):
        super().__init__()
        kh, kw = conv.kernel_size
        sh, sw = conv.stride
        self.dtype = dtype
        self.kernel_size = (kh, kw)
        self.stride = (sh, sw)
        if padding is None:
            padding = tuple((p, p) for p in conv.padding)
        self.padding = tuple(tuple(int(v) for v in p) for p in padding)
        w = conv.weight.detach().float()
        w_scale = weight_scale_per_channel(w)
        w_i8 = quantize_to_int8(w, w_scale[:, None, None, None])
        in_scale = torch.as_tensor(in_scale, dtype=torch.float32, device=w.device)
        self.register_buffer("in_scale", in_scale.reshape(()), persistent=False)
        self.register_buffer("dq", in_scale * w_scale, persistent=False)
        bias = None if conv.bias is None else conv.bias.detach().float()
        self.register_buffer("bias", bias, persistent=False)
        self.cout = w.shape[0]
        self.register_buffer(
            "w_rows", weight_rows_i8(w_i8.permute(2, 3, 1, 0)), persistent=False
        )
        if (kh, kw) == (3, 3) and sh == 1 and sw in (1, 2) and bias is None and (
            self.padding == ((1, 1), (1, 1))
        ):
            self.route = "k3"
            # (9, Cin, Cout) taps, dy-major, viewed from (9, Cout, Cin)
            # memory: the kernel's [n][k] operand layout, so the wrapper's
            # transpose back is free.
            taps = w_i8.permute(2, 3, 0, 1).reshape(9, w.shape[0], w.shape[1])
            self.register_buffer(
                "w_taps", taps.contiguous().transpose(1, 2), persistent=False
            )
        elif (kh, kw) == (1, 1) and self.padding == ((0, 0), (0, 0)):
            self.route = "matmul"
        else:
            self.route = "general"

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        """``x`` NCHW (channels_last memory) -> NCHW in ``dtype``."""
        padding = self.padding if padding is None else padding
        if self.route == "k3" and padding == self.padding:
            # K3 quantizes the NHWC view as it stages it: no int8 copy.
            y = conv3x3_i8_fused(
                x.permute(0, 2, 3, 1), self.w_taps, self.dq,
                stride_w=self.stride[1], out_dtype=self.dtype, in_scale=self.in_scale,
            )
            return y.permute(0, 3, 1, 2)
        xq = quantize_to_int8(x, self.in_scale).permute(0, 2, 3, 1)  # NHWC
        y = int8_conv_nhwc(
            xq, self.w_rows, self.cout, self.kernel_size, self.stride, padding,
            self.dq, self.bias, self.dtype,
        )
        return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# BatchNorm fold, calibration, scope filter, quantization of a model
# ---------------------------------------------------------------------------


def _fold(scale, bias, mean, var) -> None:
    # fp32 sqrt rounded once to nearest: through fp64, since PyTorch's
    # vectorized fp32 sqrt on the CPU is not correctly rounded.
    inv = scale / torch.sqrt((var + BN_EPS).double()).float()
    bias.copy_(bias - mean * inv)
    scale.copy_(inv)
    mean.zero_()
    var.copy_(torch.ones_like(var) - BN_EPS)


@torch.no_grad()
def fold_batch_norms(model: nn.Module) -> nn.Module:
    """Bake running statistics into every BatchNorm's affine, in place.

    ``weight <- weight / sqrt(var + 1e-5)``, ``bias <- bias - mean *
    weight'``, ``mean <- 0``, ``var <- 1 - 1e-5`` (fp32, the operations of
    ``tools/export.py::fold_batch_norms``), for every ``BatchNorm2d`` and
    the MetaKernel's explicit ``pos_{i}_bn_*`` tensors. Each BN stays in
    place; the conv weights are not touched.
    """
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            _fold(m.weight, m.bias, m.running_mean, m.running_var)
        for name, p in list(m.named_parameters(recurse=False)):
            if name.endswith("_bn_scale"):
                base = name[: -len("_scale")]
                _fold(
                    p, getattr(m, f"{base}_bias"), getattr(m, f"{base}_mean"),
                    getattr(m, f"{base}_var"),
                )
    return model


def _to_scale(absmax: float) -> np.ndarray:
    """absmax -> absmax / 127 (fp32), or 1.0 for an all-zero input."""
    return np.asarray(absmax / INT8_MAX if absmax > 0 else 1.0, np.float32)


@torch.no_grad()
def calibrate_scales(
    model: nn.Module, batches: Iterable[Tuple[Any, Any, Any]]
) -> Dict[str, Any]:
    """Activation scales of every quantizable block, as a JAX quant tree.

    Runs the eval forward on each ``(feats, cart, mask)`` batch (numpy or
    tensors) and records the input absmax of every BN-bearing
    ``ConvNormAct`` and every ``TorchConvTranspose`` (forward pre-hooks),
    and the MetaKernel's ``hh`` and ``p * feats`` absmaxes (its accumulate
    path, which the stem takes while calibrating, as in JAX). Takes the
    max over batches and returns ``{...: {"in_scale": absmax / 127}}``
    with ``stem_hh_scale``/``stem_pf_scale`` beside the stem's blocks.
    """
    device = next(model.parameters()).device

    def run() -> int:
        n_batches = 0
        for feats, cart, mask in batches:
            model(
                torch.as_tensor(feats, dtype=torch.float32, device=device),
                torch.as_tensor(cart, dtype=torch.float32, device=device),
                torch.as_tensor(mask, dtype=torch.bool, device=device),
            )
            n_batches += 1
        return n_batches

    return calibrate_module(model, run)


@torch.no_grad()
def calibrate_module(model: nn.Module, run: Callable[[], int]) -> Dict[str, Any]:
    """:func:`calibrate_scales` for any module: the absmaxes its quantizable
    blocks see while ``run()`` calls it (``run`` returns how many batches
    it ran; none raises), as a quant tree rooted at ``model``."""
    absmax: Dict[Tuple[str, str], torch.Tensor] = {}

    def record(scope: str, key: str, value: torch.Tensor) -> None:
        v = value.detach().float().abs().amax()
        prev = absmax.get((scope, key))
        absmax[(scope, key)] = v if prev is None else torch.maximum(prev, v)

    handles, sinks = [], []
    for name, m in model.named_modules():
        if getattr(m, "calibrates_input", False):
            handles.append(
                m.register_forward_pre_hook(
                    lambda mod, args, _n=name: record(_n, "in", mod.calib_input(args[0]))
                )
            )
        if hasattr(m, "calib_sink"):
            m.calib_sink = lambda key, v, _n=name: record(_n, key, v)
            sinks.append(m)
    try:
        n_batches = run()
    finally:
        for h in handles:
            h.remove()
        for m in sinks:
            m.calib_sink = None
    if n_batches == 0:
        raise ValueError("calibrate_scales needs at least one batch")
    tree: Dict[str, Any] = {}
    for (scope, key), v in absmax.items():
        node = tree
        for part in scope.split(".") if scope else ():
            node = node.setdefault(part, {})
        node[f"{key}_scale"] = _to_scale(float(v))
    return tree


def filter_scope(quant_tree: Dict[str, Any], scope: str) -> Dict[str, Any]:
    """Restrict a quant tree: "full" keeps everything, "heads" keeps only
    the DetectionHead towers (backbone and stem run in the compute dtype)."""
    if scope == "full":
        return quant_tree
    if scope != "heads":
        raise ValueError(f"unknown quantization scope: {scope!r}")

    def prune(node, under_head):
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                sub = prune(v, under_head or k.startswith("DetectionHead"))
                if sub:
                    out[k] = sub
            elif under_head:
                out[k] = v
        return out

    return prune(quant_tree, False)


def _scale_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _scale_leaves(v, prefix + (k,))
        else:
            yield prefix, k, float(np.asarray(v, dtype=np.float32))


@torch.no_grad()
def quantize_model(
    model: nn.Module, quant_tree: Mapping[str, Any], stem_int8: bool = False
) -> nn.Module:
    """Quantize ``model`` in place from ``quant_tree`` (JAX layout).

    Every earlier quantization is dropped first, so calling it again with
    another tree, scope or ``stem_int8`` re-quantizes from the fp weights.
    A block runs int8 exactly when its scope carries an ``in_scale``; the
    MetaKernel stem runs K4 when ``stem_int8`` and both of its scales are
    present, else K1.
    """
    for m in model.modules():
        if hasattr(m, "quantize"):
            m.quantize(None)
        if hasattr(m, "quantize_stem"):
            m.quantize_stem(None, None)
    stems: Dict[str, Dict[str, float]] = {}
    for mods, leaf, value in _scale_leaves(quant_tree):
        module = model.get_submodule(".".join(mods))
        if leaf == "in_scale":
            module.quantize(value)
        elif leaf in ("stem_hh_scale", "stem_pf_scale"):
            stems.setdefault(".".join(mods), {})[leaf] = value
        else:
            raise KeyError(f"quantize_model: unknown quant leaf {'/'.join(mods + (leaf,))}")
    for name, s in stems.items():
        if len(s) == 2:
            model.get_submodule(name).quantize_stem(
                s["stem_hh_scale"], s["stem_pf_scale"], use_kernel=stem_int8
            )
    return model


def quant_tree_of(model: nn.Module) -> Dict[str, Any]:
    """The quant tree (JAX layout, fp32 numpy leaves) a quantized model
    holds: the inverse of :func:`quantize_model`."""
    tree: Dict[str, Any] = {}
    for name, m in model.named_modules():
        for leaf, v in (m.quant_scales() if hasattr(m, "quant_scales") else {}).items():
            node = tree
            for part in name.split(".") if name else ():
                node = node.setdefault(part, {})
            node[leaf] = np.asarray(v, np.float32)
    return tree
