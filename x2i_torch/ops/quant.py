"""Weight quantization of the DiT's dense layers: the counterpart of
``x2i_tpu/ops/quant.py``.

Four modes:

* ``"w8"``: int8 weights with per-output-channel f32 scales, dequantized
  to the activation dtype inside the product: the dequantizing GEMM
  (``ops/int4_gemm.py::dequant_linear``) converts each weight tile as it
  feeds the tensor cores, as the JAX ``w8_matmul``'s XLA fusion does in
  the dot;
* ``"w8a8"``: the activations are quantized per token as well, and the
  product runs int8 x int8 -> int32 through the int8 GEMM
  (``x2i_torch/ops/int8_gemm.py``), rescaled by row scale x channel scale;
* ``"w4"``: int4 codes, two a byte, row-interleaved, with f32 (group, out)
  scales and an AWQ ``pre_scale`` per input; the same dequantizing GEMM
  converts them (the JAX ``w4_matmul`` dequantizes into its dot too). A
  layer knows whether its ``pre_scale`` is all ones (``pre_scale_ones``,
  set where the layer is built, quantized or loaded) and then skips the
  multiply, which is exact;
* ``"w4a8"``: int4 codes, half-split, whose (group, out) scales factor
  into int8 multipliers m in [1, 15] and an f32 per-output scale; the
  activations are quantized per token as in w8a8, and the w4a8 GEMM
  (``ops/int4_gemm.py``) unpacks code x m into the int8 GEMM's operand.

``QuantLinear`` stores its weights in the ``nn.Linear`` (out, in)
orientation, so that a weight row is K-contiguous: ``qweight`` int8 (out,
in) and ``scale`` f32 (out,) in w8/w8a8; ``pweight`` int8 (out, in/2) in
w4/w4a8, the transpose of the JAX ``pkernel``, with ``mscale`` int8 (G,
out) and ``scale`` f32 (out,) in w4a8, ``scale`` f32 (G, out) and
``pre_scale`` f32 (in,) in w4 (the JAX layouts); ``bias`` in the layer's
dtype. The bridge (``x2i_torch/params.py``) transposes. The quantizers
take the JAX layout (..., in, out), as the JAX functions do, and give the
same codes, multipliers and scales bit for bit; so do the JAX-layout
unpacks ``_unpack_int4``, ``_dequant_w4`` and ``_w4a8_weight_int8``.

Training through a frozen quantized layer takes the JAX package's
straight-through backward (the ``custom_vjp``s of ``w8a8_matmul``,
``w8_matmul``, ``w4_matmul`` and ``w4a8_matmul``, ``_w8a8_bwd``,
``_w4_bwd`` and ``_w4a8_bwd``): ``StraightThrough`` runs the layer's
forward under no grad, keeps only its codes and scales, and gives ``dx =
dy @ W``, W the weight dequantized in x's dtype (the int8 and w4a8
dequantize kernels of ``ops/int8_gemm.py`` and ``ops/int4_gemm.py``, the
w4 one, or their plain versions), summed in f32 and rounded to x's dtype;
the activation rounding is ignored, and the codes, scales, multipliers,
``pre_scale`` and the bias get no gradient.
The pre-quantized chunk input stays inference-only, as the JAX
``*_prequant`` products are.

Every mode splits for tensor parallelism (``QuantLinear.sliced``): a
block of its output channels takes their code rows, scales and bias; a
block of its input features takes the codes of those inputs and keeps
the per-output scale and the bias whole, its product one part of a sum,
the bias added once after. w4's group scales and AWQ ``pre_scale``
follow the inputs; w4a8's multipliers follow its groups, and its codes are
packed half-split again over the block's own inputs (a block of input
features is not a block of half-split bytes). A block of inputs is whole
groups, an even count of them in w4a8. The parts are floating products
in w8 and w4 (``forward(x, with_bias=False)``); in w8a8 and w4a8 the
activation scale is the whole row's (the tensor axis's max of the
members' row absmaxes), so a part is the int32 accumulator of the
member's codes at that scale (``acc``), summed over the axis before the
scales are applied once (``rescale``): the sum of the whole layer's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from x2i_torch.core.config import ACT_QUANT_MODES, quant_mode
from x2i_torch.ops.fused_glue import quant_rows, quant_rows_plain
from x2i_torch.ops.int4_gemm import (dequant_linear, dequant_linear_plain,
                                     nibbles, w4_codes, w4_dequant,
                                     w4_dequant_plain, w4a8_codes,
                                     w4a8_dequant, w4a8_linear,
                                     w4a8_linear_plain, w4a8_matmul_acc)
from x2i_torch.ops.int8_gemm import (int8_dequant, int8_linear,
                                     int8_linear_plain, int8_matmul_acc)


def quantize_kernel(kernel: torch.Tensor):
    """Symmetric per-output-channel int8 of a (..., in, out) kernel ->
    (codes int8 (..., in, out), scale f32 (..., out)), computed in f32 as
    the JAX ``quantize_kernel``: ``max(amax / 127, 1e-12)``, an IEEE
    division, round half to even, clip to +-127."""
    k = kernel.float()
    amax = k.abs().amax(-2, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient (the
    # divisor is filled on the device: a copy from the host would block)
    scale = (amax / amax.new_full((), 127.0)).clamp_min(1e-12)
    q = torch.round(k / scale).clamp(-127.0, 127.0).to(torch.int8)
    return q, scale.squeeze(-2)


def _ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE quotient in x's dtype (see quantize_kernel)."""
    return x / x.new_full((), d)


# ------------------------------------------------------------ int4 codes

# the int4 modes' default group size: the JAX ``QuantDense.group`` and
# ``quantize_tree`` default
INT4_GROUP = 128

def _w4_group(in_features: int, group: int) -> int:
    """w4 group size: ``group`` when it divides the input dim, else the
    whole input dim (per-channel scales)."""
    return group if group and in_features % group == 0 else in_features


def _w4a8_group(in_features: int, group: int) -> int:
    """w4a8 group size: like ``_w4_group``, but the group count must be
    even (whole groups in each half), so an odd count halves the group
    (a 64-wide input gets 32)."""
    g = _w4_group(in_features, group)
    if (in_features // g) % 2:
        g //= 2
    return g


def _pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int8 codes -> one int8 byte each pair, ``lo`` in the low nibble."""
    b = (lo.to(torch.int16) & 0x0F) | ((hi.to(torch.int16) & 0x0F) << 4)
    return b.to(torch.uint8).view(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], (..., in, out) -> row-interleaved packed
    int8 (..., in/2, out): row 2i in the low nibble, 2i + 1 in the high."""
    return _pack(q[..., 0::2, :], q[..., 1::2, :])


def quantize_kernel_w4(kernel: torch.Tensor, group: int = INT4_GROUP):
    """Symmetric int4 with per-(input-group, out-channel) scales, the JAX
    ``quantize_kernel_w4``: kernel (..., in, out) -> (pkernel int8 (...,
    in/2, out), scale f32 (..., in/g, out)); codes clip to [-7, 7]."""
    k = kernel.float()
    inn, out = k.shape[-2:]
    if inn % 2:
        raise ValueError("w4 needs an even input dim")
    g = _w4_group(inn, group)
    kg = k.reshape(*k.shape[:-2], inn // g, g, out)
    scale = _ieee_div(kg.abs().amax(-2, keepdim=True), 7.0).clamp_min(1e-12)
    q = torch.round(kg / scale).clamp(-7.0, 7.0).to(torch.int8)
    return pack_int4(q.reshape(k.shape)), scale.squeeze(-2)


def quantize_kernel_w4a8(kernel: torch.Tensor, group: int = INT4_GROUP):
    """The JAX ``quantize_kernel_w4a8``: float (..., in, out) -> (pkernel
    int8 (..., in/2, out) half-split, mscale int8 (..., G, out) in
    [1, 15], scale f32 (..., out)). The group scales amax / 7 snap to m x
    s with s = max / 15, and the codes round against the snapped scale.
    Packed row r holds input r low and input r + in/2 high."""
    k = kernel.float()
    inn, out = k.shape[-2:]
    if inn % 2:
        raise ValueError("w4a8 needs an even input dim")
    g = _w4a8_group(inn, group)
    kg = k.reshape(*k.shape[:-2], inn // g, g, out)
    gscale = _ieee_div(kg.abs().amax(-2).clamp_min(1e-8), 7.0)  # (.., G, out)
    s = _ieee_div(gscale.amax(-2), 15.0)                        # (.., out)
    m = torch.round(gscale / s[..., None, :]).clamp(1.0, 15.0)
    real = m * s[..., None, :]
    q = torch.round(kg / real[..., :, None, :]).clamp(-7.0, 7.0) \
        .to(torch.int8).reshape(k.shape)
    half = inn // 2
    return (_pack(q[..., :half, :], q[..., half:, :]), m.to(torch.int8),
            s)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Row-interleaved packed (..., in/2, out) -> int8 codes (..., in,
    out) in [-8, 7]: row 2i the low nibble, 2i + 1 the high nibble."""
    return w4_codes(packed.transpose(-1, -2)).transpose(-1, -2)


def _dequant_w4(pkernel: torch.Tensor, scale: torch.Tensor,
                dtype) -> torch.Tensor:
    """packed (..., in/2, out) + f32 scale (..., G, out) -> dtype (...,
    in, out): the scale cast to dtype before it multiplies."""
    return w4_dequant_plain(pkernel.transpose(-1, -2), scale,
                            dtype).transpose(-1, -2)


def _w4a8_codes(pkernel: torch.Tensor):
    """Half-split packed (..., in/2, out) -> (lo, hi) int8 codes of the
    inputs [0, in/2) and [in/2, in)."""
    return nibbles(pkernel)


def _w4a8_scaled(codes: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    """codes (..., rows, out) times the multipliers ms (..., Gp, out) of
    their groups -> int8, |.| <= 105."""
    rows, out = codes.shape[-2:]
    gp = ms.shape[-2]
    c = codes.reshape(*codes.shape[:-2], gp, rows // gp, out)
    return (c * ms[..., :, None, :]).reshape(codes.shape)


def _w4a8_weight_int8(pkernel: torch.Tensor,
                      mscale: torch.Tensor) -> torch.Tensor:
    """packed (..., in/2, out) + m (..., G, out) -> the int8 operand (...,
    in, out), code x m (the materialized form the JAX backward uses)."""
    return w4a8_codes(pkernel.transpose(-1, -2), mscale).transpose(-1, -2)


def quantize_kernel_w4_awq(kernel: torch.Tensor, act_amax: torch.Tensor,
                           group: int = INT4_GROUP, n_grid: int = 20,
                           cal_x: Optional[torch.Tensor] = None,
                           rng: Optional[np.random.Generator] = None):
    """Activation-aware int4 (AWQ), the JAX ``quantize_kernel_w4_awq``:
    input channel i is scaled by s_i = (act_amax_i / mean)^alpha before
    quantizing, with alpha on an ``n_grid`` grid over [0, 1] chosen by
    the mean squared output error on calibration activations ``cal_x``
    (by default 256 Laplace rows with the observed spread, drawn from
    ``rng``, numpy's default_rng(0) as in JAX). kernel (in, out), act_amax
    (in,) -> (pkernel, scale, pre_scale = 1 / s), the JAX layouts; the
    error sums in f32, in another order than numpy's."""
    k = kernel.float()
    if k.dim() != 2:
        raise ValueError("awq search is per-kernel; loop stacked layers")
    inn = k.shape[0]
    amax = np.maximum(np.asarray(act_amax, np.float64).reshape(inn), 1e-8)
    if cal_x is None:
        rng = rng or np.random.default_rng(0)
        cal_x = torch.from_numpy((rng.laplace(size=(256, inn))
                                  * (amax / 4.0)).astype(np.float32))
    cal_x = cal_x.float().to(k.device)
    ref = cal_x @ k
    best = (np.inf, None)
    ratio = amax / amax.mean()
    for alpha in np.linspace(0.0, 1.0, n_grid):
        s = torch.from_numpy(np.clip(ratio ** alpha, 1e-4, 1e4)
                             .astype(np.float32)).to(k.device)
        pk, sc = quantize_kernel_w4(k * s[:, None], group)
        out = (cal_x / s) @ _dequant_w4(pk, sc, torch.float32)
        err = float(((out - ref) ** 2).mean())
        if err < best[0]:
            best = (err, (pk, sc, 1.0 / s))
    return best[1]


# -------------------------------------------------------------- products

def w8a8_matmul(x: torch.Tensor, qweight: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Plain w8a8 product with dynamic per-token activation scales:
    x (..., in) float, qweight (out, in) int8, scale (out,) f32 ->
    (..., out) in x.dtype."""
    xq, a_scale = quant_rows_plain(x)
    return int8_linear_plain(xq, a_scale, qweight, scale, out_dtype=x.dtype)


def w8a8_matmul_prequant(xq: torch.Tensor, a_scale: torch.Tensor,
                         qweight: torch.Tensor, scale: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """Plain w8a8 product over already-quantized activations (xq int8
    (..., in), a_scale f32 (..., 1)); f32 out unless out_dtype is given."""
    return int8_linear_plain(xq, a_scale, qweight, scale,
                             out_dtype=out_dtype or torch.float32)


def w8_matmul(x: torch.Tensor, qweight: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8: the scale is cast to x.dtype before it multiplies
    the codes (as in the JAX ``w8_matmul``), then a plain product."""
    return dequant_linear_plain(x, qweight, scale, mode="w8")


def w4_matmul(x: torch.Tensor, pweight: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Plain weight-only int4 product: x (..., in) against the weight
    dequantized to x.dtype (pweight (out, in/2), scale (G, out))."""
    return dequant_linear_plain(x, pweight, scale, mode="w4")


def w4a8_matmul(x: torch.Tensor, pweight: torch.Tensor, mscale: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Plain w4a8 product with dynamic per-token activation scales: x
    (..., in) float, pweight (out, in/2), mscale (G, out), scale (out,) ->
    (..., out) in x.dtype."""
    xq, a_scale = quant_rows_plain(x)
    return w4a8_linear_plain(xq, a_scale, pweight, mscale, scale,
                             out_dtype=x.dtype)


def w4a8_matmul_prequant(xq: torch.Tensor, a_scale: torch.Tensor,
                         pweight: torch.Tensor, mscale: torch.Tensor,
                         scale: torch.Tensor, row0: int = 0,
                         out_dtype=None) -> torch.Tensor:
    """Plain w4a8 product over already-quantized activations that are the
    weight's inputs [row0, row0 + K); f32 out unless out_dtype is given."""
    return w4a8_linear_plain(xq, a_scale, pweight, mscale, scale, k0=row0,
                             out_dtype=out_dtype or torch.float32)


class StraightThrough(torch.autograd.Function):
    """A frozen ``QuantLinear``'s product with the JAX straight-through
    backward: ``apply(x, layer)`` is ``layer._product(x)``, computed under
    no grad (the kernels' ``refuse_grad`` does not fire), saving only the
    layer's codes and scales; the backward gives ``dx = dy @ W`` with W
    dequantized in x's dtype, summed in f32 (cuBLAS on the card) and
    rounded to x's dtype, and no gradient for anything but x. The weights
    are (out, in), so ``dy @ W`` contracts the out dimension with no
    transpose, as the JAX backward's direct contraction does."""

    @staticmethod
    def forward(ctx, x, layer, with_bias=True):
        ctx.mode, ctx.impl, ctx.x_dtype = layer.mode, layer.impl, x.dtype
        ctx.save_for_backward(*layer.codes())
        return layer._product(x, with_bias)

    @staticmethod
    def backward(ctx, dy):
        # the dequantize kernels for CUDA tensors, their plain versions
        # for CPU ones or on the "plain" route
        dequant = {"w8": int8_dequant, "w8a8": int8_dequant,
                   "w4": w4_dequant, "w4a8": w4a8_dequant}[ctx.mode]
        w = dequant(*ctx.saved_tensors, ctx.x_dtype, ctx.impl)
        return torch.matmul(dy.to(ctx.x_dtype), w), None, None


def _note_pre_scale(layer, incompatible_keys):
    """``QuantLinear``'s load hook: its ``pre_scale`` was just loaded."""
    layer.note_pre_scale_()


class QuantLinear(nn.Module):
    """``nn.Linear`` with quantized weights, the counterpart of
    ``QuantDense``. ``forward`` takes

    * a tensor (..., in): quantized per token by ``quant_rows`` (K8) in
      w8a8 and w4a8 (after a cast to the layer's dtype in w4a8, as in
      JAX), or multiplied by the dequantized weight in w8 and w4 through
      the dequantizing GEMM (w4 first multiplies it by ``pre_scale`` in
      its own dtype, unless ``pre_scale_ones``);
    * an ``(xq, a_scale)`` pair from a glue kernel (w8a8 and w4a8);
    * a list of such pairs, chunks along the input features: each is a
      K-slice of the one weight, and the chunks' bf16 parts are summed in
      order, so that a concatenation of the inputs is never built (in
      w4a8 each chunk starts and ends on a group boundary).

    Where autograd records and the input requires grad, the product is
    ``StraightThrough``'s (the pre-quantized forms raise there: they are
    inference-only). ``impl`` is ``FluxConfig.quant_impl``: "plain" takes
    the plain quantization, product and backward on any device; otherwise
    a CUDA tensor launches the kernels. The int4 modes' groups are
    ``group`` inputs (the JAX ``QuantDense.group``; the whole input where
    it does not divide it, and halved in w4a8 to make their count even).
    The weights are buffers (and the bias a parameter without gradient):
    the layer is frozen. ``pre_scale_ones`` (w4) says that ``pre_scale``
    is all ones: true where the buffer is made or filled with ones
    (``set_groups_``, ``set_weight_``), found once from the values where
    they are loaded (``load_state_dict``, the bridge), never in
    ``forward``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, mode: str = "w8a8",
                 dtype=torch.bfloat16, device=None, impl: str = "auto",
                 group: int = INT4_GROUP):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.mode = quant_mode(mode)
        self.dtype, self.impl, self.group = dtype, impl, group
        i8, f32 = torch.int8, torch.float32

        def buf(name, shape, dtype, fill):
            self.register_buffer(name, torch.full(shape, fill, dtype=dtype,
                                                  device=device))

        if self.mode in ("w4", "w4a8"):
            if in_features % 2:
                raise ValueError(f"{self.mode} needs an even input dim")
            buf("pweight", (out_features, in_features // 2), i8, 0)
            self.set_groups_(in_features // (
                _w4a8_group if self.mode == "w4a8" else _w4_group)(
                    in_features, group))
        else:
            buf("qweight", (out_features, in_features), i8, 0)
            buf("scale", (out_features,), f32, 1.0)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device),
                                  requires_grad=False) if bias else None)
        self.register_load_state_dict_post_hook(_note_pre_scale)

    def set_groups_(self, groups: int) -> "QuantLinear":
        """(Re)make the int4 scale buffers for ``groups`` groups of
        in / groups inputs (an even count in w4a8, as its kernel and the
        half-split packing need): the bridge sizes them from a tree's own
        leaves. The new buffers hold the identity scales."""
        inn, out = self.in_features, self.out_features
        if inn % groups or (self.mode == "w4a8" and groups % 2):
            raise ValueError(f"{self.mode}: {groups} groups do not split "
                             f"{inn} inputs")
        dev, f32 = self.pweight.device, torch.float32
        self.group = inn // groups
        if self.mode == "w4a8":
            self.register_buffer("mscale", torch.ones(
                (groups, out), dtype=torch.int8, device=dev))
            self.register_buffer("scale", torch.ones(out, dtype=f32,
                                                     device=dev))
        else:
            self.register_buffer("scale", torch.ones((groups, out),
                                                     dtype=f32, device=dev))
            self.register_buffer("pre_scale", torch.ones(inn, dtype=f32,
                                                         device=dev))
            self.pre_scale_ones = True
        return self

    @torch.no_grad()
    def note_pre_scale_(self) -> "QuantLinear":
        """Find from its values whether w4's ``pre_scale`` is all ones
        (one reading, where the layer is loaded: never in ``forward``).
        Whatever writes ``pre_scale`` in place calls it after: the load
        hook, the bridge, and through ``note_pre_scales_`` a converter's
        plan and a broadcast from another rank."""
        if self.mode == "w4":
            self.pre_scale_ones = bool((self.pre_scale == 1).all())
        return self

    @torch.no_grad()
    def set_weight_(self, weight: torch.Tensor) -> "QuantLinear":
        """Quantize a float (out, in) weight into this layer (w4: with no
        AWQ equalization, ``pre_scale`` ones, as the JAX
        ``quantize_tree``)."""
        if self.mode == "w4a8":
            pk, m, s = quantize_kernel_w4a8(weight.t(), self.group)
            self.pweight.copy_(pk.t())
            self.mscale.copy_(m)
            self.scale.copy_(s)
        elif self.mode == "w4":
            pk, s = quantize_kernel_w4(weight.t(), self.group)
            self.pweight.copy_(pk.t())
            self.scale.copy_(s)
            self.pre_scale.fill_(1.0)
            self.pre_scale_ones = True
        else:
            q, s = quantize_kernel(weight.t())
            self.qweight.copy_(q.t())
            self.scale.copy_(s)
        return self

    @torch.no_grad()
    def dequantized_weight(self) -> torch.Tensor:
        """The f32 (out, in) weight this layer multiplies by, exactly (the
        rounding happened at quantization), with w4's ``pre_scale`` folded
        in: the JAX ``dequantize_tree`` of its leaves, transposed."""
        if self.mode == "w4a8":
            return (w4a8_codes(self.pweight, self.mscale).float()
                    * self.scale[:, None])
        if self.mode == "w4":
            return (w4_dequant_plain(self.pweight, self.scale, torch.float32)
                    * self.pre_scale[None, :])
        return self.qweight.float() * self.scale[:, None]

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear, mode: str, impl: str = "auto",
                    group: int = INT4_GROUP) -> "QuantLinear":
        w = linear.weight
        q = cls(linear.in_features, linear.out_features,
                linear.bias is not None, mode, w.dtype, w.device, impl,
                group)
        q.set_weight_(w)
        if linear.bias is not None:
            q.bias.copy_(linear.bias)
        return q

    def check_inputs(self, ranges, name: str = "layer") -> None:
        """Raises ValueError, naming ``name`` and the group, where the
        input features ``ranges`` are not a block this layer splits into
        (``check_group_ranges``)."""
        if self.mode in ("w4", "w4a8"):
            check_group_ranges(self.mode, self.group, ranges, name)

    @torch.no_grad()
    def sliced(self, side: str, ranges, copy: bool = True) -> "QuantLinear":
        """A layer of a block of this one: ``side`` "out" takes the output
        channels in ``ranges`` (a list of (start, stop)), their codes,
        scales and bias; "in" the input features in ``ranges`` in order,
        with the per-output scale and the bias whole (the block's product
        is a part of a sum, the bias added once after it): w4's group
        scales and ``pre_scale`` follow the inputs, w4a8's multipliers its
        groups, and its codes are packed half-split again over the block's
        inputs (new storage). ``copy``: new storage for every tensor (else
        views where a range is one contiguous block). Raises ValueError
        where a block of inputs is not whole groups (``check_inputs``)."""
        dim = {"out": 0, "in": 1}[side]
        mode = self.mode
        if side == "in":
            self.check_inputs(ranges)
        groups = None
        if mode in ("w8", "w8a8"):
            codes = {"qweight": take_ranges(self.qweight, dim, ranges, copy)}
        elif side == "out":
            codes = {"pweight": take_ranges(self.pweight, 0, ranges, copy)}
        elif mode == "w4":
            # row-interleaved: inputs 2j, 2j + 1 are byte j
            codes = {"pweight": take_ranges(self.pweight, 1, [
                (a // 2, b // 2) for a, b in ranges], copy)}
        else:
            codes = {"pweight": take_inputs_w4a8(self.pweight, ranges)}
        if side == "in" and mode in ("w4", "w4a8"):
            g = self.group
            groups = [(a // g, b // g) for a, b in ranges]
        vectors = {}
        for leaf in ("scale", "mscale", "pre_scale"):
            t = getattr(self, leaf, None)
            if t is None:
                continue
            if t.dim() == 2:                              # (G, out)
                vectors[leaf] = (take_ranges(t, 1, ranges, copy)
                                 if side == "out" else
                                 take_ranges(t, 0, groups, copy))
            elif leaf == "pre_scale" and side == "in":    # (in,)
                vectors[leaf] = take_ranges(t, 0, ranges, copy)
            elif leaf != "pre_scale" and side == "out":   # (out,)
                vectors[leaf] = take_ranges(t, 0, ranges, copy)
            else:
                vectors[leaf] = t.clone() if copy else t
        bias = self.bias
        if bias is not None:
            bias = (take_ranges(bias, 0, ranges, copy) if side == "out"
                    else bias.clone() if copy else bias)
        width = sum(b - a for a, b in ranges)
        inn, out = ((width, self.out_features) if side == "in"
                    else (self.in_features, width))
        layer = QuantLinear(inn, out, bias is not None, mode, self.dtype,
                            "meta", self.impl, self.group)
        for leaf, t in {**codes, **vectors}.items():
            setattr(layer, leaf, t)
        layer.group = self.group
        if mode == "w4":
            layer.pre_scale_ones = self.pre_scale_ones
        if bias is not None:
            layer.bias = nn.Parameter(bias, requires_grad=False)
        return layer

    def acc(self, xq: torch.Tensor) -> torch.Tensor:
        """w8a8 / w4a8: the int32 accumulator of activation codes ``xq``
        (..., in) against the weight's codes (code x m in w4a8), with no
        scale and no bias: the int8 or w4a8 GEMM's int32-out instance for
        a CUDA tensor, its plain version for a CPU one."""
        if self.mode == "w4a8":
            return w4a8_matmul_acc(xq, self.pweight, self.mscale,
                                   impl=self.impl)
        if self.mode != "w8a8":
            raise ValueError(f"a {self.mode} layer has no int32 product")
        return int8_matmul_acc(xq, self.qweight, impl=self.impl)

    def rescale(self, acc: torch.Tensor, a_scale: torch.Tensor,
                dtype) -> torch.Tensor:
        """The output of an int32 accumulator (a sum of members' ``acc``)
        and its rows' activation scales: ``f32(acc) * a_scale * scale``
        rounded to ``dtype`` (x's), then to the layer's dtype, the
        product's rounding points, with no bias."""
        y = (acc.float() * a_scale * self.scale).to(dtype)
        return y.to(self.dtype)

    def _bias(self, y):
        return y if self.bias is None else y + self.bias.to(self.dtype)

    def codes(self):
        """The codes and scales the product reads (w8/w8a8: qweight,
        scale; w4: pweight, scale; w4a8: pweight, mscale, scale)."""
        if self.mode == "w4a8":
            return self.pweight, self.mscale, self.scale
        if self.mode == "w4":
            return self.pweight, self.scale
        return self.qweight, self.scale

    def forward(self, x, with_bias: bool = True):
        """``with_bias=False`` leaves the bias out (a part of a sum whose
        bias is added once after it; tensor inputs)."""
        if isinstance(x, (tuple, list)):
            if not with_bias:
                raise ValueError("with_bias=False takes a tensor input")
            return self._prequant(x if isinstance(x, list) else [x])
        # the JAX layer's casts around its custom_vjp: w8a8 quantizes x in
        # its own dtype; the others cast it to the layer's first (w4 after
        # the AWQ pre-scale in x's dtype)
        if self.mode == "w4" and not self.pre_scale_ones:
            x = (x * self.pre_scale.to(x.dtype)).to(self.dtype)
        elif self.mode != "w8a8":
            x = x.to(self.dtype)
        if torch.is_grad_enabled() and x.requires_grad:
            y = StraightThrough.apply(x, self, with_bias)
        else:
            y = self._product(x, with_bias)
        # w8a8's product rounds to x.dtype, then to the layer's dtype, as
        # the JAX layer does; the bias rides the GEMM's epilogue when the
        # two dtypes agree (always in the DiT)
        if self.mode == "w8a8" and x.dtype != self.dtype:
            y = y.to(self.dtype)
            return self._bias(y) if with_bias else y
        return y

    def _product(self, x, with_bias: bool = True):
        """The forward of a tensor input, after the casts of ``forward``."""
        bias = self.bias if with_bias else None
        if self.mode in ("w8", "w4"):
            return dequant_linear(x, *self.codes(), bias=bias,
                                  mode=self.mode, impl=self.impl)
        if self.mode == "w4a8":
            # quantized in the layer's dtype, the bias in the GEMM's
            # epilogue, as the JAX layer rounds
            xq, a_scale = quant_rows(x, self.impl)
            return w4a8_linear(xq, a_scale, self.pweight, self.mscale,
                               self.scale, bias=bias,
                               out_dtype=self.dtype, impl=self.impl)
        same = x.dtype == self.dtype
        xq, a_scale = quant_rows(x, self.impl)
        return int8_linear(xq, a_scale, self.qweight, self.scale,
                           bias=bias if same else None,
                           out_dtype=x.dtype, impl=self.impl)

    def _prequant(self, chunks):
        if self.mode not in ACT_QUANT_MODES:
            raise ValueError("pre-quantized input requires mode w8a8 or "
                             "w4a8")
        if torch.is_grad_enabled() and any(
                t.requires_grad for chunk in chunks for t in chunk):
            raise RuntimeError(
                "QuantLinear: a pre-quantized (xq, a_scale) input is "
                "inference-only and has no backward; train on the unfused "
                "route (FluxConfig.fused_glue=False), whose tensor inputs "
                "take the straight-through backward")
        widths = [xq.shape[-1] for xq, _ in chunks]
        if sum(widths) != self.in_features:
            raise ValueError(f"chunks of widths {widths} do not make "
                             f"{self.in_features} input features")
        w4a8 = self.mode == "w4a8"
        g = self.in_features // self.mscale.shape[0] if w4a8 else 1
        y, off = None, 0
        for i, (xq, a_scale) in enumerate(chunks):
            if w4a8 and (off % g or widths[i] % g):
                raise ValueError("w4a8 chunk not group-aligned")
            bias = self.bias if i == len(chunks) - 1 else None
            if w4a8:
                y = w4a8_linear(xq, a_scale, self.pweight, self.mscale,
                                self.scale, bias=bias, k0=off, addend=y,
                                out_dtype=self.dtype, impl=self.impl)
            else:
                y = int8_linear(xq, a_scale, self.qweight, self.scale,
                                bias=bias, k0=off, addend=y,
                                out_dtype=self.dtype, impl=self.impl)
            off += widths[i]
        return y


def check_group_ranges(mode: str, group: int, ranges, name: str) -> None:
    """Raises ValueError, naming ``name`` and the group, where the input
    features ``ranges`` of a w4 or w4a8 weight are not whole groups of
    ``group`` (an even count in w4a8, as its half-split packing and its
    GEMM need)."""
    count = sum(b - a for a, b in ranges) // group
    if any(a % group or b % group for a, b in ranges) or (
            mode == "w4a8" and count % 2):
        raise ValueError(
            f"{name}: its inputs {list(ranges)} are not "
            + ("an even count of whole groups" if mode == "w4a8"
               else "whole groups")
            + f" of {group} ({mode}); quantize with a smaller group")


def take_inputs_w4a8(pweight: torch.Tensor, ranges) -> torch.Tensor:
    """The w4a8 codes (N, in/2), half-split, of the inputs in ``ranges``
    in order, packed half-split again over them (new storage)."""
    lo, hi = nibbles(pweight)
    mine = take_ranges(torch.cat([lo, hi], 1), 1, ranges)
    half = mine.shape[1] // 2
    return _pack(mine[:, :half], mine[:, half:])


def take_ranges(t: torch.Tensor, dim: int, ranges,
                copy: bool = True) -> torch.Tensor:
    """The blocks [start, stop) of ``ranges`` of ``t`` along ``dim``,
    concatenated in order: new storage with ``copy``, else a view where
    that is one contiguous block (and a contiguous copy where not)."""
    parts = [t.narrow(dim, a, b - a) for a, b in ranges]
    if len(parts) > 1:
        return torch.cat(parts, dim)
    return parts[0].clone() if copy else parts[0].contiguous()


def make_linear(quantized, dtype, impl: str = "auto"):
    """Linear factory with one signature, ``(d_in, d_out, bias=True,
    device=None)``: ``nn.Linear``, or ``QuantLinear`` in a quantized
    mode."""
    mode = quant_mode(quantized)
    if mode:
        return lambda d_in, d_out, bias=True, device=None: QuantLinear(
            d_in, d_out, bias, mode, dtype, device, impl)
    return lambda d_in, d_out, bias=True, device=None: nn.Linear(
        d_in, d_out, bias=bias, device=device, dtype=dtype)


def _swap_linears(module: nn.Module, quantized, swap):
    """Replace every child of ``module`` that ``swap(child, impl)`` maps
    to a new layer (None: recurse into it), one at a time, holding no
    reference to a replaced layer beyond its own swap. Every submodule
    config with a ``quantized`` field (``FluxConfig``) is set to
    ``quantized``, and each layer gets the ``quant_impl`` of the nearest
    such config above it ("auto" where there is none)."""

    def walk(parent, impl):
        cfg = getattr(parent, "cfg", None)
        if dataclasses.is_dataclass(cfg) and hasattr(cfg, "quantized"):
            parent.cfg = dataclasses.replace(cfg, quantized=quantized)
            impl = cfg.quant_impl
        for name in [n for n, _ in parent.named_children()]:
            new = swap(getattr(parent, name), impl)
            if new is None:
                walk(getattr(parent, name), impl)
            else:
                setattr(parent, name, new)

    walk(module, "auto")
    return module


@torch.no_grad()
def note_pre_scales_(module: nn.Module) -> nn.Module:
    """``note_pre_scale_`` on every ``QuantLinear`` below ``module``, after
    a writer that fills its buffers in place past the layers' hooks."""
    for child in module.modules():
        if isinstance(child, QuantLinear):
            child.note_pre_scale_()
    return module


def quantize_module_(module: nn.Module, mode: str = "w8a8",
                     group: int = INT4_GROUP) -> nn.Module:
    """Swap every ``nn.Linear`` below ``module`` for a ``QuantLinear`` in
    place (the counterpart of ``quantize_tree``, ``group`` its int4 group
    size), one layer at a time on the layer's own device, so that a full
    DiT is quantized on the card with only one layer's float temporaries
    beside it; each float weight is freed as its layer is swapped. The
    model then runs as if it had been built in that mode (see
    ``_swap_linears``)."""
    mode = quant_mode(mode)
    return _swap_linears(module, mode, lambda child, impl: (
        QuantLinear.from_linear(child, mode, impl, group)
        if isinstance(child, nn.Linear) else None))


@torch.no_grad()
def dequantize_module_(module: nn.Module) -> nn.Module:
    """Swap every ``QuantLinear`` below ``module`` back for an
    ``nn.Linear`` of its dtype holding its exact dequantized weight (w4's
    ``pre_scale`` folded in), the counterpart of ``dequantize_tree``: the
    float model on the weights the quantized one uses. Configs with a
    ``quantized`` field are set to False."""

    def swap(child, impl):
        if not isinstance(child, QuantLinear):
            return None
        lin = nn.Linear(child.in_features, child.out_features,
                        bias=child.bias is not None, dtype=child.dtype,
                        device=child.scale.device)
        lin.weight.copy_(child.dequantized_weight())
        if child.bias is not None:
            lin.bias.copy_(child.bias)
        return lin

    return _swap_linears(module, False, swap)
