"""int8 weight quantization of the DiT's dense layers: the counterpart of
the int8 half of ``x2i_tpu/ops/quant.py`` (forward only; the w4 and w4a8
modes and the straight-through backward are not ported yet).

Two modes:

* ``"w8"``: int8 weights with per-output-channel f32 scales, dequantized
  to the activation dtype for a plain product (a memory saving only);
* ``"w8a8"``: the activations are quantized per token as well, and the
  product runs int8 x int8 -> int32 through the int8 GEMM
  (``x2i_torch/ops/int8_gemm.py``), rescaled by row scale x channel scale.

``QuantLinear`` stores ``qweight`` int8 (out, in), the ``nn.Linear``
orientation, so that both GEMM operands are K-contiguous; ``scale`` f32
(out,); ``bias`` in the layer's dtype. The JAX ``QuantDense`` stores
``qkernel`` (in, out); the bridge (``x2i_torch/params.py``) transposes.
``quantize_kernel`` takes the JAX layout (..., in, out), as the JAX
function does, and gives the same codes and scales bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import quant_mode
from x2i_torch.ops.fused_glue import quant_rows, quant_rows_plain
from x2i_torch.ops.int8_gemm import int8_linear, int8_linear_plain


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
    w = qweight.to(x.dtype) * scale.to(x.dtype)[:, None]
    return F.linear(x, w)


class QuantLinear(nn.Module):
    """``nn.Linear`` with int8 weights, the counterpart of ``QuantDense``
    (int8 modes). ``forward`` takes

    * a tensor (..., in): quantized per token by ``quant_rows`` (K8) in
      w8a8, or multiplied by the dequantized weight in w8;
    * an ``(xq, a_scale)`` pair from a glue kernel (w8a8 only);
    * a list of such pairs, chunks along the input features: each is a
      K-slice of the one weight, and the chunks' bf16 parts are summed in
      order, so that a concatenation of the inputs is never built.

    ``impl`` is ``FluxConfig.quant_impl``: "plain" takes the plain
    quantization and product on any device; otherwise a CUDA tensor
    launches the kernels. The weights are buffers (and the bias a
    parameter without gradient): the layer is frozen."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, mode: str = "w8a8",
                 dtype=torch.bfloat16, device=None, impl: str = "auto"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.mode = quant_mode(mode)
        self.dtype, self.impl = dtype, impl
        self.register_buffer("qweight", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device),
                                  requires_grad=False) if bias else None)

    @torch.no_grad()
    def set_weight_(self, weight: torch.Tensor) -> "QuantLinear":
        """Quantize a float (out, in) weight into this layer."""
        q, s = quantize_kernel(weight.t())
        self.qweight.copy_(q.t())
        self.scale.copy_(s)
        return self

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear, mode: str,
                    impl: str = "auto") -> "QuantLinear":
        w = linear.weight
        q = cls(linear.in_features, linear.out_features,
                linear.bias is not None, mode, w.dtype, w.device, impl)
        q.set_weight_(w)
        if linear.bias is not None:
            q.bias.copy_(linear.bias)
        return q

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            return self._prequant(x if isinstance(x, list) else [x])
        if self.mode == "w8":
            y = w8_matmul(x.to(self.dtype), self.qweight, self.scale)
            return y if self.bias is None else y + self.bias
        # the product rounds to x.dtype, then to the layer's dtype, as the
        # JAX layer does; the bias rides the GEMM's epilogue when the two
        # dtypes agree (always in the DiT)
        same = x.dtype == self.dtype
        xq, a_scale = quant_rows(x, self.impl)
        y = int8_linear(xq, a_scale, self.qweight, self.scale,
                        bias=self.bias if same else None,
                        out_dtype=x.dtype, impl=self.impl)
        if not same:
            y = y.to(self.dtype)
            if self.bias is not None:
                y = y + self.bias
        return y

    def _prequant(self, chunks):
        if self.mode != "w8a8":
            raise ValueError("pre-quantized input requires mode w8a8")
        widths = [xq.shape[-1] for xq, _ in chunks]
        if sum(widths) != self.in_features:
            raise ValueError(f"chunks of widths {widths} do not make "
                             f"{self.in_features} input features")
        y, off = None, 0
        for i, (xq, a_scale) in enumerate(chunks):
            last = i == len(chunks) - 1
            y = int8_linear(xq, a_scale, self.qweight, self.scale,
                            bias=self.bias if last else None, k0=off,
                            addend=y, out_dtype=self.dtype, impl=self.impl)
            off += widths[i]
        return y


def make_linear(quantized, dtype, impl: str = "auto"):
    """Linear factory with one signature, ``(d_in, d_out, bias=True,
    device=None)``: ``nn.Linear``, or ``QuantLinear`` in an int8 mode."""
    mode = quant_mode(quantized)
    if mode:
        return lambda d_in, d_out, bias=True, device=None: QuantLinear(
            d_in, d_out, bias, mode, dtype, device, impl)
    return lambda d_in, d_out, bias=True, device=None: nn.Linear(
        d_in, d_out, bias=bias, device=device, dtype=dtype)


@torch.no_grad()
def quantize_module_(module: nn.Module, mode: str = "w8a8") -> nn.Module:
    """Swap every ``nn.Linear`` below ``module`` for a ``QuantLinear`` in
    place (the counterpart of ``quantize_tree``), one layer at a time on
    the layer's own device, so that a full DiT is quantized on the card
    with only one layer's float temporaries beside it; each float weight
    is freed as its layer is swapped. Every submodule config with a
    ``quantized`` field (``FluxConfig``) is set to ``mode``, so that the
    model then runs as if it had been built in that mode, and each new
    layer takes the ``quant_impl`` of the nearest such config above it
    ("auto" where there is none)."""
    mode = quant_mode(mode)

    def swap(parent, impl):
        cfg = getattr(parent, "cfg", None)
        if dataclasses.is_dataclass(cfg) and hasattr(cfg, "quantized"):
            parent.cfg = dataclasses.replace(cfg, quantized=mode)
            impl = cfg.quant_impl
        # names, not children: hold no reference to a float layer beyond
        # its own swap
        for name in [n for n, _ in parent.named_children()]:
            child = getattr(parent, name)
            if isinstance(child, nn.Linear):
                setattr(parent, name,
                        QuantLinear.from_linear(child, mode, impl))
            else:
                swap(child, impl)

    swap(module, "auto")
    return module
