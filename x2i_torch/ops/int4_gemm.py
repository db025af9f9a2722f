"""The int4 weights' kernels (the w4a8 GEMM and the w4 dequantize kernel)
and the dequantizing GEMM of the weight-only modes w4 and w8, all in
``csrc/int8_gemm.cu`` and counted in ``int8_gemm.GEMM.launches``; their
plain PyTorch versions, and the wrappers that pick between them.

Both packings keep two int4 codes a byte, low nibble first, and a weight
row K-contiguous, the ``nn.Linear`` (out, in) orientation: ``pweight``
int8 (N, in/2) is the transpose of the JAX ``pkernel`` (in/2, N). They
differ in which inputs share a byte, so each has its own unpack:

* w4a8 (``x2i_tpu/ops/quant.py::quantize_kernel_w4a8``), half-split: byte
  j of a row holds input j low and input j + in/2 high. Each code is
  multiplied by its (group, out) multiplier m in [1, 15] (``mscale`` int8
  (G, N), the JAX layout), so the int8 operand is code x m, |.| <= 105.
  The GEMM (counterpart of ``_w4a8_acc`` under ``w4a8_matmul`` and
  ``w4a8_matmul_prequant``, XLA fusions on the TPU) computes over the
  weight's inputs [k0, k0 + K)::

      acc = xq @ codes[:, k0:k0 + K].T                        (int32, exact)
      out = ((f32(acc) * a_scale) * scale).to(out_dtype)

  then the addend and the bias as the int8 GEMM does
  (``int8_gemm.py``), in bf16 or, for an f32 layer, in f32 (the
  epilogue's f32 instance, counted as ``w4a8_gemm_f32``). |code x m| <=
  105, so 105 * 127 * 15360 < 2^31.
* w4 (``quantize_kernel_w4``), row-interleaved: byte j holds input 2j
  low and 2j + 1 high; the weight is ``bf16(code) * bf16(scale[g, n])``
  (``scale`` f32 (G, N)), rounded once, the JAX ``_dequant_w4`` in bf16.
  The dequantize kernel writes that (N, in) weight for the
  straight-through backward's dx; the forward takes the dequantizing
  GEMM. Its f32 instance (``w4_dequant_f32``) writes ``f32(code) *
  scale[g, n]``.

The dequantizing GEMM (counterpart of the JAX ``w8_matmul`` and
``w4_matmul``, ``x2i_tpu/ops/quant.py:102-111`` and ``:163-169``, whose
XLA fusions dequantize into the dot's operand) computes ``y = x @ W.T``
(+ bias) for bf16 x (M, K), W dequantized from the layer's own buffers:
w8 ``qweight`` int8 (N, K) with ``scale`` f32 (N,), or w4 ``pweight``
(N, K/2) row-interleaved with ``scale`` f32 (G, N). Each weight is
``bf16_rn(f32(code) * f32(bf16(scale)))``, the weight the dequantize
kernels write (the scale in the weight, never in the epilogue); the sums
are f32 and the output bf16, rounded once, then the bias added in bf16.
``dequant_gemm_weight`` has the kernel write the converted weight (N, K)
instead of the product, for the checks. On f32 x (an f32 DiT) the product
is the f32 dequantize kernel's weight (``int8_dequant`` or ``w4_dequant``
in f32) then ``F.linear`` in f32 and the f32 bias, the JAX
``jnp.dot`` on the weight dequantized to x's dtype; the dequantizing GEMM
keeps bf16 x.

The w4a8 dequantize kernel of the straight-through backward
(``ops/quant.py``) writes the (N, in) weight ``bf16(code x m) *
bf16(scale[n])``, rounded once, the JAX ``_w4a8_bwd``'s
(``x2i_tpu/ops/quant.py:359``); the w4 backward takes the w4 dequantize
kernel as it is.

A nibble is sign-extended as ``((b & 0xF) ^ 8) - 8``. ``w4a8_linear``,
``dequant_linear`` and ``w4_dequant`` launch their kernels for CUDA
tensors and take the plain versions for CPU tensors; there is no other
fallback. None has a backward: off ``impl="plain"`` the wrappers raise
when autograd records and an input requires grad.
"""

from __future__ import annotations

from typing import Optional

import torch

import torch.nn.functional as F

from x2i_torch.ops.cuda_lib import refuse_grad
from x2i_torch.ops.int8_gemm import (GEMM, OUT_KINDS, check_dequant_dtype,
                                     check_dequant_rows, check_epilogue,
                                     check_gemm_layout, int8_dequant,
                                     int8_dequant_plain,
                                     int8_matmul_acc_plain, launch_name,
                                     _check, _rows)

W4A8_K_STEP = 16       # K, k0, in/2 and the group size: multiples of it
                       # (a 16-byte chunk of packed codes is one group)
W4A8_SPAN_ALIGN = 128  # k0 of a chunk that crosses in/2 (one packed step)


def nibbles(packed: torch.Tensor):
    """int8 bytes -> (low, high) int8 codes in [-8, 7], sign-extended."""
    return ((packed & 0x0F) ^ 8) - 8, (((packed >> 4) & 0x0F) ^ 8) - 8


def w4a8_codes(pweight: torch.Tensor, mscale: torch.Tensor) -> torch.Tensor:
    """Half-split packed (..., N, in/2) and multipliers (..., G, N) ->
    the int8 operand (..., N, in), code x m."""
    lo, hi = nibbles(pweight)
    codes = torch.cat([lo, hi], dim=-1)
    n, inn = codes.shape[-2:]
    groups = mscale.shape[-2]
    m = mscale.transpose(-1, -2)[..., :, :, None]            # (.., N, G, 1)
    return (codes.reshape(*codes.shape[:-1], groups, inn // groups)
            * m).reshape(codes.shape)


def w4_codes(pweight: torch.Tensor) -> torch.Tensor:
    """Row-interleaved packed (..., N, in/2) -> int8 codes (..., N, in):
    input 2j is byte j's low nibble, 2j + 1 its high nibble."""
    lo, hi = nibbles(pweight)
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def w4_dequant_plain(pweight: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(N, in/2) packed, (G, N) f32 scales -> the (N, in) weight in dtype:
    the code and the scale cast to dtype, then one product in dtype."""
    codes = w4_codes(pweight).to(dtype)
    n, inn = codes.shape[-2:]
    groups = scale.shape[-2]
    s = scale.to(dtype).transpose(-1, -2)[..., :, :, None]
    return (codes.reshape(*codes.shape[:-1], groups, inn // groups)
            * s).reshape(codes.shape)


def check_w4a8_shapes(m: int, k: int, n: int, inn: int, groups: int,
                      k0: int):
    """The shapes the w4a8 kernel takes: M >= 1 rows of K codes, N a
    multiple of 8, the weight's inputs [k0, k0 + K) inside its ``inn``;
    K, k0, in/2 and the group size in/groups multiples of
    ``W4A8_K_STEP``, an even group count; a chunk that crosses in/2
    starts on a ``W4A8_SPAN_ALIGN`` boundary. Raises ValueError
    otherwise."""
    half = inn // 2
    g = inn // groups if groups else 0
    step = W4A8_K_STEP
    if (m < 1 or n < 8 or n % 8 or inn % 2 or half % step or groups < 2
            or groups % 2 or inn % groups or g % step or k < step
            or k % step or k0 < 0 or k0 % step or k0 + k > inn
            or (k0 < half < k0 + k and k0 % W4A8_SPAN_ALIGN)):
        raise ValueError(
            f"w4a8 GEMM kernel: unsupported shapes M {m}, K {k}, N {n}, "
            f"inputs {inn} in {groups} groups, k0 {k0} (N % 8, K, k0, in/2 "
            f"and the group size % {step}, an even group count, and k0 % "
            f"{W4A8_SPAN_ALIGN} for a chunk across in/2 must hold)")


def w4a8_matmul_acc_plain(xq: torch.Tensor, pweight: torch.Tensor,
                          mscale: torch.Tensor, k0: int = 0) -> torch.Tensor:
    """The exact int32 accumulator (..., N) of xq against the operand's
    inputs [k0, k0 + K): int32 on the CPU, float64 on a card."""
    return int8_matmul_acc_plain(xq, w4a8_codes(pweight, mscale), k0)


def w4a8_linear_plain(xq: torch.Tensor, a_scale: torch.Tensor,
                      pweight: torch.Tensor, mscale: torch.Tensor,
                      scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      k0: int = 0, addend: Optional[torch.Tensor] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function step by step in PyTorch."""
    acc = w4a8_matmul_acc_plain(xq, pweight, mscale, k0)
    out = (acc.float() * a_scale.float() * scale.float()).to(out_dtype)
    if addend is not None:
        out = addend.to(out_dtype) + out
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


def _launch_w4a8(xq, a_scale, pweight, mscale, scale, bias, k0, addend,
                 out_dtype, acc_only):
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"w4a8 GEMM kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    x = _rows(xq)
    m, k = x.shape
    _check("xq", x, torch.int8, dev)
    _check("pweight", pweight, torch.int8, dev)
    _check("mscale", mscale, torch.int8, dev)
    if pweight.dim() != 2 or mscale.dim() != 2 \
            or mscale.shape[1] != pweight.shape[0]:
        raise ValueError(f"w4a8 GEMM kernel: unsupported shapes: pweight "
                         f"{tuple(pweight.shape)} is not (N, in/2) or mscale "
                         f"{tuple(mscale.shape)} not (G, N)")
    n, half = pweight.shape
    groups = mscale.shape[0]
    check_w4a8_shapes(m, k, n, 2 * half, groups, k0)
    check_gemm_layout(x.stride(), pweight.stride(), x.data_ptr(),
                      pweight.data_ptr())
    if not mscale.is_contiguous():
        raise ValueError("w4a8 GEMM kernel: mscale must be contiguous")
    a = d = None
    if acc_only:
        out_dtype = torch.int32
    else:
        a, d = check_epilogue("w4a8 GEMM kernel", m, n, a_scale, scale, bias,
                              addend, out_dtype, dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = GEMM.lib().x2i_w4a8_gemm(
        x.data_ptr(), x.stride(0), pweight.data_ptr(), pweight.stride(0),
        mscale.data_ptr(), half, 2 * half // groups, k0, ptr(a), ptr(scale),
        ptr(bias), ptr(d), 0 if d is None else d.stride(0), out.data_ptr(),
        n, m, n, k, OUT_KINDS[out_dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4a8 GEMM launch failed: cudaError_t {err}")
    GEMM.launches[launch_name("w4a8_gemm", out_dtype)] += 1
    return out.reshape(*xq.shape[:-1], n)


def w4a8_linear(xq: torch.Tensor, a_scale: torch.Tensor,
                pweight: torch.Tensor, mscale: torch.Tensor,
                scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                k0: int = 0, addend: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16, impl: str = "auto") -> torch.Tensor:
    """The w4a8 product of pre-quantized activations (see the module
    docstring). A CUDA tensor launches the kernel, which raises on what it
    does not take; a CPU tensor, or ``impl="plain"``, takes
    ``w4a8_linear_plain``."""
    if impl != "plain":
        refuse_grad("the w4a8 GEMM", a_scale, scale, bias, addend)
    if impl == "plain" or xq.device.type == "cpu":
        return w4a8_linear_plain(xq, a_scale, pweight, mscale, scale, bias,
                                 k0, addend, out_dtype)
    return _launch_w4a8(xq, a_scale, pweight, mscale, scale, bias, k0,
                        addend, out_dtype, acc_only=False)


def w4a8_matmul_acc(xq: torch.Tensor, pweight: torch.Tensor,
                    mscale: torch.Tensor, k0: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """The int32 accumulator alone: the kernel's int32-out instance for a
    CUDA tensor (counted in ``GEMM.launches["w4a8_gemm_acc"]``), the
    plain version for a CPU one or with ``impl="plain"``. A member's
    product of a row-split w4a8 layer of the sharded DiT."""
    if impl == "plain" or xq.device.type == "cpu":
        return w4a8_matmul_acc_plain(xq, pweight, mscale, k0)
    return _launch_w4a8(xq, None, pweight, mscale, None, None, k0, None,
                        None, acc_only=True)


def check_dequant_args(n: int, half: int, groups: int, row_stride: int,
                       ptr: int):
    """What the dequantize kernel takes: N >= 1 rows of in/2 packed bytes,
    in/2 a multiple of 16, groups dividing in, contiguous 16-byte aligned
    rows (one 16-byte load a thread). Raises ValueError otherwise."""
    inn = 2 * half
    if (n < 1 or half < 16 or half % 16 or groups < 1 or inn % groups
            or (inn // groups) % 2 or row_stride % 16 or ptr % 16):
        raise ValueError(
            f"w4 dequantize kernel: unsupported shapes or layout: {n} rows "
            f"of {half} bytes, {groups} groups, row stride {row_stride} "
            f"(in/2 % 16, an even group size and 16-byte aligned rows must "
            f"hold)")


def w4_dequant(pweight: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16, impl: str = "auto") -> torch.Tensor:
    """The (N, in) weight of w4 codes (N, in/2) and scales (G, N) in dtype
    (bf16, or f32: ``w4_dequant_f32``): the kernel for a CUDA tensor,
    ``w4_dequant_plain`` for a CPU one or with ``impl="plain"``."""
    if impl != "plain":
        refuse_grad("the w4 dequantize kernel", scale)
    if impl == "plain" or pweight.device.type == "cpu":
        return w4_dequant_plain(pweight, scale, dtype)
    dev = pweight.device
    _check("pweight", pweight, torch.int8, dev)
    _check("scale", scale, torch.float32, dev)
    check_dequant_dtype("w4 dequantize kernel", dtype)
    if pweight.dim() != 2 or scale.dim() != 2 \
            or scale.shape[1] != pweight.shape[0] or pweight.stride(1) != 1 \
            or not scale.is_contiguous():
        raise ValueError(f"w4 dequantize kernel: pweight "
                         f"{tuple(pweight.shape)} must be (N, in/2) with "
                         f"contiguous rows and scale {tuple(scale.shape)} a "
                         f"contiguous (G, N)")
    n, half = pweight.shape
    check_dequant_args(n, half, scale.shape[0], pweight.stride(0),
                       pweight.data_ptr())
    out = torch.empty((n, 2 * half), dtype=dtype, device=dev)
    err = GEMM.lib().x2i_w4_dequant(
        pweight.data_ptr(), pweight.stride(0), scale.data_ptr(),
        out.data_ptr(), n, half, 2 * half // scale.shape[0],
        int(dtype == torch.float32), torch.cuda.current_stream(dev)
        .cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4 dequantize launch failed: cudaError_t {err}")
    GEMM.launches[launch_name("w4_dequant", dtype)] += 1
    return out


def w4a8_dequant_plain(pweight: torch.Tensor, mscale: torch.Tensor,
                       scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """(N, in/2) half-split packed, (G, N) multipliers, (N,) f32 scales ->
    the (N, in) weight in dtype: code x m cast to dtype times the scale
    cast to dtype, one product in dtype (the JAX ``_w4a8_bwd``'s)."""
    return w4a8_codes(pweight, mscale).to(dtype) * scale.to(dtype)[:, None]


def w4a8_dequant(pweight: torch.Tensor, mscale: torch.Tensor,
                 scale: torch.Tensor, dtype=torch.bfloat16,
                 impl: str = "auto") -> torch.Tensor:
    """The (N, in) weight of w4a8 codes (N, in/2), multipliers (G, N) and
    scales (N,): the kernel for a CUDA tensor (bf16 only),
    ``w4a8_dequant_plain`` for a CPU one or with ``impl="plain"``. The
    kernel counts in ``GEMM.launches["w4a8_dequant"]``."""
    if impl != "plain":
        refuse_grad("the w4a8 dequantize kernel", scale)
    if impl == "plain" or pweight.device.type == "cpu":
        return w4a8_dequant_plain(pweight, mscale, scale, dtype)
    dev = pweight.device
    _check("pweight", pweight, torch.int8, dev)
    _check("mscale", mscale, torch.int8, dev)
    _check("scale", scale, torch.float32, dev)
    if dtype != torch.bfloat16:
        raise ValueError(f"w4a8 dequantize kernel: bf16 output only, got "
                         f"{dtype}")
    if pweight.dim() != 2 or pweight.stride(1) != 1 or mscale.dim() != 2 \
            or mscale.shape[1] != pweight.shape[0] \
            or not mscale.is_contiguous() \
            or scale.shape != (pweight.shape[0],) or scale.stride(0) != 1:
        raise ValueError(f"w4a8 dequantize kernel: pweight "
                         f"{tuple(pweight.shape)} must be (N, in/2) with "
                         f"contiguous rows, mscale {tuple(mscale.shape)} a "
                         f"contiguous (G, N) and scale {tuple(scale.shape)} "
                         f"a contiguous (N,)")
    n, half = pweight.shape
    groups = mscale.shape[0]
    check_dequant_rows(n, half, pweight.stride(0), pweight.data_ptr(),
                       "w4a8 dequantize kernel")
    if (2 * half) % groups:
        raise ValueError(f"w4a8 dequantize kernel: unsupported shapes: "
                         f"{groups} groups do not split {2 * half} inputs")
    out = torch.empty((n, 2 * half), dtype=dtype, device=dev)
    err = GEMM.lib().x2i_w4a8_dequant(
        pweight.data_ptr(), pweight.stride(0), mscale.data_ptr(),
        scale.data_ptr(), out.data_ptr(), n, half, 2 * half // groups,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4a8 dequantize launch failed: cudaError_t "
                           f"{err}")
    GEMM.launches["w4a8_dequant"] += 1
    return out


DEQUANT_K_STEP = 64    # K of the dequantizing GEMM: a multiple of it


def dequant_weight_plain(codes: torch.Tensor, scale: torch.Tensor,
                         mode: str, dtype=torch.bfloat16) -> torch.Tensor:
    """The (N, K) weight of a w8 (``qweight``, per-row ``scale``) or w4
    (``pweight``, (G, N) ``scale``) layer in dtype: the code and the scale
    cast to dtype, one product in dtype."""
    if mode == "w8":
        return int8_dequant_plain(codes, scale, dtype)
    return w4_dequant_plain(codes, scale, dtype)


def dequant_linear_plain(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         mode: str = "w8") -> torch.Tensor:
    """The dequantizing GEMM's function in PyTorch: ``F.linear`` on the
    weight dequantized in x's dtype, then the bias added in x's dtype (the
    JAX ``w8_matmul`` / ``w4_matmul`` and ``QuantDense``'s bias)."""
    y = F.linear(x, dequant_weight_plain(codes, scale, mode, x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


def check_dequant_gemm_shapes(m: int, k: int, n: int, mode: str,
                              groups: int):
    """The shapes the dequantizing GEMM takes: M >= 1 rows, K a multiple of
    ``DEQUANT_K_STEP``, N a multiple of 8; in w4 a group size K / groups
    that is a whole multiple of 16 (a block of 16 inputs, one ``wgmma``
    step, has one scale). Raises ValueError otherwise."""
    g = k // groups if groups else 0
    if (mode not in ("w8", "w4") or m < 1 or k < DEQUANT_K_STEP
            or k % DEQUANT_K_STEP or n < 8 or n % 8
            or (mode == "w4" and (groups < 1 or k % groups or g % 16))):
        raise ValueError(
            f"dequantizing GEMM kernel: unsupported shapes M {m}, K {k}, N "
            f"{n} in mode {mode!r} with {groups} scale groups (K % "
            f"{DEQUANT_K_STEP}, N % 8 and, in w4, a group size % 16 must "
            f"be 0)")


def check_dequant_gemm_layout(x_strides, codes_strides, x_ptr: int,
                              codes_ptr: int):
    """Contiguous rows of x (bf16) and of the codes, each row start 16-byte
    aligned (a tensor map's base and row stride). Raises ValueError
    otherwise."""
    if (x_strides[1] != 1 or codes_strides[1] != 1 or (2 * x_strides[0]) % 16
            or codes_strides[0] % 16 or x_ptr % 16 or codes_ptr % 16):
        raise ValueError("dequantizing GEMM kernel: x and the codes need "
                         "contiguous rows with 16-byte aligned starts and "
                         "strides")


def _launch_dequant(x, codes, scale, bias, mode, dump):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"dequantizing GEMM kernel: tensors must be on a "
                         f"CUDA device, got {dev}")
    xr = _rows(x)
    m, k = xr.shape
    _check("x", xr, torch.bfloat16, dev)
    _check("codes", codes, torch.int8, dev)
    _check("scale", scale, torch.float32, dev)
    n = codes.shape[0] if codes.dim() == 2 else -1
    width = (2 if mode == "w4" else 1) * codes.shape[-1]
    want_scale = (n,) if mode == "w8" else (scale.shape[0], n)
    if codes.dim() != 2 or width != k or tuple(scale.shape) != want_scale \
            or not scale.is_contiguous():
        raise ValueError(f"dequantizing GEMM kernel: x {tuple(x.shape)}, "
                         f"codes {tuple(codes.shape)} and scale "
                         f"{tuple(scale.shape)} are not (M, K), the {mode} "
                         f"codes of K inputs and a contiguous "
                         f"{'(N,)' if mode == 'w8' else '(G, N)'} scale")
    groups = scale.shape[0] if mode == "w4" else 1
    check_dequant_gemm_shapes(m, k, n, mode, groups)
    check_dequant_gemm_layout(xr.stride(), codes.stride(), xr.data_ptr(),
                              codes.data_ptr())
    if bias is not None:
        _check("bias", bias, torch.bfloat16, dev)
        if bias.shape != (n,) or bias.stride(0) != 1:
            raise ValueError(f"dequantizing GEMM kernel: bias must be ({n},)")
    out = torch.empty((n, k) if dump else (m, n), dtype=torch.bfloat16,
                      device=dev)
    err = GEMM.lib().x2i_dequant_gemm(
        xr.data_ptr(), xr.stride(0), codes.data_ptr(), codes.stride(0),
        scale.data_ptr(), k // groups, None if bias is None
        else bias.data_ptr(), out.data_ptr(), out.stride(0), m, n, k,
        int(mode == "w4"), int(dump), torch.cuda.current_stream(dev)
        .cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequantizing GEMM launch failed: cudaError_t "
                           f"{err}")
    GEMM.launches["dequant_gemm"] += 1
    return out if dump else out.reshape(*x.shape[:-1], n)


def _dequant_linear_f32(x, codes, scale, bias, mode):
    """The weight-only product on f32 x: the f32 dequantize kernel's
    weight, then ``F.linear`` in f32 and the f32 bias added."""
    width = (2 if mode == "w4" else 1) * codes.shape[-1]
    if mode not in ("w8", "w4") or x.shape[-1] != width:
        raise ValueError(f"weight-only product: x {tuple(x.shape)} and the "
                         f"{mode!r} codes {tuple(codes.shape)} are not "
                         f"(..., K) and the w8 or w4 codes of K inputs")
    if bias is not None:
        _check("bias", bias, torch.float32, x.device, "weight-only product")
    dequant = int8_dequant if mode == "w8" else w4_dequant
    y = F.linear(x, dequant(codes, scale, torch.float32))
    return y if bias is None else y + bias


def dequant_linear(x: torch.Tensor, codes: torch.Tensor,
                   scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   mode: str = "w8", impl: str = "auto") -> torch.Tensor:
    """The weight-only product of a w8 or w4 layer (see the module
    docstring): a CUDA tensor launches the dequantizing GEMM on bf16 x, or
    the f32 dequantize kernel before ``F.linear`` on f32 x, each raising
    on what it does not take; a CPU tensor, or ``impl="plain"``, takes
    ``dequant_linear_plain``."""
    if impl != "plain":
        refuse_grad("the dequantizing GEMM", x, scale, bias)
    if impl == "plain" or x.device.type == "cpu":
        return dequant_linear_plain(x, codes, scale, bias, mode)
    if x.dtype == torch.float32:
        return _dequant_linear_f32(x, codes, scale, bias, mode)
    return _launch_dequant(x, codes, scale, bias, mode, dump=False)


def dequant_gemm_weight(x: torch.Tensor, codes: torch.Tensor,
                        scale: torch.Tensor, mode: str) -> torch.Tensor:
    """The (N, K) bf16 weight as the dequantizing GEMM's converter writes
    it into its B stages, dumped by the kernel (x only gives the launch
    its A operand): the checks hold it bit for bit against the dequantize
    kernels. A CPU tensor takes ``dequant_weight_plain`` in x's dtype."""
    if x.device.type == "cpu":
        return dequant_weight_plain(codes, scale, mode, x.dtype)
    return _launch_dequant(x, codes, scale, None, mode, dump=True)
