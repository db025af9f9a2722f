"""The int8 GEMM of the w8a8 mode: the CUDA kernel ``csrc/int8_gemm.cu``,
its plain PyTorch version, and the wrapper that picks between them.

Counterpart of the int8 products in ``x2i_tpu/ops/quant.py``
(``w8a8_matmul`` and ``w8a8_matmul_prequant``, XLA dots on the TPU). For
activation codes ``xq`` (..., K) int8 with row scales ``a_scale``
(..., 1) f32, and weight codes ``qweight`` (N, in) int8 with per-output
scales ``scale`` (N,) f32, it computes over the weight's columns
``[k0, k0 + K)``::

    acc = xq @ qweight[:, k0:k0 + K].T                       (int32, exact)
    out = ((f32(acc) * a_scale) * scale).to(out_dtype)
    out = addend + out                                       (if given)
    out = out + bias                                         (if given)

in the JAX package's order and at its rounding points: the rescale in f32
and rounded once, each addition then rounded in ``out_dtype``. The int32
sum is exact: at most 127 * 127 * 15360 < 2^31 on the DiT's widest input.
``out_dtype`` is bf16 (the bf16 DiT) or f32 (an f32 DiT's layers, the
epilogue's f32 instance, counted as ``int8_gemm_f32``), the bias and the
addend in it; in f32 the kernel is bit for bit the plain version.

``int8_linear`` launches the kernel for a CUDA tensor and takes
``int8_linear_plain`` for a CPU tensor; there is no other fallback.
The kernel is built on ``wgmma``, on 128 x 256 output tiles.
The kernel has no backward: off ``impl="plain"`` the wrapper raises when
autograd records and an input requires grad.
The plain version sums in int32 on the CPU and in float64 on a card
(cuBLAS has no int32 product; float64 is exact below 2^53).

The same source holds the int8 dequantize kernel of the straight-through
backward (``ops/quant.py``), the counterpart of the dequantize in the JAX
``_w8a8_bwd`` (``x2i_tpu/ops/quant.py:77``): ``int8_dequant`` writes the
(N, in) weight ``bf16(code) * bf16(scale[n])``, rounded once, that the
output gradient is multiplied by. Its f32 instance (``int8_dequant_f32``)
writes ``f32(code) * scale[n]``, the weight of the w8 mode's product on
f32 x (``int4_gemm.dequant_linear``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from x2i_torch.ops.cuda_lib import CudaLibrary, refuse_grad

K_STEP = 64          # K must be a multiple of it (the kernel zero-fills its
                     # 128-byte K tiles past K)


def _bind(lib):
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.x2i_int8_gemm.argtypes = [p, ll, p, ll, ll, p, p, p, p, ll, p, ll,
                                  i, i, i, i, p]
    lib.x2i_w4a8_gemm.argtypes = [p, ll, p, ll, p, i, i, i, p, p, p, p, ll,
                                  p, ll, i, i, i, i, p]
    lib.x2i_w4_dequant.argtypes = [p, ll, p, p, i, i, i, i, p]
    lib.x2i_int8_dequant.argtypes = [p, ll, p, p, i, i, i, p]
    lib.x2i_w4a8_dequant.argtypes = [p, ll, p, p, p, i, i, i, p]
    lib.x2i_dequant_gemm.argtypes = [p, ll, p, ll, p, i, p, p, ll, i, i, i,
                                     i, i, p]
    for fn in (lib.x2i_int8_gemm, lib.x2i_w4a8_gemm, lib.x2i_w4_dequant,
               lib.x2i_int8_dequant, lib.x2i_w4a8_dequant,
               lib.x2i_dequant_gemm):
        fn.restype = ctypes.c_int


# the library also holds the int4 weights' kernels and the dequantizing
# GEMM of the weight-only modes (ops/int4_gemm.py): the w4a8 GEMM is this
# GEMM with a B stage converted from packed int4 codes, the dequantizing
# GEMM a bf16 GEMM whose weight the consumers convert in registers; and
# the dequantize kernels of the straight-through backward and of the
# weight-only modes on f32 x; the "_f32" counts are the f32 instances'
GEMM = CudaLibrary("int8_gemm.cu", "libx2i_int8_gemm",
                   ("int8_gemm", "w4a8_gemm", "dequant_gemm", "w4_dequant",
                    "int8_dequant", "w4a8_dequant", "int8_gemm_acc",
                    "w4a8_gemm_acc", "int8_gemm_f32", "w4a8_gemm_f32",
                    "int8_dequant_f32", "w4_dequant_f32"), _bind,
                   wgmma_kernels=("int8_gemm_kernel", "w4a8_gemm_kernel",
                                  "dequant_gemm_kernel"),
                   checked_kernels=("w4_dequant_kernel",
                                    "int8_dequant_kernel",
                                    "w4a8_dequant_kernel"))


def check_gemm_shapes(m: int, k: int, n: int, width: int, k0: int):
    """The shapes the kernel takes: M >= 1 rows of K codes, K a multiple of
    ``K_STEP``, N a multiple of 8, and the weight's columns [k0, k0 + K)
    inside its ``width`` with k0 on a 16-byte boundary (the start of a TMA
    box); raises ValueError otherwise."""
    if (m < 1 or k < K_STEP or k % K_STEP or n < 8 or n % 8 or k0 < 0
            or k0 % 16 or k0 + k > width):
        raise ValueError(f"int8 GEMM kernel: unsupported shapes M {m}, K "
                         f"{k}, N {n}, weight width {width}, k0 {k0} (K % "
                         f"{K_STEP}, N % 8 and k0 % 16 must be 0)")


def check_gemm_layout(x_strides, w_strides, x_ptr: int, w_ptr: int):
    """The layout of the codes: contiguous rows of A (M, K) and of the
    weight (N, width), each row start 16-byte aligned (a tensor map's base
    and row stride); raises ValueError otherwise."""
    if (x_strides[1] != 1 or w_strides[1] != 1 or x_strides[0] % 16
            or w_strides[0] % 16 or x_ptr % 16 or w_ptr % 16):
        raise ValueError("int8 GEMM kernel: xq and qweight need contiguous "
                         "rows with 16-byte aligned starts and strides")


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def int8_matmul_acc_plain(xq: torch.Tensor, qweight: torch.Tensor,
                          k0: int = 0) -> torch.Tensor:
    """The exact int32 accumulator (..., N) of xq against the weight's
    columns [k0, k0 + K)."""
    w = qweight[:, k0:k0 + xq.shape[-1]]
    if xq.device.type == "cpu":
        acc = _rows(xq).int() @ w.int().T
    else:
        acc = (_rows(xq).double() @ w.double().T).int()
    return acc.reshape(*xq.shape[:-1], w.shape[0])


def int8_linear_plain(xq: torch.Tensor, a_scale: torch.Tensor,
                      qweight: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, k0: int = 0,
                      addend: Optional[torch.Tensor] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function step by step in PyTorch."""
    acc = int8_matmul_acc_plain(xq, qweight, k0)
    out = (acc.float() * a_scale.float() * scale.float()).to(out_dtype)
    if addend is not None:
        out = addend.to(out_dtype) + out
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


def _check(name, t, dtype, device, kernel="int8 GEMM"):
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{kernel}: {name} must be {dtype} on {device}, "
                         f"got {t.dtype} on {t.device}")


# the epilogue's output dtypes, and what the kernels' `out_kind` calls them
# (the int32 accumulator the third)
OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}


def check_epilogue(kernel: str, m: int, n: int, a_scale, scale, bias,
                   addend, out_dtype, device):
    """The epilogue's operands of the int8 and w4a8 GEMMs: out_dtype bf16
    or f32; a_scale m and scale n contiguous f32 values; the bias (n,) and
    the addend (m, n) with contiguous rows, both in out_dtype, an f32
    addend's rows starting on 16-byte boundaries (two 16-byte loads a
    thread); all on ``device``. Raises ValueError otherwise. -> (a_scale
    as (m,), the addend as (m, n) rows or None)."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel}: bf16 or f32 output only, got "
                         f"{out_dtype}")
    a = a_scale.reshape(-1)
    _check("a_scale", a, torch.float32, device, kernel)
    _check("scale", scale, torch.float32, device, kernel)
    if a.shape != (m,) or scale.shape != (n,) or a.stride(0) != 1 \
            or scale.stride(0) != 1:
        raise ValueError(f"{kernel}: a_scale must hold {m} and scale {n} "
                         f"contiguous f32 values, got "
                         f"{tuple(a_scale.shape)}, {tuple(scale.shape)}")
    if bias is not None:
        _check("bias", bias, out_dtype, device, kernel)
        if bias.shape != (n,) or bias.stride(0) != 1:
            raise ValueError(f"{kernel}: bias must be ({n},)")
    d = None
    if addend is not None:
        d = _rows(addend)
        _check("addend", d, out_dtype, device, kernel)
        per16 = 16 // d.element_size()
        f32 = out_dtype == torch.float32
        if (d.shape != (m, n) or d.stride(1) != 1 or d.stride(0) % 2
                or (f32 and (d.stride(0) % per16 or d.data_ptr() % 16))):
            raise ValueError(f"{kernel}: addend must be ({m}, {n}) with "
                             f"contiguous rows" + (" starting on 16-byte "
                                                   "boundaries" if f32
                                                   else ""))
    return a, d


def check_dequant_dtype(kernel: str, dtype) -> None:
    """The dequantize kernels write a bf16 or an f32 weight. Raises
    ValueError otherwise."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel}: bf16 or f32 output only, got {dtype}")


def _launch(xq, a_scale, qweight, scale, bias, k0, addend, out_dtype,
            acc_only):
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"int8 GEMM kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    x = _rows(xq)
    m, k = x.shape
    _check("xq", x, torch.int8, dev)
    _check("qweight", qweight, torch.int8, dev)
    if qweight.dim() != 2:
        raise ValueError(f"int8 GEMM kernel: unsupported shapes: qweight "
                         f"{tuple(qweight.shape)} is not (N, in)")
    n, width = qweight.shape
    check_gemm_shapes(m, k, n, width, k0)
    check_gemm_layout(x.stride(), qweight.stride(), x.data_ptr(),
                      qweight.data_ptr())
    a = d = None
    if acc_only:
        out_dtype = torch.int32
    else:
        a, d = check_epilogue("int8 GEMM kernel", m, n, a_scale, scale, bias,
                              addend, out_dtype, dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = GEMM.lib().x2i_int8_gemm(
        x.data_ptr(), x.stride(0), qweight.data_ptr(), qweight.stride(0), k0,
        ptr(a), ptr(scale), ptr(bias), ptr(d),
        0 if d is None else d.stride(0), out.data_ptr(), n, m, n, k,
        OUT_KINDS[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 GEMM launch failed: cudaError_t {err}")
    GEMM.launches[launch_name("int8_gemm", out_dtype)] += 1
    return out.reshape(*xq.shape[:-1], n)


def launch_name(kernel: str, out_dtype) -> str:
    """The count of a GEMM's (or dequantize kernel's) instance for
    ``out_dtype``: ``kernel``, "_f32" after it for f32, "_acc" for the
    int32 accumulator."""
    return kernel + {torch.float32: "_f32", torch.int32: "_acc"}.get(
        out_dtype, "")


def int8_linear(xq: torch.Tensor, a_scale: torch.Tensor,
                qweight: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, k0: int = 0,
                addend: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16,
                impl: str = "auto") -> torch.Tensor:
    """The w8a8 product of pre-quantized activations (see the module
    docstring). A CUDA tensor launches the kernel, which raises on what it
    does not take; a CPU tensor, or ``impl="plain"``, takes
    ``int8_linear_plain``."""
    if impl != "plain":
        refuse_grad("the int8 GEMM", a_scale, scale, bias, addend)
    if impl == "plain" or xq.device.type == "cpu":
        return int8_linear_plain(xq, a_scale, qweight, scale, bias, k0,
                                 addend, out_dtype)
    return _launch(xq, a_scale, qweight, scale, bias, k0, addend, out_dtype,
                   acc_only=False)


def int8_matmul_acc(xq: torch.Tensor, qweight: torch.Tensor,
                    k0: int = 0, impl: str = "auto") -> torch.Tensor:
    """The int32 accumulator alone (the function of ``torch._int_mm``):
    the kernel's int32-out instance for a CUDA tensor (counted in
    ``GEMM.launches["int8_gemm_acc"]``), the plain version for a CPU one
    or with ``impl="plain"``. A member's product of a row-split w8a8
    layer of the sharded DiT (``parallel/tensor.py``), whose accumulators
    the tensor axis sums before the scales."""
    if impl == "plain" or xq.device.type == "cpu":
        return int8_matmul_acc_plain(xq, qweight, k0)
    return _launch(xq, None, qweight, None, None, k0, None, None,
                   acc_only=True)


def int8_dequant_plain(qweight: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """(N, in) int8 codes, (N,) f32 scales -> the (N, in) weight in dtype:
    the code and the scale cast to dtype, then one product in dtype (the
    JAX ``_w8a8_bwd``'s ``qk.astype(x_dtype) * scale.astype(x_dtype)``)."""
    return qweight.to(dtype) * scale.to(dtype)[:, None]


def check_dequant_rows(n: int, width: int, row_stride: int, ptr: int,
                       kernel: str):
    """What the dequantize kernels read: N >= 1 rows of ``width`` bytes,
    a multiple of 8, contiguous, each row start 8-byte aligned (one 8-byte
    load a thread). Raises ValueError otherwise."""
    if n < 1 or width < 8 or width % 8 or row_stride % 8 or ptr % 8:
        raise ValueError(
            f"{kernel}: unsupported shapes or layout: {n} rows of {width} "
            f"bytes, row stride {row_stride} (width, row stride and start "
            f"% 8 must be 0)")


def int8_dequant(qweight: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.bfloat16, impl: str = "auto") -> torch.Tensor:
    """The (N, in) weight of int8 codes (N, in) and scales (N,) in dtype
    (bf16, or f32: ``int8_dequant_f32``): the kernel for a CUDA tensor,
    ``int8_dequant_plain`` for a CPU one or with ``impl="plain"``."""
    if impl != "plain":
        refuse_grad("the int8 dequantize kernel", scale)
    if impl == "plain" or qweight.device.type == "cpu":
        return int8_dequant_plain(qweight, scale, dtype)
    dev = qweight.device
    _check("qweight", qweight, torch.int8, dev)
    _check("scale", scale, torch.float32, dev)
    check_dequant_dtype("int8 dequantize kernel", dtype)
    if qweight.dim() != 2 or qweight.stride(1) != 1 \
            or scale.shape != (qweight.shape[0],) or scale.stride(0) != 1:
        raise ValueError(f"int8 dequantize kernel: qweight "
                         f"{tuple(qweight.shape)} must be (N, in) with "
                         f"contiguous rows and scale {tuple(scale.shape)} a "
                         f"contiguous (N,)")
    n, k = qweight.shape
    check_dequant_rows(n, k, qweight.stride(0), qweight.data_ptr(),
                       "int8 dequantize kernel")
    out = torch.empty((n, k), dtype=dtype, device=dev)
    err = GEMM.lib().x2i_int8_dequant(
        qweight.data_ptr(), qweight.stride(0), scale.data_ptr(),
        out.data_ptr(), n, k, int(dtype == torch.float32),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 dequantize launch failed: cudaError_t "
                           f"{err}")
    GEMM.launches[launch_name("int8_dequant", dtype)] += 1
    return out
