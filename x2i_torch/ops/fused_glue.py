"""Row-local glue kernels of the DiT (K5 and K7 in CUDA C++, K6 and K8 in
Triton), their plain PyTorch versions, and the wrappers that pick between
them.

Counterparts of the TPU kernels of ``x2i_tpu/ops/fused_glue.py``, all
launched there through ``_rows_call``:

* K5 ``ln_mod`` (``_ln_mod_kernel``): ``modulate(layer_norm(x), shift,
  scale)`` in x.dtype, the glue of the bf16 and w8 paths;
* K6 ``ln_mod_quant`` (``_ln_mod_quant_kernel``): the same, then per-row
  int8 quantization;
* K7 ``gelu_quant`` (``_gelu_quant_kernel``): tanh-gelu rounded to x.dtype,
  then per-row int8 quantization;
* K8 ``quant_rows`` (``_quant_kernel``): per-row int8 quantization.

The LayerNorm has f32 row statistics (eps 1e-6, no affine) and rounds the
normalized row to x.dtype before ``* (1 + scale) + shift``, the rounding
point of the unfused path, whose ``layer_norm`` returns the input dtype.
The quantization is the w8a8 mode's dynamic one
(``x2i_tpu/ops/quant.py:39-42``)::

    a_scale = max(max|row|, 1e-6) / 127        (f32, IEEE division)
    codes   = clip(round_half_even(row / a_scale), -127, 127)  (int8)

and returns ``(codes (..., D) int8, a_scale (..., 1) f32)``, the
pre-quantized input form of ``QuantLinear``.

What bounds them on an H100: each reads a bf16 row block once and writes
it once (bf16, or int8 plus a scale per row) against a few operations per
byte, so memory bandwidth does: at 4608 rows about 17 us for K5, 13 us
for K6 and K8 at D = 3072, 51 us for K7 at D = 12288 (3.35 TB/s).

K5 and K7 are ``csrc/row_glue.cu`` (library ``ROW_GLUE``; the design is
in its header): persistent blocks walking spans of rows with the next
rows' loads in flight, a warp per 3072-wide row for K5 and two
warpgroups per 12288-wide row for K7, other widths (multiples of 8) through a
generic instance of each. ``check_row_args`` is what they take. K7's
identity instance, the quantization alone, is held bit for bit against
``quant_rows_plain`` through ``_quant_rows_cuda``; it is off the main
path and counts no launch.

K6 and K8 are one Triton program per (batch, token) row, the whole row
in one masked power-of-two block. Rounding to bf16 is done with integer
ops on the f32 bits, so that the compiler can fold no f32 -> bf16 -> f32
round trip away; the quantization's divisions are ``div_rn`` (Triton's
``/`` on f32 is an approximate division) and its rounding is ``rint`` (a
float -> int cast truncates). Triton is imported inside the launching
function, and the CUDA library is built at its first launch: a machine
without either can still import this module and run the plain versions.

Every wrapper takes its plain version for a CPU tensor or for
``impl="plain"`` (the plain route of ``FluxConfig.quant_impl``), and
launches its kernel otherwise. The kernels have no backward, as the TPU
ones have none: except on the "plain" route, a wrapper raises when
autograd records and an input requires grad, on the CPU as on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from x2i_torch.ops.cuda_lib import BUILD_DIR, CudaLibrary, refuse_grad

# every glue kernel's launches, K5's and K7's (CUDA) with K6's and K8's
# (Triton)
LAUNCHES = {"ln_mod": 0, "ln_mod_quant": 0, "gelu_quant": 0,
            "quant_rows": 0}


def _bind(lib):
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.x2i_ln_mod.argtypes = [p, ll, ll, p, p, ll, p, i, i, i,
                               ctypes.c_float, p]
    lib.x2i_ln_mod.restype = i
    lib.x2i_gelu_quant.argtypes = [p, ll, ll, p, p, i, i, i, i, p]
    lib.x2i_gelu_quant.restype = i


# K5 and K7; their launches count in LAUNCHES. The build gate checks every
# kernel of the library for spills.
ROW_GLUE = CudaLibrary(
    "row_glue.cu", "libx2i_row_glue", (), _bind,
    checked_kernels=("ln_mod_kernel", "ln_mod_rows_kernel", "quant_kernel",
                     "quant_rows_kernel"))


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ------------------------------------------------------------------ plain

def ln_mod_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x (B, S, D); shift/scale (B, D) -> x.dtype, step by step."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    y = (xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
         ).to(x.dtype)
    return y * (1.0 + scale[:, None, :]) + shift[:, None, :]


def quant_rows_plain(x: torch.Tensor):
    """Per-row int8 quantization of (..., D) -> (int8 (..., D), f32
    (..., 1)), bit for bit the dynamic quantization of the JAX
    ``w8a8_matmul``."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient (the
    # divisor is filled on the device: a copy from the host would block)
    a_scale = amax / amax.new_full((), 127.0)
    q = torch.round(xf / a_scale).clamp(-127.0, 127.0).to(torch.int8)
    return q, a_scale


def ln_mod_quant_plain(x, shift, scale, eps: float = 1e-6):
    return quant_rows_plain(ln_mod_plain(x, shift, scale, eps))


def gelu_quant_plain(x: torch.Tensor):
    """tanh-gelu in f32, rounded to x.dtype (the unfused gelu's output),
    then quantized."""
    return quant_rows_plain(F.gelu(x.float(), approximate="tanh")
                            .to(x.dtype))


# ----------------------------------------------------------------- Triton

@functools.cache
def _triton_kernel():
    # Triton's compile cache goes with the CUDA builds, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:              # Triton before 3.0
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def round_bf16(v):
        # nearest even on the bf16 grid, with integer ops on the f32 bits
        u = v.to(tl.uint32, bitcast=True)
        return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).to(
            tl.float32, bitcast=True)

    @triton.jit
    def load_row(x_ptr, row, seq, dim, stride_xb, stride_xs,
                 BLOCK_D: tl.constexpr):
        b = row // seq
        s = row % seq
        cols = tl.arange(0, BLOCK_D)
        valid = cols < dim
        x = tl.load(x_ptr + b * stride_xb + s * stride_xs + cols,
                    mask=valid, other=0.0).to(tl.float32)
        return x, b, cols, valid

    @triton.jit
    def ln_modulate(x_ptr, shift_ptr, scale_ptr, row, seq, dim, stride_xb,
                    stride_xs, stride_eb, eps, BLOCK_D: tl.constexpr):
        # K6's LN + modulate body: the modulated row in f32, each
        # intermediate rounded to bf16 where the plain version rounds it in
        # x.dtype (K5 in csrc/row_glue.cu rounds at the same points)
        x, b, cols, valid = load_row(x_ptr, row, seq, dim, stride_xb,
                                     stride_xs, BLOCK_D)
        mean = tl.sum(x, axis=0) / dim
        xc = tl.where(valid, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / dim
        y = round_bf16(xc * tl.rsqrt(var + eps))
        sc = tl.load(scale_ptr + b * stride_eb + cols, mask=valid,
                     other=0.0).to(tl.float32)
        sh = tl.load(shift_ptr + b * stride_eb + cols, mask=valid,
                     other=0.0).to(tl.float32)
        m = round_bf16(y * round_bf16(1.0 + sc))
        return round_bf16(m + sh), cols, valid

    @triton.jit
    def quantize_row(v, valid, cols, row, dim, q_ptr, s_ptr):
        amax = tl.max(tl.where(valid, tl.abs(v), 0.0), axis=0)
        a = libdevice.div_rn(tl.maximum(amax, 1e-6), 127.0)
        q = libdevice.rint(libdevice.div_rn(v, a))
        q = tl.minimum(tl.maximum(q, -127.0), 127.0)
        tl.store(q_ptr + row * dim + cols, q.to(tl.int8), mask=valid)
        tl.store(s_ptr + row, a)

    @triton.jit
    def ln_mod_quant_kernel(x_ptr, shift_ptr, scale_ptr, q_ptr, s_ptr, seq,
                            dim, stride_xb, stride_xs, stride_eb, eps,
                            BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        o, cols, valid = ln_modulate(x_ptr, shift_ptr, scale_ptr, row, seq,
                                     dim, stride_xb, stride_xs, stride_eb,
                                     eps, BLOCK_D)
        quantize_row(o, valid, cols, row, dim, q_ptr, s_ptr)

    @triton.jit
    def quant_rows_kernel(x_ptr, q_ptr, s_ptr, seq, dim, stride_xb,
                          stride_xs, BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        x, b, cols, valid = load_row(x_ptr, row, seq, dim, stride_xb,
                                     stride_xs, BLOCK_D)
        quantize_row(x, valid, cols, row, dim, q_ptr, s_ptr)

    return triton, {"ln_mod_quant": ln_mod_quant_kernel,
                    "quant_rows": quant_rows_kernel}


def _launch_config(triton, dim):
    # a warp per 512 columns of the block: 8 for the 3072-wide rows
    block = triton.next_power_of_2(dim)
    return dict(BLOCK_D=block, num_warps=max(1, min(32, block // 512)))


def _rows3(name, x):
    """(B, S, D) or (N, D) bf16 with a contiguous last dim -> (B, S, D)."""
    if (x.dtype != torch.bfloat16 or x.dim() not in (2, 3)
            or x.stride(-1) != 1):
        raise ValueError(f"{name} kernel: x must be (B, S, D) or (N, D) bf16 "
                         f"with a contiguous last dim, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    return x if x.dim() == 3 else x[None]


def _extras(name, x, shift, scale):
    b, _, d = x.shape
    for label, t in (("shift", shift), ("scale", scale)):
        if (t.dtype != x.dtype or t.shape != (b, d) or t.stride(1) != 1
                or t.device != x.device):
            raise ValueError(f"{name} kernel: {label} must be ({b}, {d}) "
                             f"{x.dtype} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if shift.stride(0) != scale.stride(0):
        shift, scale = shift.contiguous(), scale.contiguous()
    return shift, scale


def _run_quant(name, x, *extra, eps=None):
    """Launch K6 or K8 over (B, S, D) or (N, D) x -> (int8 codes of
    x's shape, f32 row scales (..., 1))."""
    shape = x.shape
    x = _rows3(name, x)
    b, s, d = x.shape
    triton, kernels = _triton_kernel()
    q = torch.empty(shape, dtype=torch.int8, device=x.device)
    a = torch.empty((*shape[:-1], 1), dtype=torch.float32, device=x.device)
    if extra:
        shift, scale = _extras(name, x, *extra)
        args = (x, shift, scale, q, a, s, d, x.stride(0), x.stride(1),
                shift.stride(0), eps)
    else:
        args = (x, q, a, s, d, x.stride(0), x.stride(1))
    kernels[name][(b * s,)](*args, **_launch_config(triton, d))
    LAUNCHES[name] += 1
    return q, a


def check_row_args(name: str, d: int, rows: int, strides, ptrs):
    """The widths and layouts that K5 and K7 take: at least one row, D a
    multiple of 8, and every row of x (and of shift and scale) starting on
    a 16-byte boundary: each of ``ptrs`` 16-byte aligned and each stride
    of ``strides``, given as (size, stride in bf16 elements) of a dim,
    a multiple of 8 where the dim's size is above 1. Raises ValueError
    otherwise."""
    if rows < 1 or d < 8 or d % 8:
        raise ValueError(f"{name} kernel: unsupported shape: {rows} rows of "
                         f"D = {d} (D must be a multiple of 8)")
    if (any(size > 1 and stride % 8 for size, stride in strides)
            or any(p % 16 for p in ptrs)):
        raise ValueError(f"{name} kernel: rows must start on 16-byte "
                         f"boundaries, got (size, stride) {list(strides)} "
                         f"and addresses {[p % 16 for p in ptrs]} mod 16")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _ln_mod_cuda(x, shift, scale, eps):
    x = _rows3("ln_mod", x)
    shift, scale = _extras("ln_mod", x, shift, scale)
    b, s, d = x.shape
    check_row_args("ln_mod", d, b * s,
                   [(b, x.stride(0)), (s, x.stride(1)), (b, shift.stride(0))],
                   [x.data_ptr(), shift.data_ptr(), scale.data_ptr()])
    out = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    _check_launch("ln_mod", ROW_GLUE.lib().x2i_ln_mod(
        x.data_ptr(), x.stride(0), x.stride(1), shift.data_ptr(),
        scale.data_ptr(), shift.stride(0), out.data_ptr(), b, s, d, eps,
        _stream(x)))
    LAUNCHES["ln_mod"] += 1
    return out


def _quant_cuda(name, x, gelu: bool):
    """Launch K7 (``gelu``) or its identity instance over (B, S, D) or
    (N, D) x -> (int8 codes of x's shape, f32 row scales (..., 1)); counts
    nothing."""
    shape = x.shape
    x = _rows3(name, x)
    b, s, d = x.shape
    check_row_args(name, d, b * s, [(b, x.stride(0)), (s, x.stride(1))],
                   [x.data_ptr()])
    q = torch.empty(shape, dtype=torch.int8, device=x.device)
    a = torch.empty((*shape[:-1], 1), dtype=torch.float32, device=x.device)
    _check_launch(name, ROW_GLUE.lib().x2i_gelu_quant(
        x.data_ptr(), x.stride(0), x.stride(1), q.data_ptr(), a.data_ptr(),
        b, s, d, int(gelu), _stream(x)))
    return q, a


def _gelu_quant_cuda(x):
    out = _quant_cuda("gelu_quant", x, True)
    LAUNCHES["gelu_quant"] += 1
    return out


def _quant_rows_cuda(x):
    """K7's identity instance: the function of ``quant_rows_plain`` (and
    of K8), off the main path, launched by the checks alone."""
    return _quant_cuda("quant_rows (K7 identity)", x, False)


def _plain(name, impl, *tensors):
    """Whether to take the plain version; off the "plain" route, refuse
    autograd first."""
    if impl == "plain":
        return True
    refuse_grad(f"the {name} kernel", *tensors)
    return tensors[0].device.type == "cpu"


def ln_mod(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
           eps: float = 1e-6) -> torch.Tensor:
    """K5: modulate(layer_norm(x), shift, scale) in one pass, x.dtype out.
    x (B, S, D); shift/scale (B, D). A CUDA tensor launches the CUDA
    kernel (which raises on what it does not take); a CPU tensor takes
    ``ln_mod_plain``."""
    if _plain("ln_mod", "auto", x, shift, scale):
        return ln_mod_plain(x, shift, scale, eps)
    return _ln_mod_cuda(x, shift, scale, eps)


def ln_mod_quant(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6, impl: str = "auto"):
    """K6: quantize(modulate(layer_norm(x), shift, scale)) in one pass.
    x (B, S, D); shift/scale (B, D) -> (int8 (B, S, D), f32 (B, S, 1))."""
    if _plain("ln_mod_quant", impl, x, shift, scale):
        return ln_mod_quant_plain(x, shift, scale, eps)
    return _run_quant("ln_mod_quant", x, shift, scale, eps=eps)


def gelu_quant(x: torch.Tensor, impl: str = "auto"):
    """K7: quantize(gelu_tanh(x) rounded to x.dtype) in one pass; x is
    (B, S, D) or (N, D)."""
    if _plain("gelu_quant", impl, x):
        return gelu_quant_plain(x)
    return _gelu_quant_cuda(x)


def quant_rows(x: torch.Tensor, impl: str = "auto"):
    """K8: per-row int8 quantization in one pass; x is (B, S, D) or
    (N, D)."""
    if _plain("quant_rows", impl, x):
        return quant_rows_plain(x)
    return _run_quant("quant_rows", x)
