"""LayerNorm + AdaLN modulate in one pass: the Triton kernel K5, its plain
PyTorch version and the wrapper that picks between them.

Replaces the TPU kernel ``x2i_tpu/ops/fused_glue.py::_ln_mod_kernel``
(body ``_ln_modulate``), launched through ``_rows_call`` by ``ln_mod``.
It computes ``modulate(layer_norm(x), shift, scale)`` with f32 row
statistics (eps 1e-6, no affine), the normalized row rounded to x.dtype
before ``* (1 + scale) + shift`` -- the rounding point of the unfused path,
whose ``layer_norm`` returns the input dtype.

What bounds it on an H100: a (1, 4608, 3072) bf16 row block is one read
and one write of 28 MB each, against a few FLOP per byte, so memory
bandwidth bounds it (about 17 us at the 3.35 TB/s data-sheet rate).

Design: one Triton program per (batch, token) row, the whole 3072-wide row
in one masked 4096-wide block, so each byte of x is read once and each
byte of the output written once, which is all the bound allows. Triton is
imported inside the launching function: a machine without it can still
import this module and run the plain version.
"""

from __future__ import annotations

import functools
import os

import torch

from x2i_torch.ops.flash_attention import BUILD_DIR

LAUNCHES = {"ln_mod": 0}


def reset_launches():
    LAUNCHES["ln_mod"] = 0


def ln_mod_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x (B, S, D); shift/scale (B, D) -> x.dtype, step by step."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    y = (xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
         ).to(x.dtype)
    return y * (1.0 + scale[:, None, :]) + shift[:, None, :]


@functools.cache
def _triton_kernel():
    # Triton's compile cache goes with the CUDA build, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def ln_mod_kernel(x_ptr, shift_ptr, scale_ptr, out_ptr, seq, dim,
                      stride_xb, stride_xs, stride_eb, eps,
                      BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        b = row // seq
        s = row % seq
        cols = tl.arange(0, BLOCK_D)
        valid = cols < dim
        x = tl.load(x_ptr + b * stride_xb + s * stride_xs + cols,
                    mask=valid, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / dim
        xc = tl.where(valid, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / dim
        dt = out_ptr.dtype.element_ty
        # Each intermediate is rounded to x.dtype's grid (bf16, nearest
        # even) with integer ops on the f32 bits, so that the compiler can
        # fold no f32 -> bf16 -> f32 round trip away: the same per-op
        # rounding as the plain version in x.dtype.
        u = (xc * tl.rsqrt(var + eps)).to(tl.uint32, bitcast=True)
        y = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).to(
            tl.float32, bitcast=True)
        sc = tl.load(scale_ptr + b * stride_eb + cols, mask=valid,
                     other=0.0).to(tl.float32)
        sh = tl.load(shift_ptr + b * stride_eb + cols, mask=valid,
                     other=0.0).to(tl.float32)
        u = (1.0 + sc).to(tl.uint32, bitcast=True)
        t = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).to(
            tl.float32, bitcast=True)
        u = (y * t).to(tl.uint32, bitcast=True)
        m = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).to(
            tl.float32, bitcast=True)
        o = (m + sh).to(dt)
        tl.store(out_ptr + row * dim + cols, o, mask=valid)

    return triton, ln_mod_kernel


def _ln_mod_cuda(x, shift, scale, eps):
    # the kernel's explicit rounding is to the bf16 grid
    if x.dtype != torch.bfloat16 or x.dim() != 3 or x.stride(-1) != 1:
        raise ValueError(f"ln_mod kernel: x must be (B, S, D) bf16 with a "
                         f"contiguous last dim, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, s, d = x.shape
    for name, t in (("shift", shift), ("scale", scale)):
        if (t.dtype != x.dtype or t.shape != (b, d) or t.stride(1) != 1
                or t.device != x.device):
            raise ValueError(f"ln_mod kernel: {name} must be ({b}, {d}) "
                             f"{x.dtype} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if shift.stride(0) != scale.stride(0):
        shift, scale = shift.contiguous(), scale.contiguous()
    triton, kernel = _triton_kernel()
    out = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    kernel[(b * s,)](x, shift, scale, out, s, d, x.stride(0), x.stride(1),
                     shift.stride(0), eps,
                     BLOCK_D=triton.next_power_of_2(d), num_warps=8)
    LAUNCHES["ln_mod"] += 1
    return out


def ln_mod(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
           eps: float = 1e-6) -> torch.Tensor:
    """modulate(layer_norm(x), shift, scale) in one pass, x.dtype out.
    A CUDA tensor launches the Triton kernel (which raises on what it does
    not take); a CPU tensor takes ``ln_mod_plain``."""
    if x.device.type == "cpu":
        return ln_mod_plain(x, shift, scale, eps)
    return _ln_mod_cuda(x, shift, scale, eps)
