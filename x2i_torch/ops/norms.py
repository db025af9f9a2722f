"""Normalization primitives (functional; f32 statistics, input-dtype output).

Counterpart of ``x2i_tpu/ops/norms.py``."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        xf = xf * weight.float()
    return xf.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    xf = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        xf = xf * weight.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(x.dtype)
