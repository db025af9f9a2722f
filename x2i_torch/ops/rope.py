"""Rotary position embeddings in the HALF (rotate-half) channel layout.

Counterpart of the half-layout functions of ``x2i_tpu/ops/rope.py``. FLUX
checkpoints rotate interleaved pairs; the param tree the port loads already
carries its q/k channels permuted by ``half_layout_perm``, so the rotate-half
form reproduces the interleaved rotation exactly. Tables are float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def flux_rope_freqs_half(ids: torch.Tensor, axes_dim: Sequence[int],
                         theta: float = 10000.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FLUX 3-axis cos/sin, each (S, D) f32, as cat(base, base) where
    base holds the per-axis pair angles side by side.

    ids: (S, n_axes) position ids, cat(txt_ids, img_ids)."""
    ids = ids.float()
    angs = []
    for i, dim in enumerate(axes_dim):
        freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                              device=ids.device) / dim))
        angs.append(ids[:, i, None] * freqs[None, :])
    ang = torch.cat(angs, dim=-1)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def half_layout_perm(head_dim: int) -> np.ndarray:
    """Channel permutation taking interleaved-layout weights to half
    layout: new[m] = old[2m], new[D/2 + m] = old[2m + 1]."""
    return np.concatenate([np.arange(0, head_dim, 2),
                           np.arange(1, head_dim, 2)])


def rope_freqs_half(positions: torch.Tensor, head_dim: int, theta: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LLaMA/Qwen2 convention: (..., S) integer positions -> (cos, sin),
    each (..., S, head_dim) f32 tiled as cat(freqs, freqs)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """rotate_half rotation of x (B, S, H, D) with (S, D) or (B, S, D)
    tables broadcast over heads; computed in f32, x.dtype out."""
    d2 = x.shape[-1] // 2
    cos = cos.unsqueeze(-2)[..., :d2]
    sin = sin.unsqueeze(-2)[..., :d2]
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
