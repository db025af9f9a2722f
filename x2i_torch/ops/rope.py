"""Rotary position embeddings, the counterpart of ``x2i_tpu/ops/rope.py``.

Two channel layouts of FLUX's 3-axis rope: the HALF (rotate-half) layout,
which the port serves by default and the attention kernel applies itself,
and the checkpoints' own INTERLEAVED pairs (x[2i], x[2i+1]), which
``FluxConfig.rope_layout="interleaved"`` keeps (the rotation then runs here,
outside the kernel). A model's q/k channels permuted by ``half_layout_perm``
rotate in the half layout exactly as the unpermuted ones do in the
interleaved layout. Tables are float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def flux_rope_freqs(ids: torch.Tensor, axes_dim: Sequence[int],
                    theta: float = 10000.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FLUX 3-axis cos/sin in the INTERLEAVED layout, each (S, D) f32 and
    repeated pairwise, so that cos[:, 2i] == cos[:, 2i + 1].

    ids: (S, n_axes) position ids, cat(txt_ids, img_ids)."""
    ids = ids.float()
    coses, sins = [], []
    for i, dim in enumerate(axes_dim):
        freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                              device=ids.device) / dim))
        ang = ids[:, i, None] * freqs[None, :]
        coses.append(torch.repeat_interleave(torch.cos(ang), 2, dim=-1))
        sins.append(torch.repeat_interleave(torch.sin(ang), 2, dim=-1))
    return torch.cat(coses, dim=-1), torch.cat(sins, dim=-1)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation (diffusers ``apply_rotary_emb``,
    use_real_unbind_dim=-1) of x (..., S, D) with (S, D) tables from
    ``flux_rope_freqs`` broadcast over the leading axes; f32 inside,
    x.dtype out. For (B, S, H, D) pass the tables as (S, 1, D)."""
    x_even = x[..., 0::2].float()
    x_odd = x[..., 1::2].float()
    c, s = cos[..., 0::2], sin[..., 0::2]    # pair members share the angle
    out = torch.stack([x_even * c - x_odd * s, x_odd * c + x_even * s],
                      dim=-1).reshape(x.shape)
    return out.to(x.dtype)


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
