"""Qwen2.5-VL's text route, the counterpart of the LM half of
``x2i_tpu/models/qwen2_5_vl.py``: the Qwen2 LM under M-RoPE tables built
from 3-D (t, h, w) positions. The vision tower is not ported yet (the
config keeps only what the text route reads).

The port's rotation reads only the first half of each table
(``apply_rope_half``, as the JAX ``apply_rope_half`` does). M-RoPE's
sectioned tables qualify: the sections ``mrope_section * 2`` cut
``cat(ang, ang)``, and since the sections sum to head_dim / 2 the second
half takes the same streams at the same channels as the first.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import torch

from x2i_torch.core.config import Qwen2Config
from x2i_torch.models.qwen2 import Qwen2LM


@dataclass(frozen=True)
class Qwen2_5_VLConfig:
    """The text route's fields of the JAX ``Qwen2_5_VLConfig``."""

    llm: Qwen2Config = field(default_factory=Qwen2Config)
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


def mrope_tables(position_ids: torch.Tensor, head_dim: int, theta: float,
                 mrope_section: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE cos/sin, each (B, S, head_dim) f32, from 3-D positions
    (3, B, S): full tables per (t, h, w) stream, channel-sectioned as the
    concatenation over ``mrope_section * 2``, section i from stream
    i % 3 (the HF semantics)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=position_ids.device)
                           / head_dim))
    ang = position_ids.float()[..., None] * inv          # (3, B, S, D/2)
    ang = torch.cat([ang, ang], dim=-1)
    cos3, sin3 = torch.cos(ang), torch.sin(ang)
    cos_parts, sin_parts, start = [], [], 0
    for i, sec in enumerate(list(mrope_section) * 2):
        cos_parts.append(cos3[i % 3, ..., start:start + sec])
        sin_parts.append(sin3[i % 3, ..., start:start + sec])
        start += sec
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def encode_text(lm: Qwen2LM, cfg: Qwen2_5_VLConfig, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                position_ids_3d: torch.Tensor) -> torch.Tensor:
    """The encoder's text route: the LM's hidden-state stack (B, L+1, S,
    H) under the M-RoPE tables of ``position_ids_3d`` (3, B, S)."""
    rope = mrope_tables(position_ids_3d, cfg.llm.head_dim,
                        cfg.llm.rope_theta, cfg.mrope_section)
    states, _ = lm(input_ids, attention_mask=attention_mask, rope=rope)
    return states
