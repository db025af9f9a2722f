"""Qwen2.5-VL's text route, the counterpart of the LM half of
``x2i_tpu/models/qwen2_5_vl.py``: the Qwen2 LM under M-RoPE tables built
from 3-D (t, h, w) positions. The vision tower is not ported yet (the
config keeps only what the text route reads).

The port's rotation reads only the first half of each table
(``apply_rope_half``, as the JAX ``apply_rope_half`` does). M-RoPE's
sectioned tables qualify: the sections ``mrope_section * 2`` cut
``cat(ang, ang)``, and since the sections sum to head_dim / 2 the second
half takes the same streams at the same channels as the first.

``encode_with_answer`` is the ``use_answer`` reasoning2image route: a
greedy answer after the prompt, its hidden states concatenated with the
prompt's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from x2i_torch.core.config import Qwen2Config
from x2i_torch.models.decoding import (concat_answer_hiddens,
                                       greedy_decode_with_hiddens)
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


def encode_with_answer(lm: Qwen2LM, cfg: Qwen2_5_VLConfig,
                       input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       position_ids_3d: torch.Tensor,
                       vision_inputs: Optional[dict] = None,
                       max_new_tokens: int = 128,
                       eos_token_id: int = 151645):
    """The ``use_answer`` conditioning on the text route: the prompt's
    prefill under the M-RoPE tables of ``position_ids_3d`` (3, B, S), a
    greedy answer of ``max_new_tokens`` steps whose positions start at
    the largest 3-D position + 1 (text after the prompt takes one
    position on all three streams, which is 1-D rope), and the two
    stacks concatenated along the sequence. -> (stack (B, L+1, S +
    max_new_tokens, H), tokens (B, T), valid (B, T))."""
    if vision_inputs is not None:
        raise NotImplementedError(
            "image and video inputs come with the vision tower (ROADMAP.md "
            "Queue A item 4); the port encodes text")
    rope = mrope_tables(position_ids_3d, cfg.llm.head_dim,
                        cfg.llm.rope_theta, cfg.mrope_section)
    step_pos0 = position_ids_3d.amax(dim=(0, 2)) + 1
    with torch.inference_mode():
        embeds = lm.embed(input_ids)
    prefill, steps, tokens, valid = greedy_decode_with_hiddens(
        lm, embeds, attention_mask, max_new_tokens, eos_token_id,
        prefill_rope=rope, step_pos0=step_pos0)
    return concat_answer_hiddens(prefill, steps), tokens, valid
