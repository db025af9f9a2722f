"""The Qwen2.5-VL encoder, the counterpart of
``x2i_tpu/models/qwen2_5_vl.py``: the vision tower and the Qwen2 LM under
M-RoPE tables built from 3-D (t, h, w) positions.

The vision tower (HF ``Qwen2_5_VisionTransformerPretrainedModel``): the
temporal patch embedding as one Linear over the flattened patch, RMSNorm
blocks with a 2-D rotate-half rope applied in f32, window attention (full
attention on ``fullatt_block_indexes``) as an f32 segment bias of 0 and
-1e30, SwiGLU MLPs, and the 2 x 2 patch merger. Every data-dependent
index (the window permutation, the segment ids, the rope positions, the
reverse permutation) comes from the host (``data/qwen_vision.py``). The
bias takes the dispatcher's plain route (f32 scores and softmax), as it
takes XLA's in JAX: the tower launches no kernel. ``embed_multimodal``
fills the image and video pad positions with the tower's features in
order, on the device (``models/internvl.py::scatter_features``).

The port's rotation reads only the first half of each LM table
(``apply_rope_half``, as the JAX ``apply_rope_half`` does). M-RoPE's
sectioned tables qualify: the sections ``mrope_section * 2`` cut
``cat(ang, ang)``, and since the sections sum to head_dim / 2 the second
half takes the same streams at the same channels as the first.

``encode_with_answer`` is the ``use_answer`` reasoning2image route: a
greedy answer after the prompt (images and video included), its hidden
states concatenated with the prompt's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import Qwen2Config
from x2i_torch.models.decoding import (concat_answer_hiddens,
                                       greedy_decode_with_hiddens)
from x2i_torch.models.internvl import scatter_features
from x2i_torch.models.qwen2 import Qwen2LM, RMSNorm
from x2i_torch.ops.attention import attention

# the host half's arrays that the tower reads (data/qwen_vision.py)
VISION_KEYS = ("patches", "pos_hw", "window_seg", "image_seg",
               "reverse_index")


@dataclass(frozen=True)
class QwenVisionConfig:
    """The Qwen2.5-VL vision tower (the 7B's; the 3B's differs only in
    ``out_hidden_size``, the LM's width)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    out_hidden_size: int = 3584
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rms_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class Qwen2_5_VLConfig:
    vision: QwenVisionConfig = field(default_factory=QwenVisionConfig)
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


def vision_rope(pos_hw: torch.Tensor, head_dim: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D rotary tables of the tower, each (S, head_dim) f32, from (S, 2)
    (h, w) positions: head_dim / 4 frequencies per axis, emb =
    cat(freqs_h, freqs_w) twice (the rotate-half layout)."""
    dim = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=pos_hw.device) / dim))
    pos = pos_hw.float()
    freqs = torch.cat([pos[:, 0:1] * inv[None], pos[:, 1:2] * inv[None]],
                      dim=-1)                               # (S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


class QwenVisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype

        def lin(i, o):
            return nn.Linear(i, o, device=device, dtype=dt)

        self.norm1 = RMSNorm(c, cfg.rms_norm_eps, dt, device)
        self.qkv = lin(c, 3 * c)
        self.proj = lin(c, c)
        self.norm2 = RMSNorm(c, cfg.rms_norm_eps, dt, device)
        self.gate_proj = lin(c, cfg.intermediate_size)
        self.up_proj = lin(c, cfg.intermediate_size)
        self.down_proj = lin(cfg.intermediate_size, c)

    def forward(self, hidden, cos, sin, bias):
        """hidden (S, C); cos/sin (S, head_dim) f32; bias (1, 1, S, S)
        f32, this layer's (window or full) segment mask."""
        cfg = self.cfg
        s, c = hidden.shape
        h, d = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(self.norm1(hidden)).reshape(s, 3, h, d)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        cosb, sinb = cos[:, None, :], sin[:, None, :]
        qf, kf = q.float(), k.float()
        q = (qf * cosb + _rotate_half(qf) * sinb).to(q.dtype)
        k = (kf * cosb + _rotate_half(kf) * sinb).to(k.dtype)
        attn = attention(q[None], k[None], v[None], bias=bias,
                         implementation=cfg.attention_impl)[0]
        hidden = hidden + self.proj(attn.reshape(s, c))
        x = self.norm2(hidden)
        return hidden + self.down_proj(F.silu(self.gate_proj(x))
                                       * self.up_proj(x))


def _segment_bias(seg: torch.Tensor) -> torch.Tensor:
    eq = seg[:, None] == seg[None, :]
    return torch.where(eq, 0.0, -1e30).to(torch.float32)[None, None]


class QwenVisionTransformer(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        unit = cfg.spatial_merge_size ** 2
        patch = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
        self.patch_embed = nn.Linear(patch, c, bias=False, device=device,
                                     dtype=dt)
        self.block = nn.ModuleList(QwenVisionBlock(cfg, device)
                                   for _ in range(cfg.depth))
        self.ln_q = RMSNorm(c, cfg.rms_norm_eps, dt, device)
        self.merger_fc1 = nn.Linear(unit * c, unit * c, device=device,
                                    dtype=dt)
        self.merger_fc2 = nn.Linear(unit * c, cfg.out_hidden_size,
                                    device=device, dtype=dt)

    def forward(self, patches, pos_hw, window_seg, image_seg):
        """patches (S, C * temporal_patch * patch^2), window-permuted on
        the host; pos_hw (S, 2) rope positions; window_seg and image_seg
        (S,) segment ids of the windows and of the images. -> (S / 4,
        out_hidden_size), still in window order."""
        cfg = self.cfg
        s = patches.shape[0]
        hidden = self.patch_embed(patches.to(cfg.dtype))
        cos, sin = vision_rope(pos_hw, cfg.head_dim)
        bias_full, bias_win = _segment_bias(image_seg), \
            _segment_bias(window_seg)
        full = set(cfg.fullatt_block_indexes)
        for i, blk in enumerate(self.block):
            hidden = blk(hidden, cos, sin,
                         bias_full if i in full else bias_win)
        unit = cfg.spatial_merge_size ** 2
        merged = self.ln_q(hidden).reshape(s // unit, unit * cfg.hidden_size)
        return self.merger_fc2(F.gelu(self.merger_fc1(merged)))


class Qwen2_5_VLEncoder(nn.Module):
    """The tower and the LM under one module, with the JAX encoder's
    names (``visual``, ``language_model``): what a checkpoint fills.
    ``language_model``: an LM to share, by default a new one."""

    def __init__(self, cfg: Qwen2_5_VLConfig, device=None,
                 language_model: Optional[Qwen2LM] = None):
        super().__init__()
        self.cfg = cfg
        self.visual = QwenVisionTransformer(cfg.vision, device)
        self.language_model = language_model or Qwen2LM(cfg.llm, device)


def vision_tensors(vision_inputs: Optional[Dict], device
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """The tower's arrays of a host dict (``prepare_vision_inputs``) as
    tensors on ``device``."""
    if vision_inputs is None:
        return None
    return {k: torch.as_tensor(vision_inputs[k], device=device)
            for k in VISION_KEYS}


def encode_vision(visual: QwenVisionTransformer,
                  vision_inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tower's merged features in the order of the media (the reverse
    window permutation applied)."""
    feats = visual(vision_inputs["patches"], vision_inputs["pos_hw"],
                   vision_inputs["window_seg"], vision_inputs["image_seg"])
    return feats[vision_inputs["reverse_index"]]


def embed_multimodal(lm: Qwen2LM, cfg: Qwen2_5_VLConfig,
                     input_ids: torch.Tensor,
                     visual: Optional[QwenVisionTransformer] = None,
                     vision_inputs: Optional[Dict] = None) -> torch.Tensor:
    """Token embeddings with the tower's features at the image and video
    pad positions, in order (HF's masked_scatter)."""
    embeds = lm.embed(input_ids)
    if vision_inputs is None:
        return embeds
    if visual is None:
        raise ValueError("vision inputs need the vision tower; this "
                         "encoder was built without it")
    selected = ((input_ids == cfg.image_token_id)
                | (input_ids == cfg.video_token_id))
    return scatter_features(embeds, selected,
                            encode_vision(visual, vision_inputs))


def encode_text(lm: Qwen2LM, cfg: Qwen2_5_VLConfig, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                position_ids_3d: torch.Tensor,
                visual: Optional[QwenVisionTransformer] = None,
                vision_inputs: Optional[Dict] = None) -> torch.Tensor:
    """The encoder's forward: the LM's hidden-state stack (B, L+1, S, H)
    under the M-RoPE tables of ``position_ids_3d`` (3, B, S), the
    tower's features at the pad positions when ``vision_inputs`` (the
    tensors of ``VISION_KEYS``) are given."""
    rope = mrope_tables(position_ids_3d, cfg.llm.head_dim,
                        cfg.llm.rope_theta, cfg.mrope_section)
    if vision_inputs is None:
        return lm(input_ids, attention_mask=attention_mask, rope=rope)[0]
    embeds = embed_multimodal(lm, cfg, input_ids, visual, vision_inputs)
    return lm(inputs_embeds=embeds, attention_mask=attention_mask,
              rope=rope)[0]


def encode_with_answer(lm: Qwen2LM, cfg: Qwen2_5_VLConfig,
                       input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       position_ids_3d: torch.Tensor,
                       vision_inputs: Optional[dict] = None,
                       max_new_tokens: int = 128,
                       eos_token_id: int = 151645,
                       visual: Optional[QwenVisionTransformer] = None):
    """The ``use_answer`` conditioning: the prompt's prefill (the tower's
    features at the pad positions when ``vision_inputs`` are given) under
    the M-RoPE tables of ``position_ids_3d`` (3, B, S), a greedy answer
    of ``max_new_tokens`` steps whose positions start at the largest 3-D
    position + 1 (text after the prompt takes one position on all three
    streams, which is 1-D rope), and the two stacks concatenated along
    the sequence. -> (stack (B, L+1, S + max_new_tokens, H), tokens (B,
    T), valid (B, T))."""
    rope = mrope_tables(position_ids_3d, cfg.llm.head_dim,
                        cfg.llm.rope_theta, cfg.mrope_section)
    step_pos0 = position_ids_3d.amax(dim=(0, 2)) + 1
    with torch.inference_mode():
        embeds = embed_multimodal(lm, cfg, input_ids, visual, vision_inputs)
    prefill, steps, tokens, valid = greedy_decode_with_hiddens(
        lm, embeds, attention_mask, max_new_tokens, eos_token_id,
        prefill_rope=rope, step_pos0=step_pos0)
    return concat_answer_hiddens(prefill, steps), tokens, valid
