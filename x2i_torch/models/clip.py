"""CLIP's two towers, the counterpart of ``x2i_tpu/models/clip.py``.

The text tower is the pooled-embedding teacher of phase-1 distillation
(openai/clip-vit-large-patch14's text tower): learned position
embeddings, pre-LN blocks, quick_gelu, causal attention with an optional
kv mask; the pooled output is the final-LN hidden state at the first EOS
token. The vision tower is the CLIP-T / CLIP-FID scorer's
(``evalmetrics.py``): a patch convolution, a class token, a position
table, pre-LN, non-causal pre-LN blocks with quick_gelu, and the post-LN
class row as the pooled output. Its attention goes through the
dispatcher: in bf16 on the card its 257 tokens (CLS and 16 x 16 patches)
take the pad route to the flash kernel, in f32 the plain route.
``CLIPModel`` holds both towers and the two projections of an HF
``CLIPModel`` checkpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from x2i_torch.core.config import CLIPTextConfig, CLIPVisionConfig
from x2i_torch.ops.attention import attention
from x2i_torch.ops.norms import layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    """Affine LayerNorm with flax's parameter names (scale, bias)."""

    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class CLIPBlock(nn.Module):
    """A pre-LN block of either tower: causal in the text tower, not in
    the vision tower (JAX's ``CLIPVisionBlock``)."""

    def __init__(self, cfg, device=None, causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        hid = cfg.hidden_size

        def lin(i, o):
            return nn.Linear(i, o, device=device, dtype=cfg.dtype)

        self.ln1 = LayerNorm(hid, cfg.layer_norm_eps, cfg.dtype, device)
        self.q, self.k, self.v, self.o = (lin(hid, hid) for _ in range(4))
        self.ln2 = LayerNorm(hid, cfg.layer_norm_eps, cfg.dtype, device)
        self.fc1 = lin(hid, cfg.intermediate_size)
        self.fc2 = lin(cfg.intermediate_size, hid)

    def forward(self, hidden, kv_mask):
        cfg = self.cfg
        b, s, _ = hidden.shape
        h = cfg.num_attention_heads
        x = self.ln1(hidden)
        q, k, v = (lin(x).view(b, s, h, cfg.hidden_size // h)
                   for lin in (self.q, self.k, self.v))
        attn = attention(q, k, v, kv_mask=kv_mask, causal=self.causal)
        hidden = hidden + self.o(attn.reshape(b, s, cfg.hidden_size))
        return hidden + self.fc2(quick_gelu(self.fc1(self.ln2(hidden))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            device=device, dtype=cfg.dtype)
        self.position_embedding = nn.Parameter(torch.zeros(
            (cfg.max_position_embeddings, cfg.hidden_size), dtype=cfg.dtype,
            device=device))
        self.block = nn.ModuleList(CLIPBlock(cfg, device)
                                   for _ in range(cfg.num_hidden_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                  cfg.dtype, device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (B, S) -> (last_hidden (B, S, H), pooled (B, H))."""
        s = input_ids.shape[1]
        hidden = (self.token_embedding(input_ids)
                  + self.position_embedding[None, :s])
        mask = None if attention_mask is None else attention_mask.bool()
        for blk in self.block:
            hidden = blk(hidden, mask)
        hidden = self.final_ln(hidden)
        # pooled = the hidden state at the first EOS token
        eos = (input_ids == self.cfg.eos_token_id).int().argmax(-1)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        return hidden, hidden[rows, eos]


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, c, p, stride=p, bias=False,
                                         device=device, dtype=cfg.dtype)
        self.class_embedding = nn.Parameter(torch.zeros(
            c, dtype=cfg.dtype, device=device))
        self.position_embedding = nn.Parameter(torch.zeros(
            ((cfg.image_size // p) ** 2 + 1, c), dtype=cfg.dtype,
            device=device))
        self.pre_layernorm = LayerNorm(c, cfg.layer_norm_eps, cfg.dtype,
                                       device)
        self.block = nn.ModuleList(CLIPBlock(cfg, device, causal=False)
                                   for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = LayerNorm(c, cfg.layer_norm_eps, cfg.dtype,
                                        device)

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels (B, H, W, 3) CLIP-normalized -> (last_hidden (B, 1 + P,
        C), pooled (B, C))."""
        c = self.cfg.hidden_size
        x = pixels.to(self.cfg.dtype).permute(0, 3, 1, 2)
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)
        b = patches.shape[0]
        hidden = torch.cat([self.class_embedding.expand(b, 1, c), patches],
                           1) + self.position_embedding[None]
        hidden = self.pre_layernorm(hidden)
        for blk in self.block:
            hidden = blk(hidden, None)
        return hidden, self.post_layernorm(hidden[:, 0])


class CLIPModel(nn.Module):
    """Both towers and the projections into the shared space (stored as
    ``nn.Linear`` weights, (projection_dim, hidden), as HF stores them)."""

    def __init__(self, text_cfg: CLIPTextConfig,
                 vision_cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.text_model = CLIPTextEncoder(text_cfg, device)
        self.vision_model = CLIPVisionEncoder(vision_cfg, device)
        self.text_projection = nn.Linear(
            text_cfg.hidden_size, vision_cfg.projection_dim, bias=False,
            device=device, dtype=text_cfg.dtype)
        self.visual_projection = nn.Linear(
            vision_cfg.hidden_size, vision_cfg.projection_dim, bias=False,
            device=device, dtype=vision_cfg.dtype)
