"""CLIP text encoder, the counterpart of the text tower of
``x2i_tpu/models/clip.py``: the pooled-embedding teacher of phase-1
distillation (openai/clip-vit-large-patch14's text tower). Learned position
embeddings, pre-LN blocks, quick_gelu, causal attention with an optional kv
mask; the pooled output is the final-LN hidden state at the first EOS
token. The vision tower (the CLIP-T metric) is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from x2i_torch.core.config import CLIPTextConfig
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
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
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
        attn = attention(q, k, v, kv_mask=kv_mask, causal=True)
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
