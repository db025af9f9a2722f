"""SigLIP-so400m with NaViT variable resolution, MiniCPM-o's ``vpm``: the
counterpart of ``x2i_tpu/models/siglip.py``.

The patch convolution is a Linear over the flattened (c, py, px) patch;
the position table (70 x 70 entries) is indexed by the host's bucketized
fractional ids (``data/minicpm_vision.py``), so any aspect ratio maps onto
it; pre-LN blocks with a tanh GELU; then ``post_layernorm``. MiniCPM drops
the last block: ``cfg.effective_layers`` of them run. Attention goes
through the dispatcher with the patch mask. Its head size is 72
(1152 / 16), which no kernel takes (JAX's Pallas rule and the port's
both want 64 or 128 for the kernel and the pad route), so it takes the
plain attention, as it takes XLA in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import SiglipVisionConfig
from x2i_torch.models.clip import LayerNorm
from x2i_torch.ops.attention import attention


class SiglipBlock(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype

        def lin(i, o):
            return nn.Linear(i, o, device=device, dtype=dt)

        self.ln1 = LayerNorm(c, cfg.layer_norm_eps, dt, device)
        self.q, self.k, self.v, self.o = (lin(c, c) for _ in range(4))
        self.ln2 = LayerNorm(c, cfg.layer_norm_eps, dt, device)
        self.fc1 = lin(c, cfg.intermediate_size)
        self.fc2 = lin(cfg.intermediate_size, c)

    def forward(self, hidden: torch.Tensor,
                kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, c = hidden.shape
        heads = (b, s, self.cfg.num_attention_heads, -1)
        x = self.ln1(hidden)
        attn = attention(self.q(x).reshape(heads), self.k(x).reshape(heads),
                         self.v(x).reshape(heads), kv_mask=kv_mask,
                         implementation=self.cfg.attention_impl)
        hidden = hidden + self.o(attn.reshape(b, s, c))
        x = F.gelu(self.fc1(self.ln2(hidden)), approximate="tanh")
        return hidden + self.fc2(x)


class SiglipVisionTransformer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        self.patch_embedding = nn.Linear(
            cfg.num_channels * cfg.patch_size ** 2, c, device=device,
            dtype=dt)
        self.position_embedding = nn.Embedding(
            cfg.num_patches_per_side ** 2, c, device=device, dtype=dt)
        self.block = nn.ModuleList(SiglipBlock(cfg, device)
                                   for _ in range(cfg.effective_layers))
        self.post_layernorm = LayerNorm(c, cfg.layer_norm_eps, dt, device)

    def forward(self, patches: torch.Tensor, position_ids: torch.Tensor,
                patch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """patches (B, S, 3 * ps^2) padded, position_ids (B, S) ids into
        the position table, patch_mask (B, S) True where the patch is
        real -> (B, S, hidden) (the padding rows are garbage, which the
        resampler masks)."""
        hidden = self.patch_embedding(patches.to(self.cfg.dtype))
        hidden = hidden + self.position_embedding(position_ids.long())
        for blk in self.block:
            hidden = blk(hidden, patch_mask)
        return self.post_layernorm(hidden)
