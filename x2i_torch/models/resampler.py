"""The perceiver resampler of MiniCPM-o, the counterpart of
``x2i_tpu/models/resampler.py``: ``num_queries`` learned queries
cross-attend a slice's ViT patches in one attention (torch
MultiheadAttention's arithmetic: the packed in-projection as three
Linears, an out-projection with bias), the 2-D sincos table (host-built,
``data/minicpm_vision.py``) added to the keys only, the patch mask on the
keys, ``ln_q`` / ``ln_kv`` before and ``ln_post`` after, then the raw
(d, d) matrix ``proj`` (not a Linear's weight: ``out @ proj``).

The attention is 64 query rows on a slice's patches, 128-wide heads,
non-causal, masked: the dispatcher's pad route pads q to 128 rows and the
keys to a multiple of 128 (masked) and hands them to K1's exact body, on
the card and, in JAX, to the Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from x2i_torch.core.config import ResamplerConfig
from x2i_torch.models.clip import LayerNorm
from x2i_torch.ops.attention import attention


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt, eps = cfg.embed_dim, cfg.dtype, cfg.layer_norm_eps

        def lin(i, o, bias=True):
            return nn.Linear(i, o, bias=bias, device=device, dtype=dt)

        self.query = nn.Parameter(torch.zeros((cfg.num_queries, d),
                                              dtype=dt, device=device))
        if cfg.kv_dim != d:
            self.kv_proj = lin(cfg.kv_dim, d, bias=False)
        self.ln_kv = LayerNorm(d, eps, dt, device)
        self.ln_q = LayerNorm(d, eps, dt, device)
        self.in_proj_q, self.in_proj_k, self.in_proj_v, self.out_proj = (
            lin(d, d) for _ in range(4))
        self.ln_post = LayerNorm(d, eps, dt, device)
        self.proj = nn.Parameter(torch.zeros((d, d), dtype=dt,
                                             device=device))

    def forward(self, x: torch.Tensor, pos_embed: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, L, kv_dim) ViT features, pos_embed (B, L, embed_dim) the
        slices' sincos tables, kv_mask (B, L) True where the patch is real
        -> (B, num_queries, embed_dim)."""
        cfg = self.cfg
        b, l, _ = x.shape
        d, h, nq = cfg.embed_dim, cfg.num_heads, cfg.num_queries
        x = x.to(cfg.dtype)                   # flax's Dense casts its input
        if cfg.kv_dim != d:
            x = self.kv_proj(x)
        x = self.ln_kv(x)
        q = self.in_proj_q(self.ln_q(self.query)).expand(b, nq, d)
        k = self.in_proj_k(x + pos_embed.to(x.dtype))
        v = self.in_proj_v(x)
        out = attention(q.reshape(b, nq, h, -1), k.reshape(b, l, h, -1),
                        v.reshape(b, l, h, -1), kv_mask=kv_mask,
                        implementation=cfg.attention_impl)
        out = self.ln_post(self.out_proj(out.reshape(b, nq, d)))
        return out @ self.proj.to(out.dtype)
