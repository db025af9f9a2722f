"""T5 v1.1 encoder stack, the counterpart of ``x2i_tpu/models/t5.py``: the
frozen T5-XXL teacher text encoder of phase-1 distillation.

T5 specifics: an RMS LayerNorm without bias or mean-centring, no 1/sqrt(d)
attention scaling, a bucketed relative position bias computed once and
shared by every layer (it takes the plain attention, as the bias forces
the XLA path in JAX), a gated tanh-gelu feed-forward (wi_0, wi_1, wo).
The JAX blocks run under ``nn.scan``; here they are an ``nn.ModuleList``
named ``block``, filled from the scan stack by the bridge.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import T5Config
from x2i_torch.ops.attention import attention
from x2i_torch.ops.norms import rms_norm


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucketing (HF ``_relative_position_bucket``), in
    f32 as the JAX function computes it."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    log_ratio = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    large = max_exact + (torch.log(n.float() / max_exact + 1e-9) / log_ratio
                         * (num_buckets - max_exact)).to(torch.int32)
    large = large.clamp_max(num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large.long())


class T5Norm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv

        def lin(i, o):
            return nn.Linear(i, o, bias=False, device=device, dtype=cfg.dtype)

        self.attn_norm = T5Norm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype,
                                device)
        self.q, self.k, self.v = (lin(cfg.d_model, inner) for _ in range(3))
        self.o = lin(inner, cfg.d_model)
        self.ff_norm = T5Norm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype,
                              device)
        self.wi_0 = lin(cfg.d_model, cfg.d_ff)
        self.wi_1 = lin(cfg.d_model, cfg.d_ff)
        self.wo = lin(cfg.d_ff, cfg.d_model)

    def forward(self, hidden, position_bias, kv_mask):
        cfg = self.cfg
        b, s, _ = hidden.shape
        x = self.attn_norm(hidden)
        q, k, v = (lin(x).view(b, s, cfg.num_heads, cfg.d_kv)
                   for lin in (self.q, self.k, self.v))
        attn = attention(q, k, v, kv_mask=kv_mask, scale=1.0,
                         bias=position_bias)
        hidden = hidden + self.o(attn.reshape(b, s, -1))
        x = self.ff_norm(hidden)
        gelu = F.gelu(self.wi_0(x), approximate="tanh")
        return hidden + self.wo(gelu * self.wi_1(x))


class T5EncoderStack(nn.Module):
    """Encoder over inputs_embeds."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = nn.Parameter(torch.zeros(
            (cfg.relative_attention_num_buckets, cfg.num_heads),
            dtype=cfg.dtype, device=device))
        self.block = nn.ModuleList(T5Block(cfg, device)
                                   for _ in range(cfg.num_layers))
        self.final_norm = T5Norm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype,
                                 device)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        s = inputs_embeds.shape[1]
        pos = torch.arange(s, device=inputs_embeds.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        bias = self.rel_bias[buckets].permute(2, 0, 1)[None]  # (1, H, S, S)
        mask = None if attention_mask is None else attention_mask.bool()
        hidden = inputs_embeds
        for blk in self.block:
            hidden = blk(hidden, bias, mask)
        return self.final_norm(hidden)


class T5Encoder(nn.Module):
    """Token-id entry point: ids (B, S), mask (B, S) -> (B, S, d_model)."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                   dtype=cfg.dtype)
        self.encoder = T5EncoderStack(cfg, device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        return self.encoder(self.shared(input_ids), attention_mask)


