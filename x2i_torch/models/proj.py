"""Alignment network ("proj", Proj7Exp + MLP3), the counterpart of
``x2i_tpu/models/proj.py`` without the T5 refiner (off in every shipped
config).

The input is the stacked MLLM hidden states (B, C = layers + 1, S, H);
channels are mixed by a learned per-layer scale, a 5x5 Conv2d(C -> 1), or
a mean; then an MLP makes the sequence embeds (B, S, 4096) and the pooled
embeds (B, 768). The proj uses the exact erf form of gelu (torch
``nn.GELU``'s default), unlike the DiT's tanh form.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import ProjConfig
from x2i_torch.ops.norms import layer_norm


class Proj(nn.Module):
    def __init__(self, cfg: ProjConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        if cfg.use_scale:
            self.cha_scale = nn.Parameter(torch.ones(
                (1, cfg.in_channels, 1, 1), dtype=dt, device=device))
        elif cfg.use_cnn:
            # (B, C, S, H) is already NCHW with the layers as channels
            self.conv = nn.Conv2d(cfg.in_channels, 1, cfg.kernel_size,
                                  padding=cfg.kernel_size // 2,
                                  device=device, dtype=dt)
        self.ln_scale = nn.Parameter(torch.ones(cfg.input_dim, dtype=dt,
                                                device=device))
        self.ln_bias = nn.Parameter(torch.zeros(cfg.input_dim, dtype=dt,
                                                device=device))
        self.proj_in = nn.Linear(cfg.input_dim, cfg.output_dim1, bias=False,
                                 device=device, dtype=dt)
        self.proj_out = nn.Linear(cfg.output_dim1, cfg.output_dim1,
                                  bias=False, device=device, dtype=dt)
        self.pooled_out = nn.Linear(cfg.output_dim1, cfg.output_dim0,
                                    device=device, dtype=dt)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, S, H) -> (pooled (B, output_dim0), prompt_embeds
        (B, S, output_dim1))."""
        return self.mlp(self.mix(x))

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """Channel mixing (B, C, S, H) -> (B, S, H)."""
        cfg = self.cfg
        x = x.to(cfg.dtype)
        if cfg.use_scale:
            return (self.cha_scale * x).mean(dim=1)
        if cfg.use_cnn:
            return self.conv(x)[:, 0]
        return x.mean(dim=1)

    def mlp(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = layer_norm(x.to(cfg.dtype), self.ln_scale, self.ln_bias,
                       eps=cfg.norm_eps)
        x2 = self.proj_out(F.gelu(self.proj_in(x)))
        pooled = self.pooled_out(F.gelu(x2)).mean(dim=1)
        return pooled, x2
