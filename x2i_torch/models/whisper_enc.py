"""The Whisper encoder and the audio projector of MiniCPM-o (``apm``), the
counterpart of ``x2i_tpu/models/whisper_enc.py``.

The stem: Conv1d k3 p1 and an exact GELU, Conv1d k3 s2 p1 and an exact
GELU, then the fixed sinusoid table. Pre-LN blocks (``k`` without a
bias, an exact GELU), then ``final_ln``. The attention takes the frames'
mask and, for the image path's 1 s chunks, an additive chunk bias
(``data/minicpm_vision.py::chunk_bias``); a bias takes the dispatcher's
plain route, as it takes XLA in JAX. ``AudioProjector`` is linear, ReLU,
linear and then the average pool of ``pool_step`` frames, in that order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import WhisperConfig
from x2i_torch.data.minicpm_vision import sinusoidal_positions
from x2i_torch.models.clip import LayerNorm
from x2i_torch.ops.attention import attention


class WhisperBlock(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.d_model, cfg.dtype

        def lin(i, o, bias=True):
            return nn.Linear(i, o, bias=bias, device=device, dtype=dt)

        self.attn_ln = LayerNorm(c, cfg.layer_norm_eps, dt, device)
        self.q, self.k, self.v, self.o = (lin(c, c), lin(c, c, False),
                                          lin(c, c), lin(c, c))
        self.ffn_ln = LayerNorm(c, cfg.layer_norm_eps, dt, device)
        self.fc1 = lin(c, cfg.encoder_ffn_dim)
        self.fc2 = lin(cfg.encoder_ffn_dim, c)

    def forward(self, hidden, kv_mask=None, bias=None):
        b, s, c = hidden.shape
        heads = (b, s, self.cfg.encoder_attention_heads, -1)
        x = self.attn_ln(hidden)
        attn = attention(self.q(x).reshape(heads), self.k(x).reshape(heads),
                         self.v(x).reshape(heads), kv_mask=kv_mask,
                         bias=bias, implementation=self.cfg.attention_impl)
        hidden = hidden + self.o(attn.reshape(b, s, c))
        return hidden + self.fc2(F.gelu(self.fc1(self.ffn_ln(hidden))))


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.d_model, cfg.dtype
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, c, 3, padding=1,
                               device=device, dtype=dt)
        self.conv2 = nn.Conv1d(c, c, 3, stride=2, padding=1, device=device,
                               dtype=dt)
        self.block = nn.ModuleList(WhisperBlock(cfg, device)
                                   for _ in range(cfg.encoder_layers))
        self.final_ln = LayerNorm(c, cfg.layer_norm_eps, dt, device)
        self._positions = {}         # the sinusoid table by device

    def forward(self, mel: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, num_mel_bins, T) log-mel -> (B, (T - 1) // 2 + 1, d).
        kv_mask: (B, T') True where the conv frame is a key to attend;
        attn_bias: (1, 1, T', T') the chunk bias."""
        cfg = self.cfg
        x = F.gelu(self.conv1(mel.to(cfg.dtype)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)          # (B, T', d)
        if x.device not in self._positions:
            self._positions[x.device] = torch.from_numpy(
                sinusoidal_positions(cfg.max_source_positions, cfg.d_model)
            ).to(x.device, cfg.dtype)
        x = x + self._positions[x.device][:x.shape[1]][None]
        for blk in self.block:
            x = blk(x, kv_mask, attn_bias)
        return self.final_ln(x)


class AudioProjector(nn.Module):
    """Linear, ReLU, Linear into the LM's width, then the average pool of
    ``pool_step`` frames (projecting first: with the ReLU between, pooling
    first gives other numbers)."""

    def __init__(self, in_dim: int, llm_dim: int, pool_step: int = 2,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.pool_step = pool_step
        self.linear1 = nn.Linear(in_dim, llm_dim, device=device, dtype=dtype)
        self.linear2 = nn.Linear(llm_dim, llm_dim, device=device,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, d) -> (B, T // pool_step, llm_dim), in the projector's
        dtype (flax's Dense casts its input)."""
        x = self.linear1(x.to(self.linear1.weight.dtype))
        x = self.linear2(F.relu(x))
        b, t, d = x.shape
        t2 = t // self.pool_step
        return x[:, :t2 * self.pool_step].reshape(
            b, t2, self.pool_step, d).mean(dim=2)
