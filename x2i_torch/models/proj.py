"""Alignment network ("proj", Proj7Exp + MLP3), the counterpart of
``x2i_tpu/models/proj.py``.

The input is the stacked MLLM hidden states (B, C = layers + 1, S, H);
channels are mixed by a learned per-layer scale, a 5x5 Conv2d(C -> 1), or
a mean; then an MLP makes the sequence embeds (B, S, 4096) and the pooled
embeds (B, 768). With ``use_t5`` (off in every shipped config) a T5
encoder stack (``models/t5.py``) refines each channel first, over
(B * C, S, H); its attention takes a relative position bias, so it runs
the plain attention, as the bias sends JAX's to XLA. The proj uses the
exact erf form of gelu (torch ``nn.GELU``'s default), unlike the DiT's
tanh form.

For long prompts ``streaming_mix_spec`` splits ``Proj.mix`` into one linear
contribution per channel, which ``Qwen2LM.encode_premixed`` sums while the
layers run, so that the (B, C, S, H) stack is never built.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import ProjConfig, T5Config
from x2i_torch.models.t5 import T5EncoderStack
from x2i_torch.ops.norms import layer_norm


class Proj(nn.Module):
    def __init__(self, cfg: ProjConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        if cfg.use_t5:
            self.t5stack = T5EncoderStack(T5Config(
                d_model=cfg.input_dim, d_ff=cfg.input_dim * 4,
                d_kv=cfg.head_dim, num_heads=cfg.num_heads,
                num_layers=cfg.num_layers, layer_norm_eps=cfg.norm_eps,
                vocab_size=0, dtype=dt), device)
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
        """Channel mixing (B, C, S, H) -> (B, S, H), after the T5
        refiner over each channel with ``use_t5``."""
        cfg = self.cfg
        x = x.to(cfg.dtype)
        if cfg.use_t5:
            b, c, s, h = x.shape
            x = self.t5stack(x.reshape(b * c, s, h)).reshape(b, c, s, h)
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


def streaming_mix_spec(proj: Proj, num_layers: int
                       ) -> Tuple[Dict[str, Any], Callable]:
    """``Proj.mix`` as per-channel linear contributions, for
    ``Qwen2LM.encode_premixed`` (the long-prompt path).

    The proj's channels are [embeddings, layer outputs 0..L-2, the
    final-normed last state], C = num_layers + 1, and every mix mode is
    linear over that axis: channel c contributes ``mix_fn(state, w_c)``.

    -> (weights, mix_fn): weights = {"embed": w_0, "layers": (L, ...) with
    the LAST entry zero (the last layer's raw output is not a channel),
    "final": w_{C-1}, "bias": the conv bias as an f32 scalar, or None};
    mix_fn(x (B, S, H), w) -> the f32 (B, S, H) contribution. Raises
    ValueError for the t5 refiner (it mixes across channels) and for
    ``in_channels != num_layers + 1``."""
    cfg = proj.cfg
    if cfg.use_t5:
        raise ValueError("the t5 refiner mixes across channels; "
                         "streaming mix supports scale/cnn/mean only")
    c = cfg.in_channels
    if c != num_layers + 1:
        raise ValueError(f"proj in_channels {c} != num_layers+1 "
                         f"({num_layers + 1})")
    bias = None

    def mix_fn(x, wc):
        return wc * x.float()

    if cfg.use_scale:
        w = proj.cha_scale.detach().reshape(c).float() / c
    elif cfg.use_cnn:
        w = proj.conv.weight.detach()[0]                  # (C, k, k)
        bias = proj.conv.bias.detach().reshape(()).float()
        k = cfg.kernel_size
        lo = (k - 1) // 2
        hi = k - 1 - lo

        def mix_fn(x, wc):
            # the single-channel 2D convolution as k * k shifted
            # multiply-adds in f32, each (B, S, H) elementwise
            b, s, h = x.shape
            xp = F.pad(x.float(), (lo, hi, lo, hi))
            out = torch.zeros((b, s, h), dtype=torch.float32,
                              device=x.device)
            for i in range(k):
                for j in range(k):
                    out = out + wc[i, j].float() * xp[:, i:i + s, j:j + h]
            return out
    else:
        w = torch.full((c,), 1.0 / c, dtype=torch.float32,
                       device=proj.ln_scale.device)

    layers = w[1:].clone()
    layers[-1] = 0
    return {"embed": w[0], "layers": layers, "final": w[-1],
            "bias": bias}, mix_fn
