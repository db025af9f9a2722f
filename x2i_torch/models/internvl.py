"""The InternVL2.5 encoder, the counterpart of ``x2i_tpu/models/internvl.py``:
InternViT-300M, the pixel-shuffle mlp1 and the Qwen2 LM.

X2I never decodes with this model: the ViT's features of the image tiles
fill the token embeddings at the ``<IMG_CONTEXT>`` positions, in order,
and one LM forward returns every hidden state. The fill is JAX's: the
k-th selected position takes feature row k (a cumsum gather, then a
select), on the device with no read back to the host.

InternViT: a patch convolution, a CLS token and a learned position table
(resized bicubically for a grid other than the table's, by JAX's own
weight matrix, which reproduces torch's ``F.interpolate(mode="bicubic",
align_corners=False)`` without antialiasing), LayerNorm blocks with a
fused qkv (bias), an optional qk RMSNorm over the flattened heads, the
attention dispatcher (non-causal, no rope: at 1025 tokens the pad route
to 1152 with 127 masked keys, K1's exact body on a card) and the learned
per-channel residual scales ls1/ls2, no final norm. The feature of a tile
is its last hidden state without CLS, pixel-shuffled by 0.5 (ps v2) to a
quarter of the tokens at four times the width, then LayerNorm (eps 1e-5),
Linear, exact GELU, Linear: 256 tokens of the LM's width per 448 tile.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import InternViTConfig, InternVLConfig
from x2i_torch.models.clip import LayerNorm
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.ops.attention import attention
from x2i_torch.ops.norms import rms_norm


class InternViTBlock(nn.Module):
    def __init__(self, cfg: InternViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype

        def lin(i, o, bias=True):
            return nn.Linear(i, o, bias=bias, device=device, dtype=dt)

        self.norm1 = LayerNorm(c, cfg.layer_norm_eps, dt, device)
        self.qkv = lin(c, 3 * c, cfg.qkv_bias)
        if cfg.qk_normalization:
            self.q_norm_scale = nn.Parameter(torch.ones(c, dtype=dt,
                                                        device=device))
            self.k_norm_scale = nn.Parameter(torch.ones(c, dtype=dt,
                                                        device=device))
        self.proj = lin(c, c)
        self.ls1 = nn.Parameter(torch.full((c,), cfg.initializer_factor,
                                           dtype=dt, device=device))
        self.norm2 = LayerNorm(c, cfg.layer_norm_eps, dt, device)
        self.fc1 = lin(c, cfg.intermediate_size)
        self.fc2 = lin(cfg.intermediate_size, c)
        self.ls2 = nn.Parameter(torch.full((c,), cfg.initializer_factor,
                                           dtype=dt, device=device))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, c = hidden.shape
        heads = (b, s, cfg.num_attention_heads, -1)
        q, k, v = self.qkv(self.norm1(hidden)).chunk(3, dim=-1)
        if cfg.qk_normalization:
            q = rms_norm(q, self.q_norm_scale, cfg.layer_norm_eps)
            k = rms_norm(k, self.k_norm_scale, cfg.layer_norm_eps)
        attn = attention(q.reshape(heads), k.reshape(heads),
                         v.reshape(heads), implementation=cfg.attention_impl)
        attn = self.proj(attn.reshape(b, s, c))
        hidden = hidden + attn * self.ls1.to(attn.dtype)
        x = self.fc2(F.gelu(self.fc1(self.norm2(hidden))))
        return hidden + x * self.ls2.to(x.dtype)


def torch_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) interpolation matrix reproducing torch
    F.interpolate(mode='bicubic', align_corners=False, antialias=False):
    source coord (i+0.5)*in/out-0.5, 4-tap cubic convolution kernel with
    A=-0.75, border-replicated taps (JAX's ``_torch_bicubic_weights``)."""
    a = -0.75

    def kern(x):
        x = abs(x)
        if x <= 1:
            return ((a + 2) * x - (a + 3)) * x * x + 1
        if x < 2:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    w = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        coord = (i + 0.5) * scale - 0.5
        t0 = int(np.floor(coord))
        for tap in range(t0 - 1, t0 + 3):
            w[i, min(max(tap, 0), in_size - 1)] += kern(coord - tap)
    return w


class InternViT(nn.Module):
    def __init__(self, cfg: InternViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, p, dt = cfg.hidden_size, cfg.patch_size, cfg.dtype
        base = cfg.image_size // p
        self.patch_embedding = nn.Conv2d(3, c, p, stride=p, device=device,
                                         dtype=dt)
        self.class_embedding = nn.Parameter(torch.zeros((1, 1, c), dtype=dt,
                                                        device=device))
        self.position_embedding = nn.Parameter(torch.zeros(
            (1, base * base + 1, c), dtype=dt, device=device))
        self.block = nn.ModuleList(InternViTBlock(cfg, device)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, H, W, 3) normalized -> (B, 1 + N, hidden)."""
        cfg = self.cfg
        b, c, dt = pixel_values.shape[0], cfg.hidden_size, cfg.dtype
        patches = self.patch_embedding(
            pixel_values.to(dt).permute(0, 3, 1, 2))
        gh, gw = patches.shape[2], patches.shape[3]
        patches = patches.flatten(2).transpose(1, 2)          # (B, N, C)
        pos = self.position_embedding
        pos_cls, pos_patch = pos[:, :1], pos[:, 1:]
        base = cfg.image_size // cfg.patch_size
        if (gh, gw) != (base, base):
            # the table resized as JAX resizes it: two products with
            # torch's bicubic weights in f32 (F.interpolate differs at
            # the borders), then cast with the CLS row below
            grid = pos_patch.float().reshape(base, base, c)
            wh = torch.from_numpy(torch_bicubic_weights(base, gh)).to(
                pos.device)
            ww = torch.from_numpy(torch_bicubic_weights(base, gw)).to(
                pos.device)
            grid = torch.einsum("ou,uvc,pv->opc", wh, grid, ww)
            pos_patch = grid.reshape(1, gh * gw, c)
        hidden = torch.cat([self.class_embedding.to(dt).expand(b, 1, c),
                            patches], dim=1)
        hidden = hidden + torch.cat([pos_cls.to(pos_patch.dtype),
                                     pos_patch], dim=1).to(dt)
        for blk in self.block:
            hidden = blk(hidden)
        return hidden


def pixel_shuffle(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """(B, W, H, C) -> (B, W*s, H*s, C/s^2), ps_version='v2'."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale), int(c / scale))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale), int(w * scale),
                  int(c / (scale * scale)))
    return x.permute(0, 2, 1, 3)


def scatter_features(embeds: torch.Tensor, selected: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """Embeddings (B, S, C) with the selected positions (B, S) bool
    filled by feature rows (N, C) (or (T, n, C), taken as T * n rows) in
    order, over the batch flattened row by row: the k-th selected
    position takes row k (positions past the last row take the last).
    All on the device, as JAX's cumsum gather and select."""
    b, s, c = embeds.shape
    flat = embeds.reshape(b * s, c)
    sel = selected.reshape(b * s)
    feats = feats.reshape(-1, c)
    order = (sel.long().cumsum(0) - 1).clamp(0, feats.shape[0] - 1)
    gathered = feats[order].to(flat.dtype)
    return torch.where(sel[:, None], gathered, flat).reshape(b, s, c)


class InternVLEncoder(nn.Module):
    """Image tiles + token ids -> the hidden-state stack (B, L+1, S, H)
    for the proj. ``language_model``: an LM to share (the text path's),
    by default a new one of ``cfg.llm``."""

    def __init__(self, cfg: InternVLConfig, device=None,
                 language_model: Optional[Qwen2LM] = None):
        super().__init__()
        self.cfg = cfg
        v, dt = cfg.vision, cfg.vision.dtype
        llm_h = cfg.llm.hidden_size
        vit_out = int(v.hidden_size / (cfg.downsample_ratio ** 2))
        self.vision_model = InternViT(v, device)
        self.language_model = language_model or Qwen2LM(cfg.llm, device)
        self.mlp1_norm = LayerNorm(vit_out, 1e-5, dt, device)
        self.mlp1_fc1 = nn.Linear(vit_out, llm_h, device=device, dtype=dt)
        self.mlp1_fc2 = nn.Linear(llm_h, llm_h, device=device, dtype=dt)

    def extract_feature(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(T, H, W, 3) tiles -> (T, num_image_token, llm_hidden)."""
        vit = self.vision_model(pixel_values)[:, 1:, :]      # drop CLS
        hw = int(vit.shape[1] ** 0.5)
        vit = vit.reshape(vit.shape[0], hw, hw, -1)
        vit = pixel_shuffle(vit, self.cfg.downsample_ratio)
        vit = vit.reshape(vit.shape[0], -1, vit.shape[-1])
        x = F.gelu(self.mlp1_fc1(self.mlp1_norm(vit)))
        return self.mlp1_fc2(x)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The hidden-state stack (B, L+1, S, H). pixel_values: optional
        (T, H, W, 3) tiles whose features fill the ``<IMG_CONTEXT>``
        positions of ``input_ids`` in order; without them the LM runs on
        the token ids."""
        lm = self.language_model
        if pixel_values is None:
            return lm(input_ids, attention_mask=attention_mask)[0]
        embeds = scatter_features(
            lm.embed(input_ids), input_ids == self.cfg.img_context_token_id,
            self.extract_feature(pixel_values))
        return lm(inputs_embeds=embeds, attention_mask=attention_mask)[0]
