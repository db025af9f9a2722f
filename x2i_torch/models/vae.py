"""FLUX AutoencoderKL, the counterpart of ``x2i_tpu/models/vae.py``:
``encode`` (the phase-2 trainer's target latents: the mode, or a sample
with the caller's noise), ``decode`` and, for images whose decoder
activations are too large to hold at once, ``decode_tiled``.

Layout: the public ``AutoencoderKL`` methods take and return NHWC tensors,
as the JAX package does; inside, the convolutions run NCHW, PyTorch's
layout, with one transpose at each end.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import VAEConfig


class GroupNorm(nn.Module):
    """flax GroupNorm numerics: f32 statistics with the fast variance
    E[x^2] - E[x]^2 clipped at 0, scale and bias in f32; ``eps`` 1e-6 as
    the VAE's and diffusers' ResnetBlock2D's, 1e-5 as flax's default."""

    def __init__(self, groups: int, channels: int, dtype, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels, dtype=dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=dtype,
                                             device=device))

    def forward(self, x):                         # (B, C, H, W)
        b, c, h, w = x.shape
        xf = x.float().view(b, self.groups, c // self.groups, h, w)
        mean = xf.mean(dim=(2, 3, 4), keepdim=True)
        var = (xf.square().mean(dim=(2, 3, 4), keepdim=True)
               - mean.square()).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y.view(b, c, h, w) * self.scale.float()[:, None, None] \
            + self.bias.float()[:, None, None]
        return y.to(x.dtype)


def _conv(cin, cout, k, dtype, device):
    return nn.Conv2d(cin, cout, k, padding=k // 2, device=device, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, dtype, device=None):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, dtype, device)
        self.conv1 = _conv(cin, cout, 3, dtype, device)
        self.norm2 = GroupNorm(groups, cout, dtype, device)
        self.conv2 = _conv(cout, cout, 3, dtype, device)
        if cin != cout:
            self.conv_shortcut = _conv(cin, cout, 1, dtype, device)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head spatial self-attention of the mid block, in f32 and
    chunked over query rows (one (B, 1024, HW) score block at a time).
    Its head size (the channel count, 512) is outside the flash kernel's,
    so it stays eager PyTorch, as it stays XLA in the JAX package."""

    def __init__(self, c: int, groups: int, dtype, device=None):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, dtype, device)
        for n in ("to_q", "to_k", "to_v", "to_out"):
            self.add_module(n, nn.Linear(c, c, device=device, dtype=dtype))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)     # (B, HW, C)
        q, k, v = self.to_q(y), self.to_k(y).float(), self.to_v(y).float()
        scale = 1.0 / math.sqrt(c)
        n = h * w
        chunk = next((cand for cand in (1024, 512, 256, 128)
                      if n % cand == 0 and n > cand), n)
        outs = []
        for i in range(0, n, chunk):
            s = (q[:, i:i + chunk].float() @ k.transpose(1, 2)) * scale
            outs.append((torch.softmax(s, dim=-1) @ v).to(x.dtype))
        o = self.to_out(torch.cat(outs, dim=1))
        return x + o.transpose(1, 2).reshape(b, c, h, w)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        ch, g, dt = cfg.block_out_channels, cfg.norm_num_groups, cfg.dtype
        self.cfg = cfg
        self.conv_in = _conv(cfg.in_channels, ch[0], 3, dt, device)
        cin = ch[0]
        for i, c in enumerate(ch):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlock(cin, c, g, dt, device))
                cin = c
            if i < len(ch) - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(
                    c, c, 3, stride=2, device=device, dtype=dt))
        self.mid_block_1 = ResnetBlock(ch[-1], ch[-1], g, dt, device)
        if cfg.use_mid_attention:
            self.mid_attn = MidAttention(ch[-1], g, dt, device)
        self.mid_block_2 = ResnetBlock(ch[-1], ch[-1], g, dt, device)
        self.conv_norm_out = GroupNorm(g, ch[-1], dt, device)
        self.conv_out = _conv(ch[-1], 2 * cfg.latent_channels, 3, dt,
                              device)

    def forward(self, x):
        """pixels (B, 3, H, W) -> moments (B, 2 * latent, H/8, W/8)."""
        cfg = self.cfg
        x = self.conv_in(x)
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_block_{j}")(x)
            if i < n - 1:
                # diffusers' Downsample2D: pad 1 after H and W only, then a
                # stride-2 conv without padding
                x = getattr(self, f"down_{i}_downsample")(
                    F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block_1(x)
        if cfg.use_mid_attention:
            x = self.mid_attn(x)
        x = self.mid_block_2(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        ch, g, dt = cfg.block_out_channels, cfg.norm_num_groups, cfg.dtype
        self.cfg = cfg
        self.conv_in = _conv(cfg.latent_channels, ch[-1], 3, dt, device)
        self.mid_block_1 = ResnetBlock(ch[-1], ch[-1], g, dt, device)
        if cfg.use_mid_attention:
            self.mid_attn = MidAttention(ch[-1], g, dt, device)
        self.mid_block_2 = ResnetBlock(ch[-1], ch[-1], g, dt, device)
        rev = tuple(reversed(ch))
        cin = ch[-1]
        for i, c in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_block_{j}",
                                ResnetBlock(cin, c, g, dt, device))
                cin = c
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", _conv(c, c, 3, dt, device))
        self.conv_norm_out = GroupNorm(g, ch[0], dt, device)
        self.conv_out = _conv(ch[0], cfg.out_channels, 3, dt, device)

    def forward(self, z):
        """z (B, C, h, w) -> pixels (B, 3, 8h, 8w), NCHW."""
        cfg = self.cfg
        x = self.mid_block_1(self.conv_in(z))
        if cfg.use_mid_attention:
            x = self.mid_attn(x)
        x = self.mid_block_2(x)
        n_up = len(cfg.block_out_channels)
        for i in range(n_up):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_block_{j}")(x)
            if i < n_up - 1:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = getattr(self, f"up_{i}_upsample")(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """Encode and decode with the FLUX latent scale/shift convention."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)

    def encode_moments(self, pixels: torch.Tensor) -> torch.Tensor:
        """NHWC pixels (B, H, W, 3) -> NHWC moments (B, H/8, W/8, 2 * C)
        (mean, then log-variance)."""
        x = pixels.to(self.cfg.dtype).permute(0, 3, 1, 2)
        return self.encoder(x).permute(0, 2, 3, 1)

    def encode(self, pixels: torch.Tensor,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NHWC pixels in [-1, 1] -> scaled NHWC latents (B, h, w, C): the
        mode without ``eps``; with ``eps`` (B, h, w, C), the caller's
        standard-normal draw, a sample: the log-variance clipped to
        [-30, 20], the std in f32, ``mean + std * eps``."""
        mean, logvar = self.encode_moments(pixels).chunk(2, dim=-1)
        if eps is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0).float())
            mean = mean + (std * eps.to(std.device, torch.float32)
                           ).to(mean.dtype)
        return (mean - self.cfg.shift_factor) * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled NHWC latents (B, h, w, C) -> NHWC pixels in [-1, 1].
        A batch decodes one image at a time above 64x64 latents, as in the
        JAX package, to hold the peak memory at the batch-1 footprint."""
        z = z.to(self.cfg.dtype) / self.cfg.scaling_factor \
            + self.cfg.shift_factor
        z = z.permute(0, 3, 1, 2)
        if z.shape[0] == 1 or z.shape[2] * z.shape[3] <= 64 * 64:
            out = self.decoder(z)
        else:
            out = torch.cat([self.decoder(z[i:i + 1])
                             for i in range(z.shape[0])])
        return out.permute(0, 2, 3, 1)

    def decode_tiled(self, z: torch.Tensor, tile_latent: int = 64,
                     overlap: float = 0.25) -> torch.Tensor:
        """Scaled NHWC latents -> NHWC pixels, decoded in overlapping
        latent tiles whose seams are blended linearly (diffusers'
        ``tiled_decode``: tiles of 64 latents = 512 px, 25% overlap, so a
        stride of 48 latents, a 128-px blend and 384 px kept of each
        tile). Group-norm statistics are per tile. The ramps are f32 and
        the mix is cast back; a tile is blended with the one above before
        the one to its left; edge tiles are smaller than a tile. A latent
        that fits one tile is exactly ``decode``. The tiles decode one
        after another (eager PyTorch orders them; the JAX package chains
        them with ``optimization_barrier`` to the same end)."""
        cfg = self.cfg
        b, h, w, _ = z.shape
        if h <= tile_latent and w <= tile_latent:
            return self.decode(z)
        z = (z.to(cfg.dtype) / cfg.scaling_factor + cfg.shift_factor
             ).permute(0, 3, 1, 2)
        stride = max(1, int(tile_latent * (1 - overlap)))
        # latent -> pixel upscale: one 2x resize per non-final up block
        scale = 2 ** (len(cfg.block_out_channels) - 1)
        tile_px = tile_latent * scale
        blend = int(tile_px * overlap)
        keep = tile_px - blend

        def blended(prev, tile, dim):
            """``tile`` with its first rows (dim 2) or columns (dim 3)
            ramped in from the last ones of ``prev``."""
            n = min(blend, prev.shape[dim], tile.shape[dim])
            shape = [1, 1, 1, 1]
            shape[dim] = n
            ramp = (torch.arange(n, dtype=torch.float32, device=tile.device)
                    / n).view(shape)
            tail = prev.narrow(dim, prev.shape[dim] - n, n).float()
            mixed = tail * (1 - ramp) + tile.narrow(dim, 0, n).float() * ramp
            out = tile.clone()
            out.narrow(dim, 0, n).copy_(mixed.to(tile.dtype))
            return out

        rows = [[self.decoder(z[:, :, i:i + tile_latent, j:j + tile_latent])
                 for j in range(0, w, stride)] for i in range(0, h, stride)]
        out_rows = []
        for i, row in enumerate(rows):
            parts = []
            for j, tile in enumerate(row):
                # against the tiles as decoded, not as blended, as in JAX
                if i > 0:
                    tile = blended(rows[i - 1][j], tile, 2)
                if j > 0:
                    tile = blended(row[j - 1], tile, 3)
                parts.append(tile[:, :, :keep, :keep])
            out_rows.append(torch.cat(parts, dim=3))
        out = torch.cat(out_rows, dim=2)[:, :, :h * scale, :w * scale]
        return out.permute(0, 2, 3, 1)


def postprocess(pixels: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8."""
    x = (pixels.float() / 2 + 0.5).clamp(0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> [-1, 1] f32. The divisor is a tensor on the
    images' device: a CUDA division by a Python number multiplies by its
    reciprocal, which is not JAX's IEEE division."""
    x = images.float()
    return x / torch.full((), 127.5, device=x.device) - 1.0
