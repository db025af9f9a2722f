"""The ControlNeXt control branches of LightControl (X2I's phase 2), the
counterpart of ``x2i_tpu/models/controlnext.py``.

One branch maps the guidance image and the timestep to a residual of
image tokens that the FLUX double block of its index adds to its image
stream: a stride-2 conv stem 3 -> 64 -> 64 -> 128 (GroupNorm(2) + ReLU),
two stages of ResnetBlock2D (with the time embedding) + stride-2 conv,
128 -> 128 -> 256, residual mid convs, and a 2x2 stride-2 output conv to
``final_out_channels``: a 1024^2 image gives 64 x 64 = 4096 tokens, one
per packed latent. A ``ControlBank`` holds ``num_controls`` branches,
each with its own weights (JAX stacks them on a leading axis and vmaps or
maps one module over it).

Layout: the branch takes NHWC pixels, as JAX's does, and runs its
convolutions NCHW, with one transpose at each end; its tokens follow
JAX's NHWC ``reshape(b, h * w, c)`` row order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from x2i_torch.core.config import ControlNeXtConfig
from x2i_torch.models.flux import timestep_embedding
from x2i_torch.models.vae import GroupNorm

BANK_IMPLS = ("vmap", "scan")


def _conv(cin, cout, k, dtype, device, stride=1, padding=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     device=device, dtype=dtype)


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D at its defaults: silu, the time embedding
    added after conv1, GroupNorm eps 1e-6."""

    def __init__(self, cin: int, cout: int, groups: int, temb_dim: int,
                 dtype, device=None):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, dtype, device)
        self.conv1 = _conv(cin, cout, 3, dtype, device)
        self.time_emb_proj = nn.Linear(temb_dim, cout, device=device,
                                       dtype=dtype)
        self.norm2 = GroupNorm(groups, cout, dtype, device)
        self.conv2 = _conv(cout, cout, 3, dtype, device)
        if cin != cout:
            self.conv_shortcut = _conv(cin, cout, 1, dtype, device,
                                       padding=0)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class ControlNeXt(nn.Module):
    """One branch. Its GroupNorms outside the ResnetBlock2Ds take eps
    1e-5, flax's default, as JAX's do."""

    def __init__(self, cfg: ControlNeXtConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype

        def gn(groups, ch):
            return GroupNorm(groups, ch, dt, device, eps=1e-5)

        ted = cfg.time_embed_dim
        self.time_linear1 = nn.Linear(128, ted, device=device, dtype=dt)
        self.time_linear2 = nn.Linear(ted, ted, device=device, dtype=dt)
        self.stem0 = _conv(3, 64, 3, dt, device, stride=2)
        self.stem_norm0 = gn(2, 64)
        self.stem1 = _conv(64, 64, 3, dt, device)
        self.stem_norm1 = gn(2, 64)
        self.stem2 = _conv(64, 128, 3, dt, device)
        self.stem_norm2 = gn(2, 128)
        cin = 128
        for i, (cout, g) in enumerate(zip(cfg.out_channels, cfg.groups)):
            self.add_module(f"res_{i}", ResnetBlock2D(cin, cout, g, ted, dt,
                                                      device))
            self.add_module(f"down_{i}", _conv(cout, cout, 3, dt, device,
                                               stride=2))
            cin = cout
        self.mid0 = _conv(cin, cin, 3, dt, device)
        self.mid_norm0 = gn(8, cin)
        self.mid1 = _conv(cin, cin, 3, dt, device)
        self.mid_norm1 = gn(8, cin)
        self.out_conv = _conv(cin, cfg.final_out_channels, 2, dt, device,
                              stride=2, padding=0)

    def forward(self, sample: torch.Tensor,
                timestep: torch.Tensor) -> torch.Tensor:
        """sample (B, H, W, 3) guidance pixels; timestep (B,) on the
        0..1000 scale (the DiT's caller passes t * 1000) -> tokens
        (B, H/16 * W/16, final_out_channels), added as they are (the
        reference's scale is 1.0)."""
        dt = self.cfg.dtype
        temb = self.time_linear1(timestep_embedding(timestep, 128).to(dt))
        temb = self.time_linear2(F.silu(temb))
        x = sample.to(dt).permute(0, 3, 1, 2)
        x = F.relu(self.stem_norm0(self.stem0(x)))
        x = F.relu(self.stem_norm1(self.stem1(x)))
        x = F.relu(self.stem_norm2(self.stem2(x)))
        for i in range(len(self.cfg.out_channels)):
            x = getattr(self, f"res_{i}")(x, temb)
            x = getattr(self, f"down_{i}")(x)
        mid = self.mid_norm0(F.relu(self.mid0(x)))
        x = x + self.mid_norm1(self.mid1(mid))
        return self.out_conv(x).flatten(2).transpose(1, 2)


class ControlBank(nn.Module):
    """``num_controls`` independent branches, branch i feeding double
    block i."""

    def __init__(self, cfg: ControlNeXtConfig, num_controls: int,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.branches = nn.ModuleList(ControlNeXt(cfg, device)
                                      for _ in range(num_controls))

    def forward(self, sample, timestep, impl: str = "vmap"):
        return apply_control_bank(self, sample, timestep, impl)


def apply_control_bank(bank: ControlBank, sample: torch.Tensor,
                       timestep: torch.Tensor,
                       impl: str = "vmap") -> torch.Tensor:
    """Every branch on the same (sample, timestep) -> (num_controls, B,
    tokens, final_out_channels), the DiT's ``controls``. The branches run
    one after another under either ``impl``; "scan" wraps each in
    ``torch.utils.checkpoint`` when gradients are taken, as JAX's
    ``lax.map(jax.checkpoint(one))``: the backward recomputes a branch's
    activations instead of keeping all 19 branches' at once. Both give
    the same values."""
    if impl not in BANK_IMPLS:
        raise ValueError(f"impl={impl!r}: one of {BANK_IMPLS}")
    remat = impl == "scan" and torch.is_grad_enabled()
    return torch.stack([
        checkpoint(branch, sample, timestep, use_reentrant=False) if remat
        else branch(sample, timestep) for branch in bank.branches])
