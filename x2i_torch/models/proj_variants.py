"""The proj's legacy design-space variants, the counterpart of
``x2i_tpu/models/proj_variants.py`` (the reference's model_internvl/proj.py
MLP, MLP2, MLP_plus, Transformer_proj, Proj, Proj2 and Proj3). No shipped
X2I path uses them (the alignment net is ``models/proj.py::Proj``); they
are kept so that the design-space record carries over. Each returns
(pooled, sequence) like ``Proj``, and each takes JAX's param trees through
the bridge (``x2i_torch.params.load_flax``): the parameter names are the
flax ones.

``TransformerProj``'s attention goes through the port's dispatcher (in f32
on the card, K1's f32 instance, as JAX's reaches its Pallas kernel); the
T5 stacks of ``LegacyProj`` take the plain attention, as their relative
position bias sends JAX's to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import T5Config
from x2i_torch.models.t5 import T5EncoderStack
from x2i_torch.ops.attention import attention
from x2i_torch.ops.norms import layer_norm


def _ln_params(mod: nn.Module, name: str, dim: int, dtype, device):
    """The flax ``_ln`` pair: ``{name}_scale`` ones, ``{name}_bias``
    zeros."""
    mod.register_parameter(f"{name}_scale", nn.Parameter(
        torch.ones(dim, dtype=dtype, device=device)))
    mod.register_parameter(f"{name}_bias", nn.Parameter(
        torch.zeros(dim, dtype=dtype, device=device)))


def _ln(mod: nn.Module, name: str, x, eps: float):
    return layer_norm(x, getattr(mod, f"{name}_scale"),
                      getattr(mod, f"{name}_bias"), eps=eps)


class MLPProj(nn.Module):
    """MLP / MLP2 / MLP_plus: LayerNorm -> a stack of ``depth`` no-bias
    linear layers with exact gelu between them -> (pooled head, the
    sequence). The pooled head is one linear ``fc`` with bias, or with
    ``deep_pooled_head`` (MLP2) three no-bias ones ``fc_0..fc_2``."""

    def __init__(self, in_dim: int, out_dim: int, out_dim1: int,
                 depth: int = 3, deep_pooled_head: bool = False,
                 eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.depth, self.deep, self.eps = depth, deep_pooled_head, eps
        _ln_params(self, "ln", in_dim, dtype, device)

        def lin(i, o, bias=False):
            return nn.Linear(i, o, bias=bias, device=device, dtype=dtype)

        for i in range(depth):
            self.add_module(f"proj_{i}", lin(in_dim if i == 0 else out_dim,
                                             out_dim))
        if deep_pooled_head:
            self.fc_0 = lin(out_dim, out_dim1)
            self.fc_1 = lin(out_dim1, out_dim1)
            self.fc_2 = lin(out_dim1, out_dim1)
        else:
            self.fc = lin(out_dim, out_dim1, bias=True)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _ln(self, "ln", x, self.eps)
        for i in range(self.depth - 1):
            x = F.gelu(getattr(self, f"proj_{i}")(x))
        x2 = F.gelu(getattr(self, f"proj_{self.depth - 1}")(x))
        if self.deep:
            x1 = self.fc_2(F.gelu(self.fc_1(F.gelu(self.fc_0(x2)))))
        else:
            x1 = self.fc(x2)
        return x1.mean(dim=1), x2


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6, ``scale`` and ``bias``)."""

    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, eps=1e-6)


class TransformerProj(nn.Module):
    """Transformer_proj: ``num_layers`` post-LN encoder layers (attention
    with biased q/k/v/o, a ReLU feed-forward of ``ffn_dim``) and two linear
    heads: -> (mean of ``linear1`` over the sequence, ``linear2``).
    ``attention_impl``: the dispatcher's "auto", "kernel" or "plain"."""

    def __init__(self, d_model: int, n_heads: int, out_dim1: int,
                 out_dim2: int, num_layers: int = 3, ffn_dim: int = 2048,
                 dtype=torch.float32, device=None,
                 attention_impl: str = "auto"):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.num_layers, self.attention_impl = num_layers, attention_impl

        def lin(i, o):
            return nn.Linear(i, o, device=device, dtype=dtype)

        for i in range(num_layers):
            for n in ("q", "k", "v", "o"):
                self.add_module(f"l{i}_{n}", lin(d_model, d_model))
            self.add_module(f"l{i}_fc1", lin(d_model, ffn_dim))
            self.add_module(f"l{i}_fc2", lin(ffn_dim, d_model))
            self.add_module(f"l{i}_ln1", _LayerNorm(d_model, dtype, device))
            self.add_module(f"l{i}_ln2", _LayerNorm(d_model, dtype, device))
        self.linear1 = lin(d_model, out_dim1)
        self.linear2 = lin(d_model, out_dim2)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        h = self.n_heads
        d = self.d_model // h
        for i in range(self.num_layers):
            def layer(n):
                return getattr(self, f"l{i}_{n}")
            q, k, v = (layer(n)(x).view(b, s, h, d) for n in "qkv")
            a = attention(q, k, v, implementation=self.attention_impl)
            a = a.reshape(b, s, self.d_model)
            x = layer("ln1")(x + layer("o")(a))
            x = layer("ln2")(x + layer("fc2")(F.relu(layer("fc1")(x))))
        return self.linear1(x).mean(dim=1), self.linear2(x)


@dataclass(frozen=True)
class LegacyProjConfig:
    in_channels: int = 2
    kernel_size: int = 5
    input_dim: int = 896
    output_dim0: int = 768
    output_dim1: int = 4096
    num_layers: int = 4
    num_heads: int = 12
    head_dim: int = 64
    eps: float = 1e-6
    dtype: Any = torch.float32


class LegacyProj(nn.Module):
    """Proj / Proj2 / Proj3: channel mixing by a 5x5 conv, a T5 refiner
    and an MLP head, in the recorded orders.

    variant "proj":  norm0 -> conv -> norm1 -> T5 -> MLP
            "proj2": the same, with MLP2's head
            "proj3": T5 over each channel first, then norm0 -> conv ->
                     norm1 and MLP2's head"""

    def __init__(self, cfg: LegacyProjConfig, variant: str = "proj",
                 device=None):
        super().__init__()
        if variant not in ("proj", "proj2", "proj3"):
            raise ValueError(f"variant={variant!r}")
        self.cfg, self.variant = cfg, variant
        dt = cfg.dtype
        self.t5stack = T5EncoderStack(T5Config(
            d_model=cfg.input_dim, d_ff=cfg.input_dim * 4, d_kv=cfg.head_dim,
            num_heads=cfg.num_heads, num_layers=cfg.num_layers,
            layer_norm_eps=cfg.eps, vocab_size=0, dtype=dt), device)
        _ln_params(self, "norm0", cfg.input_dim, dt, device)
        _ln_params(self, "norm1", cfg.input_dim, dt, device)
        # (B, C, S, H) is NCHW with the layers as channels
        self.conv = nn.Conv2d(cfg.in_channels, 1, cfg.kernel_size,
                              padding=cfg.kernel_size // 2, device=device,
                              dtype=dt)
        self.mlp = MLPProj(cfg.input_dim, cfg.output_dim1, cfg.output_dim0,
                           depth=3, deep_pooled_head=variant != "proj",
                           eps=cfg.eps, dtype=dt, device=device)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, S, H) -> (pooled (B, output_dim0), the sequence (B, S,
        output_dim1))."""
        eps = self.cfg.eps
        b, c, s, h = x.shape

        def mix(z):
            z = self.conv(_ln(self, "norm0", z, eps))[:, 0]
            return _ln(self, "norm1", z, eps)

        if self.variant == "proj3":
            x = mix(self.t5stack(x.reshape(b * c, s, h)).reshape(b, c, s, h))
        else:
            x = self.t5stack(mix(x))
        return self.mlp(x)
