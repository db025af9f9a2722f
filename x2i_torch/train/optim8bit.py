"""Block-wise 8-bit AdamW, the counterpart of ``x2i_tpu/train/optim8bit.py``
(``adamw8bit``, the bitsandbytes AdamW8bit equivalent).

Between updates the Adam moments are kept as float8_e4m3fn codes with one
f32 absmax scale per block of 128 values (``_quantize`` / ``_dequantize``,
JAX's codec bit for bit): a tensor is flattened, zero-padded to whole
blocks, each block's ``scale = max(max|block| / 448, 1e-30)``, and its
codes ``(block / scale)`` cast to e4m3 with round to nearest even (the
largest ratio is 448 up to an ulp, which both casts take to 448: no
saturating shortcut is needed, and none is taken). 1 byte + 4/128 a value
per moment, against 4 for an f32 moment: the state is about 3.9x smaller.

The update is JAX's, all in f32: the moments decoded, ``mu = b1 mu + (1 -
b1) g``, ``nu = b2 nu + (1 - b2) g g``, bias corrections ``1 - b**count``
computed in f32, ``upd = -(lr (mu_hat / (sqrt(nu_hat) + eps) + wd p))``
cast to the parameter's dtype and added to it (optax's
``apply_updates``), the moments encoded again. It is ``train/optim.py``'s
chain with these moments: the same global-norm clip before it, the same
MultiSteps accumulation around it and the same ``learning_rate(count)``.
Plain PyTorch: the codec is a handful of elementwise passes per tensor.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from x2i_torch.train.optim import AdamW, OptState

BLOCK = 128
F8_MAX = 448.0          # the largest finite float8_e4m3fn


def _quantize(x: torch.Tensor):
    """f32 x (any shape) -> (codes float8_e4m3fn (blocks, 128), scales f32
    (blocks, 1))."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).view(-1, BLOCK)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = (blocks.abs().amax(1, keepdim=True)
             / blocks.new_full((), F8_MAX)).clamp_min(1e-30)
    return (blocks / scale).to(torch.float8_e4m3fn), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """The inverse: codes and scales -> f32 of ``shape``."""
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


class Moments8bit:
    """AdamW's moments as 8-bit blocks (a mixin before ``AdamW`` or one of
    its subclasses, which keep their clip, accumulation and schedule)."""

    def init_moments(self, params) -> dict:
        mu = [_quantize(torch.zeros_like(p, dtype=torch.float32))
              for p in params]
        return {"mu": [q for q, _ in mu], "mu_scale": [s for _, s in mu],
                "nu": [q.clone() for q, _ in mu],
                "nu_scale": [s.clone() for _, s in mu]}

    def adam(self, params, grads, state: OptState, count: int,
             lr: float) -> dict:
        b1, b2 = self.b1, self.b2
        # the bias corrections in f32, as JAX computes them
        c = torch.tensor(float(count), dtype=torch.float32)
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** c).item()
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** c).item()
        out = {"mu": [], "mu_scale": [], "nu": [], "nu_scale": []}
        for p, g, mq, ms, nq, ns in zip(params, grads, state.mu,
                                        state.mu_scale, state.nu,
                                        state.nu_scale):
            g = g.float()
            mu = b1 * _dequantize(mq, ms, g.shape) + (1 - b1) * g
            nu = b2 * _dequantize(nq, ns, g.shape) + (1 - b2) * g * g
            mu_hat = mu / mu.new_full((), bc1)
            nu_hat = nu / nu.new_full((), bc2)
            upd = -(lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)
                          + self.weight_decay * p.float()))
            p.copy_(p + upd.to(p.dtype))
            for key, m in (("mu", mu), ("nu", nu)):
                q, s = _quantize(m)
                out[key].append(q)
                out[key + "_scale"].append(s)
        return out


class AdamW8bit(Moments8bit, AdamW):
    """``optax.chain(clip_by_global_norm(max_norm), adamw8bit(lr, b1, b2,
    eps, weight_decay))`` at a constant learning rate, in
    ``optax.MultiSteps(k)`` when k > 1; JAX's ``adamw8bit`` defaults
    (weight decay 1e-2, not optax adamw's 1e-4)."""

    def __init__(self, lr: float, max_grad_norm: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, accumulate: int = 1):
        super().__init__(lr, max_grad_norm, b1, b2, eps, weight_decay,
                         accumulate)


def state_bytes(state: OptState) -> int:
    """The bytes of an optimizer state's moments (codes and scales, or the
    dense moments)."""
    tensors = [*state.mu, *state.nu, *(state.mu_scale or ()),
               *(state.nu_scale or ())]
    return sum(t.numel() * t.element_size() for t in tensors)
