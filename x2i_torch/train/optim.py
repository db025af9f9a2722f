"""AdamW as the JAX trainers chain it in optax, step by step, shared by
the phase-1 distillation and the phase-2 LightControl trainers:
``optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
weight_decay))``, wrapped in ``optax.MultiSteps(k)`` when k > 1.

* the gradients are scaled by ``max_norm / norm`` when ``norm >=
  max_norm`` (no ``+1e-6``, unlike ``clip_grad_norm_``);
* Adam moments in the parameters' dtype, bias-corrected, ``eps`` outside
  the square root;
* decoupled weight decay on every parameter;
* the learning rate read at the count before the update
  (``learning_rate(count)``; a subclass gives its schedule);
* ``p + update`` rounded to the parameter's dtype;
* with k > 1, MultiSteps' accumulation: each mini-step folds its
  gradients into a running mean (``acc + (g - acc) / (n + 1)``, n the
  mini-steps before it); the k-th hands the mean to the chain above, the
  others leave the parameters and the inner state (count, moments) as
  they were.

``train/optim8bit.py``'s 8-bit variant shares the clip, the accumulation
and ``learning_rate(count)``, and keeps its moments otherwise
(``init_moments`` and ``adam``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch


@dataclasses.dataclass
class OptState:
    count: int                     # the updates applied so far
    mu: List[torch.Tensor]         # 8-bit: f8 codes (blocks, 128)
    nu: List[torch.Tensor]
    mini_step: int = 0             # mini-steps since the last update
    acc: Optional[List[torch.Tensor]] = None   # their gradients' mean
    mu_scale: Optional[List[torch.Tensor]] = None  # 8-bit: f32 (blocks, 1)
    nu_scale: Optional[List[torch.Tensor]] = None


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """The chain above at a constant learning rate ``lr``; optax's adamw
    defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4)."""

    def __init__(self, lr: float, max_grad_norm: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, accumulate: int = 1):
        if accumulate < 1:
            raise ValueError(f"accumulate={accumulate}: at least 1")
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.accumulate = weight_decay, accumulate

    def learning_rate(self, count: int) -> float:
        return self.lr

    def init(self, params) -> OptState:
        return OptState(0, **self.init_moments(params),
                        acc=([torch.zeros_like(p) for p in params]
                             if self.accumulate > 1 else None))

    def init_moments(self, params) -> dict:
        """The OptState fields of the moments before the first update."""
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state: OptState) -> OptState:
        """One mini-step: fold ``grads`` into the accumulation and, on the
        k-th mini-step (every step when k is 1), apply one update to
        ``params`` in place; returns the new state."""
        acc = None
        if self.accumulate > 1:
            n = state.mini_step
            # the divisor as a tensor on the device: a CUDA division by a
            # Python number multiplies by its reciprocal
            acc = [a + (g.to(a.dtype) - a) / torch.full(
                (), n + 1, dtype=a.dtype, device=a.device)
                for a, g in zip(state.acc, grads)]
            if n + 1 < self.accumulate:
                return dataclasses.replace(state, mini_step=n + 1, acc=acc)
            grads, acc = acc, [torch.zeros_like(a) for a in acc]
        norm = global_norm(grads)
        if not bool(norm < self.max_grad_norm):
            grads = [g / norm.to(g.dtype) * self.max_grad_norm
                     for g in grads]
        count = state.count + 1
        moments = self.adam(params, grads, state, count,
                            self.learning_rate(state.count))
        return dataclasses.replace(state, count=count, mini_step=0, acc=acc,
                                   **moments)

    def adam(self, params, grads, state: OptState, count: int,
             lr: float) -> dict:
        """optax's adamw: updates ``params`` in place with the clipped
        ``grads`` (the ``count``-th update, at learning rate ``lr``);
        returns the new moments' OptState fields."""
        bc1, bc2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        mus, nus = [], []
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = g.to(p.dtype)
            mu = (1.0 - self.b1) * g + self.b1 * mu
            nu = (1.0 - self.b2) * g.square() + self.b2 * nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_((p + (-lr) * u).to(p.dtype))
            mus.append(mu)
            nus.append(nu)
        return {"mu": mus, "nu": nus}
