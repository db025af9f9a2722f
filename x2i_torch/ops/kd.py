"""Attention-distillation KD math, the counterpart of ``x2i_tpu/ops/kd.py``
(shared by the trainer and the inline per-block path inside the DiT).

One block's term is ``kl_div(log_softmax(normalize(teacher) / tau),
softmax(normalize(student) / tau), 'batchmean')`` with normalize = (x -
mean) / (1e-7 + std), the std unbiased; a non-finite term counts 0.
Gradients flow through the student, the kl_div target.
"""

from __future__ import annotations

import torch


def normalize_logit(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().sum(-1, keepdim=True) / (xf.shape[-1] - 1)
    return (xf - mean) / (eps + torch.sqrt(var))


def kl_term(teacher, student: torch.Tensor, tau: float) -> torch.Tensor:
    """One block's KD term over (B, S, D), 'batchmean' reduction; f32 0-d.
    teacher may be a dense tensor or an int8 (values, scales) pair from
    ``quantize_kd_stacks``."""
    teacher = dequantize_kd(teacher)
    logp_t = torch.log_softmax(normalize_logit(teacher) / tau, dim=-1)
    log_q_s = torch.log_softmax(normalize_logit(student) / tau, dim=-1)
    kl = (log_q_s.exp() * (log_q_s - logp_t)).sum() / teacher.shape[0]
    return torch.where(torch.isfinite(kl), kl, torch.zeros_like(kl))


def quantize_kd_tensor(x: torch.Tensor):
    """Per-token symmetric int8: (..., D) -> ((..., D) int8, (...,) f32
    scales)."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = amax.clamp_min(1e-6) / amax.new_full((), 127.0)
    q = torch.round(xf / scale).clamp(-127.0, 127.0).to(torch.int8)
    return q, scale[..., 0]


def quantize_kd_stacks(aux: dict) -> dict:
    """Per-token int8 of each teacher KD stack (half the bytes of bf16;
    the KD loss normalizes each token's logits anyway)."""
    return {key: quantize_kd_tensor(x) for key, x in aux.items()}


def dequantize_kd(t):
    """Inverse of ``quantize_kd_tensor`` for one stack (or passthrough)."""
    if isinstance(t, tuple):
        q, scale = t
        return q.float() * scale[..., None]
    return t
