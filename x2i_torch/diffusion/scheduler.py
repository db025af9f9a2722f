"""Flow-matching Euler discrete scheduler (diffusers
FlowMatchEulerDiscreteScheduler semantics), the counterpart of
``x2i_tpu/diffusion/scheduler.py``, with the training samplers: the
noising ``add_noise``, the timestep density and the loss weighting.
Sigmas are float32. The samplers take their random draws as an argument
or draw them from a ``torch.Generator``: ``jax.random`` and torch draw
different numbers, so a caller that wants JAX's passes them in."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from x2i_torch.core.config import SchedulerConfig


def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                    max_seq_len: int = 4096, base_shift: float = 0.5,
                    max_shift: float = 1.16) -> float:
    """Resolution-dependent mu."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


@dataclass(frozen=True)
class FlowMatchEulerScheduler:
    cfg: SchedulerConfig = field(default_factory=SchedulerConfig)

    def inference_sigmas(self, num_inference_steps: int,
                         image_seq_len: Optional[int] = None,
                         device=None) -> torch.Tensor:
        """(num_steps + 1,) f32: linspace(1, 1/n, n), shifted, then 0."""
        sigmas = torch.linspace(1.0, 1.0 / num_inference_steps,
                                num_inference_steps, dtype=torch.float32,
                                device=device)
        sigmas = self.shift_sigmas(sigmas, image_seq_len)
        return torch.cat([sigmas, sigmas.new_zeros(1)])

    def shift_sigmas(self, sigmas: torch.Tensor,
                     image_seq_len: Optional[int] = None) -> torch.Tensor:
        c = self.cfg
        if c.use_dynamic_shifting:
            if image_seq_len is None:
                raise ValueError("dynamic shifting requires image_seq_len")
            mu = calculate_shift(image_seq_len, c.base_image_seq_len,
                                 c.max_image_seq_len, c.base_shift,
                                 c.max_shift)
            return math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
        return c.shift * sigmas / (1.0 + (c.shift - 1.0) * sigmas)

    @staticmethod
    def step(sample: torch.Tensor, model_output: torch.Tensor,
             sigma: torch.Tensor, sigma_next: torch.Tensor) -> torch.Tensor:
        """One Euler step of the rectified-flow ODE (f32 update)."""
        out = sample.float() + (sigma_next - sigma) * model_output.float()
        return out.to(sample.dtype)

    @staticmethod
    def add_noise(x0: torch.Tensor, noise: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
        """Flow-matching noising x_t = (1 - sigma) x0 + sigma z in f32, in
        x0's dtype; sigma (B,) broadcast over x0's trailing axes."""
        sigma = sigma.reshape(sigma.shape + (1,) * (x0.ndim - sigma.ndim))
        return ((1.0 - sigma) * x0.float()
                + sigma * noise.float()).to(x0.dtype)


def compute_density_for_timestep_sampling(
        batch_size: int, scheme: str = "logit_normal",
        logit_mean: float = 0.0, logit_std: float = 1.0,
        mode_scale: float = 1.29, draws: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        device=None) -> torch.Tensor:
    """u in [0, 1] (B,) f32 (diffusers' training util): "logit_normal"
    takes standard normals, the other schemes uniforms on [0, 1), as
    ``draws`` (B,) or drawn from ``generator`` on ``device``."""
    if draws is None:
        draw = torch.randn if scheme == "logit_normal" else torch.rand
        draws = draw((batch_size,), generator=generator, device=device,
                     dtype=torch.float32)
    draws = draws.float()
    if scheme == "logit_normal":
        return torch.sigmoid(logit_mean + logit_std * draws)
    if scheme == "mode":
        u = draws
        return 1.0 - u - mode_scale * (torch.cos(math.pi * u / 2) ** 2
                                       - 1 + u)
    return draws


def loss_weighting(scheme: str, sigmas: torch.Tensor) -> torch.Tensor:
    """diffusers' compute_loss_weighting_for_sd3: "sigma_sqrt",
    "cosmap", otherwise ones."""
    if scheme == "sigma_sqrt":
        return sigmas ** -2.0
    if scheme == "cosmap":
        bot = 1.0 - 2.0 * sigmas + 2.0 * sigmas ** 2
        return 2.0 / (math.pi * bot)
    return torch.ones_like(sigmas)
