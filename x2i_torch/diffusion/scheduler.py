"""Flow-matching Euler discrete scheduler (diffusers
FlowMatchEulerDiscreteScheduler semantics), the counterpart of
``x2i_tpu/diffusion/scheduler.py``. Sigmas are float32."""

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
