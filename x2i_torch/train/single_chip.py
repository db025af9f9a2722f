"""The split teacher/student step on one card, the counterpart of
``x2i_tpu/train/single_chip.py``.

The teacher runs under ``torch.no_grad()`` and hands over only its KD
stacks; the student regenerates the seeded latents from the step's noise
seed and computes the MLLM states from the batch. Peak memory is then the
larger of the two halves, not their union: the teacher's activations are
freed before the student's forward starts. (The JAX module also compiles
the two halves ahead of time; PyTorch runs eagerly and needs no such
step.)
"""

from __future__ import annotations

from typing import Callable, Optional

from x2i_torch.core.config import DistillConfig, FluxConfig
from x2i_torch.train.distill import (DistillOptimizer, TrainState,
                                     make_student_step, make_teacher_step)


def single_chip_distill(flux, teacher_text_fn: Callable,
                        student_states_fn: Callable,
                        optimizer: DistillOptimizer, flux_cfg: FluxConfig,
                        dcfg: DistillConfig,
                        guidance_scale: Optional[float] = 3.5):
    """-> (run_step, teacher_fn, student_fn); run_step(state, batch,
    noise) -> (state, metrics) runs teacher then student."""
    teacher_fn = make_teacher_step(flux, teacher_text_fn, student_states_fn,
                                   flux_cfg, dcfg, guidance_scale,
                                   emit_mllm_states=False, emit_latents=False)
    student_fn = make_student_step(flux, optimizer, flux_cfg, dcfg,
                                   guidance_scale,
                                   student_states_fn=student_states_fn,
                                   regenerate_latents=True)

    def run_step(state: TrainState, batch, noise):
        teacher_out = teacher_fn(batch, noise)
        return student_fn(state, batch, teacher_out, noise)

    return run_step, teacher_fn, student_fn
