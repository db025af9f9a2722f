"""Phase-1 attention distillation, the counterpart of
``x2i_tpu/train/distill.py``: train the proj so that FLUX attends the same
way under MLLM conditioning as under T5/CLIP conditioning.

One step: the frozen FLUX runs as the teacher on the T5 sequence and the
CLIP pooled embedding and emits its KD stacks (each block's attention
output); then as the student on ``proj(MLLM hidden states)``; the KD loss
(``ops/kd.py``, tau 3, summed over the blocks) is differentiated into the
proj alone, and AdamW updates it. Both runs use the same seeded noise
latents at sigma 1 (a 1-step flow schedule, 128x128 latents = 4096 image
tokens at full size).

PyTorch runs eagerly, so the JAX step's ``flux_params`` argument is gone:
the frozen modules are bound when a step is made, and ``TrainState``
holds the proj module itself, updated in place. ``jax.random`` keys become
``noise``: an int seeds a ``torch.Generator`` on the latents' device, or a
tensor of packed latents (B, S_img, C*4) is used as it is, which is how
the tests feed both packages the same latents (the two generators draw
different numbers). A ``StepShard`` (``core/mesh.py``) is one data rank's
share of a data-parallel step: the whole batch's latents are drawn from
its seed and the rank keeps its share, and the student's gradients are
averaged over the data ranks before the optimizer (what XLA inserts for
JAX), exact for the KD loss, a sum of per-block ``batchmean`` KL terms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from x2i_torch.core.config import DistillConfig, FluxConfig
from x2i_torch.core.mesh import StepShard
from x2i_torch.diffusion.sampling import (pack_latents,
                                          prepare_latent_image_ids)
from x2i_torch.ops.kd import kl_term
from x2i_torch.train.optim import AdamW, OptState, global_norm
from x2i_torch.train.optim8bit import Moments8bit

KD_KEYS = ("double_img", "double_txt", "single")


def kd_loss(teacher_aux: Dict, student_aux: Dict, tau: float = 3.0,
            layout: str = "reference") -> torch.Tensor:
    """Sum of the per-block KL terms over the three KD stacks: (B, L, S, D)
    in the "reference" layout, (L, B, S, D) in "scan"; a teacher stack may
    be an int8 (values, scales) pair."""
    axis = 0 if layout == "scan" else 1
    loss = 0.0
    for key in KD_KEYS:
        t, s = teacher_aux[key], student_aux[key]
        terms = [kl_term(tuple(x.select(axis, i) for x in t)
                         if isinstance(t, tuple) else t.select(axis, i),
                         s.select(axis, i), tau)
                 for i in range(s.shape[axis])]
        loss = loss + torch.stack(terms).sum()
    return loss


@dataclasses.dataclass
class TrainState:
    proj: nn.Module                # the only trainable module
    opt_state: OptState
    step: int = 0


class DistillOptimizer(AdamW):
    """The JAX ``make_optimizer``: ``train/optim.py``'s chain with the
    config's betas, epsilon and weight decay, the accumulation over
    ``gradient_accumulation_steps`` mini-steps, and the learning rate
    ``warmup_cosine_decay_schedule(0 -> peak, warmup,
    decay_steps=max_train_steps, end 0)`` read at the count before the
    update, so the first update has learning rate 0."""

    def __init__(self, dcfg: DistillConfig):
        super().__init__(dcfg.learning_rate, dcfg.max_grad_norm,
                         dcfg.adam_beta1, dcfg.adam_beta2,
                         dcfg.adam_epsilon, dcfg.adam_weight_decay,
                         dcfg.gradient_accumulation_steps)
        self.dcfg = dcfg

    def learning_rate(self, count: int) -> float:
        d = self.dcfg
        peak, warmup = d.learning_rate, d.lr_warmup_steps
        if count < warmup:
            return peak * count / warmup
        decay = d.max_train_steps - warmup
        t = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


class DistillOptimizer8bit(Moments8bit, DistillOptimizer):
    """``DistillOptimizer`` with ``train/optim8bit.py``'s 8-bit moments:
    the JAX ``make_optimizer`` with ``use_8bit_adam`` (``adamw8bit`` on
    the same schedule, betas, epsilon and weight decay)."""


def make_optimizer(dcfg: DistillConfig) -> DistillOptimizer:
    return (DistillOptimizer8bit if dcfg.use_8bit_adam
            else DistillOptimizer)(dcfg)


def init_state(proj: nn.Module, optimizer: DistillOptimizer) -> TrainState:
    proj.requires_grad_(True)
    return TrainState(proj, optimizer.init(list(proj.parameters())), 0)


def make_latents(noise, batch_size: int, flux_cfg: FluxConfig,
                 dcfg: DistillConfig, device) -> torch.Tensor:
    """The step's packed noise latents (B, S_img, C*4) in the DiT's dtype:
    ``noise`` as given if it is a tensor, else drawn in f32 from a
    ``torch.Generator`` on ``device`` seeded with the int ``noise`` (with
    a ``StepShard``: the share of the whole batch's draw)."""
    if isinstance(noise, torch.Tensor):
        return noise.to(device, flux_cfg.dtype)
    share = noise if isinstance(noise, StepShard) else None
    seed = int(noise) if share is None else share.seed
    whole = batch_size * (1 if share is None else share.count)
    gen = torch.Generator(device=device).manual_seed(seed)
    lat = torch.randn((whole, flux_cfg.in_channels // 4,
                       dcfg.latent_height, dcfg.latent_width),
                      generator=gen, device=device, dtype=torch.float32)
    if share is not None:
        lat = share.take(lat)
    return pack_latents(lat).to(flux_cfg.dtype)


class _Step:
    """What the teacher and student steps share: the ids, the guidance."""

    def __init__(self, flux, flux_cfg, dcfg, guidance_scale):
        self.flux, self.flux_cfg, self.dcfg = flux, flux_cfg, dcfg
        self.guidance_scale = guidance_scale
        self.device = next(flux.parameters()).device
        self.img_ids = prepare_latent_image_ids(
            dcfg.latent_height, dcfg.latent_width, self.device)
        self.txt_ids = torch.zeros((dcfg.text_seq_len, 3),
                                   dtype=torch.float32, device=self.device)

    def inputs(self, batch, noise):
        b = next(iter(batch.values())).shape[0]
        latents = make_latents(noise, b, self.flux_cfg, self.dcfg,
                               self.device)
        timestep = torch.ones((b,), dtype=torch.float32, device=self.device)
        return latents, timestep, self.guidance(b)

    def guidance(self, b):
        if not self.flux_cfg.guidance_embeds:
            return None
        return torch.full((b,), self.guidance_scale, dtype=torch.float32,
                          device=self.device)


def make_teacher_step(flux: nn.Module, teacher_text_fn: Callable,
                      student_states_fn: Callable, flux_cfg: FluxConfig,
                      dcfg: DistillConfig,
                      guidance_scale: Optional[float] = 3.5,
                      emit_mllm_states: bool = True,
                      emit_latents: bool = True):
    """-> teacher_fn(batch, noise) -> {"teacher_aux", ["latents",
    "timestep"], ["mllm_states"]}, under no_grad: the teacher FLUX's KD
    stacks in the scan layout (per-token int8 with ``kd_stacks_int8``).
    teacher_text_fn(batch) -> (t5_seq (B, S, 4096), clip_pooled (B, 768));
    student_states_fn(batch) -> MLLM hidden states (B, C, S, H)."""
    base = _Step(flux, flux_cfg, dcfg, guidance_scale)

    @torch.no_grad()
    def teacher_fn(batch, noise):
        latents, timestep, guidance = base.inputs(batch, noise)
        t5_seq, clip_pooled = teacher_text_fn(batch)
        _, teacher_aux = flux(
            latents, t5_seq, clip_pooled, timestep, base.img_ids,
            base.txt_ids, guidance, return_attn_outputs=True,
            quantize_attn_outputs=dcfg.kd_stacks_int8, aux_layout="scan")
        out = {"teacher_aux": teacher_aux}
        if emit_latents:
            out["latents"], out["timestep"] = latents, timestep
        if emit_mllm_states:
            out["mllm_states"] = student_states_fn(batch)
        return out

    return teacher_fn


def make_student_step(flux: nn.Module, optimizer: DistillOptimizer,
                      flux_cfg: FluxConfig, dcfg: DistillConfig,
                      guidance_scale: Optional[float] = 3.5,
                      student_states_fn: Optional[Callable] = None,
                      regenerate_latents: bool = False):
    """-> student_fn(state, batch, teacher_out, noise) -> (state, metrics):
    proj -> student FLUX -> KD loss -> gradient of the proj's parameters
    -> AdamW, in place. With ``student_states_fn`` the MLLM states are
    computed from the batch (else read from teacher_out); with
    ``regenerate_latents`` the latents come from ``noise`` (else from
    teacher_out). metrics: {"loss", "grad_norm"} as 0-d tensors."""
    base = _Step(flux, flux_cfg, dcfg, guidance_scale)

    def student_fn(state: TrainState, batch, teacher_out, noise):
        if regenerate_latents:
            latents, timestep, guidance = base.inputs(batch, noise)
        else:
            latents, timestep = teacher_out["latents"], teacher_out["timestep"]
            guidance = base.guidance(latents.shape[0])
        with torch.no_grad():
            states = (student_states_fn(batch) if student_states_fn
                      is not None else teacher_out["mllm_states"])
        teacher_aux = teacher_out["teacher_aux"]
        params = list(state.proj.parameters())
        with torch.enable_grad():
            pooled, seq = state.proj(states)
            args = (latents, seq.to(flux_cfg.dtype),
                    pooled.to(flux_cfg.dtype), timestep, base.img_ids,
                    base.txt_ids, guidance)
            if dcfg.inline_kd:
                _, loss = flux(*args, kd_targets=teacher_aux,
                               kd_temperature=dcfg.kd_temperature,
                               aux_layout="scan")
            else:
                _, student_aux = flux(*args, return_attn_outputs=True,
                                      aux_layout="scan")
                loss = kd_loss(teacher_aux, student_aux, dcfg.kd_temperature,
                               layout="scan")
            grads = torch.autograd.grad(loss, params)
        if isinstance(noise, StepShard):
            grads = noise.mean(grads)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        state.opt_state = optimizer.update(params, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return student_fn


def make_distill_step(flux: nn.Module, teacher_text_fn: Callable,
                      student_states_fn: Callable,
                      optimizer: DistillOptimizer, flux_cfg: FluxConfig,
                      dcfg: DistillConfig,
                      guidance_scale: Optional[float] = 3.5):
    """The colocated step: teacher then student on one device, the
    teacher handing over its latents and the MLLM states.
    -> step_fn(state, batch, noise) -> (state, metrics)."""
    teacher_fn = make_teacher_step(flux, teacher_text_fn, student_states_fn,
                                   flux_cfg, dcfg, guidance_scale)
    student_fn = make_student_step(flux, optimizer, flux_cfg, dcfg,
                                   guidance_scale)

    def step_fn(state: TrainState, batch, noise):
        teacher_out = teacher_fn(batch, noise)
        return student_fn(state, batch, teacher_out, noise)

    return step_fn
