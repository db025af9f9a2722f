"""Phase-2 LightControl finetune, the counterpart of
``x2i_tpu/train/lightcontrol.py``: the ControlNeXt branches learn with a
flow-matching MSE loss while the DiT, the VAE and the conditioning stay
frozen.

One step: the target image's latents (a sampled VAE encode, or
precomputed in the batch), a logit-normal ``u`` that indexes the shifted
training sigma table, the noisy latents ``(1 - sigma) x0 + sigma z``, the
frozen conditioning under ``no_grad``, the bank on the target pixels at
``sigma * 1000``, the frozen DiT with ``controls=``, the loss as the mean
over the batch of each sample's mean of ``(pred - (z - x0))^2``, and the
gradient of the bank's parameters alone into ``train/optim.py``'s AdamW
(``train/optim8bit.py``'s with ``use_8bit_adam``).

PyTorch runs eagerly: the frozen modules are bound when the step is made,
``ControlTrainState`` holds the bank itself, updated in place. A step's
random draws are its third argument: an int seeds a ``torch.Generator``
on the device, or a dict of tensors gives them as they are, which is how
the tests feed JAX's draws to the port (``jax.random`` and torch draw
different numbers): "density" (B,) the normals of the timestep density,
"noise" (B, C, h, w) the latent noise, "vae" (B, h, w, C) the VAE's
sampling noise (unused when the batch carries ``latents``). A
``StepShard`` (``core/mesh.py``) is one data rank's share of a
data-parallel step: each draw is made for the whole batch from its seed,
in the one-process order, and the rank keeps its share; the gradients are
averaged over the data ranks before the optimizer, exact for this loss (a
mean over the batch).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from x2i_torch.core.config import (FluxConfig, LightControlConfig,
                                   SchedulerConfig)
from x2i_torch.core.mesh import StepShard
from x2i_torch.diffusion.sampling import (pack_latents,
                                          prepare_latent_image_ids,
                                          unpack_latents)
from x2i_torch.diffusion.scheduler import (FlowMatchEulerScheduler,
                                           compute_density_for_timestep_sampling)
from x2i_torch.models.controlnext import ControlBank, apply_control_bank
from x2i_torch.train.optim import AdamW, OptState, global_norm
from x2i_torch.train.optim8bit import AdamW8bit

Draws = Union[int, StepShard, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class ControlTrainState:
    bank: ControlBank              # the only trainable module
    opt_state: OptState
    step: int = 0


def make_lightcontrol_optimizer(ccfg: LightControlConfig) -> AdamW:
    """clip_by_global_norm(max_grad_norm) + AdamW at the constant
    learning rate and optax's defaults (with ``use_8bit_adam`` JAX's
    ``adamw8bit(learning_rate)``: its weight decay is 1e-2, not 1e-4),
    accumulated over ``gradient_accumulation_steps`` mini-steps."""
    return (AdamW8bit if ccfg.use_8bit_adam else AdamW)(
        ccfg.learning_rate, ccfg.max_grad_norm,
        accumulate=ccfg.gradient_accumulation_steps)


def init_state(bank: ControlBank, optimizer: AdamW) -> ControlTrainState:
    bank.requires_grad_(True)
    return ControlTrainState(bank, optimizer.init(list(bank.parameters())))


def make_lightcontrol_step(flux: nn.Module,
                           vae_encode: Optional[Callable],
                           conditioning_fn: Callable,
                           flux_cfg: FluxConfig, ccfg: LightControlConfig,
                           sched_cfg: SchedulerConfig, optimizer: AdamW,
                           guidance_scale: Optional[float] = 3.5):
    """-> step_fn(state, batch, draws) -> (state, metrics).

    batch: {"style_pixels": (B, H, W, 3) in [-1, 1], the target image,
    which the bank also takes as its guidance, + what conditioning_fn
    needs}; with ``vae_encode=None`` also "latents" (B, H/8, W/8, C).
    vae_encode(pixels, eps) -> scaled NHWC latents, eps the (B, h, w, C)
    f32 sampling noise; conditioning_fn(batch) -> (pooled, prompt), run
    under ``no_grad``. metrics: {"loss", "grad_norm"} as 0-d tensors,
    the latter the global norm of this mini-step's raw gradients."""
    device = next(flux.parameters()).device
    sched = FlowMatchEulerScheduler(sched_cfg)
    n_train = sched_cfg.num_train_timesteps
    # the training sigma table: linspace(1, 1/n, n), shifted as at 4096
    # image tokens (only a dynamically shifting config reads the count)
    sigma_table = sched.shift_sigmas(torch.linspace(
        1.0, 1.0 / n_train, n_train, dtype=torch.float32, device=device),
        image_seq_len=4096)

    def step_fn(state: ControlTrainState, batch, draws: Draws):
        pixels = batch["style_pixels"].to(device)
        bsz, px_h, px_w = pixels.shape[:3]
        gen, share = None, None
        if isinstance(draws, StepShard):
            share, draws = draws, draws.seed
        if not isinstance(draws, dict):
            gen = torch.Generator(device=device).manual_seed(int(draws))
        count = 1 if share is None else share.count

        def mine(whole):
            return whole if share is None else share.take(whole)

        def draw(name, shape):
            if gen is None:
                return draws[name].to(device, torch.float32)
            return mine(torch.randn((shape[0] * count, *shape[1:]),
                                    generator=gen, device=device,
                                    dtype=torch.float32))

        with torch.no_grad():
            if vae_encode is None:
                latents = batch["latents"].to(device)
            else:
                latents = vae_encode(pixels, draw(
                    "vae", (bsz, px_h // 8, px_w // 8,
                            flux_cfg.in_channels // 4)))
            latents = latents.permute(0, 3, 1, 2)          # NCHW
            h, w = latents.shape[2:]
            noise = draw("noise", tuple(latents.shape))
            u = mine(compute_density_for_timestep_sampling(
                bsz * count, "logit_normal", ccfg.logit_mean, ccfg.logit_std,
                draws=None if gen is not None else draws["density"],
                generator=gen, device=device))
            idx = (u.to(device) * n_train).to(torch.int32).clamp(
                0, n_train - 1)
            sigmas = sigma_table[idx.long()]
            noisy = sched.add_noise(latents.float(), noise, sigmas)
            packed = pack_latents(noisy).to(flux_cfg.dtype)
            pooled, prompt = conditioning_fn(batch)
            img_ids = prepare_latent_image_ids(h, w, device)
            txt_ids = torch.zeros((prompt.shape[1], 3), dtype=torch.float32,
                                  device=device)
            guidance = (torch.full((bsz,), guidance_scale,
                                   dtype=torch.float32, device=device)
                        if flux_cfg.guidance_embeds else None)
            target = noise - latents.float()

        params = list(state.bank.parameters())
        with torch.enable_grad():
            controls = apply_control_bank(state.bank, pixels, sigmas * 1000.0,
                                          impl=ccfg.control_bank_impl)
            pred = flux(packed, prompt.to(flux_cfg.dtype),
                        pooled.to(flux_cfg.dtype), sigmas, img_ids, txt_ids,
                        guidance, controls=controls)
            pred = unpack_latents(pred, h * 8, w * 8).float()
            loss = (pred - target).square().reshape(bsz, -1).mean(1).mean()
            grads = torch.autograd.grad(loss, params)
        if share is not None:
            grads = share.mean(grads)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        state.opt_state = optimizer.update(params, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return step_fn
